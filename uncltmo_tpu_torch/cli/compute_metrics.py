"""Offline quality metrics over result directories (port of
`cli/compute_metrics.py`), the device work on --device (the card by
default; `--device cpu` runs without one).

Covers the reference's offline metric CLIs:
  * batch TMQI over tone-mapped outputs vs their HDR sources
    (`metrics/TMQI_python/demo.py:8-31`),
  * temporal warp error between consecutive frames of a scene
    (`metrics/compute_wrap_error.py:93-124`),
  * FID between a real-LDR dir and a fake dir (`fid/fid_score.py:294-324`),
  * blind BTMQI-surrogate scores (see `uncltmo_tpu_torch/metrics/btmqi.py`).

Examples:
  python -m uncltmo_tpu_torch.cli.compute_metrics tmqi --hdr_dir hdrs/ \
      --ldr_dir outputs/
  python -m uncltmo_tpu_torch.cli.compute_metrics warp \
      --frames_dir outputs/scene1/
  python -m uncltmo_tpu_torch.cli.compute_metrics fid --real_dir div2k/ \
      --fake_dir outputs/ --inception_weights pt_inception.pth
  python -m uncltmo_tpu_torch.cli.compute_metrics btmqi --ldr_dir outputs/
"""
from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np
import torch
import torch.nn.functional as F

from uncltmo_tpu_torch.utils.io import (HDR_EXTENSIONS, read_hdr_image,
                                        read_ldr_image)


def _hdr_at(hdr: np.ndarray, ldr: np.ndarray, device) -> torch.Tensor:
    """The HDR image on `device`, resized to the LDR's size where they
    differ: bilinear with half-pixel centres and no antialiasing, the rule
    of the JAX CLI's `cv2.resize`."""
    x = torch.from_numpy(hdr).to(device)
    if hdr.shape[:2] != ldr.shape[:2]:
        x = F.interpolate(x.permute(2, 0, 1)[None], size=ldr.shape[:2],
                          mode="bilinear", align_corners=False,
                          antialias=False)[0].permute(1, 2, 0)
    return x


def cmd_tmqi(args):
    if getattr(args, "hdr_file", ""):
        if not args.ldr_file:
            sys.exit("--hdr_file needs --ldr_file")
        return _tmqi_pair(args)
    if not (args.hdr_dir and args.ldr_dir):
        sys.exit("need --hdr_dir + --ldr_dir (or --hdr_file + --ldr_file)")
    if getattr(args, "per_scene", 0):
        return _tmqi_scenes(args)
    _tmqi_dir(args.hdr_dir, args.ldr_dir, args.output,
              int(getattr(args, "max_frames", 0)),
              revised=bool(getattr(args, "revised", 0)), device=args.device)


def _tmqi_pair(args):
    """Single HDR/LDR pair, the reference TMQI CLI's core usage
    (`TMQI.py:260-456`: two positional files -> Q, S, N, s_local)."""
    from uncltmo_tpu_torch.metrics.tmqi import tmqi
    ldr = read_ldr_image(args.ldr_file) * 255.0
    hdr = _hdr_at(read_hdr_image(args.hdr_file), ldr, args.device)
    q, s, n, s_local, _ = tmqi(hdr, ldr.astype(np.float32),
                               revised=bool(getattr(args, "revised", 0)),
                               device=args.device)
    prec = int(getattr(args, "precision", 4))
    print(f"Q: {round(q, prec)} S: {round(s, prec)} N: {round(n, prec)}")
    print("s_local: " + " ".join(str(round(v, prec)) for v in s_local))
    _save(args.output, {"Q": q, "S": s, "N": n, "s_local": s_local})


def _tmqi_scenes(args):
    """Video-dataset layout (reference `metrics/TMQI_python/demo.py:8-31`):
    scene sub-directories of .npy HDR frames, first `max_frames` per scene,
    outputs named <frame>_UnCLTMO.png under the same scene name."""
    all_scores, means = {}, []
    for scene in sorted(os.listdir(args.hdr_dir)):
        h = os.path.join(args.hdr_dir, scene)
        l = os.path.join(args.ldr_dir, scene)
        if not (os.path.isdir(h) and os.path.isdir(l)):
            continue
        scores = _tmqi_dir(h, l, "", int(args.max_frames) or 6,
                           revised=bool(getattr(args, "revised", 0)),
                           device=args.device)
        if scores:
            all_scores[scene] = scores
            means.append(np.mean([v["Q"] for v in scores.values()]))
    if means:
        print(f"average score over {len(all_scores)} scenes: "
              f"{float(np.mean(means)):.4f}")
        _save(args.output, {"per_scene": all_scores,
                            "mean_Q": float(np.mean(means))})


def _tmqi_dir(hdr_dir, ldr_dir, output, max_frames=0, revised=False,
              device="cuda"):
    from uncltmo_tpu_torch.metrics.tmqi import tmqi
    scores = {}
    ldr_files = {os.path.splitext(f)[0]: f for f in os.listdir(ldr_dir)
                 if f.lower().endswith((".png", ".jpg"))}
    # filter to HDR frames BEFORE the max_frames cut (a stray non-frame
    # entry must not consume one of the protocol's 6 per-scene slots)
    hdr_names = sorted(n for n in os.listdir(hdr_dir)
                       if os.path.splitext(n)[1] in HDR_EXTENSIONS)
    if max_frames:
        hdr_names = hdr_names[:max_frames]
    for hdr_name in hdr_names:
        stem = os.path.splitext(hdr_name)[0]
        # exact stem match (bare or any '_suffix' the savers append) — an
        # unanchored prefix scan would pair '1.hdr' with '10_UnCLTMO.png'
        # whenever the dict enumerates it first
        match = ldr_files.get(stem) or next(
            (v for k, v in sorted(ldr_files.items())
             if k.startswith(stem + "_")), None)
        if match is None:
            continue
        ldr = read_ldr_image(os.path.join(ldr_dir, match)) * 255.0
        hdr = _hdr_at(read_hdr_image(os.path.join(hdr_dir, hdr_name)), ldr,
                      device)
        q, s, n, _, _ = tmqi(hdr, ldr.astype(np.float32), revised=revised,
                             device=device)
        scores[stem] = {"Q": q, "S": s, "N": n}
        print(f"{stem}: Q={q:.4f} S={s:.4f} N={n:.6f}")
    if scores:
        mean_q = float(np.mean([v["Q"] for v in scores.values()]))
        print(f"mean Q over {len(scores)} images: {mean_q:.4f}")
        _save(output, {"per_image": scores, "mean_Q": mean_q})
    return scores


def _baseline_for(baseline_dir: str, name: str):
    """The L1L0-baseline render matching `name`: same filename, or the
    reference's '<stem>_L1L0TM.png' pattern (`Tester.py:378-385`)."""
    stem = os.path.splitext(name)[0]
    for cand in (name, stem + "_L1L0TM.png"):
        p = os.path.join(baseline_dir, cand)
        if os.path.exists(p):
            return read_ldr_image(p)
    return None


def cmd_warp(args):
    from uncltmo_tpu_torch.metrics.warp_error import (compute_warp_error,
                                                      resolve_flow_algo)
    # frames decoded on the host are scored where --device says
    resolved = resolve_flow_algo(
        args.algo, card=torch.device(args.device).type == "cuda")
    if args.protocol == "strict":
        # the published protocol is DeepFlow on the L1L0 baseline renders
        # (`Tester.py:378-390`); strict mode refuses to emit numbers that
        # would silently mean something else on this machine
        if resolved != "DeepFlow":
            raise SystemExit(
                f"--protocol strict: flow algo resolves to {resolved!r} on "
                "this machine but the paper protocol requires DeepFlow "
                "(opencv-contrib); rerun with --protocol loose to accept a "
                "documented deviation")
        if not args.baseline_dir:
            raise SystemExit(
                "--protocol strict requires --baseline_dir with the L1L0 "
                "baseline renders (flow on the model's own output is not "
                "the paper protocol)")
    frames = sorted(f for f in os.listdir(args.frames_dir)
                    if f.lower().endswith((".png", ".jpg")))
    e1s, e2s = [], []
    flow_source = None
    for a, b in zip(frames[:-1], frames[1:]):
        f0 = read_ldr_image(os.path.join(args.frames_dir, a))
        f1 = read_ldr_image(os.path.join(args.frames_dir, b))
        src0 = src1 = None
        if args.baseline_dir:
            src0 = _baseline_for(args.baseline_dir, a)
            src1 = _baseline_for(args.baseline_dir, b)
            if src0 is None or src1 is None:
                if args.protocol == "strict":
                    raise SystemExit(
                        f"--protocol strict: no baseline render for "
                        f"{a!r}/{b!r} in {args.baseline_dir!r}")
                src0 = src1 = None
        e1, e2, info = compute_warp_error(f0, f1, algo=args.algo,
                                          flow_source0=src0,
                                          flow_source1=src1,
                                          with_provenance=True,
                                          device=args.device)
        if flow_source not in (None, info["flow_source"]):
            info["flow_source"] = "mixed"   # some pairs had a baseline
        flow_source = info["flow_source"]
        e1s.append(e1)
        e2s.append(e2)
        print(f"{a} -> {b}: E1={e1:.6f} E2={e2:.6f}")
    if e1s:
        print(f"mean E1={np.mean(e1s):.6f} mean E2={np.mean(e2s):.6f} "
              f"[flow={resolved} on {flow_source} renders]")
        _save(args.output, {"E1": float(np.mean(e1s)),
                            "E2": float(np.mean(e2s)),
                            "flow_algo": resolved,
                            "flow_source": flow_source})


def cmd_fid(args):
    from uncltmo_tpu_torch.metrics.fid import calculate_fid_given_paths
    fid = calculate_fid_given_paths([args.real_dir, args.fake_dir],
                                    batch_size=args.batch_size,
                                    small_dset=bool(args.small_dset),
                                    weights_path=args.inception_weights,
                                    max_images=args.max_images or None,
                                    device=args.device)
    print(f"FID: {fid:.4f}")
    _save(args.output, {"fid": fid})


def _demo_adjust(im01: np.ndarray) -> np.ndarray:
    """The reference demo's pre-scoring adjustment `im = (im-37.5)*0.9+45`
    (`metrics/BTMQI_metric/demo_for_videoDataTesting.m:26`), reproduced
    with MATLAB's saturating+rounding uint8 arithmetic."""
    u8 = np.round(np.clip(im01, 0.0, 1.0) * 255.0)
    return np.clip(np.clip(u8 - 37.5, 0.0, 255.0) * 0.9 + 45.0,
                   0.0, 255.0).round() / 255.0


def cmd_btmqi(args):
    from uncltmo_tpu_torch.metrics.btmqi import btmqi, load_svr_model
    # parse model.mat once, not per image
    model_mat = load_svr_model(args.model_mat) if args.model_mat else None
    label = "SVR BTMQI" if model_mat else "surrogate BTMQI"
    # measured caveats: docs/BTMQI_VALIDATION.md (features are a from-paper
    # reconstruction; BTMQI.p is encrypted p-code with no source)
    if model_mat:
        print("NOTE: SVR scores use RECONSTRUCTED features — published "
              "2..8 scale but NOT bit-comparable to the MATLAB tool, and "
              "measured UNRELIABLE for ranking distortion severity "
              "(docs/BTMQI_VALIDATION.md); prefer the surrogate for "
              "relative comparisons")
    else:
        print("NOTE: surrogate BTMQI (reconstructed features, own scale) — "
              "good for relative comparisons, not comparable to published "
              "BTMQI numbers (docs/BTMQI_VALIDATION.md)")
    scores = {}
    for f in sorted(os.listdir(args.ldr_dir)):
        if not f.lower().endswith((".png", ".jpg")):
            continue
        im = read_ldr_image(os.path.join(args.ldr_dir, f))
        if getattr(args, "demo_adjust", 0):
            im = _demo_adjust(im)
        s, _ = btmqi(im, model_mat=model_mat, device=args.device)
        scores[f] = s
        print(f"{f}: {s:.4f}")
    if scores:
        print(f"mean {label}: {np.mean(list(scores.values())):.4f}")
        if args.mos:
            # |Spearman rank correlation| vs a {filename: MOS} JSON — the
            # reference's BTMQI validation protocol
            # (`metrics/BTMQI_metric/result.m:5-7`)
            from scipy.stats import spearmanr
            with open(args.mos) as fh:
                mos = json.load(fh)
            common = sorted(set(scores) & set(mos))
            if len(common) < 2:
                raise SystemExit(
                    f"--mos: only {len(common)} filenames overlap between "
                    "the scored images and the MOS table")
            rho = abs(spearmanr([scores[k] for k in common],
                                [float(mos[k]) for k in common]).statistic)
            print(f"|spearman(BTMQI, MOS)| over {len(common)} images: "
                  f"{rho:.4f}")
            scores = {"scores": scores, "spearman_abs": rho}
        _save(args.output, scores)


def _save(path, obj):
    if path:
        with open(path, "w") as f:
            json.dump(obj, f, indent=2)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    sub = p.add_subparsers(dest="cmd", required=True)
    t = sub.add_parser("tmqi")
    t.add_argument("--hdr_dir", default="")
    t.add_argument("--ldr_dir", default="")
    t.add_argument("--hdr_file", default="",
                   help="single-pair mode (reference TMQI.py CLI): score "
                        "one HDR/LDR pair instead of directories")
    t.add_argument("--ldr_file", default="")
    t.add_argument("--precision", type=int, default=4,
                   help="rounding of printed scores (TMQI.py --precision)")
    t.add_argument("--per_scene", type=int, default=0,
                   help="video layout: scene sub-dirs, first max_frames "
                        "frames each (TMQI_python/demo.py)")
    t.add_argument("--max_frames", type=int, default=0,
                   help="cap frames per dir (demo.py uses 6 per scene)")
    t.add_argument("--revised", type=int, default=0,
                   help="TMQIr revised variant (reference TMQI.py "
                        "--revised: LDR rescaled in S, moving-window "
                        "naturalness std)")
    t.add_argument("--output", default="")
    w = sub.add_parser("warp")
    w.add_argument("--frames_dir", required=True)
    w.add_argument("--algo", default="auto",
                   choices=["auto", "DeepFlow", "DIS", "Farneback",
                            "hs_jax"],
                   help="flow estimator; hs_jax = the pyramidal "
                        "Horn-Schunck in torch (no cv2 dependency; what "
                        "'auto' runs on the card)")
    w.add_argument("--baseline_dir", default="",
                   help="dir of L1L0-baseline renders to estimate flow on "
                        "(the paper protocol, Tester.py:378-385); matched "
                        "by filename or '<stem>_L1L0TM.png'")
    w.add_argument("--protocol", default="loose",
                   choices=["loose", "strict"],
                   help="strict = refuse to run unless the result is "
                        "paper-comparable (DeepFlow + baseline flow); "
                        "loose = run what this machine has and record the "
                        "{flow_algo, flow_source} provenance in the output")
    w.add_argument("--output", default="")
    f = sub.add_parser("fid")
    f.add_argument("--real_dir", required=True)
    f.add_argument("--fake_dir", required=True)
    f.add_argument("--batch_size", type=int, default=20)
    f.add_argument("--small_dset", type=int, default=0,
                   help="use the fid_score_small_dset.py protocol variant")
    f.add_argument("--inception_weights", required=True,
                   help="InceptionV3 state dict (.pth or converted .npz): "
                        "the pytorch-fid pt_inception-2015-12-05 release "
                        "(URL in the reference's fid/inception.py:13) or "
                        "any torchvision inception_v3 weights. Required — "
                        "FID on random weights is garbage.")
    f.add_argument("--max_images", type=int, default=0,
                   help="cap images per side (the reference wrapper's "
                        "--number_of_images intent; 0 = the protocol's "
                        "900 cap). NOTE: the reference's own "
                        "small_dset_run_fid.sh passes --number_of_images "
                        "to a script that doesn't define it (argparse "
                        "would reject) — the flag works here.")
    f.add_argument("--output", default="")
    b = sub.add_parser("btmqi")
    b.add_argument("--ldr_dir", required=True)
    b.add_argument("--model_mat", default="",
                   help="path to the reference's libsvm model.mat "
                        "(metrics/BTMQI_metric/model.mat): runs the "
                        "reference's actual SVR on the reconstructed "
                        "features (published score scale) instead of the "
                        "surrogate combination")
    b.add_argument("--mos", default="",
                   help="{filename: MOS} JSON; prints |Spearman| of BTMQI "
                        "vs MOS (`metrics/BTMQI_metric/result.m`)")
    b.add_argument("--demo_adjust", type=int, default=0,
                   help="apply the reference demo's (im-37.5)*0.9+45 "
                        "pre-adjustment before scoring "
                        "(`demo_for_videoDataTesting.m:26`)")
    b.add_argument("--output", default="")
    for sp in (t, w, f, b):
        sp.add_argument("--device", type=str, default="cuda",
                        help="torch device of the metric (default cuda; "
                             "cpu runs without a card)")
    args = p.parse_args(argv)
    {"tmqi": cmd_tmqi, "warp": cmd_warp, "fid": cmd_fid,
     "btmqi": cmd_btmqi}[args.cmd](args)


if __name__ == "__main__":
    main()
