"""Offline data preparation of the PyTorch port (port of
`cli/prepare_lambdas.py`; reference `data/lum_est_test_cor.py:344-451`,
`data/run_hist_fit.sh`): brightness-factor (lambda) dicts and the mean LDR
histogram they are fitted against.

    python -m uncltmo_tpu_torch.cli.prepare_lambdas --mode MODE ... \\
        [--device cpu]

Modes:
  lambdas        one lambda per HDR file (.hdr / .npy) of --input_dir, into
                 a {name: lambda} dict .npy at --output (resumable)
  scene_lambdas  one lambda per scene directory of --input_dir, fitted on
                 its first HDR frame and keyed by the directory's name
  mean_hist      the mean of the [0, 1] 20-bin histograms of the LDR images
                 of --input_dir ({'mean_vals', 'all_bins'}, the format of
                 `ldr_avg_hist_900_images_20_bins.npy`)
  show           print a saved .npy (a lambda dict or a histogram)

`--optimizer grid` fits on --device (the card by default), `de` is the
reference's scipy differential evolution.  PNGs are read by the port's own
reader; other LDR formats need imageio or cv2.
"""
from __future__ import annotations

import argparse
import os

import numpy as np

from uncltmo_tpu_torch import params as P
from uncltmo_tpu_torch.ops.lambda_est import fit_lambda, fit_lambda_de
from uncltmo_tpu_torch.utils.io import (list_hdr_names, read_hdr_image,
                                        read_ldr_image)


def _gray_of(path: str) -> np.ndarray:
    rgb = read_hdr_image(path)
    gray = rgb[..., :3] @ np.asarray(P.REC601, np.float32)
    if gray.min() < 0:
        gray = gray - gray.min()
    return gray / max(gray.max(), 1e-12)


def mode_lambdas(args, scene_mode: bool = False) -> None:
    mean = np.load(args.mean_hist_path, allow_pickle=True)[()]
    targets = np.asarray(mean["mean_vals"], np.float32)
    res = {}
    if os.path.isfile(args.output):
        res = np.load(args.output, allow_pickle=True)[()]
    if scene_mode:
        # the first HDR frame of each scene; empty directories and stray
        # entries are skipped, not fitted or fatal
        paths = []
        for d in sorted(os.listdir(args.input_dir)):
            scene_dir = os.path.join(args.input_dir, d)
            if not os.path.isdir(scene_dir):
                continue
            frames = list_hdr_names(scene_dir)
            if not frames:
                print(f"[{d}] skipped: no HDR frames")
                continue
            paths.append((d, os.path.join(scene_dir, frames[0])))
    else:
        paths = [(os.path.splitext(f)[0], os.path.join(args.input_dir, f))
                 for f in list_hdr_names(args.input_dir)]
    for key, path in paths:
        if key in res:
            continue
        if args.optimizer == "de":
            lam = fit_lambda_de(_gray_of(path), targets, bins=args.bins)
        else:
            lam = fit_lambda(_gray_of(path), targets, bins=args.bins,
                             device=args.device)
        res[key] = lam
        print(f"[{key}] [{lam:.4f}]")
        np.save(args.output, res)
    print(f"saved {len(res)} lambdas to {args.output}")


def mode_mean_hist(args) -> None:
    hists = []
    edges = None
    for f in sorted(os.listdir(args.input_dir)):
        if not f.lower().endswith((".png", ".jpg", ".jpeg")):
            continue
        im = read_ldr_image(os.path.join(args.input_dir, f))
        gray = (im[..., :3] @ np.asarray(P.REC601, np.float32)
                if im.ndim == 3 else im)
        h, edges = np.histogram(gray.reshape(-1), bins=args.bins,
                                density=True, range=(0, 1))
        hists.append(h)
        if len(hists) >= args.max_images:
            break
    if not hists:
        raise SystemExit(
            f"no png/jpg/jpeg images in {args.input_dir!r}: refusing to "
            "save a NaN mean histogram (every later lambda fit would "
            "optimise a meaningless objective)")
    np.save(args.output, {"mean_vals": np.mean(hists, axis=0),
                          "all_bins": edges})
    print(f"saved mean histogram of {len(hists)} images to {args.output}")


def mode_show(args) -> None:
    """Print a saved .npy: a lambda dict or a mean histogram (reference
    `activate_trained_model/lambda_data/read_npy.py:1-6`)."""
    data = np.load(args.npy, allow_pickle=True)
    if data.dtype == object and data.shape == ():
        data = data[()]
    if isinstance(data, dict):
        for k in sorted(data, key=str):
            print(f"{k}: {data[k]}")
        print(f"({len(data)} entries)")
    else:
        print(data)


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--mode", choices=["lambdas", "scene_lambdas",
                                      "mean_hist", "show"], required=True)
    p.add_argument("--input_dir", default="")
    p.add_argument("--npy", default="",
                   help="mode=show: the .npy to print")
    p.add_argument("--output", default="")
    p.add_argument("--mean_hist_path", default="")
    p.add_argument("--bins", type=int, default=20)
    p.add_argument("--max_images", type=int, default=900)
    p.add_argument("--optimizer", choices=["grid", "de"], default="grid",
                   help="'grid': the log-grid sweep on --device (default); "
                        "'de': the reference's scipy differential "
                        "evolution (`adaptive_lambda.py:59-60`), ~100x "
                        "slower")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device of the grid fit (default cuda)")
    args = p.parse_args(argv)
    if args.mode == "show":
        if not args.npy:
            p.error("--mode show requires --npy")
        mode_show(args)
        return
    if not args.input_dir or not args.output:
        p.error(f"--mode {args.mode} requires --input_dir and --output")
    if args.mode == "mean_hist":
        mode_mean_hist(args)
    else:
        mode_lambdas(args, scene_mode=(args.mode == "scene_lambdas"))


if __name__ == "__main__":
    main()
