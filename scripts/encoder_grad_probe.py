#!/usr/bin/env python3
"""Where the encoder's gradient differs between the card and the CPU.

    python3 scripts/encoder_grad_probe.py [--seeds 0 1 2 3] [--size 112]

Runs one stage-0 training step of the port at `--size` (GCN grid
`bottleneck_grid(size)`, B = 2, float32, TF32 off) on the card and on the
CPU from one seed and with the same drop path masks -- the comparison of
`chip_smoke.py`'s `train_reference` phase -- and records, at every skip
concat of the generator's training forward, the skip `x2` and the gradient
`g` that reaches the concat.  From those it rebuilds the concat's gradient
`dx2 = g0 + 2 x2 g2 + g3 * 0.5 / sqrt(x2 + eps)` on both sides in float64
and reports, per seed and generator:

* the Adam first moments of the encoder cells behind a skip (`inc`,
  `down0..2`), card against CPU: the worst entry (name, index, both values)
  and the worst relative L2 error;
* for the bias of the cell whose skip differs most, channel by channel, how
  much of the card-minus-CPU difference of its gradient is the sum of the
  `dx2` differences over that channel (the bias gradient is the sum of the
  gradient at the cell's output over its positive entries, and the skip's
  share of it is `dx2`);
* the entries of `x2` that carry most of that difference: their values on
  both sides, `0.5 / sqrt(x2 + eps)` on both sides, `g3`, and each entry's
  share of the channel's difference.

One JSON line per (seed, generator); the whole also goes to
`encoder_grad_probe.json` in `chip_smoke.py`'s output directory.  Needs a
CUDA card.
"""
from __future__ import annotations

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

CELL_OF_CHANNELS = {32: "inc.conv", 64: "down_path.0.mpconv.1",
                    128: "down_path.1.mpconv.1", 256: "down_path.2.mpconv.1"}
ENCODER = ("inc.", "down_path.0.", "down_path.1.", "down_path.2.")


def run_side(torch, smoke, seed, video, dev, size, grid):
    """One stage-0 step on `dev`; (state, [(x2, g) per skip concat of the
    G-phase forward, float64 on the CPU])."""
    import numpy as np
    from uncltmo_tpu_torch.models import blocks
    records = []
    real = blocks.fused_concat_skip

    def recording(x2, x1):
        out = real(x2, x1)
        if torch.is_grad_enabled() and out.requires_grad:
            rec = {"x2": x2.detach().double().cpu()}
            out.register_hook(
                lambda g: rec.__setitem__("g", g.detach().double().cpu()))
            records.append(rec)
        return out

    blocks.fused_concat_skip = recording
    try:
        step, state = smoke.build_trainer(torch, seed, video, dev, size=size,
                                          grid=grid)
        b = 2
        n = b if video else 2 * b
        masks = [torch.ones(n) for _ in range(8)]
        masks[1][0] = 0.0
        rng = np.random.default_rng(seed + 20)
        state, _ = step(state, smoke.synthetic_batch(rng, b, size),
                        torch.Generator(), 1e-5, 1.5e-5, stage=0,
                        drop_masks=iter(masks))
    finally:
        blocks.fused_concat_skip = real
    return state, records


def dx2_of(torch, rec, eps):
    c = rec["x2"].shape[1]
    x2, g = rec["x2"], rec["g"]
    factor = 0.5 / torch.sqrt(x2 + eps)
    return (g[:, :c] + 2.0 * x2 * g[:, 2 * c:3 * c]
            + g[:, 3 * c:] * factor) * (x2 > 0), factor


def probe(torch, smoke, seed, video, size, grid):
    from uncltmo_tpu_torch import params
    eps = params.EPSILON
    (card, rec_card) = run_side(torch, smoke, seed, video, "cuda", size, grid)
    (cpu, rec_cpu) = run_side(torch, smoke, seed, video, "cpu", size, grid)
    out = {"seed": seed, "generator": "video" if video else "image",
           "size": size, "epsilon": eps, "skip_concats": len(rec_card)}
    # the encoder's first moments, card against CPU
    worst_max, worst_l2, outside = (0.0, None), (0.0, None), 0.0
    moments = {}
    for (name, pa), pc in zip(card.gen.named_parameters(),
                              cpu.gen.parameters()):
        ma = card.opt_G.state[pa]["exp_avg"].double().cpu()
        mc = cpu.opt_G.state[pc]["exp_avg"].double()
        moments[name] = (ma, mc)
        rel = ((ma - mc).abs().max() / mc.abs().max()).item()
        l2 = ((ma - mc).norm() / mc.norm()).item()
        if not name.startswith(ENCODER):
            outside = max(outside, rel)
            continue
        if rel > worst_max[0]:
            idx = int((ma - mc).abs().argmax())
            worst_max = (rel, {"name": name, "flat_index": idx,
                               "card": ma.flatten()[idx].item(),
                               "cpu": mc.flatten()[idx].item(),
                               "max_abs_cpu": mc.abs().max().item()})
        if l2 > worst_l2[0]:
            worst_l2 = (l2, name)
    out["encoder_exp_avg_worst_of_max_abs"] = worst_max[0]
    out["encoder_exp_avg_worst_entry"] = worst_max[1]
    out["encoder_exp_avg_worst_rel_l2"] = {"value": worst_l2[0],
                                           "name": worst_l2[1]}
    out["other_exp_avg_worst_of_max_abs"] = outside
    # the skip concats: sum dx2 per cell over the frames of a video step
    cells = {}
    for ra, rc in zip(rec_card, rec_cpu):
        c = ra["x2"].shape[1]
        da, fa = dx2_of(torch, ra, eps)
        dc, fc = dx2_of(torch, rc, eps)
        cells.setdefault(c, []).append((ra, rc, da - dc, fa, fc))
    rows = []
    for c, frames in sorted(cells.items()):
        cell = CELL_OF_CHANNELS[c]
        ma, mc = moments[cell + ".conv1.bias"]
        bias_diff = (ma - mc) * 2.0           # exp_avg = 0.5 g after one step
        from_skip = sum(f[2].sum((0, 2, 3)) for f in frames)
        ch = int(bias_diff.abs().argmax())
        tiny = sum(int(((f[0]["x2"] > 0) & (f[0]["x2"] < 1e-5)).sum())
                   for f in frames)
        flips = sum(int(((f[0]["x2"] > 0) != (f[1]["x2"] > 0)).sum())
                    for f in frames)
        # the entries of that channel that differ most
        top = []
        for t, (ra, rc, diff, fa, fc) in enumerate(frames):
            d = diff[:, ch]
            for flat in d.abs().flatten().topk(3).indices.tolist():
                n, rem = divmod(flat, d.shape[1] * d.shape[2])
                h, w = divmod(rem, d.shape[2])
                top.append({
                    "frame_step": t, "sample": n, "h": h, "w": w,
                    "x2_card": ra["x2"][n, ch, h, w].item(),
                    "x2_cpu": rc["x2"][n, ch, h, w].item(),
                    "factor_card": fa[n, ch, h, w].item(),
                    "factor_cpu": fc[n, ch, h, w].item(),
                    "g3_card": ra["g"][n, 3 * c + ch, h, w].item(),
                    "g3_cpu": rc["g"][n, 3 * c + ch, h, w].item(),
                    "dx2_card_minus_cpu": d[n, h, w].item()})
        top.sort(key=lambda e: -abs(e["dx2_card_minus_cpu"]))
        top = top[:3]
        rows.append({
            "cell": cell, "channels": c,
            "entries": sum(f[0]["x2"].numel() for f in frames),
            "entries_in_0_1e-5": tiny, "relu_flips_card_vs_cpu": flips,
            "bias": cell + ".conv1.bias", "channel": ch,
            "bias_grad_card_minus_cpu": bias_diff[ch].item(),
            "bias_grad_max_abs_cpu": (2.0 * mc).abs().max().item(),
            "sum_of_dx2_differences_in_channel": from_skip[ch].item(),
            "top_entries": top,
            "top_entries_share_of_bias_difference": (
                sum(e["dx2_card_minus_cpu"] for e in top)
                / bias_diff[ch].item() if bias_diff[ch] != 0 else None)})
    out["cells"] = rows
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seeds", type=int, nargs="+", default=[0])
    ap.add_argument("--size", type=int, default=112)
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("encoder_grad_probe: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as smoke
    from uncltmo_tpu_torch.models.unet import bottleneck_grid
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    print(smoke.nvidia_smi_line(), flush=True)
    grid = bottleneck_grid(args.size)
    results = []
    for seed in args.seeds:
        for video in (False, True):
            res = probe(torch, smoke, seed, video, args.size, grid)
            results.append(res)
            print(json.dumps(res), flush=True)
    os.makedirs(smoke.OUT_DIR, exist_ok=True)
    with open(os.path.join(smoke.OUT_DIR, "encoder_grad_probe.json"),
              "w") as f:
        json.dump({"nvidia_smi": smoke.nvidia_smi_line(),
                   "results": results}, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
