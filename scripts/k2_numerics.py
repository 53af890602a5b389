#!/usr/bin/env python3
"""K2's float32 numerics on one card, and how they meet the training
step's card-vs-CPU check.

    python3 scripts/k2_numerics.py [--repeats 6] [--batch 4]

1. At the four cells, at the sizes a 112 x 112 training step gives them
   (the `train_reference` phase of `chip_smoke.py`), K2's output, cuDNN's
   (TF32 off) and the CPU's are held against a float64 reference computed
   on the card: max and mean error and the mean signed error (bias) over
   the positive outputs, each of the reference's max-abs, and each
   version's relative L2 distance to the CPU's.  A bias moves every
   activation near zero the same way, which the encoder's gradient through
   0.5 / sqrt(x2 + 1e-8) amplifies.
2. `chip_smoke.phase_train_reference` `--repeats` times in this process
   (the step on the card against the CPU at seed 3, published epsilon and
   1e-2): one JSON line per generator and epsilon per repeat, and the
   count of repeats that failed.  cuDNN's default float32 algorithms vary
   from run to run, so one run can pass where another fails.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
# (cell, Cin, C1, C2, input side at 112 x 112)
CELLS = [("inc", 1, 32, 32, 112), ("down0", 32, 64, 64, 52),
         ("down1", 64, 128, 128, 24), ("down2", 128, 256, 256, 10)]


def errors(torch, batch: int) -> None:
    import torch.nn.functional as F
    from uncltmo_tpu_torch.ops.kernels.double_conv import (
        double_conv3x3_plain, fused_double_conv3x3)
    g = torch.Generator(device="cuda").manual_seed(0)
    for name, cin, c1, c2, s in CELLS:
        def rnd(*shape, std=1.0):
            return torch.randn(shape, generator=g, device="cuda") * std
        x = torch.rand((batch, cin, s, s), generator=g, device="cuda")
        w = (rnd(c1, cin, 3, 3, std=(2 / (9 * cin)) ** 0.5), rnd(c1, std=0.1),
             rnd(c2, c1, 3, 3, std=(2 / (9 * c1)) ** 0.5), rnd(c2, std=0.1))
        mid = F.relu(F.conv2d(x.double(), w[0].double(), w[1].double()))
        ref = F.relu(F.conv2d(mid, w[2].double(), w[3].double()))
        outs = {"kernel": fused_double_conv3x3(x, *w).double(),
                "cudnn": double_conv3x3_plain(x, *w).double(),
                "cpu": double_conv3x3_plain(
                    *(t.cpu() for t in (x, *w))).double().cuda()}
        scale = ref.abs().max().item()
        row = {"cell": name, "shape": [batch, cin, s, s]}
        for tag, v in outs.items():
            e = v - ref
            row[tag] = {
                "max": e.abs().max().item() / scale,
                "mean_abs": e.abs().mean().item() / scale,
                "bias": e[ref > 0].mean().item() / scale,
                "l2_to_cpu": ((v - outs["cpu"]).norm()
                              / outs["cpu"].norm()).item()}
        print(json.dumps(row), flush=True)


def train_reference(torch, repeats: int) -> None:
    import chip_smoke
    keep = ("generator", "epsilon", "exp_avg_max_rel_err",
            "encoder_exp_avg_rel_l2_err", "encoder_worst_parameter",
            "g_worst_parameter")
    chip_smoke.emit = lambda phase, **kw: print(json.dumps(
        {"phase": phase, **{k: v for k, v in kw.items() if k in keep}}),
        flush=True)
    failed = 0
    for r in range(repeats):
        try:
            chip_smoke.phase_train_reference(torch)
        except AssertionError as exc:
            failed += 1
            print(json.dumps({"repeat": r, "failed": str(exc)}), flush=True)
    print(json.dumps({"repeats": repeats, "failed": failed}), flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--repeats", type=int, default=6)
    ap.add_argument("--batch", type=int, default=4)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("k2_numerics: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    errors(torch, args.batch)
    train_reference(torch, args.repeats)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(json.dumps({"card": smi}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
