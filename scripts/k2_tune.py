#!/usr/bin/env python3
"""Time variants of the K2 CUDA source against each other on one card.

    python3 scripts/k2_tune.py [--dtype bfloat16] [--iters 10] \\
        [--batch 60,8] [--frame 1080x1920] [--bits] [--library] \\
        base= 'ch128=@UNCLTMO_K2_CFG256=4,24,2,128,256,4,128,1,3' \\
        'other=path/to/copy.cu::-DSOME_FLAG'

Each argument is `name=[source::]nvcc flags`; the source defaults to the
one of `--dtype` in `uncltmo_tpu_torch/ops/kernels/csrc/`
(`double_conv3x3_bf16.cu` or `double_conv3x3.cu`; a copy elsewhere finds
the headers it includes there too).  A flag written
`@MACRO=a,b,c` becomes a `#define MACRO a, b, c` in a header that is
force-included (nvcc splits `-D` values at commas); a shape is TH, TW,
NWG, CH, C2P, CL, CINC, TG, NST (see the source's `Cfg`), the float32 ones
are the `UNCLTMO_K2F_*` macros.  All variants are built at once (one nvcc
each) into `chiprun_out/k2_tune/`, with ptxas' registers and spills and
the SASS count of `HGMMA` per kernel; then each is run at the four
main-path cells at every batch of `--batch` (60: one 1080p frame; 8 and
16: a rank's training batch and its frames; 120: a video frame step of
two scenes) and, with `--frame 1080x1920`, at the four B = 1 planes of a
whole frame, with the weights packed under the variant's own plan
(`uncltmo_double_conv3x3_plan`), held against the plain version (the error
is reported, not enforced: a variant may be an ablation) and timed with
CUDA events, in the order given and once more in reverse.  `--bits`
holds every variant's output against the first one's bit for bit
(`same_bits`: a second source that must round as the first);
`--library` times cuDNN's two convolutions and relus beside them (TF32
off).  One JSON line per (variant, shape), then one summary line per
variant and batch.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
OUT = os.path.join(ROOT, "chiprun_out", "k2_tune")
CELLS = [("inc", 1, 32, 32, 256), ("down0", 32, 64, 64, 126),
         ("down1", 64, 128, 128, 61), ("down2", 128, 256, 256, 28)]


def frame_planes(h: int, w: int, cells):
    """The B = 1 inputs of the cells when one whole (h, w) frame goes
    through the U-Net in one forward: (cell, 1, Cin, C1, C2, H, W)."""
    from uncltmo_tpu_torch.ops.preprocess import padded_size
    ph, pw = padded_size(h), padded_size(w)
    out = []
    for cell, cin, c1, c2, _ in CELLS:
        if any(c[0] == cell for c in cells):
            out.append((cell, 1, cin, c1, c2, ph, pw))
        ph, pw = (ph - 4) // 2, (pw - 4) // 2
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("variants", nargs="+")
    ap.add_argument("--dtype", default="bfloat16",
                    choices=["bfloat16", "float32"])
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--cells", default="inc,down0,down1,down2")
    ap.add_argument("--batch", default="60",
                    help="comma-separated batches of the four cells")
    ap.add_argument("--frame", default="",
                    help="HxW: also the B = 1 planes of a whole frame")
    ap.add_argument("--bits", action="store_true",
                    help="hold each output to the first variant's, bit for "
                         "bit")
    ap.add_argument("--library", action="store_true",
                    help="time cuDNN's two convolutions beside the variants")
    args = ap.parse_args()
    import torch
    from uncltmo_tpu_torch.ops.kernels import build
    from uncltmo_tpu_torch.ops.kernels.double_conv import (
        Plan, double_conv3x3_plain, pack_double_conv_weights)
    import torch.nn.functional as F
    if not torch.cuda.is_available():
        print("k2_tune: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cudnn.allow_tf32 = False
    os.makedirs(OUT, exist_ok=True)
    default_src = os.path.join(build.CSRC, {
        "bfloat16": "double_conv3x3_bf16.cu",
        "float32": "double_conv3x3.cu"}[args.dtype])
    procs = []
    for spec in args.variants:
        name, _, rest = spec.partition("=")
        src, sep, flags = rest.partition("::")
        if not sep:
            src, flags = default_src, rest
        lib = os.path.join(OUT, name + ".so")
        header = os.path.join(OUT, name + ".h")
        with open(header, "w") as f:
            for flag in flags.split():
                if flag.startswith("@"):
                    macro, _, value = flag[1:].partition("=")
                    f.write(f"#define {macro} {value}\n")
        plain = [flag for flag in flags.split() if not flag.startswith("@")]
        cmd = [build.nvcc_path(), *build.NVCC_FLAGS, *plain, "-I",
               build.CSRC, "-include", header, "-o", lib, src]
        procs.append((name, lib, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    libs = []
    for name, lib, proc in procs:
        log = proc.communicate()[0]
        if proc.returncode != 0:
            print(json.dumps({"variant": name, "build": "failed",
                              "log": log[-3000:]}), flush=True)
            continue
        regs = [ln.split(":")[-1].strip() for ln in log.splitlines()
                if "Used" in ln and "registers" in ln]
        spills = [ln.strip() for ln in log.splitlines()
                  if "spill" in ln and "0 bytes spill stores" not in ln]
        sass = subprocess.run(["cuobjdump", "-sass", lib],
                              capture_output=True, text=True).stdout
        hgmma = [blk.count(" HGMMA.") for blk in sass.split("Function : ")[1:]]
        print(json.dumps({"variant": name, "build": "ok", "registers": regs,
                          "spills": spills, "hgmma": hgmma}), flush=True)
        libs.append((name, ctypes.CDLL(lib)))

    dtype = getattr(torch, args.dtype)
    g = torch.Generator(device="cuda").manual_seed(2)
    cells = [c for c in CELLS if c[0] in args.cells.split(",")]
    shapes = [(cell, int(b), cin, c1, c2, s, s)
              for b in args.batch.split(",")
              for cell, cin, c1, c2, s in cells]
    if args.frame:
        shapes += frame_planes(*map(int, args.frame.split("x")), cells)
    totals = {name: {} for name, _ in libs}
    for cell, batch, cin, c1, c2, h, w in shapes:

        def rnd(*shape, std=1.0):
            return (torch.randn(shape, generator=g, device="cuda")
                    * std).to(dtype)
        x = torch.rand((batch, cin, h, w), generator=g,
                       device="cuda").to(dtype)
        wts = (rnd(c1, cin, 3, 3, std=(2.0 / (9 * cin)) ** 0.5),
               rnd(c1, std=0.1),
               rnd(c2, c1, 3, 3, std=(2.0 / (9 * c1)) ** 0.5),
               rnd(c2, std=0.1))
        ref = double_conv3x3_plain(x, *wts).float()
        scale = ref.abs().max().item()
        y = torch.empty((batch, c2, h - 4, w - 4), dtype=dtype,
                        device="cuda")
        flops = 2 * 9 * batch * (cin * c1 * (h - 2) * (w - 2)
                                 + c1 * c2 * (h - 4) * (w - 4))
        key = f"{cell}/B{batch}" + (f"/{h}x{w}" if h != w else "")
        packs = {}
        for name, handle in libs:
            plan = (ctypes.c_int * len(Plan._fields))()
            build.call(handle, "uncltmo_double_conv3x3_plan", cin, c1, c2,
                       plan)
            plan = Plan(*plan)
            if plan.ch1 == 0:      # a source from before conv1's blocks
                plan = plan._replace(ch1=plan.ch)
            packs[name] = pack_double_conv_weights(*wts, plan=plan)
        first = None
        runs = [(name, handle) for name, handle in libs + libs[::-1]]
        if args.library:
            runs.insert(len(libs), ("cudnn", None))
        for name, handle in runs:
            if handle is None:
                def run():
                    F.relu_(F.conv2d(F.relu_(F.conv2d(x, wts[0], wts[1])),
                                     wts[2], wts[3]))
            else:
                pk = packs[name]

                def run(handle=handle, pk=pk):
                    build.call(handle, "uncltmo_double_conv3x3", x, *pk, y,
                               batch, cin, h, w, c1, c2, on=x)
                y.fill_(float("nan"))
                try:
                    run()
                except RuntimeError as e:    # e.g. too much shared memory
                    print(json.dumps({"variant": name, "shape": key,
                                      "error": str(e)}), flush=True)
                    continue
                torch.cuda.synchronize()
            row = {"variant": name, "shape": key}
            if handle is not None:
                row["rel_err"] = (y.float() - ref).abs().max().item() / scale
                if args.bits:
                    if first is None:
                        first = y.clone()
                    row["same_bits"] = bool(torch.equal(y, first))
            for _ in range(2):
                run()
            t0 = torch.cuda.Event(enable_timing=True)
            t1 = torch.cuda.Event(enable_timing=True)
            t0.record()
            for _ in range(args.iters):
                run()
            t1.record()
            torch.cuda.synchronize()
            ms = t0.elapsed_time(t1) / args.iters
            totals.setdefault(name, {}).setdefault(key, []).append(ms)
            row.update(ms=ms, tflops=flops / ms / 1e9)
            print(json.dumps(row), flush=True)
        del x, y, ref, packs
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    for name, by_shape in totals.items():
        best = {k: min(v) for k, v in by_shape.items()}
        for batch in sorted({k.split("/")[1] for k in best}):
            part = {k: v for k, v in best.items() if k.split("/")[1] == batch}
            print(json.dumps({"variant": name, "batch": batch, "ms": part,
                              "sum_ms": sum(part.values()), "card": smi}),
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
