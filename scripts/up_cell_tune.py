#!/usr/bin/env python3
"""Time the decoder's up cell on one card: the fused kernel's variants
against each other and against the library path it replaces.

    python3 scripts/up_cell_tune.py [--iters 10] [--batch 60,8] \\
        [--frame 1080x1920] [--library] [--cells up0,up1,up2,up3] \\
        base= 'v=@UNCLTMO_UP_CFG32B=4,4,85,2,32,2,4,86,2,32,2,0'

A cell is what `models/blocks.py:Up` runs after its 2x2 upsample:
`[x2, x1, x2^2, sqrt(x2 + eps)]` -> ConvTranspose2d(k=3) -> relu ->
ConvTranspose2d(k=3) -> relu, at the U-Net's four decoder shapes (a 256^2
tile: skips of 24, 57, 122 and 252 pixels) and, with `--frame`, at the four
B = 1 planes of a whole frame.  `--library` times today's path twice: K1's
Triton kernel plus torch's ConvTs and relus with cuDNN's default
algorithms, then with `torch.backends.cudnn.benchmark` on (TF32 off in
both).

Each variant argument is `name=[source::]nvcc flags`; the source defaults
to `uncltmo_tpu_torch/ops/kernels/csrc/up_cell.cu` (a copy elsewhere finds
the headers it includes there too).  A flag written `@MACRO=a,b,c` becomes a `#define MACRO a,
b, c` in a force-included header (nvcc splits `-D` values at commas); the
cells' shapes are the `UNCLTMO_UP_CFG*` macros of the source (NST, then
per phase TH, TW, MW, N, J, then SQ).  Every
variant is built at once into `up_cell_tune/` under `chip_smoke.py`'s
output directory (ptxas' registers and spills, the SASS count of `HGMMA` per kernel), then run at
every shape with the weights packed under its own plan
(`uncltmo_up_cell_plan`), held against the plain version (the error is
reported, not enforced) and timed with CUDA events, in the order given and
once more in reverse.  One JSON line per (variant, shape), then one
summary line per variant and batch with the card's name and power limit.
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
from chip_smoke import OUT_DIR  # noqa: E402  (the repo's output directory)

OUT = os.path.join(OUT_DIR, "up_cell_tune")
# (cell, skip channels C, C1 = C2, skip side at a 256^2 tile)
CELLS = [("up0", 256, 128, 24), ("up1", 128, 64, 57), ("up2", 64, 32, 122),
         ("up3", 32, 32, 252)]


def cell_flops(b: int, c: int, c1: int, h: int, w: int) -> int:
    """Output-size flops of the two 3x3 ConvTs: (H+2)(W+2) outputs of
    9 * 4C * C1 products, then (H+4)(W+4) of 9 * C1 * C1."""
    return 2 * 9 * b * (4 * c * c1 * (h + 2) * (w + 2)
                        + c1 * c1 * (h + 4) * (w + 4))


def frame_planes(h: int, w: int):
    """The B = 1 inputs of the up cells when a whole (h, w) frame goes
    through the U-Net in one forward: (cell, C, C1, H, W) of the skip."""
    from uncltmo_tpu_torch.ops.preprocess import padded_size
    ph, pw = padded_size(h), padded_size(w)
    skips = []
    for cout in (32, 64, 128, 256):
        ph, pw = ph - 4, pw - 4
        skips.append((cout, ph, pw))
        ph, pw = ph // 2, pw // 2
    out = []
    for (cell, c, c1, _), (cs, sh, sw) in zip(CELLS, skips[::-1]):
        assert cs == c
        out.append((cell, c, c1, sh, sw))
    return out


def cell_inputs(torch, g, b, c, c1, h, w):
    """A skip as the encoder makes it (post-relu, many exact zeros), the
    upsampled branch, and ConvTranspose2d weights (Cin, Cout, 3, 3)."""
    x2 = torch.relu(torch.randn((b, c, h, w), generator=g, device="cuda"))
    x1 = torch.randn((b, c, h, w), generator=g, device="cuda")
    cin = 4 * c

    def rnd(*shape, std):
        return torch.randn(shape, generator=g, device="cuda") * std
    return (x2, x1, rnd(cin, c1, 3, 3, std=(2.0 / (9 * cin)) ** 0.5),
            rnd(c1, std=0.1), rnd(c1, c1, 3, 3, std=(2.0 / (9 * c1)) ** 0.5),
            rnd(c1, std=0.1))


def build_variants(variants):
    from uncltmo_tpu_torch.ops.kernels import build
    os.makedirs(OUT, exist_ok=True)
    default_src = os.path.join(build.CSRC, "up_cell.cu")
    procs = []
    for spec in variants:
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
        # per kernel: ptxas' registers and spills, under a short name
        regs, fn = {}, ""
        for ln in log.splitlines():
            if "Compiling entry function" in ln:
                fn = "up_cell@" + str(len(regs))
            elif fn and ("spill" in ln or ("Used" in ln and "registers"
                                           in ln)):
                regs.setdefault(fn, []).append(ln.split(":")[-1].strip())
        spills = {k: v for k, v in regs.items()
                  if any("spill" in x and "0 bytes spill stores" not in x
                         for x in v)}
        sass = subprocess.run(["cuobjdump", "-sass", lib],
                              capture_output=True, text=True).stdout
        hgmma = [blk.count(" HGMMA.") for blk in sass.split("Function : ")[1:]]
        warnings = [ln.strip()[:300] for ln in log.splitlines()
                    if "wgmma" in ln.lower() or "Performance" in ln]
        print(json.dumps({"variant": name, "build": "ok", "registers": regs,
                          "spills": spills, "hgmma": hgmma,
                          "warnings": warnings}), flush=True)
        libs.append((name, ctypes.CDLL(lib)))
    return libs


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("variants", nargs="*")
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--cells", default="up0,up1,up2,up3")
    ap.add_argument("--batch", default="60")
    ap.add_argument("--frame", default="",
                    help="HxW: also the B = 1 planes of a whole frame")
    ap.add_argument("--library", action="store_true",
                    help="time K1 + cuDNN's ConvTs and relus, default "
                         "algorithms and benchmarked")
    args = ap.parse_args()
    import torch
    import torch.nn.functional as F
    from uncltmo_tpu_torch.ops.kernels import up_cell
    from uncltmo_tpu_torch.ops.kernels.concat_skip import fused_concat_skip
    if not torch.cuda.is_available():
        print("up_cell_tune: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    libs = build_variants(args.variants)
    g = torch.Generator(device="cuda").manual_seed(2)
    cells = [c for c in CELLS if c[0] in args.cells.split(",")]
    shapes = [(cell, int(b), c, c1, s, s)
              for b in args.batch.split(",") for cell, c, c1, s in cells]
    if args.frame:
        shapes += [(cell, 1, c, c1, h, w) for cell, c, c1, h, w in
                   frame_planes(*map(int, args.frame.split("x")))
                   if cell in args.cells.split(",")]
    totals = {}
    for cell, batch, c, c1, h, w in shapes:
        x2, x1, w1, b1, w2, b2 = cell_inputs(torch, g, batch, c, c1, h, w)
        ref = up_cell.up_cell_plain(x2, x1, w1, b1, w2, b2)
        scale = ref.abs().max().item()
        flops = cell_flops(batch, c, c1, h, w)
        key = f"{cell}/B{batch}" + (f"/{h}x{w}" if batch == 1 else "")
        runs = []
        for name, handle in libs:
            plans = up_cell.library_plans(handle, 4 * c, c1, c1)
            if cell == shapes[0][0] and batch == shapes[0][1]:
                print(json.dumps({"variant": name, "plan": plans}),
                      flush=True)
            packed = up_cell.pack_up_cell_weights(w1, b1, w2, b2, plans)
            y = torch.empty((batch, c1, h + 4, w + 4), device="cuda")

            def run(handle=handle, packed=packed, y=y):
                up_cell.launch_with(handle, x2, x1, packed, y, None, c1, c1)
            runs.append((name, run, y))
        if args.library:
            def library():
                cat = fused_concat_skip(x2, x1)
                mid = F.relu_(F.conv_transpose2d(cat, w1, b1))
                F.relu_(F.conv_transpose2d(mid, w2, b2))
            runs.append(("cudnn_default", library, None))
            runs.append(("cudnn_benchmark", library, None))
        for name, run, y in runs + runs[::-1]:
            torch.backends.cudnn.benchmark = name == "cudnn_benchmark"
            row = {"variant": name, "shape": key}
            try:
                run()
                torch.cuda.synchronize()
            except RuntimeError as e:
                print(json.dumps({**row, "error": str(e)}), flush=True)
                continue
            if y is not None:
                row["rel_err"] = (y - ref).abs().max().item() / scale
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
        torch.backends.cudnn.benchmark = False
        del x2, x1, ref, runs
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
