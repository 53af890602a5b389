#!/usr/bin/env python3
"""Time variants of the K2 CUDA source against each other on one card.

    python3 scripts/k2_tune.py [--dtype bfloat16] [--iters 10] [--batch 60] \\
        base= 'ch128=@UNCLTMO_K2_CFG256=4,24,2,128,256,4,128,1,3' \\
        'other=path/to/copy.cu::-DSOME_FLAG'

Each argument is `name=[source::]nvcc flags`; the source defaults to
`uncltmo_tpu_torch/ops/kernels/csrc/double_conv3x3.cu`.  A flag written
`@MACRO=a,b,c` becomes a `#define MACRO a, b, c` in a header that is
force-included (nvcc splits `-D` values at commas); a shape is TH, TW,
NWG, CH, C2P, CL, CINC, TG, NST (see the source's `Cfg`), the float32 ones
are the `UNCLTMO_K2F_*` macros.  All variants are built at once (one nvcc
each) into `chiprun_out/k2_tune/`, with ptxas' registers and spills and
the SASS count of `HGMMA` per kernel; then each is run at the four
main-path cells (B = 60: one 1080p frame; `--batch 8`: a rank's training
batch), with the weights packed under the variant's own plan
(`uncltmo_double_conv3x3_plan`), held against the plain version (the error
is reported, not enforced: a variant may be an ablation) and timed with
CUDA events, in the order given and once more in reverse.  One JSON line
per (variant, cell), then one summary line per variant.
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


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("variants", nargs="+")
    ap.add_argument("--dtype", default="bfloat16",
                    choices=["bfloat16", "float32"])
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--cells", default="inc,down0,down1,down2")
    ap.add_argument("--batch", type=int, default=60)
    args = ap.parse_args()
    import torch
    from uncltmo_tpu_torch.ops.kernels import build
    from uncltmo_tpu_torch.ops.kernels.double_conv import (
        Plan, double_conv3x3_plain, pack_double_conv_weights)
    if not torch.cuda.is_available():
        print("k2_tune: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cudnn.allow_tf32 = False
    os.makedirs(OUT, exist_ok=True)
    default_src = os.path.join(build.CSRC, "double_conv3x3.cu")
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
        # the selected element type only (`UNCLTMO_K2_ELEM`)
        cmd = [build.nvcc_path(), *build.NVCC_FLAGS, *plain,
               f"-DUNCLTMO_K2_ELEM={int(args.dtype == 'bfloat16')}",
               "-include", header, "-o", lib, src]
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
        handle = ctypes.CDLL(lib)
        handle.uncltmo_double_conv3x3.argtypes = (
            [ctypes.c_void_p] * 6 + [ctypes.c_int] * 7 + [ctypes.c_void_p])
        handle.uncltmo_double_conv3x3.restype = ctypes.c_int
        handle.uncltmo_double_conv3x3_plan.argtypes = (
            [ctypes.c_int] * 4 + [ctypes.POINTER(ctypes.c_int)])
        libs.append((name, handle))

    dtype = getattr(torch, args.dtype)
    g = torch.Generator(device="cuda").manual_seed(2)
    totals = {name: {} for name, _ in libs}
    for cell, cin, c1, c2, s in CELLS:
        if cell not in args.cells.split(","):
            continue

        def rnd(*shape, std=1.0):
            return (torch.randn(shape, generator=g, device="cuda")
                    * std).to(dtype)
        batch = args.batch
        x = torch.rand((batch, cin, s, s), generator=g,
                       device="cuda").to(dtype)
        w = (rnd(c1, cin, 3, 3, std=(2.0 / (9 * cin)) ** 0.5),
             rnd(c1, std=0.1),
             rnd(c2, c1, 3, 3, std=(2.0 / (9 * c1)) ** 0.5),
             rnd(c2, std=0.1))
        ref = double_conv3x3_plain(x, *w).float()
        scale = ref.abs().max().item()
        y = torch.empty((batch, c2, s - 4, s - 4), dtype=dtype, device="cuda")
        stream = torch.cuda.current_stream().cuda_stream
        flops = 2 * 9 * batch * (cin * c1 * (s - 2) ** 2
                                 + c1 * c2 * (s - 4) ** 2)
        code = 0 if dtype == torch.float32 else 1
        packs = {}
        for name, handle in libs:
            plan = (ctypes.c_int * 12)()
            handle.uncltmo_double_conv3x3_plan(cin, c1, c2, code, plan)
            packs[name] = pack_double_conv_weights(*w, plan=Plan(*plan))
        for name, handle in libs + libs[::-1]:
            pk = packs[name]

            def run():
                err = handle.uncltmo_double_conv3x3(
                    x.data_ptr(), pk.w1.data_ptr(), pk.b1.data_ptr(),
                    pk.w2.data_ptr(), pk.b2.data_ptr(), y.data_ptr(), batch,
                    cin, s, s, c1, c2, code, stream)
                if err:
                    raise RuntimeError(f"{name} {cell}: launch error {err}")
            y.fill_(float("nan"))
            try:
                run()
            except RuntimeError as e:      # e.g. too much shared memory
                print(json.dumps({"variant": name, "cell": cell,
                                  "error": str(e)}), flush=True)
                continue
            torch.cuda.synchronize()
            err = (y.float() - ref).abs().max().item()
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
            totals[name].setdefault(cell, []).append(ms)
            print(json.dumps({"variant": name, "cell": cell, "ms": ms,
                              "tflops": flops / ms / 1e9,
                              "rel_err": err / scale}), flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    for name, cells in totals.items():
        best = {c: min(v) for c, v in cells.items()}
        print(json.dumps({"variant": name, "ms": best,
                          "sum_ms": sum(best.values()), "card": smi}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
