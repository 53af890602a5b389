#!/usr/bin/env python3
"""Smoke run of the PyTorch port (`uncltmo_tpu_torch`) on one CUDA card.

    python3 chip_smoke.py [--seed 0] [--frames 4]

Drives the port's main path -- tiled 1080p image tone mapping with the
published generator (depth 4, 32 filters, weights drawn from a seed) --
through `InferenceRunner.run_on_path`, and holds each hand-written kernel
against its plain PyTorch version on the card.  One JSON line per phase:

 1. device: the card's name and power limit (nvidia-smi);
 2. build: nvcc of the CUDA kernels for sm_90a, Triton's first compile;
 3. K1 (Triton skip concat) vs plain at the four Up shapes, B=60, f32/bf16;
 4. K2 (CUDA double conv) vs plain (cuDNN) at the inc/down0..2 shapes,
    B=60, f32/bf16;
 5. the generator forward (8x1x256x256) with the kernels vs all-plain;
 6. end to end: synthetic 1080x1920 .hdr files -> PNGs in f32 and bf16,
    kernel launch counts of that run, warm frames/s, and a small image
    checked against the same runner on the CPU (plain versions);
 7. the kernels line, the nvidia-smi line, and `{"ok": true, ...}` last.

Any mismatch beyond the stated tolerance raises and the script exits
non-zero.  Without a CUDA card, or without the package beside it, it exits
non-zero and prints no result.  Times come from CUDA events after warm-up.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
OUT_DIR = os.path.join(ROOT, "chiprun_out")

# NVIDIA H100 SXM data sheet (dense): HBM bytes/s and peak flop/s by type.
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12}

K1_SHAPES = [(256, 24), (128, 57), (64, 122), (32, 252)]      # (C, H=W)
K2_SHAPES = [("inc", 1, 32, 32, 256), ("down0", 32, 64, 64, 126),
             ("down1", 64, 128, 128, 61), ("down2", 128, 256, 256, 28)]
BATCH = 60                    # tiles of one 1080p frame at 256/64
K1_TOL = {"float32": (1e-6, 1e-6), "bfloat16": (8e-3, 1e-6)}  # (rtol, atol)
K2_TOL = {"float32": 1e-4, "bfloat16": 2e-2}  # max err / max |plain|
GEN_TOL = {"float32": 1e-3, "bfloat16": 0.1}  # sigmoid output, abs
LOG: list = []


def emit(phase: str, **kw) -> None:
    rec = {"phase": phase, **kw}
    LOG.append(rec)
    print(json.dumps(rec), flush=True)


def time_ms(fn, iters: int = 10, warmup: int = 3) -> float:
    import torch
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound_ms(nbytes: float, flops: float, dtype: str):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def nvidia_smi_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() else ""


def phase_build():
    from uncltmo_tpu_torch.ops.kernels import build
    t0 = time.perf_counter()
    build.load_library("double_conv3x3.cu")
    info = build.build_info["double_conv3x3.cu"]
    ptxas = [ln.strip() for ln in info["log"].splitlines()
             if "registers" in ln or "spill" in ln]
    emit("build", kernel="fused_double_conv3x3", route="cuda",
         nvcc_seconds=info["seconds"],
         load_seconds=time.perf_counter() - t0, ptxas=ptxas)


def phase_k1(torch, dtypes):
    from uncltmo_tpu_torch.ops.kernels.concat_skip import (
        concat_skip_plain, fused_concat_skip)
    t0 = time.perf_counter()
    x = torch.rand(1, 4, 8, 8, device="cuda")
    fused_concat_skip(x, x)
    torch.cuda.synchronize()
    emit("build", kernel="fused_concat_skip", route="triton",
         first_launch_seconds=time.perf_counter() - t0)
    g = torch.Generator(device="cuda").manual_seed(1)
    rows = {d: [] for d in dtypes}
    for dname, dtype in dtypes.items():
        for c, s in K1_SHAPES:
            shape = (BATCH, c, s, s)
            x2 = torch.rand(shape, generator=g, device="cuda").to(dtype)
            x1 = torch.randn(shape, generator=g, device="cuda").to(dtype)
            out = fused_concat_skip(x2, x1)
            ref = concat_skip_plain(x2, x1)
            torch.cuda.synchronize()
            err = (out.float() - ref.float()).abs().max().item()
            rtol, atol = K1_TOL[dname]
            if not torch.allclose(out.float(), ref.float(), rtol=rtol,
                                  atol=atol):
                raise AssertionError(f"K1 {dname} {shape}: max err {err}")
            ms = time_ms(lambda: fused_concat_skip(x2, x1))
            plain = time_ms(lambda: concat_skip_plain(x2, x1))
            nbytes = 6 * x2.numel() * x2.element_size()
            flops = 3 * x2.numel()
            bms, by = bound_ms(nbytes, flops, dname)
            row = dict(dtype=dname, shape=list(shape), max_abs_err=err,
                       ms=ms, plain_ms=plain, bytes=nbytes, bound_ms=bms,
                       bound_by=by)
            rows[dname].append(row)
            emit("k1", **row)
            del x2, x1, out, ref
    return rows


def phase_k2(torch, dtypes):
    import torch.nn.functional as F
    from uncltmo_tpu_torch.ops.kernels.double_conv import (
        double_conv3x3_plain, fused_double_conv3x3)
    g = torch.Generator(device="cuda").manual_seed(2)
    rows = {d: [] for d in dtypes}
    for dname, dtype in dtypes.items():
        for name, cin, c1, c2, s in K2_SHAPES:
            def rnd(*shape, std=1.0):
                return (torch.randn(shape, generator=g, device="cuda")
                        * std).to(dtype)
            x = torch.rand((BATCH, cin, s, s), generator=g,
                           device="cuda").to(dtype)
            w1 = rnd(c1, cin, 3, 3, std=(2.0 / (9 * cin)) ** 0.5)
            b1 = rnd(c1, std=0.1)
            w2 = rnd(c2, c1, 3, 3, std=(2.0 / (9 * c1)) ** 0.5)
            b2 = rnd(c2, std=0.1)
            out = fused_double_conv3x3(x, w1, b1, w2, b2)
            ref = double_conv3x3_plain(x, w1, b1, w2, b2)
            torch.cuda.synchronize()
            err = (out.float() - ref.float()).abs().max().item()
            scale = ref.float().abs().max().item()
            if not err <= K2_TOL[dname] * max(scale, 1e-6):
                raise AssertionError(f"K2 {dname} {name}: max err {err} "
                                     f"(plain max {scale})")
            ms = time_ms(lambda: fused_double_conv3x3(x, w1, b1, w2, b2))
            plain = time_ms(lambda: double_conv3x3_plain(x, w1, b1, w2, b2))

            def cudnn():
                F.relu_(F.conv2d(F.relu_(F.conv2d(x, w1, b1)), w2, b2))
            library = time_ms(cudnn)
            flops = 2 * 9 * BATCH * (cin * c1 * (s - 2) ** 2
                                     + c1 * c2 * (s - 4) ** 2)
            nbytes = (x.numel() + out.numel() + w1.numel() + w2.numel()
                      + c1 + c2) * x.element_size()
            bms, by = bound_ms(nbytes, flops, dname)
            row = dict(dtype=dname, cell=name, shape=list(x.shape),
                       max_abs_err=err, plain_max_abs=scale, ms=ms,
                       plain_ms=plain, library_ms=library, flops=flops,
                       tflops=flops / ms / 1e9, bound_ms=bms, bound_by=by)
            rows[dname].append(row)
            emit("k2", **row)
            del x, out, ref
    return rows


def phase_generator(torch, dtypes, seed):
    from uncltmo_tpu_torch.models import blocks
    from uncltmo_tpu_torch.models.unet import UNetTMO, seeded_init_
    from uncltmo_tpu_torch.ops.kernels.concat_skip import concat_skip_plain
    from uncltmo_tpu_torch.ops.kernels.double_conv import double_conv3x3_plain
    g = torch.Generator(device="cuda").manual_seed(seed + 3)
    x = torch.rand((8, 1, 256, 256), generator=g, device="cuda")
    for dname, dtype in dtypes.items():
        model = seeded_init_(UNetTMO(), seed).to("cuda").eval()
        for p in model.parameters():       # as TileEngine: params only
            p.data = p.data.to(dtype)
        with torch.no_grad():
            out, _ = model(x.to(dtype))
            # the same model with the blocks' kernels swapped for their
            # plain versions (a comparison harness, not a port option)
            k1, k2 = blocks.fused_concat_skip, blocks.fused_double_conv3x3
            blocks.fused_concat_skip = concat_skip_plain
            blocks.fused_double_conv3x3 = double_conv3x3_plain
            try:
                ref, _ = model(x.to(dtype))
            finally:
                blocks.fused_concat_skip, blocks.fused_double_conv3x3 = k1, k2
        err = (out.float() - ref.float()).abs().max().item()
        finite = bool(torch.isfinite(out.float()).all())
        emit("generator", dtype=dname, shape=list(out.shape),
             max_abs_err=err, finite=finite, out_std=out.float().std().item())
        if not finite or not err <= GEN_TOL[dname]:
            raise AssertionError(f"generator {dname}: max err {err}, "
                                 f"finite={finite}")


def synthetic_hdr(rng, h: int, w: int):
    """A smooth scene over ~6 decades of luminance with coloured regions
    and fine noise, float32 RGB."""
    import numpy as np
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    f = rng.uniform(2.0, 6.0, 4).astype(np.float32)
    logl = (2.0 * np.sin(f[0] * xx / w + f[1] * yy / h)
            + 1.5 * np.cos(f[2] * yy / h) + 1.0 * np.sin(f[3] * xx / w)) / 1.5
    lum = 10.0 ** logl
    tint = rng.uniform(0.3, 1.0, (3, 1, 1)).astype(np.float32)
    rgb = lum[None] * (tint + 0.3 * np.sin(xx / (40 + 10 * tint)))
    rgb *= 1.0 + 0.05 * rng.standard_normal((3, h, w)).astype(np.float32)
    return np.clip(rgb, 1e-4, None).transpose(1, 2, 0).astype(np.float32)


def profile_frame(torch, dname, runner, loaded, top: int = 10) -> None:
    """Device time of one warm 1080p frame by kernel (torch.profiler), and
    the device's idle share over the frame's wall time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        runner._tonemap_loaded(*loaded)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    rows = []
    for e in prof.key_averages():
        # device-side events only: the CPU ops that launched them carry
        # the same time again
        if getattr(e, "device_type", None) != DeviceType.CUDA:
            continue
        dev_us = getattr(e, "self_device_time_total",
                         getattr(e, "self_cuda_time_total", 0))
        if dev_us > 0:
            rows.append((dev_us, e.key, e.count))
    rows.sort(reverse=True)
    total_ms = sum(r[0] for r in rows) / 1e3
    emit("profile", dtype=dname, wall_ms=wall_ms, device_ms=total_ms,
         idle_share=max(0.0, 1.0 - total_ms / wall_ms) if wall_ms else None,
         top=[{"kernel": k[:90], "ms": us / 1e3, "calls": n,
               "share": us / 1e3 / total_ms if total_ms else None}
              for us, k, n in rows[:top]])


def phase_end_to_end(torch, dtypes, seed, n_frames):
    import numpy as np
    from uncltmo_tpu_torch.config import get_model_params
    from uncltmo_tpu_torch.inference.runner import InferenceRunner
    from uncltmo_tpu_torch.models.unet import UNetTMO, seeded_init_
    from uncltmo_tpu_torch.ops.kernels.concat_skip import fused_concat_skip
    from uncltmo_tpu_torch.ops.kernels.double_conv import fused_double_conv3x3
    from uncltmo_tpu_torch.utils.io import read_png, write_radiance_hdr

    rng = np.random.default_rng(seed)
    state = seeded_init_(UNetTMO(), seed).state_dict()
    mp = get_model_params("imageTMO")
    launches = {}
    with tempfile.TemporaryDirectory() as tmp:
        in_dir = os.path.join(tmp, "in")
        small_dir = os.path.join(tmp, "small")
        os.makedirs(in_dir)
        os.makedirs(small_dir)
        lams = {}
        for i in range(n_frames):
            write_radiance_hdr(os.path.join(in_dir, f"frame{i}.hdr"),
                               synthetic_hdr(rng, 1080, 1920))
            lams[f"frame{i}"] = float(rng.uniform(100, 1000))
        write_radiance_hdr(os.path.join(small_dir, "small.hdr"),
                           synthetic_hdr(rng, 250, 300))
        lams["small"] = 400.0
        lam = os.path.join(tmp, "lambdas.npy")
        np.save(lam, lams)
        for dname, dtype in dtypes.items():
            runner = InferenceRunner(mp, None, state_dict=state, dtype=dtype,
                                     device="cuda")
            # warm-up pass (Triton compiles, cuDNN picks algorithms)
            runner.run_on_path(in_dir, os.path.join(tmp, "warm"), lam,
                               scale=1)
            torch.cuda.synchronize()
            fused_concat_skip.launches = 0
            fused_double_conv3x3.launches = 0
            t0 = time.perf_counter()
            outs = runner.run_on_path(in_dir, os.path.join(tmp, dname), lam,
                                      scale=1)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches[dname] = {
                "fused_concat_skip": fused_concat_skip.launches,
                "fused_double_conv3x3": fused_double_conv3x3.launches}
            # device-only rate on preloaded frames (CUDA events)
            loaded = runner.load_image(os.path.join(in_dir, "frame0.hdr"),
                                       lam, scale=1)
            out01 = runner._tonemap_loaded(*loaded)
            torch.cuda.synchronize()
            finite = bool(torch.isfinite(out01).all())
            dev_ms = time_ms(lambda: runner._tonemap_loaded(*loaded),
                             iters=n_frames, warmup=1)
            profile_frame(torch, dname, runner, loaded)
            shapes = [read_png(p).shape for p in outs]
            emit("end_to_end", dtype=dname, frames=len(outs),
                 png_shapes=[list(s) for s in shapes], finite=finite,
                 out_shape=list(out01.shape),
                 files_fps=len(outs) / wall, device_ms_per_frame=dev_ms,
                 device_fps=1e3 / dev_ms, launches=launches[dname])
            if (len(outs) != n_frames or not finite
                    or any(s != (1080, 1920, 3) for s in shapes)
                    or tuple(out01.shape) != (1080, 1920, 3)):
                raise AssertionError(f"end to end {dname}: bad output")
            if min(launches[dname].values()) < 1:
                raise AssertionError(f"end to end {dname}: a kernel was not "
                                     f"launched: {launches[dname]}")
            del runner, loaded, out01
        # a small image: the card (kernels) against the CPU (plain
        # versions), float32, PNGs within 1 level
        pngs = {}
        for dev in ("cuda", "cpu"):
            runner = InferenceRunner(mp, None, state_dict=state,
                                     device=dev)
            pngs[dev] = read_png(runner.run_on_path(
                small_dir, os.path.join(tmp, "small_" + dev), lam,
                scale=1)[0]).astype(np.int16)
        diff = int(np.abs(pngs["cuda"] - pngs["cpu"]).max())
        emit("reference", image=list(pngs["cpu"].shape),
             max_uint8_diff_cuda_vs_cpu=diff)
        if diff > 1:
            raise AssertionError(f"card vs CPU runner: {diff} levels apart")
    return launches


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--frames", type=int, default=4)
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(ROOT, "uncltmo_tpu_torch")):
        print("chip_smoke: the uncltmo_tpu_torch package is not beside this "
              "script", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    kind = torch.cuda.get_device_name(0)
    smi = nvidia_smi_line()
    emit("device", kind=kind, count=torch.cuda.device_count(),
         nvidia_smi=smi, torch=torch.__version__, cuda=torch.version.cuda)
    dtypes = {"float32": torch.float32, "bfloat16": torch.bfloat16}
    phase_build()
    k1 = phase_k1(torch, dtypes)
    k2 = phase_k2(torch, dtypes)
    phase_generator(torch, dtypes, args.seed)
    launches = phase_end_to_end(torch, dtypes, args.seed, args.frames)

    kernels = []
    for name, route, source, replaces, rows in (
            ("fused_concat_skip", "triton",
             "uncltmo_tpu_torch/ops/kernels/_concat_skip_triton.py",
             "uncltmo_tpu/ops/pallas_kernels.py:183", k1),
            ("fused_double_conv3x3", "cuda",
             "uncltmo_tpu_torch/ops/kernels/csrc/double_conv3x3.cu",
             "uncltmo_tpu/ops/pallas_kernels.py:108", k2)):
        for dname in dtypes:
            r = rows[dname]
            # one conv batch of a 1080p frame: the four main-path shapes
            bms = sum(x["bound_ms"] for x in r)
            kernels.append({
                "name": f"{name}/{dname}", "route": route, "source": source,
                "replaces": replaces,
                "launches": launches[dname][name],
                "max_abs_err": max(x["max_abs_err"] for x in r),
                "ms": sum(x["ms"] for x in r),
                "plain_ms": sum(x["plain_ms"] for x in r),
                "bound_ms": bms,
                "bound_by": max(r, key=lambda x: x["bound_ms"])["bound_by"],
                "library_ms": (sum(x["library_ms"] for x in r)
                               if "library_ms" in r[0] else None)})
    os.makedirs(OUT_DIR, exist_ok=True)
    with open(os.path.join(OUT_DIR, "chip_smoke.json"), "w") as f:
        json.dump({"log": LOG, "kernels": kernels}, f, indent=1)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
