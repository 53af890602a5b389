#!/usr/bin/env python3
"""Smoke run of the PyTorch port (`uncltmo_tpu_torch`) on one CUDA card.

    python3 chip_smoke.py [--seed 0] [--frames 2]

Drives the port's serving paths with the published generator (depth 4, 32
filters, weights drawn from a seed) at 1080p -- tiled image tone mapping
(`InferenceRunner.run_on_path`), tiled video tone mapping with the temporal
recurrence (`run_on_video_path`, `scene_batch` 1 and 2) and whole-image
inference (`InferenceRunner(whole_image=True)`) -- and holds each
hand-written kernel against its plain PyTorch version on the card.  One
JSON line per phase:

 1. device: the card's name and power limit (nvidia-smi);
 2. build: nvcc of the CUDA kernels for sm_90a, Triton's first compile;
 3. K1 (Triton skip concat) vs plain at the four Up shapes, B=60, f32/bf16;
 4. K2 (CUDA double conv on the tensor cores) vs plain (cuDNN) at the
    inc/down0..2 shapes, B=60, f32/bf16, timed; then untimed at ragged and
    padded shapes;
 5. the generator forward (8x1x256x256) with the kernels vs all-plain;
 6. end to end: synthetic 1080x1920 .hdr files -> PNGs in f32 and bf16,
    kernel launch counts of that run, warm frames/s, and a small image
    checked against the same runner on the CPU (plain versions);
 7. k1_extra / k2_extra (untimed): both kernels vs plain at the shapes the
    new paths give them: B=120 tiles (two scenes in one video frame step)
    and the four B=1 planes of a whole 1080p frame;
 8. video: scenes of 6 frames of 1080x1920 .hdr files -> PNGs with
    `scene_batch` 1 and 2, launch counts, device ms per scene and frames/s,
    the cost of the carry in a frame step, a profile; video_reference: a
    small scene on the card against the CPU runner;
 9. whole_image: one 1080x1920 frame in one forward, first and warm ms,
    launch counts, peak memory, a profile, and a small image card vs CPU;
10. the kernels line (launches summed over all paths), the nvidia-smi
    line, and `{"ok": true, ...}` last.

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
# untimed: ragged sizes and channel counts that need padding, more input
# channels than one staging chunk, more output channels than one pass
K2_RAGGED = [(2, 16, 24, 16, 37, 40), (2, 8, 8, 8, 68, 32),
             (3, 1, 24, 8, 29, 33), (2, 3, 5, 7, 5, 5),
             (1, 144, 40, 72, 19, 35), (1, 20, 48, 100, 17, 25),
             (1, 6, 96, 300, 13, 14)]       # (B, Cin, C1, C2, H, W)
GEN_TOL = {"float32": 1e-3, "bfloat16": 0.1}  # sigmoid output, abs
FRAME_HW = (1080, 1920)       # the frame size of every end-to-end phase
SMALL_HW = (250, 300)         # card-vs-CPU comparisons
VIDEO_FRAMES = 6              # frames of a scene (the published scenes')
VIDEO_BATCH = 120             # tiles of two 1080p scenes in one frame step
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
    # ptxas -v, per kernel instantiation: registers, shared memory, spills
    ptxas, entry = [], ""
    for ln in info["log"].splitlines():
        if "Compiling entry function" in ln:
            entry = ln.split("'")[1] if "'" in ln else ln.strip()
        elif "registers" in ln or "spill" in ln:
            # the mangled name; for the templated kernel, from its Cfg<...>
            short = entry[entry.find("CfgI"):] if "CfgI" in entry else entry
            ptxas.append({"entry": short[:64],
                          "info": ln.replace("ptxas info    :", "").strip()})
    emit("build", kernel="fused_double_conv3x3", route="cuda",
         nvcc_seconds=info["seconds"],
         load_seconds=time.perf_counter() - t0, ptxas=ptxas)


def k1_check(torch, dname, x2, x1) -> float:
    """K1 against its plain version on (x2, x1); the max abs error."""
    from uncltmo_tpu_torch.ops.kernels.concat_skip import (
        concat_skip_plain, fused_concat_skip)
    out = fused_concat_skip(x2, x1)
    ref = concat_skip_plain(x2, x1)
    torch.cuda.synchronize()
    err = (out.float() - ref.float()).abs().max().item()
    rtol, atol = K1_TOL[dname]
    if out.shape != ref.shape or not torch.allclose(
            out.float(), ref.float(), rtol=rtol, atol=atol):
        raise AssertionError(f"K1 {dname} {tuple(x2.shape)}: max err {err}")
    return err


def k1_inputs(torch, g, dtype, shape):
    return (torch.rand(shape, generator=g, device="cuda").to(dtype),
            torch.randn(shape, generator=g, device="cuda").to(dtype))


def k2_inputs(torch, g, dtype, b, cin, c1, c2, h, w):
    def rnd(*shape, std=1.0):
        return (torch.randn(shape, generator=g, device="cuda")
                * std).to(dtype)
    return (torch.rand((b, cin, h, w), generator=g, device="cuda").to(dtype),
            rnd(c1, cin, 3, 3, std=(2.0 / (9 * cin)) ** 0.5),
            rnd(c1, std=0.1),
            rnd(c2, c1, 3, 3, std=(2.0 / (9 * c1)) ** 0.5),
            rnd(c2, std=0.1))


def k2_check(torch, dname, name, args):
    """K2 against its plain version; (out, max abs error, plain's max)."""
    from uncltmo_tpu_torch.ops.kernels.double_conv import (
        double_conv3x3_plain, fused_double_conv3x3)
    out = fused_double_conv3x3(*args)      # packs in the call
    ref = double_conv3x3_plain(*args)
    torch.cuda.synchronize()
    err = (out.float() - ref.float()).abs().max().item()
    scale = ref.float().abs().max().item()
    if (out.shape != ref.shape
            or not err <= K2_TOL[dname] * max(scale, 1e-6)):
        raise AssertionError(f"K2 {dname} {name}: max err {err} "
                             f"(plain max {scale})")
    return out, err, scale


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
            x2, x1 = k1_inputs(torch, g, dtype, shape)
            err = k1_check(torch, dname, x2, x1)
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
            del x2, x1
    return rows


def phase_k2(torch, dtypes):
    import torch.nn.functional as F
    from uncltmo_tpu_torch.ops.kernels.double_conv import (
        double_conv3x3_plain, fused_double_conv3x3, pack_double_conv_weights)
    g = torch.Generator(device="cuda").manual_seed(2)
    rows = {d: [] for d in dtypes}
    for dname, dtype in dtypes.items():
        for name, cin, c1, c2, s in K2_SHAPES:
            x, w1, b1, w2, b2 = k2_inputs(torch, g, dtype, BATCH, cin, c1,
                                          c2, s, s)
            out, err, scale = k2_check(torch, dname, name,
                                       (x, w1, b1, w2, b2))
            # as the model calls it: weights packed once, outside the call
            packed = pack_double_conv_weights(w1, b1, w2, b2)
            ms = time_ms(lambda: fused_double_conv3x3(x, w1, b1, w2, b2,
                                                      packed=packed))
            ms_packing = time_ms(
                lambda: fused_double_conv3x3(x, w1, b1, w2, b2))
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
                       ms_packing_in_call=ms_packing, plain_ms=plain,
                       library_ms=library, flops=flops,
                       tflops=flops / ms / 1e9, bound_ms=bms, bound_by=by)
            rows[dname].append(row)
            emit("k2", **row)
            del x, out
        for shape in K2_RAGGED:
            _, err, scale = k2_check(torch, dname, shape,
                                     k2_inputs(torch, g, dtype, *shape))
            emit("k2_ragged", dtype=dname, shape=list(shape),
                 max_abs_err=err, plain_max_abs=scale)
    return rows


def whole_image_planes(h: int, w: int):
    """The shapes one whole (h, w) frame gives the kernels at B = 1: K2's
    four inputs (cell, Cin, C1, C2, H, W) and K1's four skips (C, H, W)."""
    from uncltmo_tpu_torch.ops.preprocess import padded_size
    ph, pw = padded_size(h), padded_size(w)
    k2, k1 = [], []
    cin, c = 1, 32
    for name, *_ in K2_SHAPES:
        k2.append((name, cin, c, c, ph, pw))
        ph, pw = ph - 4, pw - 4
        k1.append((c, ph, pw))
        cin, c, ph, pw = c, 2 * c, ph // 2, pw // 2
    return k2, k1


def phase_kernels_extra(torch, dtypes):
    """Untimed: both kernels against their plain versions at the shapes the
    video path (B = 120 tiles) and the whole-image path (B = 1 planes)
    give them."""
    g = torch.Generator(device="cuda").manual_seed(4)
    k2_planes, k1_planes = whole_image_planes(*FRAME_HW)
    k1_shapes = ([(VIDEO_BATCH, c, s, s) for c, s in K1_SHAPES]
                 + [(1, c, h, w) for c, h, w in k1_planes])
    k2_shapes = ([(n, VIDEO_BATCH, cin, c1, c2, s, s)
                  for n, cin, c1, c2, s in K2_SHAPES]
                 + [(n, 1, cin, c1, c2, h, w)
                    for n, cin, c1, c2, h, w in k2_planes])
    for dname, dtype in dtypes.items():
        for shape in k1_shapes:
            err = k1_check(torch, dname, *k1_inputs(torch, g, dtype, shape))
            emit("k1_extra", dtype=dname, shape=list(shape), max_abs_err=err)
        for name, *shape in k2_shapes:
            out, err, scale = k2_check(torch, dname, (name, *shape),
                                       k2_inputs(torch, g, dtype, *shape))
            emit("k2_extra", dtype=dname, cell=name, shape=list(shape),
                 out_shape=list(out.shape), max_abs_err=err,
                 plain_max_abs=scale)
            del out
        torch.cuda.empty_cache()


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
            blocks.fused_double_conv3x3 = (
                lambda *args, packed=None: double_conv3x3_plain(*args))
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


def profile_call(torch, dname, fn, path: str = "image", top: int = 10) -> None:
    """Device time of one warm call of `fn` by kernel (torch.profiler), and
    the device's idle share over the call's wall time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
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
    emit("profile", path=path, dtype=dname, wall_ms=wall_ms,
         device_ms=total_ms,
         idle_share=max(0.0, 1.0 - total_ms / wall_ms) if wall_ms else None,
         top=[{"kernel": k.replace("(anonymous namespace)::", "")[:90],
               "ms": us / 1e3, "calls": n,
               "share": us / 1e3 / total_ms if total_ms else None}
              for us, k, n in rows[:top]])


def reset_counts() -> None:
    from uncltmo_tpu_torch.ops.kernels.concat_skip import fused_concat_skip
    from uncltmo_tpu_torch.ops.kernels.double_conv import fused_double_conv3x3
    fused_concat_skip.launches = 0
    fused_double_conv3x3.launches = 0


def read_counts() -> dict:
    from uncltmo_tpu_torch.ops.kernels.concat_skip import fused_concat_skip
    from uncltmo_tpu_torch.ops.kernels.double_conv import fused_double_conv3x3
    return {"fused_concat_skip": fused_concat_skip.launches,
            "fused_double_conv3x3": fused_double_conv3x3.launches}


def png_diff(a: str, b: str) -> int:
    import numpy as np
    from uncltmo_tpu_torch.utils.io import read_png
    return int(np.abs(read_png(a).astype(np.int16)
                      - read_png(b).astype(np.int16)).max())


def write_scenes(root: str, rng, names, n_frames: int, hw) -> dict:
    """One directory of `.hdr` frames per scene; a scene's frames are one
    synthetic image under a slowly changing exposure.  Returns the lambdas
    by scene name."""
    from uncltmo_tpu_torch.utils.io import write_radiance_hdr
    lams = {}
    for name in names:
        os.makedirs(os.path.join(root, name))
        base = synthetic_hdr(rng, *hw)
        for i in range(n_frames):
            write_radiance_hdr(os.path.join(root, name, f"{i:03d}.hdr"),
                               base * (1.0 + 0.1 * i))
        lams[name] = float(rng.uniform(100, 1000))
    return lams


def carry_cost(torch, dname, runner) -> dict:
    """A frame step of 60 tiles without and with a carry (the eight
    splices and the eight recorded slices are the difference), and, for
    comparison, the eight splices as plain `torch.cat` copies at their
    shapes."""
    model = runner.engine.model
    g = torch.Generator(device="cuda").manual_seed(5)
    x = torch.rand((BATCH, 1, 256, 256), generator=g,
                   device="cuda").to(runner.engine.dtype)
    with torch.no_grad():
        _, _, carry = model.frame(x)
        no_carry = time_ms(lambda: model.frame(x), iters=5, warmup=2)
        with_carry = time_ms(lambda: model.frame(x, carry), iters=5, warmup=2)
        # the tensors a plain splice would copy: the four encoder outputs
        # (32..256 channels) and the four decoder inputs
        shapes = [(32, 252), (64, 122), (128, 57), (256, 24), (256, 12),
                  (128, 28), (64, 61), (32, 126)]
        acts = [torch.rand((BATCH, c, s, s), device="cuda").to(x.dtype)
                for c, s in shapes]
        cat_ms = time_ms(lambda: [torch.cat([r, a[:, r.shape[1]:]], 1)
                                  for r, a in zip(carry, acts)],
                         iters=5, warmup=2)
    return {"frame_ms_no_carry": no_carry, "frame_ms_with_carry": with_carry,
            "carry_ms": with_carry - no_carry,
            "eight_splices_as_cat_ms": cat_ms,
            "carry_channels": [int(c.shape[1]) for c in carry]}


def phase_video(torch, dtypes, seed):
    """Two synthetic scenes through `run_on_video_path` with `scene_batch`
    1 and 2; a small scene on the card against the CPU runner."""
    import numpy as np
    from uncltmo_tpu_torch.config import get_model_params
    from uncltmo_tpu_torch.inference.runner import (InferenceRunner,
                                                    postprocess_device)
    from uncltmo_tpu_torch.models.unet import UNetTMO, seeded_init_
    from uncltmo_tpu_torch.utils.io import read_png

    rng = np.random.default_rng(seed + 1)
    state = seeded_init_(UNetTMO(), seed).state_dict()
    mp = get_model_params("videoTMO")
    launches = {}
    with tempfile.TemporaryDirectory() as tmp:
        scenes = os.path.join(tmp, "scenes")
        small = os.path.join(tmp, "small")
        lams = write_scenes(scenes, rng, ["scene_a", "scene_b"],
                            VIDEO_FRAMES, FRAME_HW)
        lams.update(write_scenes(small, rng, ["small"], 3, SMALL_HW))
        lam = os.path.join(tmp, "lambdas.npy")
        np.save(lam, lams)
        n_frames = 2 * VIDEO_FRAMES
        for dname, dtype in dtypes.items():
            runner = InferenceRunner(mp, None, video=True, state_dict=state,
                                     dtype=dtype, device="cuda")
            runner.run_on_video_path(scenes, os.path.join(tmp, "warm"), lam)
            torch.cuda.synchronize()
            outs, counts, wall = {}, {}, {}
            for sb in (1, 2):
                reset_counts()
                t0 = time.perf_counter()
                outs[sb] = runner.run_on_video_path(
                    scenes, os.path.join(tmp, f"{dname}_sb{sb}"), lam,
                    scene_batch=sb)
                torch.cuda.synchronize()
                wall[sb] = time.perf_counter() - t0
                counts[sb] = read_counts()
            launches[dname] = {k: counts[1][k] + counts[2][k]
                               for k in counts[1]}
            # device-only times on preloaded scenes: tiler + recurrence +
            # blend, then the per-frame postprocess (CUDA events)
            loaded = [runner._load_scene(
                [os.path.join(scenes, n, f"{i:03d}.hdr")
                 for i in range(VIDEO_FRAMES)], lam)
                for n in ("scene_a", "scene_b")]
            stacks = torch.stack([torch.stack(ld[2]) for ld in loaded])

            def run_scenes(group):
                if len(group) == 1:
                    fakes = runner.engine.run_video(stacks[group[0]])[None]
                else:
                    fakes = runner.engine.run_videos(stacks[group])
                return [postprocess_device(loaded[s][1][i], fakes[j][i],
                                           loaded[s][3], loaded[s][4])
                        for j, s in enumerate(group)
                        for i in range(VIDEO_FRAMES)]

            finite = all(bool(torch.isfinite(o).all())
                         for o in run_scenes([0, 1]))
            torch.cuda.reset_peak_memory_stats()
            ms_sb1 = time_ms(lambda: run_scenes([0]), iters=3, warmup=1)
            ms_sb2 = time_ms(lambda: run_scenes([0, 1]), iters=3, warmup=1)
            peak_gb = torch.cuda.max_memory_allocated() / 1e9
            carry = carry_cost(torch, dname, runner)
            profile_call(torch, dname, lambda: run_scenes([0]),
                         path="video_scene_batch_1")
            shapes = [read_png(p).shape for p in outs[1] + outs[2]]
            diff = max(png_diff(a, b) for a, b in zip(outs[1], outs[2]))
            # 4 launches a frame step and chunk; one chunk a 1080p plan
            expected = {1: 4 * VIDEO_FRAMES * 2, 2: 4 * VIDEO_FRAMES}
            emit("video", dtype=dname, scenes=2, frames_per_scene=VIDEO_FRAMES,
                 pngs=[len(outs[1]), len(outs[2])],
                 png_shape=list(shapes[0]), finite=finite,
                 launches_scene_batch_1=counts[1],
                 launches_scene_batch_2=counts[2],
                 expected_launches=expected,
                 device_ms_per_scene_scene_batch_1=ms_sb1,
                 device_fps_scene_batch_1=VIDEO_FRAMES / ms_sb1 * 1e3,
                 device_ms_per_scene_scene_batch_2=ms_sb2 / 2,
                 device_fps_scene_batch_2=n_frames / ms_sb2 * 1e3,
                 files_fps_scene_batch_1=n_frames / wall[1],
                 files_fps_scene_batch_2=n_frames / wall[2],
                 peak_memory_gb=peak_gb,
                 max_uint8_diff_scene_batch_2_vs_1=diff, **carry)
            if (len(outs[1]) != n_frames or len(outs[2]) != n_frames
                    or not finite
                    or any(sh != FRAME_HW + (3,) for sh in shapes)):
                raise AssertionError(f"video {dname}: bad output")
            for sb in (1, 2):
                if any(v != expected[sb] for v in counts[sb].values()):
                    raise AssertionError(
                        f"video {dname} scene_batch={sb}: launches "
                        f"{counts[sb]}, expected {expected[sb]} each")
            if diff > 1:
                raise AssertionError(f"video {dname}: scene_batch 2 vs 1 "
                                     f"{diff} levels apart")
            del runner, loaded, stacks
            torch.cuda.empty_cache()
        # a small scene: the card (kernels) against the CPU (plain
        # versions), float32, PNGs within 1 level
        pngs = {}
        for dev in ("cuda", "cpu"):
            runner = InferenceRunner(mp, None, video=True, state_dict=state,
                                     device=dev)
            pngs[dev] = runner.run_on_video_path(
                small, os.path.join(tmp, "small_" + dev), lam)
        diff = max(png_diff(a, b) for a, b in zip(pngs["cuda"], pngs["cpu"]))
        emit("video_reference", frames=len(pngs["cpu"]),
             image=list(read_png(pngs["cpu"][0]).shape),
             max_uint8_diff_cuda_vs_cpu=diff)
        if len(pngs["cuda"]) != 3 or len(pngs["cpu"]) != 3 or diff > 1:
            raise AssertionError(f"video, card vs CPU runner: {diff} levels "
                                 "apart")
    return launches


def phase_whole_image(torch, dtypes, seed):
    """One 1080p frame in one forward (no tiling), and a small image on the
    card against the CPU runner."""
    import numpy as np
    from uncltmo_tpu_torch.config import get_model_params
    from uncltmo_tpu_torch.inference.runner import InferenceRunner
    from uncltmo_tpu_torch.models.unet import UNetTMO, seeded_init_
    from uncltmo_tpu_torch.utils.io import read_png, write_radiance_hdr

    rng = np.random.default_rng(seed + 2)
    state = seeded_init_(UNetTMO(), seed).state_dict()
    mp = get_model_params("imageTMO")
    launches = {}
    with tempfile.TemporaryDirectory() as tmp:
        in_dir = os.path.join(tmp, "in")
        small_dir = os.path.join(tmp, "small")
        os.makedirs(in_dir)
        os.makedirs(small_dir)
        write_radiance_hdr(os.path.join(in_dir, "frame.hdr"),
                           synthetic_hdr(rng, *FRAME_HW))
        write_radiance_hdr(os.path.join(small_dir, "small.hdr"),
                           synthetic_hdr(rng, *SMALL_HW))
        lam = os.path.join(tmp, "lambdas.npy")
        np.save(lam, {"frame": 500.0, "small": 400.0})
        for dname, dtype in dtypes.items():
            runner = InferenceRunner(mp, None, state_dict=state, dtype=dtype,
                                     whole_image=True, device="cuda")
            loaded = runner.load_image(os.path.join(in_dir, "frame.hdr"),
                                       lam, scale=1)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            out01 = runner._tonemap_loaded(*loaded)
            torch.cuda.synchronize()
            first_ms = (time.perf_counter() - t0) * 1e3
            peak_gb = torch.cuda.max_memory_allocated() / 1e9
            finite = bool(torch.isfinite(out01).all())
            warm_ms = time_ms(lambda: runner._tonemap_loaded(*loaded),
                              iters=3, warmup=1)
            reset_counts()
            outs = runner.run_on_path(in_dir, os.path.join(tmp, dname), lam,
                                      scale=1)
            torch.cuda.synchronize()
            launches[dname] = read_counts()
            profile_call(torch, dname,
                         lambda: runner._tonemap_loaded(*loaded),
                         path="whole_image")
            shape = read_png(outs[0]).shape
            emit("whole_image", dtype=dname, padded=list(loaded[1].shape),
                 png_shape=list(shape), out_shape=list(out01.shape),
                 finite=finite, first_ms=first_ms, warm_ms=warm_ms,
                 peak_memory_gb_first_frame=peak_gb,
                 launches=launches[dname])
            if (not finite or shape != FRAME_HW + (3,)
                    or tuple(out01.shape) != FRAME_HW + (3,)):
                raise AssertionError(f"whole image {dname}: bad output")
            if any(v != 4 for v in launches[dname].values()):
                raise AssertionError(f"whole image {dname}: launches "
                                     f"{launches[dname]}, expected 4 each")
            del runner, loaded, out01
            torch.cuda.empty_cache()
        pngs = {}
        for dev in ("cuda", "cpu"):
            runner = InferenceRunner(mp, None, state_dict=state,
                                     whole_image=True, device=dev)
            pngs[dev] = runner.run_on_path(
                small_dir, os.path.join(tmp, "small_" + dev), lam,
                scale=1)[0]
        diff = png_diff(pngs["cuda"], pngs["cpu"])
        emit("whole_image_reference", image=list(read_png(pngs["cpu"]).shape),
             max_uint8_diff_cuda_vs_cpu=diff)
        if diff > 1:
            raise AssertionError(f"whole image, card vs CPU runner: {diff} "
                                 "levels apart")
    return launches


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
                               synthetic_hdr(rng, *FRAME_HW))
            lams[f"frame{i}"] = float(rng.uniform(100, 1000))
        write_radiance_hdr(os.path.join(small_dir, "small.hdr"),
                           synthetic_hdr(rng, *SMALL_HW))
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
            profile_call(torch, dname,
                         lambda: runner._tonemap_loaded(*loaded))
            shapes = [read_png(p).shape for p in outs]
            emit("end_to_end", dtype=dname, frames=len(outs),
                 png_shapes=[list(s) for s in shapes], finite=finite,
                 out_shape=list(out01.shape),
                 files_fps=len(outs) / wall, device_ms_per_frame=dev_ms,
                 device_fps=1e3 / dev_ms, launches=launches[dname])
            if (len(outs) != n_frames or not finite
                    or any(s != FRAME_HW + (3,) for s in shapes)
                    or tuple(out01.shape) != FRAME_HW + (3,)):
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
    ap.add_argument("--frames", type=int, default=2,
                    help="1080p files of the tiled image phase")
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
    paths = [phase_end_to_end(torch, dtypes, args.seed, args.frames)]
    phase_kernels_extra(torch, dtypes)
    paths.append(phase_video(torch, dtypes, args.seed))
    paths.append(phase_whole_image(torch, dtypes, args.seed))
    # each path was driven with the counts set to 0 just before it and read
    # just after; the kernels line carries their sum
    launches = {d: {k: sum(p[d][k] for p in paths) for k in paths[0][d]}
                for d in dtypes}

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
