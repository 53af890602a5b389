#!/usr/bin/env python3
"""Smoke run of the PyTorch port (`uncltmo_tpu_torch`) on one CUDA card.

    python3 chip_smoke.py [--seed 0] [--frames 2]

Drives the port's serving paths with the published generator (depth 4, 32
filters, weights drawn from a seed) at 1080p -- tiled image tone mapping
(`InferenceRunner.run_on_path`), tiled video tone mapping with the temporal
recurrence (`run_on_video_path`, `scene_batch` 1 and 2) and whole-image
inference (`InferenceRunner(whole_image=True)`) -- and the GAN training step
(`training.train_step.make_train_step`) for the image and the video
generator at the published batch of 8 x 2 frames of 256 x 256, in float32
and in bfloat16, the training loop around it
(`training.trainer.GanTrainer`) and its evaluation
(`training.tester.Tester`), the generator's other configurations (a
batch-norm generator trained and served, one forward of every other
option), the trainer's final assessment with its FID and the offline
metric CLI, and holds each hand-written kernel against its plain PyTorch
version on the card.
One JSON line per phase:

 1. device: the card's name and power limit (nvidia-smi);
 2. build: nvcc of the CUDA kernels for sm_90a in a thread, Triton's first
    compiles meanwhile;
 3. K1 (Triton skip concat) vs plain at the four Up shapes, B=60, f32/bf16;
 4. K2 (CUDA double conv on the tensor cores) vs plain (cuDNN) at the
    inc/down0..2 shapes, B=60, f32/bf16, timed; then untimed at ragged and
    padded shapes;
 5. the generator forward (8x1x256x256) with the kernels vs all-plain;
 6. end to end: synthetic 1080x1920 .hdr files -> PNGs in f32 and bf16,
    kernel launch counts of that run, warm frames/s, and a small image
    checked against the same runner on the CPU (plain versions);
 7. k1_extra / k2_extra (untimed): both kernels vs plain at the shapes the
    other paths give them: B=120 tiles (two scenes in one video frame
    step), the four B=1 planes of a whole 1080p frame, and the training
    batches B=16 (image generator) and B=8 (a frame step of the video
    generator);
 8. video: scenes of 4 frames of 1080x1920 .hdr files -> PNGs with
    `scene_batch` 1 and 2, launch counts, device ms per scene and frames/s,
    the cost of the carry in a frame step, a profile; video_reference: a
    small scene on the card against the CPU runner;
 9. whole_image: one 1080x1920 frame in one forward, first and warm ms,
    launch counts, peak memory, a profile, and a small image card vs CPU;
10. k1_backward: K1's gradient kernel (Triton) vs its plain version at the
    four training shapes, f32 and bf16, bit for bit: B = 16 (timed) and
    B = 8 (the video generator's frame steps);
11. k2_autograd: K2 under autograd (the kernel forward, the library's
    convolution gradients backward) vs autograd of the plain version at the
    four training shapes, f32 with TF32 off: B = 16 (forward and backward
    timed) and B = 8;
12. train: for the image and the video generator, two D pre-train steps,
    three stage-0 steps, one stage-1 and one stage-2 step in float32:
    finite logs, a gradient and a changed value for every parameter, the
    kernels' launch counts, step ms per stage, peak memory, a profile of a
    stage-0 step; train_reference: a 112 x 112 step on the card against
    the same step on the CPU, at the published epsilon of the skip concat
    and at 1e-2;
13. trainer: `training.trainer.GanTrainer` at the same batch on synthetic
    data, one D pre-train epoch and one main epoch of 20 steps, image and
    video generator: steps/s beside the bare step's ms, the loop's
    wait/dispatch/log/summary seconds, launch counts (20 x a step's, none
    while D pre-trains, plus one generator forward for each 1/4-epoch
    sample grid), peak memory; the newest checkpoint reloaded into a fresh
    trainer bit for bit and served by `InferenceRunner` from its .pth on a
    small image (`summary_control`, not run here, times the summaries);
    the video generator's epochs have 10 steps;
14. data_parallel: the training step on two ranks of
    `torch.distributed` (NCCL over two cards where there are two, else
    gloo with both on card 0), 4 clips a rank of the published batch,
    against the one-process step from the same state, batch and drop path
    (image G stages 0-2 and stage 0 at epsilon 1e-2, video G stage 0),
    beside the one-process step against itself; the ranks' digests equal,
    every rank's K1 / K1 backward / K2 launches, step ms a rank, peak
    memory; `TileEngine(devices=[d0, d1])` on a 1080p frame and a 4-frame
    scene (also `batchMax`) against the one-device engine;
15. tester: `training.tester.Tester` for the image and the video
    generator on the video phase's 1080p files, float32, as the training
    CLIs build it: a lambda fitted on the card at construction (held
    against the CPU fit), one warm and one counted `save_images_for_model`
    each, ms by stage (forward, TMQI, warp error and its flow, PNG), each
    render's TMQI against the CPU's, the Horn-Schunck flow and the warp
    error against the CPU's on a small crop, the flow backend (torch, on
    the card), launch counts, peak memory;
16. k2_autograd in bfloat16 (B = 16, timed): K2's Function against
    autograd of the plain version in bfloat16, the backward formula on the
    plain output and the end-to-end gradients;
17. train_bf16: the image and the video generator at the published batch
    in bfloat16 (`compute_dtype=torch.bfloat16`, autocast), stages 0-2:
    the first step against the float32 step from the same state, batch
    and drop path (losses, the fake's statistics, a forward's fake in
    relative L2), step ms beside the float32 `train` phase's, launches a
    step (every launch's dtype recorded: all bfloat16), peak memory, a
    profile of a stage-0 step;
18. options: a batch-norm generator's running statistics after one step
    (published epsilon) and three (epsilon 1e-2) on the card against the
    CPU at 112 x 112; three batch-norm steps at the published batch
    (launches: K1 only) and that generator served on a 1080p frame by the
    card's runner and on a small frame by the card's and the CPU's (PNGs
    within one level); one forward at
    the published width of every other option with its K1 / K2 launches;
19. assessment: `GanTrainer.run_final_assessment` of an image-G trainer
    on 16 synthetic 540x960 HDR inputs (15 `.hdr`, one ZIP / HALF `.exr`)
    rendered at 1/2 size, with the FID against 16 real PNGs on seeded
    Inception weights (the published ones are not in the repository):
    16 PNGs, K1 and K2 4 launches a render, the FID stored under the
    model's name, the card's activations against the CPU extractor's and
    the FID of each, the FID's seconds by stage (decode + resample on the
    host, the extractor on the card, sqrtm on the host); `compute_metrics`
    tmqi over 4 pairs on the card against the CPU and btmqi over the
    renders; BTMQI's features of a 1080p render of the video phase, card
    vs CPU, with the entropy bins that differ, and its ms a frame;
20. the kernels line (launches summed over all paths; K2 under autograd
    is an entry of its own per dtype, with its backward's bound, and so
    is K1's backward), the nvidia-smi line, and `{"ok": true, ...}`
    last.

Every record carries `at_s`, the seconds since the script started.

Any mismatch beyond the stated tolerance raises and the script exits
non-zero.  Without a CUDA card, or without the package beside it, it exits
non-zero and prints no result.  Times come from CUDA events after warm-up.
"""
from __future__ import annotations

import argparse
import copy
import dataclasses
import json
import os
import shutil
import subprocess
import sys
import tempfile
import threading
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
SMALL_FRAMES = 2              # of the small scene: one frame with a carry
VIDEO_FRAMES = 4              # frames of a scene (the published scenes: 6)
VIDEO_BATCH = 120             # tiles of two 1080p scenes in one frame step
TRAIN_BATCH = (8, 2, 256)      # samples, frames a sample, frame size
TRAIN_FRAMES = TRAIN_BATCH[0] * TRAIN_BATCH[1]
TRAINER_ITEMS = 160            # samples of the trainer phase's epochs
# the video generator's trainer epochs: 10 steps (20 before the train_bf16
# and options phases came, cut to pay for them)
TRAINER_VIDEO_ITEMS = 80
# the batches the training step gives the kernels: all 16 frames at once
# (image generator) and one frame of every sample (video generator)
TRAIN_KERNEL_BATCHES = (TRAIN_FRAMES, TRAIN_BATCH[0])
# K1's gradient kernel: float32 bit for bit; bfloat16 bit for bit as well
# (every step rounds where the plain version rounds)
# K2 under autograd against autograd of the plain version (float32).  The
# kernel's output differs from cuDNN's in the last bits, so of millions of
# outputs a few within 1e-6 of zero fall on the other side of the relu; each
# such entry adds or removes a whole term of every gradient (one of the 52
# thousand that a weight gradient of `down1` sums, one of a few hundred
# under a 5x5 patch of dx).  So the Function's formula is held tightly with
# the plain version's own output as its `y` (no flip possible), and the
# Function end to end in the L2 norm, entry by entry only to 5e-2.
K2_FORMULA_TOL = 1e-4          # of max-abs, same relu mask on both sides
K2_GRAD_L2_TOL = 2e-3          # end to end, relative L2 error
K2_GRAD_MAX_TOL = 5e-2         # end to end, entry by entry, of max-abs
# card vs CPU at 112 x 112: float32 sums in another order.  The encoder
# cells behind a skip (`inc`, `down0..2`) get their gradient through
# 0.5 / sqrt(x2 + 1e-8) of the skip concat, which is in the thousands for the
# few dozen activations below 1e-6; one such activation that comes out as
# 1.2e-7 on one side and 5e-8 on the other moves a gradient by a quarter of
# its scale.  `scripts/encoder_grad_probe.py` finds those entries: over
# seeds 0..3 the worst encoder moment differs by 5e-3 to 0.7 of its max-abs
# between the card and the CPU, each time through one or two activations.
# So this comparison runs at a fixed seed whose draw has no such entry of
# weight (seed 3: 0.030 / 0.061 of max-abs and 0.015 / 0.024 in L2 for the
# image / video generator), is held there to twice those figures, and is
# held strictly with the concat's epsilon at 1e-2, where the factor is at
# most 5 and every parameter meets the common tolerance.
REF_SEED = 3
REF_LOG_RTOL = 1e-3
REF_GRAD_LOG_RTOL = 1e-2
REF_D_TOL = 1e-3               # exp_avg, of its max-abs
REF_G_TOL = 1e-2
REF_ENCODER_L2_TOL = 5e-2      # published epsilon: relative L2 of exp_avg
REF_ENCODER_MAX_TOL = 0.15     # and entry by entry, of its max-abs
REF_ENCODER_LOG_RTOL = 5e-2
ENCODER = ("inc.", "down_path.0.", "down_path.1.", "down_path.2.")
# bfloat16 training against the float32 step from the same state, batch
# and drop path (tests/test_torch_bf16_train.py measures 1e-5 to 2.7e-2 on
# the losses and 1.9e-3 on the fake on the CPU): losses and the fake's
# statistics relative, the fake of a forward in relative L2
BF16_LOG_RTOL = 5e-2
BF16_FAKE_L2_TOL = 3e-2
# K2 under autograd in bfloat16 against autograd of the plain version in
# bfloat16, end to end: both backwards are cuDNN's bf16 convolutions, so
# they differ by the forwards' rounding (2^-8 of an element) and the relu
# flips it causes; relative L2
K2_BF16_GRAD_L2_TOL = 5e-2
# a batch-norm generator's running statistics, card against CPU, of
# (1 + |value|): after one step at the published epsilon (both statistics
# updates of a step are forwards of the same parameters, so only float32
# sums differ), and after three steps with the skip concat's epsilon at
# 1e-2, as `train_reference` holds the parameters (at 1e-8 the encoder's
# first Adam steps follow gradients that differ by up to 0.7 of their
# max-abs between the card and the CPU, and the statistics behind them by
# 1.2e-3 on an H100 80GB HBM3); what is left is the +-lr Adam noise of
# gradients at rounding level (the pre-norm conv biases', whose true
# gradient is 0) and the GCN's choice between near-tied neighbours
BN_STATS_STEP_TOL = 1e-5
# measured 1.30e-4 to 1.44e-4 on an H100 80GB HBM3; a step that moves the
# statistics once instead of twice reads 0.28 (CPU against CPU, the same
# three steps)
BN_STATS_TOL = 1e-3
BN_FRAME_TILES = 4             # of the 1080p chunk, card vs CPU
# K2 under autograd in bfloat16: the backward formula on the plain
# version's own output (no relu flip possible) against autograd of plain,
# relative L2; end to end the kernel's y flips relus near zero (3.2e-2 to
# 4.5e-2 in relative L2 on an H100 80GB HBM3)
K2_BF16_FORMULA_L2_TOL = 1e-2
LOG: list = []
T0 = time.perf_counter()


def emit(phase: str, **kw) -> None:
    rec = {"phase": phase, "at_s": round(time.perf_counter() - T0, 1), **kw}
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


def phase_first_launches(torch):
    """Triton's compile of K1's two kernels (float32; the bfloat16 variants
    compile in their phases), while nvcc builds K2 in a thread."""
    import threading
    from uncltmo_tpu_torch.ops.kernels.concat_skip import (
        fused_concat_skip, fused_concat_skip_backward)
    failed = []

    def build():
        try:
            phase_build()
        except BaseException as exc:        # raised again below
            failed.append(exc)

    nvcc_thread = threading.Thread(target=build)
    nvcc_thread.start()
    t0 = time.perf_counter()
    x = torch.rand(1, 4, 8, 8, device="cuda")
    out = fused_concat_skip(x, x)
    fused_concat_skip_backward(x, out)
    torch.cuda.synchronize()
    emit("build", kernel="fused_concat_skip", route="triton",
         first_launch_seconds=time.perf_counter() - t0)
    nvcc_thread.join()
    if failed:
        raise failed[0]


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
    video path (B = 120 tiles), the whole-image path (B = 1 planes) and
    the training step (B = 16 and B = 8 frames) give them."""
    g = torch.Generator(device="cuda").manual_seed(4)
    k2_planes, k1_planes = whole_image_planes(*FRAME_HW)
    batches = (VIDEO_BATCH,) + TRAIN_KERNEL_BATCHES
    k1_shapes = ([(b, c, s, s) for b in batches for c, s in K1_SHAPES]
                 + [(1, c, h, w) for c, h, w in k1_planes])
    k2_shapes = ([(n, b, cin, c1, c2, s, s) for b in batches
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


def phase_video(torch, dtypes, seed, scenes):
    """Two synthetic scenes, written into `scenes` (the tester phase reads
    them again), through `run_on_video_path` with `scene_batch` 1 and 2; a
    small scene on the card against the CPU runner.  The first float32
    1080p render is copied beside `scenes` as `VIDEO_RENDER` (the
    assessment phase scores it).  Returns the launch counts and the
    scenes' lambdas."""
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
        small = os.path.join(tmp, "small")
        scene_lams = write_scenes(scenes, rng, ["scene_a", "scene_b"],
                                  VIDEO_FRAMES, FRAME_HW)
        lams = dict(scene_lams)
        lams.update(write_scenes(small, rng, ["small"], SMALL_FRAMES,
                                 SMALL_HW))
        lam = os.path.join(tmp, "lambdas.npy")
        np.save(lam, lams)
        n_frames = 2 * VIDEO_FRAMES
        loaded = stacks = None
        for dname, dtype in dtypes.items():
            runner = InferenceRunner(mp, None, video=True, state_dict=state,
                                     dtype=dtype, device="cuda")
            # the image phase warmed the 60-tile forward; this warms the
            # carry's kernels
            runner.run_on_video_path(small, os.path.join(tmp, "warm"), lam)
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
            # blend, then the per-frame postprocess (CUDA events); the
            # preprocessing does not depend on the dtype, so both dtypes
            # time the scenes loaded once
            if loaded is None:
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
            ms_sb1 = time_ms(lambda: run_scenes([0]), iters=2, warmup=1)
            ms_sb2 = time_ms(lambda: run_scenes([0, 1]), iters=2, warmup=1)
            peak_gb = torch.cuda.max_memory_allocated() / 1e9
            carry = carry_cost(torch, dname, runner)
            profile_call(torch, dname, lambda: run_scenes([0]),
                         path="video_scene_batch_1")
            shapes = [read_png(p).shape for p in outs[1] + outs[2]]
            if dname == "float32":
                shutil.copy(outs[1][0], os.path.join(
                    os.path.dirname(scenes), VIDEO_RENDER))
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
            del runner
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
        if (len(pngs["cuda"]) != SMALL_FRAMES
                or len(pngs["cpu"]) != SMALL_FRAMES or diff > 1):
            raise AssertionError(f"video, card vs CPU runner: {diff} levels "
                                 "apart")
    return launches, scene_lams


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


def phase_k1_backward(torch, dtypes):
    """K1's gradient kernel against `concat_skip_backward_plain` at the
    shapes the training step gives it, timed: 16 frames at once (the image
    generator; the rows returned) and 8 (a frame step of the video
    generator, and a rank's image batch in `data_parallel`)."""
    from uncltmo_tpu_torch.ops.kernels.concat_skip import (
        concat_skip_backward_plain, fused_concat_skip_backward)
    g = torch.Generator(device="cuda").manual_seed(6)
    rows = {d: [] for d in dtypes}
    for batch in TRAIN_KERNEL_BATCHES:
        for dname, dtype in dtypes.items():
            for c, s in K1_SHAPES:
                shape = (batch, c, s, s)
                # a skip as the encoder makes it: post-relu, half of it zero
                x2 = torch.relu(torch.randn(shape, generator=g,
                                            device="cuda")).to(dtype)
                gout = torch.randn((batch, 4 * c, s, s), generator=g,
                                   device="cuda").to(dtype)
                dx2, dx1 = fused_concat_skip_backward(x2, gout)
                ref2, ref1 = concat_skip_backward_plain(x2, gout)
                torch.cuda.synchronize()
                err = (dx2.float() - ref2.float()).abs().max().item()
                exact = bool(torch.equal(dx2, ref2)
                             and torch.equal(dx1, ref1))
                if not exact:
                    raise AssertionError(f"K1 backward {dname} {shape}: max "
                                         f"err {err} (must be bit-exact)")
                row = dict(dtype=dname, shape=list(shape), max_abs_err=err,
                           bit_exact=exact,
                           zero_share=(x2 == 0).float().mean().item())
                ms = time_ms(lambda: fused_concat_skip_backward(x2, gout))
                plain = time_ms(lambda: concat_skip_backward_plain(x2, gout))
                # reads x2 and three slabs of g, writes dx2; dx1 is a view
                nbytes = 5 * x2.numel() * x2.element_size()
                bms, by = bound_ms(nbytes, 7 * x2.numel(), dname)
                row.update(ms=ms, plain_ms=plain, bytes=nbytes,
                           bound_ms=bms, bound_by=by)
                if batch == TRAIN_FRAMES:
                    rows[dname].append(row)
                emit("k1_backward", **row)
                del x2, gout, dx2, ref2
    return rows


def k2_autograd_check(torch, g, name, cin, c1, c2, s, batch):
    """`fused_double_conv3x3` under autograd against autograd of the plain
    version at one cell and batch; raises beyond the tolerances.  Returns
    what the timings need and the errors."""
    from uncltmo_tpu_torch.ops.kernels.double_conv import (
        double_conv3x3_backward, double_conv3x3_plain, fused_double_conv3x3,
        pack_double_conv_weights)
    args = k2_inputs(torch, g, torch.float32, batch, cin, c1, c2, s, s)
    need_dx = name != "inc"            # `inc` reads the batch itself

    def leaves():
        return [a.clone().requires_grad_(i > 0 or need_dx)
                for i, a in enumerate(args)]

    mine, ref = leaves(), leaves()
    packed = pack_double_conv_weights(*args[1:])
    y = fused_double_conv3x3(*mine, packed=packed)
    y_ref = double_conv3x3_plain(*ref)
    gy = torch.randn(y.shape, generator=g, device="cuda")
    wanted = [t for t in mine if t.requires_grad]
    wanted_ref = [t for t in ref if t.requires_grad]
    got = torch.autograd.grad(y, wanted, gy, retain_graph=True)
    want = torch.autograd.grad(y_ref, wanted_ref, gy, retain_graph=True)
    torch.cuda.synchronize()
    names = (["dx"] if need_dx else []) + ["dw1", "db1", "dw2", "db2"]
    y_err = (y - y_ref).abs().max().item()
    errs = {"y": y_err / y_ref.abs().max().item()}
    l2 = {}
    for n, a, b in zip(names, got, want):
        errs[n] = ((a - b).abs().max() / b.abs().max()).item()
        l2[n] = ((a - b).norm() / b.norm()).item()
    flips = int(((y > 0) != (y_ref > 0)).sum())
    # the backward formula alone, on the plain version's own output
    formula = double_conv3x3_backward(*args, y_ref.detach(), gy,
                                      need_dx=need_dx)
    formula_err = {n: ((a - b).abs().max() / b.abs().max()).item()
                   for n, a, b in zip(
                       names, [t for t in formula if t is not None], want)}
    if (errs["y"] > K2_TOL["float32"]
            or any(v > K2_FORMULA_TOL for v in formula_err.values())
            or any(v > K2_GRAD_L2_TOL for v in l2.values())
            or any(v > K2_GRAD_MAX_TOL
                   for k, v in errs.items() if k != "y")):
        raise AssertionError(
            f"K2 autograd {name} B={batch}: formula {formula_err}, end to "
            f"end max {errs}, l2 {l2}, {flips} relu flips")
    row = dict(cell=name, shape=list(args[0].shape), y_max_abs_err=y_err,
               rel_err=errs, rel_l2_err=l2, relu_flips=flips,
               formula_rel_err=formula_err, outputs=y.numel())
    return row, (args, mine, ref, packed, y, y_ref, gy, wanted, wanted_ref)


def k2_autograd_times(torch, held, name, cin, c1, c2, s, batch) -> dict:
    """Forward and backward ms of K2's Function and of autograd of the
    plain version, cuDNN's forward and the weight packing, beside their
    bounds, on the tensors `k2_autograd_check` built."""
    import torch.nn.functional as F
    from uncltmo_tpu_torch.ops.kernels.double_conv import (
        double_conv3x3_plain, fused_double_conv3x3, pack_double_conv_weights)
    args, mine, ref, packed, y, y_ref, gy, wanted, wanted_ref = held
    x, w1, b1, w2, b2 = args
    with torch.no_grad():
        fwd_nograd = time_ms(lambda: fused_double_conv3x3(
            *args, packed=packed))

        def cudnn():
            F.relu_(F.conv2d(F.relu_(F.conv2d(x, w1, b1)), w2, b2))
        library = time_ms(cudnn)
    fwd = time_ms(lambda: fused_double_conv3x3(*mine, packed=packed))
    bwd = time_ms(lambda: torch.autograd.grad(y, wanted, gy,
                                              retain_graph=True))
    plain_fwd = time_ms(lambda: double_conv3x3_plain(*ref))
    plain_bwd = time_ms(lambda: torch.autograd.grad(
        y_ref, wanted_ref, gy, retain_graph=True))
    pack = time_ms(lambda: pack_double_conv_weights(*args[1:]))
    # the forward's bound, as in the k2 phase
    flops = 2 * 9 * batch * (cin * c1 * (s - 2) ** 2
                             + c1 * c2 * (s - 4) ** 2)
    nbytes = (x.numel() + y.numel() + w1.numel() + w2.numel()
              + c1 + c2) * x.element_size()
    bms, by = bound_ms(nbytes, flops, "float32")
    # the backward's least time: the wgrad of both cells, conv2's dgrad,
    # and conv1's dgrad where dx is needed, each as many flops as its
    # forward, at the float32 peak.  The recompute of conv1 in
    # `double_conv3x3_backward` is the port's own cost, not the
    # gradient's, and is left out
    conv1 = 2 * 9 * batch * cin * c1 * (s - 2) ** 2
    conv2 = 2 * 9 * batch * c1 * c2 * (s - 4) ** 2
    bwd_flops = conv1 * (2 if name != "inc" else 1) + 2 * conv2
    return dict(forward_ms=fwd, forward_ms_no_grad=fwd_nograd,
                backward_ms=bwd, plain_forward_ms=plain_fwd,
                plain_autograd_backward_ms=plain_bwd, pack_ms=pack,
                library_forward_ms=library, flops=flops, bound_ms=bms,
                bound_by=by, backward_flops=bwd_flops,
                backward_bound_ms=bwd_flops / PEAK_FLOPS["float32"] * 1e3)


def phase_k2_autograd(torch):
    """`fused_double_conv3x3` under autograd (the kernel forward, library
    gradients backward) against autograd of the plain version, float32, at
    the shapes the training step gives it, timed: 16 frames at once (the
    rows returned) and 8 (a frame step of the video generator, and a
    rank's image batch in `data_parallel`)."""
    g = torch.Generator(device="cuda").manual_seed(7)
    rows = []
    for name, cin, c1, c2, s in K2_SHAPES:
        for batch in (TRAIN_FRAMES, TRAIN_BATCH[0]):
            row, held = k2_autograd_check(torch, g, name, cin, c1, c2, s,
                                          batch)
            row.update(k2_autograd_times(torch, held, name, cin, c1, c2, s,
                                         batch))
            if batch == TRAIN_FRAMES:
                rows.append(row)
            emit("k2_autograd", batch=batch, **row)
            del held
            torch.cuda.empty_cache()
    return rows


def train_counts() -> dict:
    from uncltmo_tpu_torch.ops.kernels.concat_skip import fused_concat_skip
    from uncltmo_tpu_torch.ops.kernels.double_conv import fused_double_conv3x3
    return {"fused_concat_skip": fused_concat_skip.launches,
            "fused_concat_skip_backward": fused_concat_skip.backward_launches,
            "fused_double_conv3x3": fused_double_conv3x3.launches,
            "fused_double_conv3x3_backward_calls":
                fused_double_conv3x3.backward_calls}


def reset_train_counts() -> None:
    from uncltmo_tpu_torch.ops.kernels.concat_skip import fused_concat_skip
    from uncltmo_tpu_torch.ops.kernels.double_conv import fused_double_conv3x3
    reset_counts()
    fused_concat_skip.backward_launches = 0
    fused_double_conv3x3.backward_calls = 0


def synthetic_batch(rng, b: int, size: int) -> dict:
    """A training batch in the pipeline's layout: lambda-log HDR luma and
    two LDR lumas in [0, 1], (B, 2, H, W, 1), smooth scenes plus noise at
    a brightness of their own."""
    import numpy as np
    yy, xx = np.mgrid[0:size, 0:size].astype(np.float32) / size
    out = {}
    for key, gamma in (("hdr", 1.0), ("ldr_pos", 1.0), ("ldr_neg", 3.0)):
        f = rng.uniform(2.0, 9.0, (b, 2, 2, 1, 1)).astype(np.float32)
        level = rng.uniform(0.15, 0.7, (b, 2, 1, 1)).astype(np.float32)
        img = (level + 0.2 * np.sin(f[:, :, 0] * xx + f[:, :, 1] * yy)
               + 0.08 * rng.standard_normal((b, 2, size, size)))
        out[key] = (np.clip(img, 0.0, 1.0) ** gamma)[..., None].astype(
            np.float32)
    return out


def build_trainer(torch, seed, video, device, size=256, grid=None,
                  dtype=None, **gen_options):
    """A seeded generator (`UNetTMO(**gen_options)`) and discriminator and
    the training step over them in `dtype` (float32 when None)."""
    from uncltmo_tpu_torch import params
    from uncltmo_tpu_torch.models.discriminator import SimpleDiscriminator
    from uncltmo_tpu_torch.models.unet import UNetTMO, seeded_init_
    from uncltmo_tpu_torch.training.state import TrainState
    from uncltmo_tpu_torch.training.train_step import (LossConfig,
                                                       make_train_step)
    gen = seeded_init_(UNetTMO(gcn_grid=grid or params.GCN_GRID,
                               **gen_options), seed)
    disc = seeded_init_(SimpleDiscriminator(input_size=size), seed + 1)
    step = make_train_step(gen, disc, LossConfig(video=video), device=device,
                           compute_dtype=dtype or torch.float32)
    return step, TrainState.create(gen, disc)


def check_step(torch, tag, state, logs, before, pretrain) -> None:
    """Finite logs; every parameter of D (and of G after a full step) has
    a finite gradient that is not all zero and a changed value."""
    bad = [k for k, v in logs.items() if not torch.isfinite(v).all()]
    if bad:
        raise AssertionError(f"train {tag}: logs not finite: {bad}")
    groups = [("D", state.disc)] + ([] if pretrain else [("G", state.gen)])
    for gname, module in groups:
        for name, p in module.named_parameters():
            if gname == "D" and name == "model.4.bias":
                continue       # a common shift of all logits: gradient 0
            g = p.grad
            if (g is None or not torch.isfinite(g).all()
                    or not bool(g.abs().sum() > 0)
                    or torch.equal(p.detach(), before[gname][name])):
                raise AssertionError(
                    f"train {tag}: {gname}.{name} got no gradient or did "
                    "not move")


def snapshot(state) -> dict:
    return {"D": {n: p.detach().clone()
                  for n, p in state.disc.named_parameters()},
            "G": {n: p.detach().clone()
                  for n, p in state.gen.named_parameters()}}


# one forward of either generator (a sample grid, B = 2): K1 in the four Up
# blocks, K2 in `inc` and `down0..2`
GRID_FORWARD = {"fused_concat_skip": 4, "fused_double_conv3x3": 4}


def train_per_step(video: bool) -> dict:
    """Kernel launches of one full training step (none in a D pre-train
    step): K1 and K2 in each of the two generator forwards, K1's gradient
    and K2's library gradient in the backward; twice over for the video
    generator's two frame steps."""
    n = 2 if video else 1
    return {"fused_concat_skip": 8 * n, "fused_concat_skip_backward": 4 * n,
            "fused_double_conv3x3": 8 * n,
            "fused_double_conv3x3_backward_calls": 4 * n}


def phase_train(torch, seed):
    """A few steps of the GAN training step at full width for the image
    and the video generator; returns the kernels' launch counts and the
    step ms by stage of each generator."""
    import numpy as np
    b, _, size = TRAIN_BATCH
    g_lr, d_lr = 1e-5, 1.5e-5          # scripts/run_imageTMO_train.sh
    # one warm step per stage (two at stage 0); the first pre-train and the
    # first stage-0 step warm up; the trainer phase gives the steady
    # stage-0 time over 20 steps
    plan = [("pretrain", 0, True), ("pretrain", 0, True), ("stage0", 0, False),
            ("stage0", 0, False), ("stage0", 0, False), ("stage1", 1, False),
            ("stage2", 2, False)]
    warmups = (0, 2)
    total, stage_ms = {}, {}
    for video in (False, True):
        path = "video" if video else "image"
        rng = np.random.default_rng(seed + 10 + int(video))
        step, state = build_trainer(torch, seed, video, "cuda", size=size)
        generator = torch.Generator(device="cuda").manual_seed(seed)
        batches = [synthetic_batch(rng, b, size) for _ in range(3)]
        per_step = train_per_step(video)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_train_counts()
        ms, last_logs = {}, {}
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        for i, (tag, stage, pretrain) in enumerate(plan):
            before = snapshot(state)
            n0 = train_counts()
            start.record()
            state, logs = step(state, batches[i % 3], generator, g_lr, d_lr,
                               stage=stage, pretrain=pretrain)
            end.record()
            torch.cuda.synchronize()
            check_step(torch, f"{path} {tag}", state, logs, before, pretrain)
            n1 = train_counts()
            want = {k: 0 if pretrain else v for k, v in per_step.items()}
            got = {k: n1[k] - n0[k] for k in n1}
            if got != want:
                raise AssertionError(f"train {path} {tag}: launches {got}, "
                                     f"expected {want}")
            if i not in warmups:
                ms.setdefault(tag, []).append(start.elapsed_time(end))
            last_logs[tag] = {k: float(v) for k, v in logs.items()}
        counts = train_counts()
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        if state.step != len(plan):
            raise AssertionError(f"train {path}: step count {state.step}")
        inc_grad = state.gen.inc.conv.conv.weight.grad.abs().mean().item()
        if not inc_grad > 0:
            raise AssertionError(f"train {path}: inc.conv.conv.weight has "
                                 "no gradient (it sits behind K2)")
        # device time of a warm stage-0 step by kernel (not counted above)
        profile_call(torch, "float32", lambda: step(
            state, batches[0], generator, g_lr, d_lr, stage=0),
            path=f"train_{path}_stage0", top=14)
        emit("train", generator=path, dtype="float32",
             batch=list(TRAIN_BATCH), steps=[t for t, _, _ in plan],
             step_ms={k: sum(v) / len(v) for k, v in ms.items()},
             launches=counts, launches_per_step=per_step,
             peak_memory_gb=peak_gb,
             inc_conv_conv_weight_mean_abs_grad=inc_grad,
             state_step=state.step, logs=last_logs)
        for k, v in counts.items():
            total[k] = total.get(k, 0) + v
        stage_ms[path] = {k: sum(v) / len(v) for k, v in ms.items()}
        del step, state, batches
        torch.cuda.empty_cache()
    return total, stage_ms


def phase_train_reference(torch):
    """One stage-0 step at 112 x 112 (GCN grid 3, B = 2) on the card against
    the same step on the CPU, from one seed (`REF_SEED`) and with the same
    drop path masks: at the published epsilon, and with the skip concat's
    epsilon at 1e-2, where its gradient has no singularity and every
    parameter is held to the common tolerance."""
    import numpy as np
    from uncltmo_tpu_torch import params
    size, b, seed = 112, 2, REF_SEED
    published = params.EPSILON
    for video in (False, True):
        for eps in (published, 1e-2):
            params.EPSILON = eps
            try:
                sides = {}
                for dev in ("cuda", "cpu"):
                    rng = np.random.default_rng(seed + 20)
                    step, state = build_trainer(torch, seed, video, dev,
                                                size=size, grid=3)
                    n = b if video else 2 * b
                    masks = [torch.ones(n) for _ in range(8)]
                    masks[1][0] = 0.0                # drops a sample
                    state, logs = step(state, synthetic_batch(rng, b, size),
                                       torch.Generator(), 1e-5, 1.5e-5,
                                       stage=0, drop_masks=iter(masks))
                    sides[dev] = (state, {k: float(v)
                                          for k, v in logs.items()})
            finally:
                params.EPSILON = published
            (card, logs), (cpu, ref_logs) = sides["cuda"], sides["cpu"]
            strict = eps != published
            worst = {"D": 0.0, "G": 0.0, "G_encoder": 0.0}
            encoder_l2, worst_name = 0.0, None
            for gname, a, c, opt_a, opt_c in (
                    ("D", card.disc, cpu.disc, card.opt_D, cpu.opt_D),
                    ("G", card.gen, cpu.gen, card.opt_G, cpu.opt_G)):
                for (name, pa), pc in zip(a.named_parameters(),
                                          c.parameters()):
                    if name == "model.4.bias":
                        continue
                    ma = opt_a.state[pa]["exp_avg"].cpu()
                    mc = opt_c.state[pc]["exp_avg"]
                    rel = ((ma - mc).abs().max() / mc.abs().max()).item()
                    key = gname
                    if gname == "G" and name.startswith(ENCODER):
                        key = "G_encoder"
                        encoder_l2 = max(encoder_l2, ((ma - mc).norm()
                                                      / mc.norm()).item())
                        if rel > worst[key]:
                            worst_name = name
                    worst[key] = max(worst[key], rel)
            log_err = {k: abs(logs[k] - ref_logs[k])
                       / max(abs(ref_logs[k]), 1e-30) for k in ref_logs
                       if abs(ref_logs[k]) > 1e-12}
            enc_logs = ("gradG/inc", "gradG/down0", "gradG/down1",
                        "gradG/down2")
            emit("train_reference", generator="video" if video else "image",
                 seed=seed, epsilon=eps, size=size, batch=b,
                 exp_avg_max_rel_err=worst,
                 encoder_exp_avg_rel_l2_err=encoder_l2,
                 encoder_worst_parameter=worst_name,
                 log_max_rel_err=max(v for k, v in log_err.items()
                                     if not k.startswith("gradG/")),
                 grad_log_max_rel_err=max(
                     v for k, v in log_err.items()
                     if k.startswith("gradG/") and k not in enc_logs),
                 encoder_grad_log_max_rel_err=max(log_err[k]
                                                  for k in enc_logs))
            for k, v in log_err.items():
                lim = (REF_LOG_RTOL if not k.startswith("gradG/")
                       else REF_GRAD_LOG_RTOL if strict or k not in enc_logs
                       else REF_ENCODER_LOG_RTOL)
                if not v <= lim:
                    raise AssertionError(
                        f"train card vs CPU (eps {eps}): log {k} {logs[k]} "
                        f"vs {ref_logs[k]}")
            limits = {"D": REF_D_TOL, "G": REF_G_TOL,
                      "G_encoder": REF_G_TOL if strict
                      else REF_ENCODER_MAX_TOL}
            for k, v in worst.items():
                if not v <= limits[k]:
                    raise AssertionError(
                        f"train card vs CPU (eps {eps}): exp_avg of {k} "
                        f"differs by {v} of its max-abs")
            if not encoder_l2 <= (REF_G_TOL if strict
                                  else REF_ENCODER_L2_TOL):
                raise AssertionError(
                    f"train card vs CPU (eps {eps}): exp_avg of the encoder "
                    f"differs by {encoder_l2} in relative L2")


def phase_k2_autograd_bf16(torch):
    """`fused_double_conv3x3` under autograd in bfloat16 (the kernel
    forward, library gradients in bfloat16 backward) against autograd of
    the plain version in bfloat16, at the training batch (B = 16), timed:
    the shapes and dtype a bfloat16 training step gives it."""
    import torch.nn.functional as F
    from uncltmo_tpu_torch.ops.kernels.double_conv import (
        double_conv3x3_backward, double_conv3x3_plain, fused_double_conv3x3,
        pack_double_conv_weights)
    g = torch.Generator(device="cuda").manual_seed(8)
    rows = []
    for name, cin, c1, c2, s in K2_SHAPES:
        args = k2_inputs(torch, g, torch.bfloat16, TRAIN_FRAMES, cin, c1, c2,
                         s, s)
        need_dx = name != "inc"
        mine = [a.clone().requires_grad_(i > 0 or need_dx)
                for i, a in enumerate(args)]
        ref = [a.clone().requires_grad_(i > 0 or need_dx)
               for i, a in enumerate(args)]
        packed = pack_double_conv_weights(*args[1:])
        y = fused_double_conv3x3(*mine, packed=packed)
        y_ref = double_conv3x3_plain(*ref)
        gy = torch.randn(y.shape, generator=g, device="cuda").to(y.dtype)
        wanted = [t for t in mine if t.requires_grad]
        wanted_ref = [t for t in ref if t.requires_grad]
        got = torch.autograd.grad(y, wanted, gy, retain_graph=True)
        want = torch.autograd.grad(y_ref, wanted_ref, gy, retain_graph=True)
        torch.cuda.synchronize()
        names = (["dx"] if need_dx else []) + ["dw1", "db1", "dw2", "db2"]
        y_err = (y.float() - y_ref.float()).abs().max().item()
        y_rel = y_err / y_ref.float().abs().max().item()
        def rel_l2(pairs):
            return {n: ((a.float() - b.float()).norm()
                        / b.float().norm()).item() for n, a, b in pairs}
        l2 = rel_l2(zip(names, got, want))
        formula = double_conv3x3_backward(*args, y_ref.detach(), gy,
                                          need_dx=need_dx)
        formula_l2 = rel_l2(zip(names, [t for t in formula if t is not None],
                                want))
        if not (y_rel <= K2_TOL["bfloat16"]
                and all(v <= K2_BF16_GRAD_L2_TOL for v in l2.values())
                and all(v <= K2_BF16_FORMULA_L2_TOL
                        for v in formula_l2.values())):
            raise AssertionError(f"K2 autograd bfloat16 {name}: y {y_rel}, "
                                 f"gradients (relative L2) {l2}, formula "
                                 f"{formula_l2}")
        x, w1, b1, w2, b2 = args
        with torch.no_grad():
            def cudnn():
                F.relu_(F.conv2d(F.relu_(F.conv2d(x, w1, b1)), w2, b2))
            library = time_ms(cudnn)
        fwd = time_ms(lambda: fused_double_conv3x3(*mine, packed=packed))
        bwd = time_ms(lambda: torch.autograd.grad(y, wanted, gy,
                                                  retain_graph=True))
        plain_fwd = time_ms(lambda: double_conv3x3_plain(*ref))
        plain_bwd = time_ms(lambda: torch.autograd.grad(
            y_ref, wanted_ref, gy, retain_graph=True))
        conv1 = 2 * 9 * TRAIN_FRAMES * cin * c1 * (s - 2) ** 2
        conv2 = 2 * 9 * TRAIN_FRAMES * c1 * c2 * (s - 4) ** 2
        nbytes = (x.numel() + y.numel() + w1.numel() + w2.numel()
                  + c1 + c2) * x.element_size()
        bms, by = bound_ms(nbytes, conv1 + conv2, "bfloat16")
        # as in f32: the gradient's own operations, no recompute of conv1
        bwd_flops = conv1 * (2 if need_dx else 1) + 2 * conv2
        row = dict(cell=name, dtype="bfloat16", shape=list(x.shape),
                   y_max_abs_err=y_err, y_rel_err=y_rel, rel_l2_err=l2,
                   formula_rel_l2_err=formula_l2,
                   forward_ms=fwd, backward_ms=bwd,
                   plain_forward_ms=plain_fwd,
                   plain_autograd_backward_ms=plain_bwd,
                   library_forward_ms=library, flops=conv1 + conv2,
                   bound_ms=bms, bound_by=by, backward_flops=bwd_flops,
                   backward_bound_ms=bwd_flops / PEAK_FLOPS["bfloat16"]
                   * 1e3)
        rows.append(row)
        emit("k2_autograd", **row)
        del args, mine, ref, y, y_ref, gy, wanted, wanted_ref, got, want
        torch.cuda.empty_cache()
    return rows


class LaunchDtypes:
    """Records the dtype (or another attribute, `what`) of the first
    tensor of every launch of K1 (forward and backward) and of every call
    of K2's forward kernel and library backward while it is entered, by
    wrapping the functions that launch them: the values seen, and launches
    by value."""

    def __init__(self, what: str = "dtype"):
        self.what = what
        self.seen = {}
        self.counts = {}

    def __enter__(self):
        from uncltmo_tpu_torch.ops.kernels import _concat_skip_triton as k1
        from uncltmo_tpu_torch.ops.kernels import double_conv as k2
        self._saved = []
        for mod, name, key in ((k1, "launch", "fused_concat_skip"),
                               (k1, "launch_backward",
                                "fused_concat_skip_backward"),
                               (k2, "_launch", "fused_double_conv3x3"),
                               (k2, "double_conv3x3_backward",
                                "fused_double_conv3x3_backward_calls")):
            fn = getattr(mod, name)
            self._saved.append((mod, name, fn))

            def wrapped(x, *a, _fn=fn, _key=key, **kw):
                v = str(getattr(x, self.what))
                self.seen.setdefault(_key, set()).add(v)
                by = self.counts.setdefault(_key, {})
                by[v] = by.get(v, 0) + 1
                return _fn(x, *a, **kw)
            setattr(mod, name, wrapped)
        return self

    def __exit__(self, *exc):
        for mod, name, fn in self._saved:
            setattr(mod, name, fn)


def generator_fake(torch, gen, hdr_btchw, video, dtype):
    """A deterministic forward of the generator on the step's batch, under
    autocast for bfloat16: the fake, float32, (B*T, 1, H, W)."""
    from uncltmo_tpu_torch.models.unet import video_apply
    ctx = (torch.autocast("cuda", dtype=dtype) if dtype != torch.float32
           else torch.autocast("cuda", enabled=False))
    with torch.no_grad(), ctx:
        x = hdr_btchw.to(dtype)
        if video:
            out, _ = video_apply(gen, x, with_features=False)
        else:
            out, _ = gen(x.reshape((-1,) + tuple(x.shape[2:])))
    return out.float().reshape(-1, 1, *out.shape[-2:])


def phase_train_bf16(torch, seed, f32_ms):
    """bfloat16 training (`compute_dtype=torch.bfloat16`: the batch as
    bfloat16, G's and D's forwards and the losses under autocast, float32
    parameters and Adam states) for the image and the video generator at
    the published batch, stages 0-2.  The first step is held against the
    float32 step from the same state, batch and drop path (losses and the
    fake's statistics), and a forward's fake against the float32 forward;
    then step ms by CUDA events beside the float32 phase's, launches per
    step (all in bfloat16), peak memory and a profile of a stage-0 step.
    Returns the launch counts."""
    import numpy as np
    b, _, size = TRAIN_BATCH
    g_lr, d_lr = 1e-5, 1.5e-5
    plan = [("stage0", 0), ("stage0", 0), ("stage0", 0), ("stage1", 1),
            ("stage2", 2)]
    total = {}
    for video in (False, True):
        path = "video" if video else "image"
        rng = np.random.default_rng(seed + 10 + int(video))
        batches = [synthetic_batch(rng, b, size) for _ in range(3)]
        ref_step, ref_state = build_trainer(torch, seed, video, "cuda",
                                            size=size)
        step, state = build_trainer(torch, seed, video, "cuda", size=size,
                                    dtype=torch.bfloat16)
        hdr = torch.from_numpy(batches[0]["hdr"]).cuda().permute(
            0, 1, 4, 2, 3)
        fake32 = generator_fake(torch, ref_state.gen, hdr, video,
                                torch.float32)
        fake16 = generator_fake(torch, state.gen, hdr, video, torch.bfloat16)
        fake_l2 = ((fake16 - fake32).norm() / fake32.norm()).item()
        _, ref_logs = ref_step(ref_state, batches[0], torch.Generator(
            device="cuda").manual_seed(seed), g_lr, d_lr, stage=0)
        ref_logs = {k: float(v) for k, v in ref_logs.items()}
        del ref_step, ref_state
        torch.cuda.empty_cache()
        per_step = train_per_step(video)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_train_counts()
        ms, vs_f32 = {}, {}
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        with LaunchDtypes() as dtypes:
            for i, (tag, stage) in enumerate(plan):
                before = snapshot(state)
                n0 = train_counts()
                start.record()
                state, logs = step(state, batches[i % 3], torch.Generator(
                    device="cuda").manual_seed(seed), g_lr, d_lr, stage=stage)
                end.record()
                torch.cuda.synchronize()
                check_step(torch, f"bf16 {path} {tag}", state, logs, before,
                           False)
                got = {k: v - n0[k] for k, v in train_counts().items()}
                if got != per_step:
                    raise AssertionError(f"train_bf16 {path} {tag}: launches "
                                         f"{got}, expected {per_step}")
                if i == 0:
                    vs_f32 = {k: abs(float(logs[k]) - ref_logs[k])
                              / max(abs(ref_logs[k]), 1e-30)
                              for k in ("errD", "errG_d", "errG_struct",
                                        "fake/min", "fake/max", "fake/mean")}
                else:
                    ms.setdefault(tag, []).append(start.elapsed_time(end))
        counts = train_counts()
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        if (any(v != {"torch.bfloat16"} for v in dtypes.seen.values())
                or len(dtypes.seen) != 4):
            raise AssertionError(f"train_bf16 {path}: launch dtypes "
                                 f"{dtypes.seen}")
        if (not fake_l2 <= BF16_FAKE_L2_TOL
                or not all(v <= BF16_LOG_RTOL for v in vs_f32.values())):
            raise AssertionError(f"train_bf16 {path}: against float32, fake "
                                 f"{fake_l2}, logs {vs_f32}")
        params_f32 = all(p.dtype == torch.float32 for p in
                         state.gen.parameters()) and all(
            st["exp_avg"].dtype == torch.float32
            for st in state.opt_G.state.values())
        if not params_f32:
            raise AssertionError(f"train_bf16 {path}: parameters or Adam "
                                 "states are not float32")
        profile_call(torch, "bfloat16", lambda: step(
            state, batches[0], torch.Generator(device="cuda").manual_seed(
                seed), g_lr, d_lr, stage=0),
            path=f"train_bf16_{path}_stage0", top=14)
        emit("train_bf16", generator=path, dtype="bfloat16",
             batch=list(TRAIN_BATCH), steps=[t for t, _ in plan],
             step_ms={k: sum(v) / len(v) for k, v in ms.items()},
             float32_step_ms=f32_ms[path], launches=counts,
             launches_per_step=per_step,
             launch_dtypes={k: sorted(v) for k, v in dtypes.seen.items()},
             peak_memory_gb=peak_gb, fake_rel_l2_vs_float32=fake_l2,
             logs_rel_err_vs_float32=vs_f32,
             params_and_adam_float32=params_f32)
        for k, v in counts.items():
            total[k] = total.get(k, 0) + v
        del step, state, batches
        torch.cuda.empty_cache()
    return total


# one forward at the published width of each other generator option:
# (name, UNetTMO keyword arguments, K2 and K1 launches it must make)
OPTION_FORWARDS = [
    ("batch_norm", dict(unet_norm="batch_norm"), 0, 4),
    ("instance_norm", dict(unet_norm="instance_norm"), 0, 4),
    ("leakyrelu_square", dict(activation="leakyrelu", con_operator="square"),
     0, 0),
    ("no_doubleConvTranspose", dict(double_conv_transpose=False), 0, 4),
    ("no_dct_zeros", dict(double_conv_transpose=False, padding_mode="zeros"),
     0, 4),
    ("up_mode", dict(up_mode=True), 4, 4),
    ("up_mode_no_dct", dict(up_mode=True, double_conv_transpose=False), 0, 4),
    ("bilinear", dict(bilinear=True), 4, 4),
    ("original_unet", dict(con_operator="original_unet"), 4, 0),
    ("square", dict(con_operator="square"), 4, 0),
    ("square_root", dict(con_operator="square_root"), 4, 0),
    ("gamma", dict(con_operator="gamma"), 4, 0),
    ("manual_d", dict(con_operator="square_and_square_root_manual_d",
                      n_channels=2), 4, 0),
]
# a batch-norm generator: K1 in the decoder's four concats (two forwards
# and one backward a step), no K2 (every encoder cell has a norm)
BN_PER_STEP = {"fused_concat_skip": 8, "fused_concat_skip_backward": 4,
               "fused_double_conv3x3": 0,
               "fused_double_conv3x3_backward_calls": 0}
BN_SERVE_LAUNCHES = {"fused_concat_skip": 4, "fused_double_conv3x3": 0}


def record_forward(engine) -> list:
    """Wrap `engine._forward` so that each chunk's tiles and outputs are
    kept on the host, in order; returns the list they go to."""
    chunks, forward = [], engine._forward

    def kept(tiles):
        out = forward(tiles)
        chunks.append((tiles.cpu(), out.cpu()))
        return out

    engine._forward = kept
    return chunks


def phase_options(torch, seed):
    """The generator's other configurations on the card.  A batch-norm
    generator: three steps at 112 x 112 (B = 2) on the card and on the CPU
    from one seed and the same drop path, running statistics held to each
    other; three steps at the published batch on the card (launches: K1
    in the decoder, no K2, whose cells have a norm), then served from its
    weights and statistics on a 1080p frame by the card's
    `InferenceRunner`, its chunk's outputs on `BN_FRAME_TILES` tiles held
    against the CPU's on the same tiles, and on a small frame by the
    card's and the CPU's, PNGs within one level.  Then one forward at the
    published width of each other option, with the launches of K1 and K2
    it makes.  Returns the launch counts (all float32)."""
    import numpy as np
    from uncltmo_tpu_torch.config import get_model_params
    from uncltmo_tpu_torch.inference.runner import InferenceRunner
    from uncltmo_tpu_torch.models.unet import UNetTMO, seeded_init_
    from uncltmo_tpu_torch.utils.io import read_png, write_radiance_hdr
    g_lr, d_lr = 1e-5, 1.5e-5
    total = {}

    def add(counts):
        for k, v in counts.items():
            total[k] = total.get(k, 0) + v

    # -- batch norm, card against CPU: one step at the published epsilon,
    # three with the skip concat's epsilon at 1e-2
    from uncltmo_tpu_torch import params
    published = params.EPSILON
    rows, failed = [], False
    for eps, n_steps, tol in ((published, 1, BN_STATS_STEP_TOL),
                              (1e-2, 3, BN_STATS_TOL)):
        sides = {}
        params.EPSILON = eps
        try:
            for dev in ("cuda", "cpu"):
                rng = np.random.default_rng(seed + 30)
                step, state = build_trainer(torch, seed, False, dev,
                                            size=112, grid=3,
                                            unet_norm="batch_norm")
                masks = [torch.ones(4) for _ in range(4 * n_steps)]
                masks[1][0] = 0.0
                masks[-2][3] = 0.0
                it = iter(masks)
                reset_train_counts()
                for _ in range(n_steps):
                    state, logs = step(state, synthetic_batch(rng, 2, 112),
                                       torch.Generator(), g_lr, d_lr,
                                       stage=0, drop_masks=it)
                if dev == "cuda":
                    torch.cuda.synchronize()
                    add(train_counts())
                sides[dev] = ({k: v.detach().cpu() for k, v in
                               state.gen.state_dict().items()},
                              {k: float(v) for k, v in logs.items()})
        finally:
            params.EPSILON = published
        (card, logs), (cpu, ref_logs) = sides["cuda"], sides["cpu"]
        keys = [k for k in cpu if k.endswith(("running_mean",
                                              "running_var"))]
        errs = {k: ((card[k] - cpu[k]).abs() / (1 + cpu[k].abs())).max()
                .item() for k in keys}
        worst = max(errs, key=errs.get)
        moved = all(not torch.equal(cpu[k], torch.zeros_like(cpu[k]))
                    for k in keys if k.endswith("running_mean"))
        rows.append(dict(
            epsilon=eps, steps=n_steps, stats_max_rel_err=errs[worst],
            worst_statistic=worst, tolerance=tol, n_statistics=len(keys),
            num_batches_tracked=int(card["inc.conv.norm.num_batches_tracked"]),
            last_step_log_max_rel_err=max(
                abs(logs[k] - ref_logs[k]) / max(abs(ref_logs[k]), 1e-30)
                for k in ("errD", "errG_d", "errG_struct", "fake/mean"))))
        failed |= not (errs[worst] <= tol and moved and len(keys) == 36)
    emit("options", part="batch_norm_card_vs_cpu", size=112, batch=2,
         runs=rows)
    if failed:
        raise AssertionError(f"options: batch-norm statistics card vs CPU "
                             f"{rows}")

    # -- batch norm at the published batch on the card, then served
    b, _, size = TRAIN_BATCH
    rng = np.random.default_rng(seed + 31)
    step, state = build_trainer(torch, seed, False, "cuda", size=size,
                                unet_norm="batch_norm")
    batches = [synthetic_batch(rng, b, size) for _ in range(3)]
    generator = torch.Generator(device="cuda").manual_seed(seed)
    torch.cuda.synchronize()
    reset_train_counts()
    t0 = time.perf_counter()
    for i in range(3):
        before = snapshot(state)
        n0 = train_counts()
        state, logs = step(state, batches[i], generator, g_lr, d_lr, stage=0)
        torch.cuda.synchronize()
        check_step(torch, f"batch_norm step {i}", state, logs, before, False)
        got = {k: v - n0[k] for k, v in train_counts().items()}
        if got != BN_PER_STEP:
            raise AssertionError(f"options: batch-norm step launches {got}, "
                                 f"expected {BN_PER_STEP}")
    steps_ms = (time.perf_counter() - t0) / 3 * 1e3
    add(train_counts())
    sd = {k: v.detach().cpu() for k, v in state.gen.state_dict().items()}
    del step, state, batches
    torch.cuda.empty_cache()
    mp = dict(get_model_params("batch_norm"), unet_norm="batch_norm")
    rng = np.random.default_rng(seed + 32)
    with tempfile.TemporaryDirectory() as tmp:
        lam = os.path.join(tmp, "lambdas.npy")
        np.save(lam, {"frame": 40.0})
        dirs = {}
        for tag, hw in (("frame", FRAME_HW), ("small", SMALL_HW)):
            dirs[tag] = os.path.join(tmp, tag)
            os.makedirs(dirs[tag])
            write_radiance_hdr(os.path.join(dirs[tag], "frame.hdr"),
                               synthetic_hdr(rng, *hw))
        pngs, secs = {}, {}
        # the 1080p frame on the card (counted), its tiles kept; card vs CPU
        # on a small frame, and on a subset of the 1080p frame's tiles (the
        # whole frame on the CPU took 10.5 s of the phase)
        for dev, tag in (("cuda", "frame"), ("cuda", "small"),
                         ("cpu", "small")):
            runner = InferenceRunner(mp, None, state_dict=sd, device=dev)
            if tag == "frame":
                chunks = record_forward(runner.engine)
            elif dev == "cpu":
                cpu_engine = runner.engine
            reset_counts()
            t0 = time.perf_counter()
            pngs[dev, tag] = runner.run_on_path(
                dirs[tag], os.path.join(tmp, dev + tag), lam, scale=1)[0]
            if dev == "cuda":
                torch.cuda.synchronize()
            if tag == "frame":
                serve_counts = read_counts()
                add(serve_counts)
            secs[f"{dev}_{tag}"] = time.perf_counter() - t0
        frame_shape = list(read_png(pngs["cuda", "frame"]).shape)
        diff = png_diff(pngs["cuda", "small"], pngs["cpu", "small"])
    # the card's 1080p chunk against the CPU on tiles spread over it (in
    # eval mode a tile's output is its own, whatever the chunk)
    tiles, outs = chunks[0]
    sel = np.linspace(0, len(tiles) - 1, BN_FRAME_TILES).round().astype(int)
    t0 = time.perf_counter()
    tile_err = (cpu_engine._forward(tiles[sel]) - outs[sel]).abs().max().item()
    secs["cpu_frame_tiles"] = time.perf_counter() - t0
    if (diff > 1 or serve_counts != BN_SERVE_LAUNCHES
            or frame_shape != list(FRAME_HW) + [3] or len(chunks) != 1
            or not tile_err <= GEN_TOL["float32"]):
        raise AssertionError(f"options: batch-norm frame card vs CPU "
                             f"{diff} levels, 1080p tiles {tile_err}, "
                             f"launches {serve_counts}, 1080p PNG "
                             f"{frame_shape}, {len(chunks)} chunks")
    emit("options", part="batch_norm_train_and_serve", batch=list(TRAIN_BATCH),
         steps=3, step_ms_host=steps_ms, launches_per_step=BN_PER_STEP,
         frame=list(FRAME_HW), compared_frame=list(SMALL_HW),
         png_max_diff_levels=diff, frame_chunk_tiles=len(tiles),
         frame_tiles_compared=sel.tolist(), frame_tiles_max_abs_err=tile_err,
         frame_tiles_tolerance=GEN_TOL["float32"],
         serve_launches=serve_counts, serve_s=secs)

    # -- one forward of each other option at the published width
    rows = []
    for name, kw, k2_want, k1_want in OPTION_FORWARDS:
        model = seeded_init_(UNetTMO(**kw), seed).cuda()
        x = torch.rand(2, kw.get("n_channels", 1), 256, 256,
                       generator=torch.Generator().manual_seed(seed)).cuda()
        reset_counts()
        with torch.no_grad():
            out, _ = model(x)
        torch.cuda.synchronize()
        counts = read_counts()
        add(counts)
        finite = bool(torch.isfinite(out).all())
        want = {"fused_concat_skip": k1_want, "fused_double_conv3x3": k2_want}
        if counts != want or not finite or tuple(out.shape) != (2, 1, 256,
                                                                256):
            raise AssertionError(f"options {name}: launches {counts} "
                                 f"(expected {want}), finite {finite}")
        rows.append({"option": name, "k1_launches": counts[
            "fused_concat_skip"], "k2_launches": counts[
            "fused_double_conv3x3"]})
        del model, x, out
    emit("options", part="forwards", batch=2, size=256, filters=32,
         per_forward=rows)
    return total


def trainer_options(out_dir: str, seed: int):
    """The published training options (`scripts/run_imageTMO_train.sh`)
    at batch 8, with one D pre-train epoch and one main epoch."""
    from uncltmo_tpu_torch.config import (Options, create_output_dirs,
                                          save_run_settings)
    opt = Options(batch_size=TRAIN_BATCH[0], num_epochs=1,
                  d_pretrain_epochs=1, G_lr=1e-5, D_lr=1.5e-5,
                  lr_decay_step=50, loss_g_d_factor=0.1,
                  pyramid_weight_list="0.2,0.4,0.6", adv_weight_list="1,1,0",
                  manual_seed=seed + 999, result_dir_prefix=out_dir,
                  output_dir=out_dir)
    create_output_dirs(out_dir)
    save_run_settings(opt, out_dir)
    return opt


def same_state(torch, a, b) -> bool:
    """Parameters and both Adam states bit for bit."""
    for ma, mb in ((a.gen, b.gen), (a.disc, b.disc)):
        for (na, pa), (nb, pb) in zip(ma.named_parameters(),
                                      mb.named_parameters()):
            if na != nb or not torch.equal(pa, pb):
                return False
    for oa, ob in ((a.opt_G, b.opt_G), (a.opt_D, b.opt_D)):
        sa, sb = oa.state_dict()["state"], ob.state_dict()["state"]
        if sa.keys() != sb.keys():
            return False
        for i in sa:
            for k in ("step", "exp_avg", "exp_avg_sq"):
                if not torch.equal(sa[i][k].cpu(), sb[i][k].cpu()):
                    return False
    return a.step == b.step


def trainer_want(video: bool, steps: int) -> dict:
    """Kernel launches of a main epoch of `steps` steps: each step's, and
    one forward of the generator (B = 2, on the host worker) for each
    1/4-epoch sample grid."""
    grids = steps // max(steps // 4, 1)
    return {k: steps * v + (grids * GRID_FORWARD.get(k, 0))
            for k, v in train_per_step(video).items()}


def summary_control(torch, seed, rounds: int = 2) -> dict:
    """What the 1/4-epoch summaries cost: 20-step main epochs of the image
    G's trainer with and without them, alternated `rounds` times in one
    process after a warm epoch.  Not run by `main`; alone:

        python3 -c 'import chip_smoke as s, torch; s.phase_first_launches(
            torch); s.summary_control(torch, 0)'
    """
    from uncltmo_tpu_torch.data.pipeline import SyntheticDataSource
    from uncltmo_tpu_torch.training.trainer import GanTrainer
    steps = TRAINER_ITEMS // TRAIN_BATCH[0]
    ms = {"with": [], "without": []}
    timings = {"with": [], "without": []}
    with tempfile.TemporaryDirectory() as tmp:
        trainer = GanTrainer(
            trainer_options(os.path.join(tmp, "run"), seed), source=(
                SyntheticDataSource(size=TRAIN_BATCH[2],
                                    n_items=TRAINER_ITEMS)), device="cuda")
        summary = trainer.print_epoch_summary
        for kind in ["with"] + ["with", "without"] * rounds:
            trainer.print_epoch_summary = (summary if kind == "with"
                                           else lambda *a: None)
            reset_train_counts()
            t0 = time.perf_counter()
            trainer.train_epoch(0)
            trainer._ckpt_saver.wait()
            trainer._host_worker.wait()
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) / steps * 1e3
            want = (trainer_want(False, steps) if kind == "with" else
                    {k: steps * v for k, v in train_per_step(False).items()})
            if train_counts() != want:
                raise AssertionError(f"summary control: launches "
                                     f"{train_counts()}, expected {want}")
            ms[kind].append(wall)
            timings[kind].append(dict(trainer.last_epoch_timings))
    ms["with"] = ms["with"][1:]         # the first epoch warms up
    timings["with"] = timings["with"][1:]
    rec = {"generator": "image", "steps": steps, "ms_per_step": ms,
           "timings": timings,
           "summary_share": 1 - sum(ms["without"]) / sum(ms["with"])}
    emit("summary_control", **rec)
    return rec


def phase_trainer(torch, seed, bare_ms):
    """`GanTrainer` at the published batch (8 x 2 frames of 256 x 256,
    float32) on `SyntheticDataSource(size=256)`: one D pre-train epoch and
    one main epoch, of 20 steps each for the image generator (160 items)
    and 10 for the video generator (80).  The kernels' launch counts of the
    main epoch are the steps x a step's plus the four sample grids'
    forwards (`trainer_want`),
    and 0 in the pre-train epoch; the newest checkpoint loads
    into a fresh trainer bit for bit; `InferenceRunner` serves it on a
    small image.  Returns the launch counts."""
    import numpy as np
    from uncltmo_tpu_torch.config import get_model_params
    from uncltmo_tpu_torch.data.pipeline import SyntheticDataSource
    from uncltmo_tpu_torch.inference.runner import InferenceRunner
    from uncltmo_tpu_torch.training.trainer import GanTrainer
    from uncltmo_tpu_torch.utils import checkpoint as ckpt
    from uncltmo_tpu_torch.utils.io import read_png, write_radiance_hdr
    size = TRAIN_BATCH[2]
    total = {}
    for video in (False, True):
        path = "video" if video else "image"
        n_items = TRAINER_VIDEO_ITEMS if video else TRAINER_ITEMS
        steps = n_items // TRAIN_BATCH[0]
        with tempfile.TemporaryDirectory() as tmp:
            out = os.path.join(tmp, "run")
            opt = trainer_options(out, seed)

            def make():
                return GanTrainer(opt, video=video, source=SyntheticDataSource(
                    size=size, n_items=n_items), device="cuda")

            t0 = time.perf_counter()
            trainer = make()
            init_s = time.perf_counter() - t0
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            reset_train_counts()
            t0 = time.perf_counter()
            trainer.train_epoch(0, pretrain=True)
            torch.cuda.synchronize()
            pretrain_s = time.perf_counter() - t0
            pretrain_timings = dict(trainer.last_epoch_timings)
            pretrain_counts = train_counts()
            trainer.num_iter = 0               # as `GanTrainer.train` does
            reset_train_counts()
            t0 = time.perf_counter()
            trainer.train_epoch(0)
            torch.cuda.synchronize()
            main_s = time.perf_counter() - t0
            timings = dict(trainer.last_epoch_timings)
            t0 = time.perf_counter()
            trainer._ckpt_saver.wait()
            trainer._host_worker.wait()
            torch.cuda.synchronize()
            drain_s = time.perf_counter() - t0
            # read once the host worker has run the last sample grid
            counts = train_counts()
            peak_gb = torch.cuda.max_memory_allocated() / 1e9
            want = trainer_want(video, steps)
            if counts != want or any(pretrain_counts.values()):
                raise AssertionError(
                    f"trainer {path}: launches {counts} (expected {want}), "
                    f"pre-train epoch {pretrain_counts} (expected none)")
            if timings["steps"] != steps or trainer.state.step != 2 * steps:
                raise AssertionError(f"trainer {path}: {timings['steps']} "
                                     f"steps, state step {trainer.state.step}")
            # the newest checkpoint into a fresh trainer, bit for bit
            newest = ckpt.latest_checkpoint(os.path.join(out, "models"))
            fresh = make()
            fresh.load_checkpoint()
            reloaded = same_state(torch, fresh.state, trainer.state)
            if not reloaded or fresh.num_iter != steps:
                raise AssertionError(f"trainer {path}: {newest} does not "
                                     "reload to the live state")
            # ... and served from its .pth by the inference runner
            rng = np.random.default_rng(seed + 40)
            img_dir = os.path.join(tmp, "in")
            os.makedirs(img_dir)
            write_radiance_hdr(os.path.join(img_dir, "small.hdr"),
                               synthetic_hdr(rng, *SMALL_HW))
            lam = os.path.join(tmp, "lambdas.npy")
            np.save(lam, {"small": 40.0})
            runner = InferenceRunner(
                get_model_params("trainer", os.path.join(out,
                                                         "run_settings.npy")),
                net_path=newest, device="cuda")
            pngs = runner.run_on_path(img_dir, os.path.join(tmp, "out"), lam,
                                      scale=1)
            png = read_png(pngs[0])
            if png.shape != SMALL_HW + (3,) or png.std() == 0:
                raise AssertionError(f"trainer {path}: served PNG "
                                     f"{png.shape}, std {png.std()}")
            emit("trainer", generator=path, dtype="float32",
                 batch=list(TRAIN_BATCH), steps=steps, init_s=init_s,
                 pretrain_s=pretrain_s, pretrain_timings=pretrain_timings,
                 main_s=main_s, steps_per_s=steps / main_s,
                 ms_per_step=main_s / steps * 1e3,
                 bare_step_ms=bare_ms[path], timings=timings,
                 drain_s=drain_s, launches=counts,
                 pretrain_launches=pretrain_counts, peak_memory_gb=peak_gb,
                 checkpoint=os.path.basename(newest),
                 checkpoint_reload_bit_equal=reloaded,
                 served_png=list(png.shape))
            for k, v in counts.items():
                total[k] = total.get(k, 0) + v
            del trainer, fresh, runner
            torch.cuda.empty_cache()
    return total


# the data_parallel phase: the training step on two ranks at the published
# batch (4 clips a rank) against the one-process step from the same state,
# batch and drop path: the image generator at stages 0-2, with the skip
# concat's epsilon at 1e-2 and in bfloat16, the video generator at stage 0
DP_WORLD = 2
DP_PLAN = [(False, 0, "published"), (False, 1, "published"),
           (False, 2, "published"), (False, 0, "strict"),
           (True, 0, "published"), (False, 0, "bf16")]
# (video, stage, mode): the published epsilon, 1e-2, or bfloat16 autocast
# at the published epsilon
DP_STRICT_EPS = 1e-2
# Two ranks against one process, both on the card.  One process differs
# from itself between two runs of the same step (cuDNN's float32 gradient
# algorithms sum in no fixed order): on an H100 80GB HBM3 by up to 4e-3 of
# max-abs in G's exp_avg (the GCN's `pos_embed`, whose gradient sums the
# batch through the neighbour choice), 1.8e-3 in the encoder, 3.4e-5 in D;
# the ranks by up to 1.6e-2, 1.5e-2 and 3.4e-5.  Every G parameter is held
# in relative L2 and entry by entry (of max-abs): at the published epsilon
# to `train_reference`'s encoder limits (5e-2 / 0.15) and its D and log
# limits; with the skip concat's epsilon at 1e-2 tighter, where the
# encoder has no singularity.
DP_STRICT = {"log": 1e-4, "grad_log": 1e-3, "D": 2e-4, "G_l2": 2e-2,
             "G_max": 5e-2}
DP_PUBLISHED = {"log": REF_LOG_RTOL, "grad_log": REF_ENCODER_LOG_RTOL,
                "D": REF_D_TOL, "G_l2": REF_ENCODER_L2_TOL,
                "G_max": REF_ENCODER_MAX_TOL}
# bfloat16 (autocast; the collectives in float32): the losses as
# `train_bf16` holds bf16 against float32.  A weight gradient leaves its
# bfloat16 convolution rounded to 2^-8 of its size, and each rank rounds
# its half-batch sum before the all-reduce where one process rounds the
# whole sum once: where a sum cancels, as a D bias's over few samples
# does, that moves it by a tenth of its max-abs (0.11 for `model.2.bias`
# on the CPU at 112 px, 3.3e-2 on an H100 80GB HBM3, where G's
# `pos_embed` moved by 4.8e-2 in relative L2); held as
# `tests/test_torch_bf16_train.py` holds the bf16 step's moments (0.1 in
# relative L2)
DP_BF16 = dict(DP_PUBLISHED, log=BF16_LOG_RTOL, grad_log=1e-2, D=0.3,
               G_l2=0.1)
# D's last bias (`model.4.bias`) shifts every logit alike, which the
# relativistic loss does not see: its gradient is rounding noise, held
# apart from the other parameters by its largest |exp_avg| on either side,
# as `tests/test_torch_distributed.py` holds it on the CPU (1e-5).  In
# bfloat16 the sum of the logits' gradients (of unit size in all) keeps the
# rounding of its bfloat16 partial sums, 2^-8 of their size each (an
# exp_avg of 2^-7 on the CPU at 112 px): held at a tenth of the unit sum
DP_STRICT["D_bias"] = DP_PUBLISHED["D_bias"] = 1e-5
DP_BF16["D_bias"] = 5e-2
DP_LOGIT_BIAS = "D.model.4.bias"
DP_ENGINE_TOL = 1e-5           # the sharded canvas, of the one-device's max
DP_ENGINE_HW = (1096, 1936)    # a 1080p frame padded to the U-Net grid
DP_TIMEOUT_S = 300.0
# `GanTrainer.train()` on the ranks: a main epoch of 4 steps at the
# published batch (a summary and a checkpoint each step), resumed from a
# warm checkpoint with the skip concat's epsilon at 1e-2, as
# `tests/test_torch_distributed.py` runs the CLI.  Otherwise the ranks'
# rounding becomes another trajectory within a few steps: on the CPU at
# 112 px, where each single step agrees to 1e-4, G's exp_avg was 0.38
# apart in relative L2 after a D pre-train epoch and four steps at the
# published epsilon (the encoder's gradient behind 0.5 / sqrt(x2 + 1e-8)),
# and 1.6e-2 at epsilon 1e-2 (fresh Adam moves every parameter by +-lr)
DP_TRAINER_ITEMS = 4 * TRAIN_BATCH[0]
# Over four steps on the card the one-process run differs from itself
# (cuDNN's and the GCN's float32 gradient sums have no fixed order), and a
# parameter whose gradient cancels over the batch reads that spread large
# of its own max-abs (D's `model.2.bias`: 3.7e-3 after four steps on an
# H100 80GB HBM3, where the losses agreed to 4e-7).  So the trainer is held
# by its logs and layer by layer in relative L2, as
# `tests/test_torch_distributed.py` holds the CLI's `.pth`, at the strict
# step's limits; a rank with the wrong rows, state or gradient is off by
# a whole layer
DP_TRAINER = {"log": DP_STRICT["log"], "grad_log": DP_STRICT["grad_log"],
              "layer_l2": DP_STRICT["G_l2"], "D_bias": DP_STRICT["D_bias"]}


def first_moments(torch, state) -> dict:
    """Adam's exp_avg of every parameter by "D.name" / "G.name", on the
    host in one device-to-host copy: with two ranks on one card each small
    copy waits for the other rank's time slice."""
    names, flat = [], []
    for gname, module, opt in (("D", state.disc, state.opt_D),
                               ("G", state.gen, state.opt_G)):
        for name, p in module.named_parameters():
            names.append((f"{gname}.{name}", p.shape))
            flat.append(opt.state[p]["exp_avg"].reshape(-1))
    flat = torch.cat(flat).cpu()
    moments, i = {}, 0
    for name, shape in names:
        n = shape.numel()
        moments[name] = flat[i:i + n].view(shape)
        i += n
    return moments


def dp_steps(torch, seed, device, rank, world, digest=True) -> list:
    """`DP_PLAN`'s steps (float32, or bfloat16 in mode "bf16"), each from
    the seeded initial state and fresh Adam states, on this rank's rows of
    the published batch (all of them in one process), the drop path drawn
    from one seeded generator.  A step: its logs, first moments by name,
    the state's digest, its ms by CUDA events, its launches."""
    import numpy as np
    from uncltmo_tpu_torch import params
    from uncltmo_tpu_torch.parallel import mesh
    from uncltmo_tpu_torch.training.state import TrainState
    built, out = {}, []
    published = params.EPSILON
    for video, stage, mode in DP_PLAN:
        key = (video, mode == "bf16")
        clock = {"t": time.perf_counter()}
        host_s = {}

        def lap(name):
            t = time.perf_counter()
            host_s[name] = t - clock["t"]
            clock["t"] = t

        if key not in built:
            rng = np.random.default_rng(seed + 50 + int(video))
            batch = synthetic_batch(rng, TRAIN_BATCH[0], TRAIN_BATCH[2])
            step, state = build_trainer(
                torch, seed, video, device, size=TRAIN_BATCH[2],
                dtype=torch.bfloat16 if key[1] else torch.float32)
            built[key] = (step, state.gen, state.disc,
                          copy.deepcopy(state.gen.state_dict()),
                          copy.deepcopy(state.disc.state_dict()),
                          mesh.shard_batch(batch, rank, world))
        lap("build")
        step, gen, disc, gen0, disc0, batch = built[key]
        gen.load_state_dict(gen0)
        disc.load_state_dict(disc0)
        state = TrainState.create(gen, disc)
        lap("reset")
        generator = torch.Generator(device=device).manual_seed(seed)
        params.EPSILON = DP_STRICT_EPS if mode == "strict" else published
        n0 = train_counts()
        try:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            state, logs = step(state, batch, generator, 1e-5, 1.5e-5,
                               stage=stage)
            end.record()
            torch.cuda.synchronize()
        finally:
            params.EPSILON = published
        lap("step")
        moments = first_moments(torch, state)
        lap("moments")
        digest_hex = mesh.state_digest(state) if digest else None
        lap("digest")
        out.append({"logs": {k: float(v) for k, v in logs.items()},
                    "moments": moments, "digest": digest_hex,
                    "host_s": host_s, "ms": start.elapsed_time(end),
                    "launches": {k: v - n0[k]
                                 for k, v in train_counts().items()}})
    return out


def dp_source():
    from uncltmo_tpu_torch.data.pipeline import SyntheticDataSource
    return SyntheticDataSource(size=TRAIN_BATCH[2], n_items=DP_TRAINER_ITEMS)


def warm_checkpoint(torch, opt, out_dirs) -> None:
    """The trainer's initial state with warm Adam states (ten steps old,
    exp_avg 0, a flat exp_avg_sq of 1e-2: the update is smooth in the
    gradient), saved as the checkpoint of iteration 0 in each of
    `out_dirs`, which `opt.checkpoint` resumes from."""
    from uncltmo_tpu_torch.training.trainer import GanTrainer
    from uncltmo_tpu_torch.utils import checkpoint as ckpt
    st = GanTrainer(opt, source=dp_source(), device="cuda").state
    for adam, module in ((st.opt_G, st.gen), (st.opt_D, st.disc)):
        for p in module.parameters():
            adam.state[p] = {"step": torch.tensor(10.0),
                             "exp_avg": torch.zeros_like(p),
                             "exp_avg_sq": torch.full_like(p, 1e-2)}
    for out in out_dirs:
        ckpt.save_train_state(os.path.join(out, "models"), 0, 0, st,
                              extra_meta={"num_iter": 0})


def dp_trainer(torch, opt, device, assess: tuple) -> dict:
    """`GanTrainer.train()` on `dp_source()` in this process, a rank of the
    group or the only one, resumed from `warm_checkpoint`, with the skip
    concat's epsilon at `DP_STRICT_EPS`; then the final
    assessment of `assess` (an image directory and its lambdas; rank 0
    renders); then a
    fresh trainer loads the newest checkpoint.  Returns the first moments,
    the digests of the live and of the resumed state, the launches of the
    run (drained) and of the assessment, the rendered files, seconds."""
    from uncltmo_tpu_torch import params
    from uncltmo_tpu_torch.parallel import mesh
    from uncltmo_tpu_torch.training.trainer import GanTrainer
    published, params.EPSILON = params.EPSILON, DP_STRICT_EPS
    try:
        t0 = time.perf_counter()
        trainer = GanTrainer(opt, source=dp_source(), device=device)
        init_s = time.perf_counter() - t0
        reset_train_counts()
        t0 = time.perf_counter()
        trainer.train()                # drains the saver and host worker
        torch.cuda.synchronize(trainer.device)
        train_s = time.perf_counter() - t0
        counts = train_counts()
        reset_counts()
        pngs = trainer.run_final_assessment(*assess, scale=1)
        torch.cuda.synchronize(trainer.device)
        assess_counts = read_counts()
    finally:
        params.EPSILON = published
    fresh = GanTrainer(opt, source=dp_source(), device=device)
    fresh.load_checkpoint()
    return {"moments": first_moments(torch, trainer.state),
            "digest": mesh.state_digest(trainer.state),
            "resumed_digest": mesh.state_digest(fresh.state),
            "resumed_num_iter": fresh.num_iter, "step": trainer.state.step,
            "world": trainer.world, "launches": counts,
            "assessment_launches": assess_counts,
            "assessment_pngs": None if pngs is None else len(pngs),
            "init_s": init_s, "train_s": train_s,
            "timings": dict(trainer.last_epoch_timings)}


def dp_rank(dev, out_dir: str, seed: int, opt, assess: tuple) -> None:
    """A rank of the data_parallel phase (`mesh.launch` has joined it to
    the group on `dev`): wait until the parent's one-process runs are done
    (so that the ranks' times are their own), run `DP_PLAN` and then
    `dp_trainer`, save the results."""
    import torch
    from uncltmo_tpu_torch.inference.engine import disable_tf32
    from uncltmo_tpu_torch.parallel import mesh
    rank, world = mesh.rank_world()
    disable_tf32("cuda")
    torch.set_num_threads(max(1, (os.cpu_count() or 2) // world))
    # the card's context and cuDNN's handle (8 s in a fresh process),
    # while the parent runs its one-process steps
    torch.nn.functional.conv2d(torch.zeros(1, 1, 4, 4, device=dev),
                               torch.zeros(1, 1, 3, 3, device=dev))
    torch.cuda.synchronize(dev)
    ready = os.path.join(out_dir, "ready")
    deadline = time.perf_counter() + DP_TIMEOUT_S
    while not os.path.exists(ready):
        if time.perf_counter() > deadline:
            raise TimeoutError("data_parallel: no one-process steps")
        time.sleep(0.05)
    mesh.barrier()
    torch.cuda.reset_peak_memory_stats(dev)
    reset_train_counts()
    t0 = time.perf_counter()
    results = dp_steps(torch, seed, dev, rank, world)
    launches = train_counts()
    steps_s = time.perf_counter() - t0
    peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9
    trainer = dp_trainer(torch, opt, dev, assess)
    torch.save({"results": results, "launches": launches,
                "steps_s": steps_s, "peak_memory_gb": peak_gb,
                "trainer": trainer, "device": str(dev),
                "backend": mesh.dist.get_backend()},
               os.path.join(out_dir, f"rank{rank}.pt"))


class DPRanks(threading.Thread):
    """`mesh.launch(fn, DP_WORLD, "cuda", *args)` on a thread of its own,
    so that the parent works while the ranks start.  `finish` joins it and
    raises a rank's failure; ranks that outlive its deadline, or the
    parent's failure (`stop`), are terminated."""

    def __init__(self, fn, *args):
        super().__init__(daemon=True)
        self.fn, self.args, self.error = fn, args, None

    def run(self):
        from uncltmo_tpu_torch.parallel import mesh
        try:
            mesh.launch(self.fn, DP_WORLD, "cuda", *self.args)
        except BaseException as e:     # raised again by `finish`
            self.error = e

    def stop(self) -> None:
        import multiprocessing
        for p in multiprocessing.active_children():
            p.terminate()
        self.join(30)

    def finish(self, timeout: float) -> None:
        self.join(timeout)
        if self.is_alive():
            self.stop()
            raise TimeoutError("data_parallel: the ranks hang")
        if self.error is not None:
            raise AssertionError(f"data_parallel: a rank failed: "
                                 f"{self.error}") from self.error


def last_train_logs(out_dir: str) -> tuple:
    """(the number of train records, the logs of the last one) of a
    trainer's JSONL."""
    with open(os.path.join(out_dir, "train_metrics.jsonl")) as f:
        recs = [json.loads(line) for line in f]
    recs = [r for r in recs if r.get("phase") == "train"]
    meta = ("step", "time", "epoch", "phase", "sec_per_step")
    return len(recs), {k: v for k, v in recs[-1].items() if k not in meta}


def dp_compare(ref: dict, got: dict) -> dict:
    """Logs and first moments of a step against another run of it: the
    largest relative error of the loss and statistics logs and of the
    gradient logs; exp_avg's largest error of its max-abs for D and for
    G, G's largest relative L2, and the largest relative L2 of a layer
    (the unit of the `gradG/*` logs: `D.model.2`, `G.down_path.0`,
    `G.gcn`, ...), with the parameters and the layer where they fall."""
    import torch
    worst = {"D": (0.0, ""), "G_max": (0.0, ""), "G_l2": (0.0, ""),
             "layer_l2": (0.0, "")}
    layers = {}
    for name, mc in ref["moments"].items():
        ma = got["moments"][name]
        if name == DP_LOGIT_BIAS:      # rounding noise: held absolutely
            continue
        parts = name.split(".")
        layer = ".".join(parts[:3] if parts[1] in (
            "down_path", "up_path", "model", "tail") else parts[:2])
        layers.setdefault(layer, []).append((ma.reshape(-1), mc.reshape(-1)))
        errs = {"max": ((ma - mc).abs().max() / mc.abs().max()).item(),
                "l2": ((ma - mc).norm() / mc.norm()).item()}
        keys = (("D", "max"),) if name[0] == "D" else (("G_max", "max"),
                                                       ("G_l2", "l2"))
        for key, kind in keys:
            if errs[kind] >= worst[key][0]:
                worst[key] = (errs[kind], name)
    for layer, pairs in layers.items():
        a, c = (torch.cat([p[i] for p in pairs]) for i in (0, 1))
        e = ((a - c).norm() / c.norm()).item()
        if e >= worst["layer_l2"][0]:
            worst["layer_l2"] = (e, layer)
    err = {k: abs(got["logs"][k] - v) / max(abs(v), 1e-30)
           for k, v in ref["logs"].items() if abs(v) > 1e-12}
    return {"log": max(v for k, v in err.items()
                       if not k.startswith("gradG/")),
            "grad_log": max(v for k, v in err.items()
                            if k.startswith("gradG/")),
            **{k: v for k, (v, _) in worst.items()},
            "D_bias": max(ref["moments"][DP_LOGIT_BIAS].abs().max().item(),
                          got["moments"][DP_LOGIT_BIAS].abs().max().item()),
            "worst_parameter": {k: n for k, (_, n) in worst.items()}}


def dp_check(tag: str, e: dict, mode: str) -> None:
    limits = {"strict": DP_STRICT, "bf16": DP_BF16,
              "trainer": DP_TRAINER}.get(mode, DP_PUBLISHED)
    bad = [k for k, v in limits.items() if not e[k] <= v]
    if bad:
        raise AssertionError(f"data_parallel {tag}: {bad} beyond "
                             f"{limits} against one process: {e}")


def dp_engine(torch, seed, devices) -> dict:
    """`TileEngine(devices=...)` against the one-device engine on a 1080p
    frame (published generator) and a 4-frame 1080p scene (published and
    `batchMax` generators): the canvas within `DP_ENGINE_TOL` of max-abs
    and the 8-bit renders within one level, with cuDNN's deterministic
    algorithms (without them the one-device engine differs from itself by
    up to 1.6e-4 of max-abs between two runs on an H100 80GB HBM3: that
    spread is recorded too); ms of each engine as served (cuDNN's own
    choice); launches by device."""
    import numpy as np
    from uncltmo_tpu_torch.inference.engine import TileEngine
    from uncltmo_tpu_torch.models.unet import UNetTMO, seeded_init_
    rng = np.random.default_rng(seed + 60)
    h, w = DP_ENGINE_HW
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    scene = np.stack([0.45 + 0.25 * np.sin(xx / (40.0 + 7 * t) + yy / 55.0)
                      + 0.05 * rng.standard_normal((h, w)).astype(np.float32)
                      for t in range(VIDEO_FRAMES)])
    scene = torch.from_numpy(np.clip(scene, 0, 1)[..., None]).cuda()

    def rel(a, b) -> float:
        return ((a - b).abs().max() / b.abs().max()).item()

    out, counts = {}, {}
    for stretch in ("none", "batchMax"):
        gen = seeded_init_(UNetTMO(stretch_g=stretch), seed)
        one = TileEngine(gen, device="cuda")
        two = TileEngine(gen, devices=devices)
        runs = [("scene", lambda e: e.run_video(scene))]
        if stretch == "none":
            runs.insert(0, ("frame", lambda e: e.run_image(scene[0])))
        for what, run in runs:
            tag = f"{what}_{stretch}"
            spread = rel(run(one), run(one))
            torch.backends.cudnn.deterministic = True
            try:
                ref = run(one)
                reset_counts()
                with LaunchDtypes(what="device") as by_device:
                    got = run(two)
                    torch.cuda.synchronize()
            finally:
                torch.backends.cudnn.deterministic = False
            counts[tag] = {"total": read_counts(),
                           "by_device": by_device.counts}
            err = rel(got, ref)
            u8 = [np.clip(x.cpu().numpy() * 255.0, 0, 255).astype(np.int16)
                  for x in (got, ref)]
            levels = int(np.abs(u8[0] - u8[1]).max())
            out[tag] = {"canvas_max_err_of_max_abs": err,
                        "render_max_level_diff": levels,
                        "one_device_vs_itself_default_cudnn": spread,
                        "ms_one_device": time_ms(lambda: run(one), 1, 1),
                        "ms_sharded": time_ms(lambda: run(two), 1, 1)}
            if not (err <= DP_ENGINE_TOL and levels <= 1):
                raise AssertionError(f"data_parallel engine {tag}: canvas "
                                     f"{err} of max-abs, {levels} levels")
        del one, two
    return {"results": out, "launches": counts}


def phase_data_parallel(torch, seed) -> dict:
    """Two ranks (`mesh.launch`: NCCL over two cards where there are two,
    else gloo with both ranks on card 0) at the published batch, 4 clips a
    rank.  The training step against the one-process step from the same
    state, batch and drop path (`DP_PLAN`), the ranks' states after every
    step by digest, K1, K1's backward and K2 launched on both ranks; then
    `GanTrainer.train()` on the ranks against one process (`dp_trainer`:
    the resume on every rank, the sharded prefetch, rank 0's logs,
    checkpoints, sample grids and final assessment, the barriers); then the
    tile-sharded engine (`dp_engine`).  The kernels were built before, so
    the ranks load them from the cache.  Returns the phase's launches by
    dtype."""
    import numpy as np
    from uncltmo_tpu_torch.parallel import mesh
    from uncltmo_tpu_torch.data.pipeline import (SyntheticDataSource,
                                                 TrainPipeline)
    from uncltmo_tpu_torch.inference.engine import disable_tf32
    from uncltmo_tpu_torch.utils.io import write_radiance_hdr
    t_phase = time.perf_counter()
    disable_tf32("cuda")               # as in the ranks: float32 parity
    n_cards = torch.cuda.device_count()
    backend = mesh.backend_for("cuda", DP_WORLD)
    with tempfile.TemporaryDirectory() as tmp:
        assess = (os.path.join(tmp, "assess"), os.path.join(tmp, "lam.npy"))
        os.makedirs(assess[0])
        write_radiance_hdr(os.path.join(assess[0], "small.hdr"),
                           synthetic_hdr(np.random.default_rng(seed + 61),
                                         *SMALL_HW))
        np.save(assess[1], {"small": 40.0})
        opts = {n: dataclasses.replace(
            trainer_options(os.path.join(tmp, n), seed), checkpoint=1)
            for n in ("one", "again", "two")}
        warm_checkpoint(torch, opts["one"], [o.output_dir
                                             for o in opts.values()])
        ranks_thread = DPRanks(dp_rank, tmp, seed, opts["two"], assess)
        ranks_thread.start()
        try:
            # the one-process steps on card 0 while the ranks start
            refs = dp_steps(torch, seed, "cuda", 0, 1, digest=False)
            # ... and again: the step's own run-to-run spread on the card
            again = dp_steps(torch, seed, "cuda", 0, 1, digest=False)
            trainer_ref = dp_trainer(torch, opts["one"], "cuda", assess)
            trainer_again = dp_trainer(torch, opts["again"], "cuda", assess)
            one_process_s = time.perf_counter() - t_phase
            with open(os.path.join(tmp, "ready"), "w"):
                pass
            ranks_thread.finish(DP_TIMEOUT_S)
        finally:
            if ranks_thread.is_alive():
                ranks_thread.stop()
        ranks = [torch.load(os.path.join(tmp, f"rank{r}.pt"),
                            weights_only=False) for r in range(DP_WORLD)]
        logged = {n: last_train_logs(o.output_dir) for n, o in opts.items()}
        ckpts = {n: sorted(os.listdir(os.path.join(o.output_dir, "models")))
                 for n, o in opts.items()}
    ranks_s = time.perf_counter() - t_phase
    steps = []
    for i, (video, stage, mode) in enumerate(DP_PLAN):
        tag = f"{'video' if video else 'image'} stage {stage} {mode}"
        got = [r["results"][i] for r in ranks]
        if (len({g["digest"] for g in got}) != 1
                or any(g["logs"] != got[0]["logs"] for g in got)):
            raise AssertionError(f"data_parallel {tag}: the ranks' states "
                                 "or logs differ")
        steps.append({"generator": "video" if video else "image",
                      "stage": stage, "mode": mode,
                      "rank_ms": [g["ms"] for g in got],
                      "rank_host_s": [g["host_s"] for g in got],
                      "one_process_ms": refs[i]["ms"],
                      "digest": got[0]["digest"][:16],
                      "ranks_vs_one_process": dp_compare(refs[i], got[0]),
                      "one_process_vs_itself": dp_compare(refs[i],
                                                          again[i])})
    launches = {"float32": {}, "bfloat16": {}}
    for r in ranks:
        for (video, _, mode), res in zip(DP_PLAN, r["results"]):
            if res["launches"] != train_per_step(video):
                raise AssertionError(
                    f"data_parallel: rank on {r['device']} launched "
                    f"{res['launches']} in a {mode} step, expected "
                    f"{train_per_step(video)}")
            by = launches["bfloat16" if mode == "bf16" else "float32"]
            for k, v in res["launches"].items():
                by[k] = by.get(k, 0) + v
    # the trainer on the ranks against one process
    tr = [r["trainer"] for r in ranks]
    n_steps = DP_TRAINER_ITEMS // TRAIN_BATCH[0]
    # rank 0 draws the sample grids, as one process does
    want = [trainer_want(False, n_steps)] * 2 + [
        {k: n_steps * v for k, v in train_per_step(False).items()}
    ] * (DP_WORLD - 1)
    trainer_vs_one, trainer_vs_itself = (dp_compare(
        {"moments": trainer_ref["moments"], "logs": logged["one"][1]},
        {"moments": t["moments"], "logs": logged[n][1]})
        for t, n in ((tr[0], "two"), (trainer_again, "again")))
    trainer = {
        "steps": n_steps, "items": DP_TRAINER_ITEMS,
        "rank_launches": [t["launches"] for t in tr],
        "assessment_launches": [t["assessment_launches"] for t in tr],
        "rank_init_s": [t["init_s"] for t in tr],
        "rank_train_s": [t["train_s"] for t in tr],
        "rank_timings": [t["timings"] for t in tr],
        "one_process_train_s": trainer_ref["train_s"],
        "digest": tr[0]["digest"][:16],
        "train_records": {n: v[0] for n, v in logged.items()},
        "checkpoints": ckpts["two"],
        "ranks_vs_one_process": trainer_vs_one,
        "one_process_vs_itself": trainer_vs_itself}
    for k in launches["float32"]:
        launches["float32"][k] += sum(t["launches"][k] for t in tr)
    # what every rank pays to make the whole global batch and keep half
    # of it (the stream stays the one-process run's): host ms a batch
    batch_ms = {}
    for tag, b in (("global", TRAIN_BATCH[0]),
                   ("rank_rows", TRAIN_BATCH[0] // DP_WORLD)):
        pipe = TrainPipeline(SyntheticDataSource(size=TRAIN_BATCH[2]), b)
        t0 = time.perf_counter()
        for i in range(3):
            pipe._make_batch(pipe.batch_rng(0, 0, i))
        batch_ms[tag] = (time.perf_counter() - t0) / 3 * 1e3
    devices = (mesh.get_mesh(DP_WORLD) if n_cards >= DP_WORLD
               else [torch.device("cuda", 0)] * DP_WORLD)
    t0 = time.perf_counter()
    engine = dp_engine(torch, seed, devices)
    engine_s = time.perf_counter() - t0
    for c in list(engine["launches"].values()) + [
            {"total": t["assessment_launches"]} for t in tr]:
        for k, v in c["total"].items():
            launches["float32"][k] += v
    emit("data_parallel", backend=backend, cards=n_cards, ranks=DP_WORLD,
         rank_devices=[r["device"] for r in ranks],
         rank_backends=[r["backend"] for r in ranks],
         batch_per_rank=[TRAIN_BATCH[0] // DP_WORLD] + list(TRAIN_BATCH[1:]),
         steps=steps, launches_per_rank=[r["launches"] for r in ranks],
         peak_memory_gb_per_rank=[r["peak_memory_gb"] for r in ranks],
         trainer=trainer, engine_devices=[str(d) for d in devices],
         engine=engine, host_batch_ms=batch_ms, one_process_s=one_process_s,
         rank_steps_s=[r["steps_s"] for r in ranks], ranks_s=ranks_s,
         engine_s=engine_s, phase_s=time.perf_counter() - t_phase)
    # the checks, after the record is out
    for (video, stage, mode), st in zip(DP_PLAN, steps):
        dp_check(f"{st['generator']} stage {stage} {mode}",
                 st["ranks_vs_one_process"], mode)
    dp_check("trainer", trainer_vs_one, "trainer")
    bad = []
    got = [t["launches"] for t in [trainer_ref] + tr]
    if got != want:
        bad.append(f"launches {got} (one process, ranks), expected {want}")
    if len({t["digest"] for t in tr} | {t["resumed_digest"] for t in tr}) != 1:
        bad.append("the ranks' states differ, or do not resume bit for bit")
    if [t["world"] for t in tr] != [DP_WORLD] * DP_WORLD or any(
            t["resumed_num_iter"] != n_steps or t["step"] != n_steps
            for t in tr + [trainer_ref]):
        bad.append("world, step or resumed iteration")
    if [t["assessment_pngs"] for t in tr] != [1] + [None] * (DP_WORLD - 1) \
            or not all(tr[0]["assessment_launches"].values()) \
            or any(any(t["assessment_launches"].values()) for t in tr[1:]):
        bad.append("the final assessment is not rank 0's alone")
    if (len({v[0] for v in logged.values()}) != 1
            or ckpts["two"] != ckpts["one"]):
        bad.append(f"records {logged}, checkpoints {ckpts}")
    if bad:
        raise AssertionError(f"data_parallel trainer: {bad}")
    return launches


class StageClock:
    """Host seconds of named stages, each closed by a CUDA sync: `wrap`
    returns `fn` timed under `name`."""

    def __init__(self, torch):
        self.torch = torch
        self.seconds: dict = {}
        self.calls: list = []

    def wrap(self, name, fn, record=False):
        def timed(*args, **kwargs):
            self.torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            self.torch.cuda.synchronize()
            self.seconds[name] = (self.seconds.get(name, 0.0)
                                  + time.perf_counter() - t0)
            if record:
                self.calls.append((name, args, out))
            return out
        return timed

    def ms(self) -> dict:
        return {k + "_ms": v * 1e3 for k, v in self.seconds.items()}


def timed_eval(torch, tester, state_dict, out_dir: str, epoch_iter: int):
    """One `save_images_for_model` with `state_dict`, split into the
    engine's forward, TMQI, the warp error (its flow on its own) and the
    PNG writes.  Returns (metrics, ms by stage, the TMQI calls, the flow's
    devices)."""
    from uncltmo_tpu_torch.metrics import flow
    from uncltmo_tpu_torch.training import tester as tester_mod
    clock = StageClock(torch)
    devices = []
    saved = (tester_mod.compute_warp_error, tester_mod.save_uint8_png,
             flow.horn_schunck_flow)
    hs = clock.wrap("flow", flow.horn_schunck_flow)

    def hs_seen(img0, img1, **kw):
        devices.append(img0.device.type)
        return hs(img0, img1, **kw)
    engine = tester.engine
    engine.run_image = clock.wrap("forward", engine.run_image)
    engine.run_video = clock.wrap("forward", engine.run_video)
    tester._score = clock.wrap("tmqi", tester._score, record=True)
    tester_mod.compute_warp_error = clock.wrap("warp_error", saved[0])
    tester_mod.save_uint8_png = clock.wrap("png", saved[1])
    flow.horn_schunck_flow = hs_seen
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        metrics = tester.save_images_for_model(state_dict, out_dir, 0,
                                               epoch_iter)
        torch.cuda.synchronize()
        total_ms = (time.perf_counter() - t0) * 1e3
    finally:
        (tester_mod.compute_warp_error, tester_mod.save_uint8_png,
         flow.horn_schunck_flow) = saved
        del engine.run_image, engine.run_video, tester._score
    ms = clock.ms()
    ms["total_ms"] = total_ms
    ms["other_ms"] = total_ms - sum(v for k, v in ms.items()
                                    if k not in ("total_ms", "flow_ms"))
    return metrics, ms, clock.calls, devices


# the Tester's launches of each forward kernel: 4 a frame step; an image
# render is one step (image G) or four (the video G replicates the frame
# 4x), a scene one step a frame
TESTER_LAUNCHES = {"image": 4 * 2, "video": 4 * (VIDEO_FRAMES + 4 * 2)}
LAMBDA_RTOL = 1e-4            # card vs CPU fit of the same gray
TMQI_TOL = 1e-4               # Q of one render, card vs CPU
FLOW_TOL_PX = 0.25            # Horn-Schunck on uint8 renders, card vs CPU
WARP_RTOL = 1e-2              # E1 / E2 of the same pair, card vs CPU


def phase_tester(torch, seed, scenes, scene_lams):
    """The Tester at full width on the video phase's 1080p files, float32,
    built as the training CLIs build it: an image-G Tester on two eval
    images, one of whose lambdas is fitted on the card at construction
    (`calc_lambda` against a synthetic mean histogram), and a video-G
    Tester that adds one 4-frame scene.  Each `save_images_for_model` is
    run once to warm up and once with the counts set to 0, timed by
    stage.  Held: the fitted lambda against the CPU fit of the same gray,
    each render's TMQI against the CPU's, the Horn-Schunck flow and the
    warp error against the CPU's on a SMALL_HW crop of two scene renders,
    the flow backend (the torch one, on the card) and the launch counts.
    Returns the launch counts."""
    import importlib.util
    import numpy as np
    from uncltmo_tpu_torch import params
    from uncltmo_tpu_torch.config import Options
    from uncltmo_tpu_torch.metrics import warp_error
    from uncltmo_tpu_torch.metrics.flow import horn_schunck_flow
    from uncltmo_tpu_torch.metrics.tmqi import tmqi
    from uncltmo_tpu_torch.models.unet import UNetTMO, seeded_init_
    from uncltmo_tpu_torch.ops import lambda_est
    from uncltmo_tpu_torch.training.tester import Tester
    from uncltmo_tpu_torch.utils.io import read_hdr_image
    # renders on the card take the torch flow and warp whether cv2 imports
    # or not; recorded beside the flow's backend
    cv2_present = importlib.util.find_spec("cv2") is not None
    total = {}
    with tempfile.TemporaryDirectory() as tmp:
        eval_dir = os.path.join(tmp, "eval")
        video_root = os.path.join(tmp, "video")
        os.makedirs(eval_dir)
        os.makedirs(video_root)
        for name, scene in (("a", "scene_a"), ("b", "scene_b")):
            os.symlink(os.path.join(scenes, scene, "000.hdr"),
                       os.path.join(eval_dir, name + ".hdr"))
        os.symlink(os.path.join(scenes, "scene_a"),
                   os.path.join(video_root, "scene_a"))
        lam = os.path.join(tmp, "lambdas.npy")
        np.save(lam, {"a": scene_lams["scene_a"],
                      "scene_a": scene_lams["scene_a"]})
        hist = os.path.join(tmp, "mean_hist.npy")
        t = np.linspace(0.4, 1.6, 20, dtype=np.float32)
        np.save(hist, {"mean_vals": t, "all_bins": np.linspace(0, 1, 21)})
        opt = Options(test_dataroot_original_hdr=eval_dir,
                      f_factor_path=lam, mean_hist_path=hist,
                      lambdas_path=os.path.join(tmp, "lambdas"),
                      output_dir=tmp)
        gen = seeded_init_(UNetTMO(), seed).to("cuda")
        fit = StageClock(torch)
        saved_fit = lambda_est.fit_lambda
        lambda_est.fit_lambda = fit.wrap("lambda_fit", saved_fit)
        torch.cuda.reset_peak_memory_stats()
        try:
            t0 = time.perf_counter()
            image_t = Tester(opt, gen, device="cuda")
            init_s = time.perf_counter() - t0
        finally:
            lambda_est.fit_lambda = saved_fit
        video_t = Tester(opt, gen, video=True, test_video_path=video_root,
                         device="cuda")
        # the fitted lambda against the CPU fit of the same gray
        rgb = read_hdr_image(os.path.join(eval_dir, "b.hdr"))
        gray = rgb[..., :3] @ np.asarray(params.REC601, np.float32)
        gray = gray / gray.max()
        lam_card = float(image_t.lambda_table["b"])
        lam_cpu = lambda_est.fit_lambda(gray, t, device="cpu")
        lam_err = abs(lam_card - lam_cpu) / lam_cpu
        if not lam_err <= LAMBDA_RTOL:
            ces = {v: lambda_est.cross_entropy_np(v, gray, t, 20)
                   for v in (lam_card, lam_cpu)}
            raise AssertionError(f"tester: lambda {lam_card} on the card, "
                                 f"{lam_cpu} on the CPU; CE {ces}")
        rows = {}
        for path, tester in (("image", image_t), ("video", video_t)):
            # the trainer hands its live weights on the card
            timed_eval(torch, tester, gen.state_dict(),
                       os.path.join(tmp, "warm_" + path), 0)
            reset_counts()
            metrics, ms, scored, devices = timed_eval(
                torch, tester, gen.state_dict(), os.path.join(tmp, path),
                1)
            counts = read_counts()
            want = TESTER_LAUNCHES[path]
            if any(v != want for v in counts.values()):
                raise AssertionError(f"tester {path}: launches {counts}, "
                                     f"expected {want} each")
            # each render's TMQI on the card against the CPU's: Q, S, N
            # and the five s_l.  Q and S are NaN where an s_l is
            # negative (an untrained G can anti-correlate with its
            # input); NaN must meet NaN, and at least one render must
            # have a finite Q, so that Q and S are compared
            q_err, n_nan = 0.0, 0
            for _, (orig, out01), q in scored:
                card = tmqi(orig, out01 * 255.0, device="cuda")
                cpu = tmqi(orig, out01.cpu() * 255.0, device="cpu")
                a = np.array(card[:3] + tuple(card[3]))
                b = np.array(cpu[:3] + tuple(cpu[3]))
                if (not np.array_equal(np.isnan(a), np.isnan(b))
                        or not np.array_equal([q], a[:1], equal_nan=True)
                        or np.nanmax(np.abs(a - b)) > TMQI_TOL):
                    raise AssertionError(
                        f"tester {path}: TMQI Q, S, N, s_l {a.tolist()} on"
                        f" the card (the Tester's Q {q}), {b.tolist()} "
                        "on the CPU")
                q_err = max(q_err, float(np.nanmax(np.abs(a - b))))
                n_nan += int(np.isnan(a[0]))
            if n_nan == len(scored):
                raise AssertionError(f"tester {path}: every render's Q "
                                     "is NaN; Q and S were not compared")
            rec = dict(generator=path, dtype="float32",
                       frame=list(FRAME_HW), renders=len(scored),
                       metrics=metrics, launches=counts,
                       expected_launches=want,
                       tmqi_max_abs_err_cuda_vs_cpu=q_err,
                       renders_with_nan_q=n_nan, **ms)
            if path == "video":
                resolved = warp_error.resolve_flow_algo(card=True)
                if (metrics.get("flow_algo") != "hs_jax"
                        or resolved != "hs_jax"
                        or devices != ["cuda"]):
                    raise AssertionError(
                        f"tester video: flow {metrics.get('flow_algo')} "
                        f"/ {resolved} on {devices}, expected the torch "
                        "Horn-Schunck on cuda")
                # two scene renders, cropped: card against the CPU
                frames = [out for _, (_, out), _ in scored[:2]]
                h, w = SMALL_HW
                pair = [f[:h, :w] for f in frames]
                u8 = [(f[..., 0] * 255.0).clamp(0, 255).to(torch.uint8)
                      for f in pair]
                f_card = horn_schunck_flow(u8[0].float() / 255.0,
                                           u8[1].float() / 255.0)
                f_cpu = horn_schunck_flow(u8[0].cpu().float() / 255.0,
                                          u8[1].cpu().float() / 255.0)
                flow_err = (f_card.cpu() - f_cpu).abs().max().item()
                # the Tester's call on the card, against the torch
                # branch on the CPU (on the host, with cv2, the branch
                # would be cv2's)
                e_card = warp_error.compute_warp_error(pair[0], pair[1])
                e_cpu = warp_error.warp_error_torch(pair[0].cpu(),
                                                    pair[1].cpu())
                e_err = max(abs(a - b) / abs(b)
                            for a, b in zip(e_card, e_cpu))
                rec.update(flow_backend=resolved, flow_devices=devices,
                           cv2_importable=cv2_present,
                           flow_max_abs_px_cuda_vs_cpu=flow_err,
                           warp_e1_e2_cuda=list(e_card),
                           warp_e1_e2_cpu=list(e_cpu),
                           warp_rel_err_cuda_vs_cpu=e_err)
                if not (flow_err <= FLOW_TOL_PX and e_err <= WARP_RTOL):
                    raise AssertionError(
                        f"tester: flow {flow_err} px, E1/E2 {e_card} vs "
                        f"{e_cpu} card vs CPU")
            else:
                rec.update(init_s=init_s, lambda_card=lam_card,
                           lambda_cpu=lam_cpu, lambda_rel_err=lam_err,
                           **fit.ms())
            emit("tester", **rec)
            for k, v in counts.items():
                total[k] = total.get(k, 0) + v
        emit("tester_memory",
             peak_memory_gb=torch.cuda.max_memory_allocated() / 1e9)
        del image_t, video_t, gen
        torch.cuda.empty_cache()
    return total


# the final assessment: 16 HDR inputs (one a ZIP / HALF OpenEXR file) at
# 540 x 960, rendered at 1/2 size, and 16 real PNGs of that size
ASSESS_IMAGES = 16
ASSESS_HW = (540, 960)
ASSESS_SCALE = 2
ASSESS_LAUNCHES = 4           # K1 and K2 a render: one forward of its tiles
VIDEO_RENDER = "video_render_1080p.png"   # written by the video phase
FID_BATCH = 20                # the FID loader's batch
EXTRACTOR_TOL = 1e-4          # card vs CPU activations, of their max-abs
FID_RTOL = 1e-3               # FID of the card's vs the CPU's activations
BTMQI_TOL = 5e-5              # 1080p features, card vs CPU (golden's 5e-5)


def write_exr_zip_half(path: str, rgb) -> None:
    """float RGB (H, W, 3) -> a scanline OpenEXR file of HALF samples, ZIP
    compressed (16 lines a chunk), from the file layout with struct and
    zlib: each line holds the B, G and R samples in turn; a chunk is the
    lines' bytes split into even and odd halves, delta-coded (+128), and
    deflated."""
    import struct
    import zlib
    import numpy as np

    def attr(name, kind, value):
        return (name + b"\0" + kind + b"\0" + struct.pack("<i", len(value))
                + value)

    h, w = rgb.shape[:2]
    chlist = b"".join(c + b"\0" + struct.pack("<iB3xii", 1, 0, 1, 1)
                      for c in (b"B", b"G", b"R")) + b"\0"
    box = struct.pack("<4i", 0, 0, w - 1, h - 1)
    head = (struct.pack("<iI", 20000630, 2)
            + attr(b"channels", b"chlist", chlist)
            + attr(b"compression", b"compression", b"\3")
            + attr(b"dataWindow", b"box2i", box)
            + attr(b"displayWindow", b"box2i", box)
            + attr(b"lineOrder", b"lineOrder", b"\0")
            + attr(b"pixelAspectRatio", b"float", struct.pack("<f", 1.0))
            + attr(b"screenWindowCenter", b"v2f", struct.pack("<2f", 0, 0))
            + attr(b"screenWindowWidth", b"float", struct.pack("<f", 1.0))
            + b"\0")
    half = np.asarray(rgb, np.float32).astype("<f2")
    chunks = []
    for y in range(0, h, 16):
        raw = np.ascontiguousarray(
            half[y:y + 16, :, ::-1].transpose(0, 2, 1)).tobytes()
        b = np.frombuffer(raw, np.uint8)
        t = np.concatenate([b[0::2], b[1::2]]).astype(np.int16)
        t[1:] = (t[1:] - t[:-1] + 128) & 0xFF
        data = zlib.compress(t.astype(np.uint8).tobytes())
        if len(data) >= len(raw):
            data = raw
        chunks.append(struct.pack("<ii", y, len(data)) + data)
    offsets, pos = [], len(head) + 8 * len(chunks)
    for c in chunks:
        offsets.append(pos)
        pos += len(c)
    with open(path, "wb") as f:
        f.write(head + struct.pack(f"<{len(chunks)}Q", *offsets)
                + b"".join(chunks))


def seeded_inception_weights(torch, path: str, seed: int) -> None:
    """A torchvision-named InceptionV3 state dict through Mixed_6e, drawn
    from `seed` (He-scaled convs, batch-norm statistics away from (0, 1)),
    saved as `.pth`: the published weights are not in the repository."""
    from uncltmo_tpu_torch.metrics.inception import InceptionTrunk768
    g = torch.Generator().manual_seed(seed)
    sd = {}
    with torch.device("meta"):               # shapes only, no init
        shapes = InceptionTrunk768().state_dict()
    for k, v in shapes.items():
        if not k.endswith(".weight"):
            continue
        p, (o, i, kh, kw) = k[:-len(".weight")], v.shape
        sd[p + ".conv.weight"] = (torch.randn(v.shape, generator=g)
                                  * (2.0 / (i * kh * kw)) ** 0.5)
        sd[p + ".bn.weight"] = 1.0 + 0.05 * torch.randn(o, generator=g)
        sd[p + ".bn.bias"] = 0.05 * torch.randn(o, generator=g)
        sd[p + ".bn.running_mean"] = 0.05 * torch.randn(o, generator=g)
        sd[p + ".bn.running_var"] = 0.5 + torch.rand(o, generator=g)
    torch.save(sd, path)


def same_json(a, b, tol: float) -> bool:
    """Two metric JSONs equal in structure, numbers within `tol` of each
    other (NaN meets NaN)."""
    import math
    if isinstance(b, dict):
        return a.keys() == b.keys() and all(same_json(a[k], b[k], tol)
                                            for k in b)
    if isinstance(b, float):
        return (math.isnan(a) and math.isnan(b)) or abs(a - b) <= tol
    return a == b


def phase_assessment(torch, seed, video_png: str) -> dict:
    """`GanTrainer.run_final_assessment` of an image-G trainer on the card:
    16 synthetic 540x960 HDR inputs (one a ZIP / HALF `.exr`) rendered at
    1/2 size, and the FID of the renders against 16 real PNGs with seeded
    Inception weights, merged into `fid_res_path`.  Held: 16 PNGs, 4
    launches of K1 and K2 a render, the FID finite, >= 0 and stored under
    the model's name (the tail catches and prints a failure, so a missing
    entry fails here); the FID recomputed from the card's activations,
    which match the CPU extractor's within EXTRACTOR_TOL of their
    max-abs, and the FID of the CPU's activations within FID_RTOL.
    Then `compute_metrics` on the card (tmqi of 4 inputs against their
    real-side PNGs, finite and within TMQI_TOL of the same on the CPU;
    btmqi over the renders) and BTMQI's features of the
    video phase's 1080p render, card vs CPU, with the entropy bins that
    differ.  Returns the launch counts."""
    import contextlib
    import io
    import numpy as np
    import scipy.linalg
    from uncltmo_tpu_torch.cli import compute_metrics
    from uncltmo_tpu_torch.data.pipeline import SyntheticDataSource
    from uncltmo_tpu_torch.inference import runner as runner_mod
    from uncltmo_tpu_torch.metrics import btmqi as btmqi_mod
    from uncltmo_tpu_torch.metrics import fid, inception
    from uncltmo_tpu_torch.training.trainer import GanTrainer
    from uncltmo_tpu_torch.utils.io import (read_png, write_png,
                                            write_radiance_hdr)
    t_phase = time.perf_counter()
    rng = np.random.default_rng(seed + 60)
    with tempfile.TemporaryDirectory() as tmp:
        inputs, real = os.path.join(tmp, "in"), os.path.join(tmp, "real")
        os.makedirs(inputs)
        os.makedirs(real)
        lams = {}
        for i in range(ASSESS_IMAGES):
            name = f"a{i:02d}"
            hdr = synthetic_hdr(rng, *ASSESS_HW)
            if i == 0:
                write_exr_zip_half(os.path.join(inputs, name + ".exr"), hdr)
            else:
                write_radiance_hdr(os.path.join(inputs, name + ".hdr"), hdr)
            lams[name] = float(rng.uniform(100, 1000))
            # the real side: a log tone map of the input at the renders'
            # size (2x2 means), named by the input's stem
            h, w = (n // ASSESS_SCALE for n in ASSESS_HW)
            ldr = np.log1p(hdr) / np.log1p(hdr.max()) * 255.0
            ldr = ldr.reshape(h, ASSESS_SCALE, w, ASSESS_SCALE, 3).mean(
                axis=(1, 3))
            write_png(os.path.join(real, name + ".png"),
                      np.clip(ldr, 0, 255).astype(np.uint8))
        lam = os.path.join(tmp, "lambdas.npy")
        np.save(lam, lams)
        weights = os.path.join(tmp, "inception.pth")
        seeded_inception_weights(torch, weights, seed)
        opt = trainer_options(os.path.join(tmp, "run"), seed)
        opt.fid_real_path, opt.inception_weights = real, weights
        trainer = GanTrainer(opt, source=SyntheticDataSource(
            size=TRAIN_BATCH[2], n_items=TRAIN_BATCH[0]), device="cuda")
        setup_s = time.perf_counter() - t_phase
        # the tail's stages, timed; the extractor's batches and activations
        # recorded for the CPU comparison
        clock = StageClock(torch)
        batches = []
        saved = (fid.load_fid_image, inception.make_inception_extractor,
                 scipy.linalg.sqrtm, runner_mod.InferenceRunner.run_on_path)

        def make_extractor(*args, **kwargs):
            timed = clock.wrap("extractor", saved[1](*args, **kwargs))

            def recorded(batch):
                acts = timed(batch)
                batches.append((batch, acts))
                return acts
            return recorded

        fid.load_fid_image = clock.wrap("decode_resample", saved[0])
        inception.make_inception_extractor = make_extractor
        scipy.linalg.sqrtm = clock.wrap("sqrtm", saved[2])
        runner_mod.InferenceRunner.run_on_path = clock.wrap("render",
                                                            saved[3])
        reset_counts()
        try:
            t0 = time.perf_counter()
            outs = trainer.run_final_assessment(inputs, lam,
                                                scale=ASSESS_SCALE)
            torch.cuda.synchronize()
            assess_s = time.perf_counter() - t0
        finally:
            (fid.load_fid_image, inception.make_inception_extractor,
             scipy.linalg.sqrtm, runner_mod.InferenceRunner.run_on_path) = \
                saved
        counts = read_counts()
        shapes = {read_png(p).shape for p in outs}
        want_hw = tuple(n // ASSESS_SCALE for n in ASSESS_HW)
        want = ASSESS_LAUNCHES * ASSESS_IMAGES
        if (len(outs) != ASSESS_IMAGES or shapes != {want_hw + (3,)}
                or any(v != want for v in counts.values())):
            raise AssertionError(f"assessment: {len(outs)} PNGs of {shapes}"
                                 f", launches {counts} (expected {want})")
        res_path = os.path.join(opt.output_dir, opt.fid_res_path + ".npy")
        stored = (np.load(res_path, allow_pickle=True)[()]
                  if os.path.exists(res_path) else {})
        fid_val = stored.get(opt.result_dir_prefix)
        if fid_val is None or not np.isfinite(fid_val) or fid_val < 0:
            raise AssertionError(f"assessment: FID {fid_val} stored in "
                                 f"{res_path} ({sorted(stored)})")
        # the card's activations against the CPU extractor's, and the FID
        # of each (real side first, then the fake side)
        n_real = len(os.listdir(real))
        card = np.concatenate([a for _, a in batches])
        t0 = time.perf_counter()
        cpu_ext = saved[1](weights, device="cpu")
        cpu = np.concatenate([cpu_ext(b) for b, _ in batches])
        cpu_extractor_s = time.perf_counter() - t0
        scale = float(np.abs(cpu).max())
        act_err = float(np.abs(card - cpu).max()) / scale
        act_err4 = float(np.abs(card[:4] - cpu[:4]).max()) / scale

        def fid_of(acts):
            vecs = fid.activations_to_patch_vectors(acts)
            return fid.frechet_distance(
                *fid.activation_statistics(vecs[:n_real * 64]),
                *fid.activation_statistics(vecs[n_real * 64:]))

        fid_card, fid_cpu = fid_of(card), fid_of(cpu)
        fid_err = abs(fid_card - fid_cpu) / abs(fid_cpu)
        # the extractor alone at the loader's batch, CUDA events
        ext = saved[1](weights, device="cuda")
        batch20 = np.concatenate([b for b, _ in batches])[:FID_BATCH]
        extractor_ms_20 = time_ms(lambda: ext(batch20), iters=5, warmup=2)
        if not (len(card) == 2 * ASSESS_IMAGES and act_err <= EXTRACTOR_TOL
                and abs(fid_card - fid_val) <= 1e-9 * fid_val
                and fid_err <= FID_RTOL):
            raise AssertionError(
                f"assessment: {len(card)} activations, card vs CPU "
                f"{act_err} of max-abs; FID stored {fid_val}, from the "
                f"card's activations {fid_card}, the CPU's {fid_cpu}")
        # compute_metrics on the card: TMQI of 4 inputs (the .exr among
        # them) against their real-side tone maps (an untrained G's renders
        # anti-correlate with their inputs, which makes Q NaN) at half
        # their size, against the same on the CPU, after one pair that
        # meets cuDNN's first calls at these shapes; BTMQI over the renders
        pairs, warm = os.path.join(tmp, "pairs"), os.path.join(tmp, "warm")
        os.makedirs(pairs)
        os.makedirs(warm)
        for i, n in enumerate(sorted(os.listdir(inputs))[:5]):
            os.symlink(os.path.join(inputs, n),
                       os.path.join(warm if i == 4 else pairs, n))
        render_dir = os.path.dirname(outs[0])
        js = {}
        cm_s = {}
        for tag, cmd in (
                ("tmqi_warm", ["tmqi", "--hdr_dir", warm, "--ldr_dir",
                               real, "--device", "cuda"]),
                ("tmqi", ["tmqi", "--hdr_dir", pairs, "--ldr_dir", real,
                          "--device", "cuda"]),
                ("tmqi_cpu", ["tmqi", "--hdr_dir", pairs, "--ldr_dir", real,
                              "--device", "cpu"]),
                ("btmqi", ["btmqi", "--ldr_dir", render_dir, "--device",
                           "cuda"])):
            path = os.path.join(tmp, tag + ".json")
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(io.StringIO()):
                compute_metrics.main(cmd + ["--output", path])
            torch.cuda.synchronize()
            cm_s[tag] = time.perf_counter() - t0
            with open(path) as f:
                js[tag] = json.load(f)
        btmqi_scores = list(js["btmqi"].values())
        if (len(js["tmqi"]["per_image"]) != 4
                or not np.isfinite(js["tmqi"]["mean_Q"])
                or not same_json(js["tmqi"], js["tmqi_cpu"], TMQI_TOL)
                or len(btmqi_scores) != ASSESS_IMAGES
                or not np.all(np.isfinite(btmqi_scores))):
            raise AssertionError(f"assessment: compute_metrics tmqi "
                                 f"{js['tmqi']} (CPU {js['tmqi_cpu']}), "
                                 f"btmqi {js['btmqi']}")
        # BTMQI of a 1080p render, card vs CPU, and the entropy bins that
        # differ between the two smoothings
        im = read_png(video_png)
        _, f_card = btmqi_mod.btmqi(im, device="cuda")
        _, f_cpu = btmqi_mod.btmqi(im, device="cpu")
        gray = torch.from_numpy(np.ascontiguousarray(
            (im.astype(np.float32) / 255.0)
            @ np.asarray(btmqi_mod.P.REC709, np.float32)))
        k = btmqi_mod.fspecial_gauss_1d(11, 1.5)
        mus = [btmqi_mod._smoothed_mean(gray.to(d), k).clamp(0, 1).cpu()
               for d in ("cuda", "cpu")]
        flips = sum(int(((mus[0] ** (2.0 ** e)) * 4095).int().ne(
            ((mus[1] ** (2.0 ** e)) * 4095).int()).sum()) for e in range(5))
        g_card = gray.cuda()
        btmqi_ms = time_ms(lambda: btmqi_mod.btmqi_features(g_card),
                           iters=5, warmup=1)
        b_err = float(np.abs(f_card - f_cpu).max())
        rec = dict(
            renders=len(outs), render_shape=list(want_hw) + [3],
            inputs=dict(hdr=ASSESS_IMAGES - 1, exr_zip_half=1,
                        hw=list(ASSESS_HW), scale=ASSESS_SCALE),
            launches=counts, expected_launches=want, fid=fid_val,
            fid_from_card_activations=fid_card,
            fid_from_cpu_activations=fid_cpu, fid_rel_err_cuda_vs_cpu=fid_err,
            activation_max_err_of_max_abs=act_err,
            activation_max_err_of_max_abs_first4=act_err4,
            activation_max_abs=scale, final_assessment_s=assess_s,
            fid_decode_resample_s=clock.seconds.get("decode_resample", 0.0),
            fid_extractor_calls=len(batches),
            fid_extractor_ms_per_call=(clock.seconds["extractor"]
                                       / len(batches) * 1e3),
            fid_extractor_batch=len(batches[0][0]),
            extractor_ms_batch20=extractor_ms_20,
            fid_sqrtm_s=clock.seconds.get("sqrtm", 0.0),
            render_s=clock.seconds.get("render", 0.0),
            cpu_extractor_s=cpu_extractor_s,
            tmqi_ms_per_pair=cm_s["tmqi"] / 4 * 1e3,
            tmqi_first_pair_ms=cm_s["tmqi_warm"] * 1e3,
            tmqi_cpu_ms_per_pair=cm_s["tmqi_cpu"] / 4 * 1e3,
            tmqi_mean_q=js["tmqi"]["mean_Q"],
            btmqi_cli_ms_per_render=cm_s["btmqi"] / ASSESS_IMAGES * 1e3,
            btmqi_ms_per_1080p_frame=btmqi_ms,
            btmqi_max_err_cuda_vs_cpu=b_err,
            btmqi_flipped_bins_cuda_vs_cpu=flips, setup_s=setup_s,
            phase_s=time.perf_counter() - t_phase)
        emit("assessment", **rec)
        if not b_err <= BTMQI_TOL:
            raise AssertionError(f"assessment: BTMQI 1080p features card vs "
                                 f"CPU {b_err} ({flips} bins differ)")
        del trainer, ext
        torch.cuda.empty_cache()
    return counts


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
    phase_first_launches(torch)
    k1 = phase_k1(torch, dtypes)
    k2 = phase_k2(torch, dtypes)
    phase_generator(torch, dtypes, args.seed)
    paths = [phase_end_to_end(torch, dtypes, args.seed, args.frames)]
    phase_kernels_extra(torch, dtypes)
    with tempfile.TemporaryDirectory() as shared:
        # the video phase's 1080p scenes, read again by the tester phase
        scenes = os.path.join(shared, "scenes")
        video, scene_lams = phase_video(torch, dtypes, args.seed, scenes)
        paths.append(video)
        paths.append(phase_whole_image(torch, dtypes, args.seed))
        k1b = phase_k1_backward(torch, dtypes)
        k2g = phase_k2_autograd(torch)
        k2g16 = phase_k2_autograd_bf16(torch)
        train, stage_ms = phase_train(torch, args.seed)
        phase_train_reference(torch)
        train16 = phase_train_bf16(torch, args.seed, stage_ms)
        options = phase_options(torch, args.seed)
        trainer = phase_trainer(torch, args.seed, stage_ms)
        data_parallel = phase_data_parallel(torch, args.seed)
        tester = phase_tester(torch, args.seed, scenes, scene_lams)
        assessment = phase_assessment(torch, args.seed,
                                      os.path.join(shared, VIDEO_RENDER))
    train = {k: train[k] + trainer[k] + options.get(k, 0)
             + data_parallel["float32"][k] for k in train}
    train16 = {k: v + data_parallel["bfloat16"][k]
               for k, v in train16.items()}
    # each path was driven with the counts set to 0 just before it and read
    # just after; the kernels line carries their sum (training, the options,
    # the Tester and the final assessment are float32 but for `train_bf16`)
    launches = {d: {k: sum(p[d][k] for p in paths) for k in paths[0][d]}
                for d in dtypes}
    for k in launches["float32"]:
        launches["float32"][k] += train[k] + tester[k] + assessment[k]
        launches["bfloat16"][k] += train16[k]

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
    # K1's gradient kernel: on the training paths, float32 (`train`,
    # `trainer`, the options' batch-norm steps) and bfloat16 (`train_bf16`)
    for dname, counted in (("float32", train), ("bfloat16", train16)):
        r = k1b[dname]
        kernels.append({
            "name": f"fused_concat_skip_backward/{dname}", "route": "triton",
            "source": "uncltmo_tpu_torch/ops/kernels/_concat_skip_triton.py",
            "replaces": "uncltmo_tpu/ops/pallas_kernels.py:221",
            "launches": counted["fused_concat_skip_backward"],
            "max_abs_err": max(x["max_abs_err"] for x in r),
            "ms": sum(x["ms"] for x in r),
            "plain_ms": sum(x["plain_ms"] for x in r),
            "bound_ms": sum(x["bound_ms"] for x in r),
            "bound_by": max(r, key=lambda x: x["bound_ms"])["bound_by"],
            "library_ms": None})
    # K2 under autograd, at the training batch: `ms` is the forward (the
    # kernel, saving for backward), `backward_ms` the library's gradients
    for dname, counted, rows in (("float32", train, k2g),
                                 ("bfloat16", train16, k2g16)):
        row = {
            "name": f"fused_double_conv3x3/autograd/{dname}", "route": "cuda",
            "source": "uncltmo_tpu_torch/ops/kernels/csrc/double_conv3x3.cu",
            "replaces": "uncltmo_tpu/ops/pallas_kernels.py:108",
            "launches": counted["fused_double_conv3x3"],
            "max_abs_err": max(x["y_max_abs_err"] for x in rows),
            "ms": sum(x["forward_ms"] for x in rows),
            "plain_ms": sum(x["plain_forward_ms"] for x in rows),
            "bound_ms": sum(x["bound_ms"] for x in rows),
            "bound_by": max(rows, key=lambda x: x["bound_ms"])["bound_by"],
            "library_ms": sum(x["library_forward_ms"] for x in rows),
            "batch": TRAIN_FRAMES,
            "backward_calls": counted["fused_double_conv3x3_backward_calls"],
            "backward_ms": sum(x["backward_ms"] for x in rows),
            "backward_bound_ms": sum(x["backward_bound_ms"] for x in rows),
            "plain_autograd_backward_ms": sum(
                x["plain_autograd_backward_ms"] for x in rows)}
        if "pack_ms" in rows[0]:
            row["pack_ms"] = sum(x["pack_ms"] for x in rows)
        kernels.append(row)
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
