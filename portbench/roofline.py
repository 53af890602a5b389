"""The yardstick's peaks and its counts of operations and bytes.

Peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense rates at the 700 W
limit).  The port computes in float32; the highest rate at which the chip
multiplies float32 inputs is the TF32 tensor rate, and FFT convolutions
and split-TF32 products both beat the 67 TFLOP/s of the FMA units on
direct-convolution operations, so every share of a float32 peak here is
taken against 495 TFLOP/s.  Work is counted from shapes, whatever kernel
does it: a valid 3x3 convolution is 2 * 9 * Cin * Cout * Hout * Wout
operations, and every input is read once and every output written once.
"""
from __future__ import annotations

import torch

PEAK_FLOPS_F32 = 495e12        # TF32 tensor cores, dense
HBM_BYTES_PER_S = 3.35e12


def conv3x3_flops(batch: int, cin: int, cout: int, h_out: int,
                  w_out: int) -> float:
    return 2.0 * 9 * cin * cout * h_out * w_out * batch


def double_conv_work(batch: int, cin: int, c1: int, c2: int, h: int,
                     w: int, elem: int = 4):
    """(operations, bytes) of a valid (conv3x3 -> bias -> relu) x 2 cell on
    a (batch, cin, h, w) input: its input, both weights and biases read
    once, its (batch, c2, h - 4, w - 4) output written once."""
    flops = (conv3x3_flops(batch, cin, c1, h - 2, w - 2)
             + conv3x3_flops(batch, c1, c2, h - 4, w - 4))
    nbytes = elem * (batch * cin * h * w + 9 * cin * c1 + c1 + 9 * c1 * c2
                     + c2 + batch * c2 * (h - 4) * (w - 4))
    return flops, nbytes


def roofline_pct(flops: float, nbytes: float, device_s: float) -> float:
    """The least time the chip could take (the larger of operations over
    the peak and bytes over the bandwidth) as a share of `device_s`, %."""
    least = max(flops / PEAK_FLOPS_F32, nbytes / HBM_BYTES_PER_S)
    return 100.0 * least / device_s


def counted_flops(fn, *args) -> float:
    """Operations of fn(*args) as torch's FlopCounterMode counts them
    (convolutions, transposed convolutions, matrix products)."""
    from torch.utils.flop_counter import FlopCounterMode
    with FlopCounterMode(display=False) as counter:
        fn(*args)
    return float(counter.get_total_flops())


def generator_flops_per_tile(tile: int = 256) -> float:
    """The reference generator's operations on one tile, counted on meta
    tensors (no arithmetic is done)."""
    from .reference import unet
    p = {k: torch.empty(s, device="meta")
         for k, s in unet.param_shapes().items()}
    x = torch.empty((1, 1, tile, tile), device="meta")
    return counted_flops(lambda: unet.generator_frame(p, x))
