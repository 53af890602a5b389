"""Compute dtypes under `torch.autocast`.

bfloat16 training runs the generator's and the discriminator's forwards and
the loss terms under autocast (`training/train_step.py`).  A few functions
must not follow it, because a bfloat16 product there changes a result
rather than rounding it: the GCN's KNN distances (a reordered neighbour is
another graph), the sliding-window statistics and the structural loss (their
variance formulas cancel large terms), and TMQI's naturalness.  The JAX
package pins them to float32 with `Precision.HIGHEST`
(`uncltmo_tpu/models/gcn.py:78-82`, `uncltmo_tpu/ops/windows.py:62-70,92`,
`uncltmo_tpu/losses/struct.py:33-38`); here they are `float32_island`s.
With TF32 off (`inference.engine.disable_tf32`) their products are full
float32 ones.
"""
from __future__ import annotations

import contextlib
import functools
from typing import Optional

import torch


def autocast_dtype(device_type: str) -> Optional[torch.dtype]:
    """The dtype autocast gives eligible ops on `device_type` now, or None
    when autocast is off there."""
    if torch.is_autocast_enabled(device_type):
        return torch.get_autocast_dtype(device_type)
    return None


@contextlib.contextmanager
def no_autocast():
    """Autocast off on the CPU and the card for a block of code."""
    with torch.autocast("cpu", enabled=False), \
            torch.autocast("cuda", enabled=False):
        yield


def float32_island(fn):
    """Run `fn` with autocast off on the CPU and the card, its tensor
    arguments (positional) of a narrower floating-point type as float32.
    On float32 and float64 inputs outside autocast it computes exactly what
    `fn` computes."""
    @functools.wraps(fn)
    def wrapped(*args, **kwargs):
        args = [a.float() if isinstance(a, torch.Tensor)
                and a.is_floating_point() and a.element_size() < 4 else a
                for a in args]
        with no_autocast():
            return fn(*args, **kwargs)
    return wrapped
