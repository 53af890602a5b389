"""What the wrappers of the hand-written CUDA kernels share: their weights
packed in TF32 planes, in the byte image of `wgmma`'s shared-memory
stages, and the key a kept packing depends on."""
from __future__ import annotations

from typing import NamedTuple

import torch


class PackedCell(NamedTuple):
    """A cell's two weights in the layout its kernel reads, and its two
    biases as they are (contiguous)."""
    w1: torch.Tensor
    b1: torch.Tensor
    w2: torch.Tensor
    b2: torch.Tensor


def round_up(n: int, m: int) -> int:
    return -(-n // m) * m


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """float32 rounded to TF32 (10 mantissa bits) to nearest, ties away
    from zero, as the card's `cvt.rna.tf32.f32`."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def tf32_split(w: torch.Tensor):
    """w = hi + lo + (error below 2^-21 |w|), hi and lo both TF32."""
    hi = tf32_round(w)
    return hi, tf32_round(w - hi)


def b_image_index(k: int, n: int, es: int) -> torch.Tensor:
    """Element offsets (k, n) -> position in the shared-memory image of a
    K x N weight operand as `wgmma` reads it through the kernel's
    descriptors: K-major, each row n holding K elements in S = min(K * es,
    128) bytes (the swizzle width: 32, 64 or 128), K beyond 128 bytes in
    column blocks of N rows, and the 16-byte chunks of a row XOR-ed with
    bits of the row number as Hopper's 128 / 64 / 32-byte swizzles do
    (address bits [4, 4 + log2(S / 16)) ^= bits [7, ...))."""
    s = min(k * es, 128)
    assert s in (32, 64, 128) and k * es % s == 0 and n % 8 == 0, (k, n, es)
    rk, per16 = s // es, 16 // es
    kk = torch.arange(k)[:, None]
    nn = torch.arange(n)[None, :]
    swz = (nn % 8) >> {128: 0, 64: 1, 32: 2}[s]
    chunk = ((kk % rk) // per16) ^ swz
    byte = (kk // rk) * n * s + nn * s + chunk * 16 + (kk % per16) * es
    return byte // es


def stage_images(b: torch.Tensor, es: int) -> torch.Tensor:
    """b (planes, ..., N, K), a weight operand per row n of outputs ->
    (..., planes, K * N) in the stage image's order."""
    planes, n, k = b.shape[0], b.shape[-2], b.shape[-1]
    idx = b_image_index(k, n, es).T.reshape(-1)
    out = b.new_empty(b.shape[1:-2] + (planes, k * n))
    for p in range(planes):
        out[..., p, idx] = b[p].reshape(b.shape[1:-2] + (k * n,))
    return out


def weights_key(*params: torch.Tensor, dtype: torch.dtype | None = None):
    """What a cached packing depends on: a reload, a cast, a move or an
    in-place update of any parameter changes the key, and so does the dtype
    the weights are packed in (`dtype`, None for their own)."""
    return tuple((p.data_ptr(), p.dtype, p.device, p._version)
                 for p in params) + (dtype,)


def check_packed(what: str, packed: PackedCell, sizes, plan) -> None:
    """Raise unless `packed` holds the elements (w1, w2) `plan` reads."""
    if (packed.w1.numel(), packed.w2.numel()) != tuple(sizes):
        raise ValueError(f"{what}: `packed` was not packed under the "
                         f"kernel's plan {plan}")
