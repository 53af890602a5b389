"""The one traffic generator: seeded synthetic HDR radiance frames, scenes,
lambdas and Radiance `.hdr` files, made from a traffic file's parameters.

A frame is a smooth scene over about six decades of luminance with
coloured regions and 5% multiplicative noise (the smoke test's
`synthetic_hdr`, drawn on the device).  A scene is one such frame panning
and brightening slowly over its frames.  Files are run-length RGBE
(new-style scanlines: the mantissas as literal dumps, the exponents as
runs), written by `write_rle_hdr`.
"""
from __future__ import annotations

import numpy as np
import torch


def hdr_frames(gen: torch.Generator, n: int, h: int, w: int
               ) -> torch.Tensor:
    """(n, h, w, 3) float32 radiance on the generator's device."""
    dev = gen.device
    yy = torch.arange(h, dtype=torch.float32, device=dev)[:, None]
    xx = torch.arange(w, dtype=torch.float32, device=dev)[None, :]
    out = torch.empty((n, h, w, 3), dtype=torch.float32, device=dev)
    for i in range(n):
        f = 2.0 + 4.0 * torch.rand(4, generator=gen, device=dev)
        logl = (2.0 * torch.sin(f[0] * xx / w + f[1] * yy / h)
                + 1.5 * torch.cos(f[2] * yy / h)
                + torch.sin(f[3] * xx / w)) / 1.5
        tint = 0.3 + 0.7 * torch.rand(3, 1, 1, generator=gen, device=dev)
        rgb = (10.0 ** logl)[None] * (tint + 0.3 * torch.sin(
            xx[None] / (40.0 + 10.0 * tint)))
        rgb = rgb * (1.0 + 0.05 * torch.randn(3, h, w, generator=gen,
                                              device=dev))
        out[i] = rgb.clamp_(min=1e-4).permute(1, 2, 0)
    return out


def hdr_scenes(gen: torch.Generator, n: int, frames: int, h: int, w: int,
               pan: int, gain: float) -> torch.Tensor:
    """(n, frames, h, w, 3): frame k of a scene is its first frame shifted
    by k * pan pixels and scaled by 1 + k * gain."""
    base = hdr_frames(gen, n, h, w)
    return torch.stack([torch.roll(base, k * pan, dims=2) * (1.0 + k * gain)
                        for k in range(frames)], 1)


def gan_batches(gen: torch.Generator, n: int, b: int, frames: int,
                size: int) -> list:
    """n training batches in the pipeline's layout on the generator's
    device: `hdr` (lambda-log luma), `ldr_pos` and `ldr_neg` (luma in
    [0, 1], the negative gamma-3 darkened), each (b, frames, size, size,
    1): smooth scenes plus noise at a brightness of their own (the smoke
    test's `synthetic_batch`)."""
    dev = gen.device
    ax = torch.arange(size, dtype=torch.float32, device=dev) / size
    yy, xx = ax[:, None], ax[None, :]
    out = []
    for _ in range(n):
        batch = {}
        for key, gamma in (("hdr", 1.0), ("ldr_pos", 1.0), ("ldr_neg", 3.0)):
            f = 2.0 + 7.0 * torch.rand(b, frames, 2, 1, 1, generator=gen,
                                       device=dev)
            level = 0.15 + 0.55 * torch.rand(b, frames, 1, 1, generator=gen,
                                             device=dev)
            img = (level + 0.2 * torch.sin(f[:, :, 0] * xx + f[:, :, 1] * yy)
                   + 0.08 * torch.randn(b, frames, size, size, generator=gen,
                                        device=dev))
            batch[key] = (img.clamp(0.0, 1.0) ** gamma)[..., None]
        out.append(batch)
    return out


def lambdas(rng: np.random.Generator, n: int, lo: float, hi: float
            ) -> list:
    """n lambdas, uniform in [lo, hi] (the lambda dictionary's values)."""
    return [float(v) for v in rng.uniform(lo, hi, n)]


def rgbe(rgb: torch.Tensor) -> np.ndarray:
    """(h, w, 3) radiance -> (h, w, 4) uint8 RGBE (mantissa truncated),
    converted on the tensor's device."""
    v = rgb.max(-1).values
    mant, exp = torch.frexp(v)
    ok = v >= 1e-32
    scale = torch.where(ok, mant * 256.0 / torch.where(ok, v, 1.0), 0.0)
    out = torch.empty(rgb.shape[:2] + (4,), dtype=torch.uint8,
                      device=rgb.device)
    out[..., :3] = (rgb * scale[..., None]).clamp(0, 255).to(torch.uint8)
    out[..., 3] = torch.where(ok, exp + 128, 0).to(torch.uint8)
    return out.cpu().numpy()


def rle_scanlines(px: np.ndarray) -> bytes:
    """(h, w, 4) RGBE -> new-style run-length scanlines: per row the header
    2, 2, w >> 8, w & 255, then the three mantissa channels as literal
    dumps of up to 128 bytes and the exponent channel as runs of up to
    127."""
    h, w, _ = px.shape
    n_dumps = -(-w // 128)
    chunks = np.zeros((h, 3, n_dumps, 129), np.uint8)
    chunks[..., 0] = 128
    chunks[..., -1, 0] = w - 128 * (n_dumps - 1)
    mant = np.zeros((h, 3, n_dumps * 128), np.uint8)
    mant[..., :w] = px[..., :3].transpose(0, 2, 1)
    chunks[..., 1:] = mant.reshape(h, 3, n_dumps, 128)
    # the last dump's padding lies at the end of each channel's bytes
    dumps = chunks.reshape(h, 3, -1)[..., :w + n_dumps]
    head = np.empty((h, 4), np.uint8)
    head[:] = (2, 2, w >> 8, w & 255)
    fixed = np.concatenate([head, dumps.reshape(h, -1)], 1)

    e = px[..., 3]
    starts = np.ones((h, w), bool)
    starts[:, 1:] = e[:, 1:] != e[:, :-1]
    starts = np.flatnonzero(starts)
    lengths = np.diff(np.append(starts, h * w))
    pieces = -(-lengths // 127)
    first = np.repeat(starts, pieces)
    k = np.arange(len(first)) - np.repeat(np.cumsum(pieces) - pieces, pieces)
    p_start = first + 127 * k
    p_len = np.minimum(127, np.repeat(starts + lengths, pieces) - p_start)
    codes = np.empty((len(p_start), 2), np.uint8)
    codes[:, 0] = 128 + p_len
    codes[:, 1] = e.reshape(-1)[p_start]
    per_row = np.bincount(p_start // w, minlength=h)
    runs = np.split(codes.reshape(-1), 2 * np.cumsum(per_row)[:-1])
    return b"".join(part for r in range(h)
                    for part in (fixed[r].tobytes(), runs[r].tobytes()))


def write_rle_hdr(path: str, rgb: torch.Tensor) -> str:
    """Write (h, w, 3) radiance as a run-length Radiance `.hdr` file."""
    h, w = rgb.shape[:2]
    with open(path, "wb") as f:
        f.write(b"#?RADIANCE\nFORMAT=32-bit_rle_rgbe\n\n")
        f.write(f"-Y {h} +X {w}\n".encode())
        f.write(rle_scanlines(rgbe(rgb)))
    return path


def write_lambda_dict(path: str, names, values) -> str:
    np.save(path, dict(zip(names, values)))
    return path
