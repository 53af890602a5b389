"""Plain reference of the host I/O around the pipeline: the Radiance RGBE
decode (flat and new-style run-length scanlines, mantissa * 2^(e - 136) as
cv2 and `rgbe.c` decode it), cv2 INTER_LINEAR's downscale (half-pixel
centres, no antialiasing) and a PNG decoder (8-bit gray or RGB, all five
row filters) to read back what the program wrote."""
from __future__ import annotations

import struct
import zlib

import numpy as np
import torch


def decode_radiance(buf: bytes) -> np.ndarray:
    """Radiance `.hdr` bytes -> float32 (H, W, 3)."""
    head_end = buf.index(b"\n\n") + 2
    line_end = buf.index(b"\n", head_end)
    words = buf[head_end:line_end].split()
    if words[0] != b"-Y" or words[2] != b"+X":
        raise ValueError(f"resolution line {buf[head_end:line_end]!r}")
    h, w = int(words[1]), int(words[3])
    data = np.frombuffer(buf, np.uint8, offset=line_end + 1)
    if not (data[0] == 2 and data[1] == 2 and data[2] < 128):
        rgbe = data[:h * w * 4].reshape(h, w, 4)
    else:
        rgbe = np.empty((h, w, 4), np.uint8)
        pos = 0
        for y in range(h):
            if data[pos] != 2 or data[pos + 1] != 2 or (
                    int(data[pos + 2]) << 8 | int(data[pos + 3])) != w:
                raise ValueError(f"scanline {y}: bad header")
            pos += 4
            for c in range(4):
                x = 0
                row = rgbe[y, :, c]
                while x < w:
                    n = int(data[pos])
                    if n > 128:
                        row[x:x + n - 128] = data[pos + 1]
                        x += n - 128
                        pos += 2
                    else:
                        row[x:x + n] = data[pos + 1:pos + 1 + n]
                        x += n
                        pos += 1 + n
    e = rgbe[..., 3].astype(np.int32)
    scale = np.where(e > 0, np.exp2((e - 136).astype(np.float64)), 0.0)
    return (rgbe[..., :3] * scale[..., None]).astype(np.float32)


def _axis(n_in: int, n_out: int):
    pos = (np.arange(n_out) + 0.5) * (n_in / n_out) - 0.5
    pos = np.maximum(pos, 0.0)
    i0 = np.minimum(np.floor(pos).astype(np.int64), n_in - 1)
    i1 = np.minimum(i0 + 1, n_in - 1)
    return i0, i1, (pos - i0).astype(np.float32)


def downscale(rgb: torch.Tensor, scale: int) -> torch.Tensor:
    """(H, W, C) -> (H // scale, W // scale, C), bilinear, half-pixel."""
    h, w = rgb.shape[0] // scale, rgb.shape[1] // scale
    dev = rgb.device
    y0, y1, fy = (torch.from_numpy(a).to(dev) for a in
                  _axis(rgb.shape[0], h))
    x0, x1, fx = (torch.from_numpy(a).to(dev) for a in
                  _axis(rgb.shape[1], w))
    rows = (rgb[y0] * (1 - fy)[:, None, None] + rgb[y1] * fy[:, None, None])
    return (rows[:, x0] * (1 - fx)[None, :, None]
            + rows[:, x1] * fx[None, :, None])


def decode_png(buf: bytes) -> np.ndarray:
    """8-bit gray or RGB PNG bytes -> uint8 (H, W[, 3])."""
    if buf[:8] != b"\x89PNG\r\n\x1a\n":
        raise ValueError("not a PNG")
    pos, idat, ihdr = 8, [], None
    while pos < len(buf):
        n, kind = struct.unpack(">I4s", buf[pos:pos + 8])
        body = buf[pos + 8:pos + 8 + n]
        if kind == b"IHDR":
            ihdr = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        pos += 12 + n
    w, h, depth, ctype, _, _, interlace = ihdr
    ch = {0: 1, 2: 3}.get(ctype)
    if depth != 8 or ch is None or interlace:
        raise ValueError(f"PNG type {ihdr} is not read here")
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    raw = raw.reshape(h, 1 + w * ch)
    out = np.zeros((h, w * ch), np.uint8)
    prev = np.zeros(w * ch, np.int32)
    for y in range(h):
        f, line = raw[y, 0], raw[y, 1:].astype(np.int32)
        if f == 0:
            cur = line
        elif f == 2:
            cur = (line + prev) & 255
        elif f in (1, 3, 4):
            cur = np.zeros_like(line)
            for i in range(len(line)):
                a = cur[i - ch] if i >= ch else 0
                b = prev[i]
                c = prev[i - ch] if i >= ch else 0
                if f == 1:
                    pred = a
                elif f == 3:
                    pred = (a + b) // 2
                else:
                    pa, pb, pc = abs(b - c), abs(a - c), abs(a + b - 2 * c)
                    pred = a if pa <= pb and pa <= pc else (
                        b if pb <= pc else c)
                cur[i] = (line[i] + pred) & 255
        else:
            raise ValueError(f"PNG row filter {f}")
        out[y] = cur
        prev = cur
    return out.reshape(h, w, ch) if ch > 1 else out.reshape(h, w)
