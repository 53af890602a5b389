"""Host image I/O in numpy and the standard library alone (no cv2, imageio
or PIL): a Radiance `.hdr` reader (RGBE, flat and new-style RLE scanlines)
and writer, the OpenEXR reader (`utils/exr.py`, re-exported here), `.npy`
input, a PNG writer and reader on zlib + struct, the LDR reader of the
metrics, and the lambda dictionary loader (port of
`uncltmo_tpu/utils/io.py`).  LDR files that the
PNG reader does not take (filtered rows, JPEG, 16 bits) are decoded by
imageio or cv2, imported inside the function, as the JAX reader does."""
from __future__ import annotations

import functools
import os
import re
import struct
import zlib

import numpy as np

from .exr import read_exr  # noqa: F401  (the readers' import path)

# The extensions a directory listing takes as HDR input, matched with their
# case as the JAX package does (`uncltmo_tpu/utils/io.py:28`): `a.HDR` is
# not listed by either.
HDR_EXTENSIONS = (".hdr", ".dng", ".exr", ".npy")
# Listed, but with no decoder here (the JAX package reads it through
# imageio's FreeImage plugin): `read_hdr_image` refuses it by name.
UNDECODED_EXTENSIONS = (".dng",)


def list_hdr_names(directory: str) -> list:
    """The sorted file names of `directory` that the runners take as HDR
    input."""
    return sorted(n for n in os.listdir(directory)
                  if os.path.splitext(n)[1] in HDR_EXTENSIONS)

_RES_RE = re.compile(rb"^-Y (\d+) \+X (\d+)$")


def _rle_channel(buf: bytes, pos: int, width: int) -> tuple[np.ndarray, int]:
    """One channel of a new-style RLE scanline."""
    out = np.empty(width, np.uint8)
    x = 0
    while x < width:
        count = buf[pos]
        pos += 1
        if count > 128:
            count -= 128
            if x + count > width:
                raise IOError("corrupt RLE run in .hdr scanline")
            out[x:x + count] = buf[pos]
            pos += 1
        else:
            if count == 0 or x + count > width:
                raise IOError("corrupt RLE dump in .hdr scanline")
            out[x:x + count] = np.frombuffer(buf, np.uint8, count, pos)
            pos += count
        x += count
    return out, pos


def _decode_rgbe(buf: bytes, pos: int, h: int, w: int) -> np.ndarray:
    """Scanline data -> (h, w, 4) uint8 RGBE."""
    new_rle = (8 <= w < 32768 and len(buf) >= pos + 4
               and buf[pos] == 2 and buf[pos + 1] == 2
               and not buf[pos + 2] & 0x80)
    if not new_rle:
        n = h * w * 4
        if len(buf) - pos < n:
            raise IOError("truncated flat .hdr data (old-style RLE is not "
                          "supported)")
        return np.frombuffer(buf, np.uint8, n, pos).reshape(h, w, 4)
    rgbe = np.empty((h, w, 4), np.uint8)
    for y in range(h):
        if (buf[pos] != 2 or buf[pos + 1] != 2
                or (buf[pos + 2] << 8 | buf[pos + 3]) != w):
            raise IOError(f"bad RLE scanline header at row {y}")
        pos += 4
        for c in range(4):
            rgbe[y, :, c], pos = _rle_channel(buf, pos, w)
    return rgbe


def read_radiance_hdr(path: str) -> np.ndarray:
    """Radiance RGBE `.hdr` -> float32 RGB (H, W, 3).  Mantissa * 2^(e-136),
    without the half-step offset, as cv2 and the rgbe.c reader decode."""
    with open(path, "rb") as f:
        buf = f.read()
    if not buf.startswith((b"#?RADIANCE", b"#?RGBE")):
        raise IOError(f"{path}: not a Radiance .hdr file")
    pos = buf.index(b"\n\n") + 2          # header ends at an empty line
    end = buf.index(b"\n", pos)
    m = _RES_RE.match(buf[pos:end].strip())
    if m is None:
        raise IOError(f"{path}: unsupported resolution line "
                      f"{buf[pos:end]!r} (only -Y H +X W)")
    h, w = int(m.group(1)), int(m.group(2))
    rgbe = _decode_rgbe(buf, end + 1, h, w)
    e = rgbe[..., 3].astype(np.int32)
    scale = np.where(e == 0, 0.0,
                     np.ldexp(1.0, e - 136)).astype(np.float32)
    return rgbe[..., :3].astype(np.float32) * scale[..., None]


def write_radiance_hdr(path: str, rgb: np.ndarray) -> str:
    """float RGB (H, W, 3) -> flat (uncompressed) Radiance `.hdr`."""
    rgb = np.asarray(rgb, np.float32)
    h, w = rgb.shape[:2]
    v = rgb.max(axis=-1)
    mant, exp = np.frexp(v)
    ok = v >= 1e-32
    scale = np.where(ok, mant * 256.0 / np.where(ok, v, 1.0), 0.0)
    rgbe = np.zeros((h, w, 4), np.uint8)
    rgbe[..., :3] = np.clip(rgb * scale[..., None], 0, 255).astype(np.uint8)
    rgbe[..., 3] = np.where(ok, exp + 128, 0).astype(np.uint8)
    with open(path, "wb") as f:
        f.write(b"#?RADIANCE\nFORMAT=32-bit_rle_rgbe\n\n")
        f.write(f"-Y {h} +X {w}\n".encode())
        f.write(rgbe.tobytes())
    return path


def read_hdr_image(path: str) -> np.ndarray:
    """Read a linear HDR image as float32 RGB (H, W, 3)."""
    ext = os.path.splitext(path)[1].lower()
    if ext == ".npy":
        return np.load(path, allow_pickle=True).astype("float32")
    if ext == ".hdr":
        return read_radiance_hdr(path)
    if ext == ".exr":
        return read_exr(path)
    if ext in UNDECODED_EXTENSIONS:
        raise NotImplementedError(
            f"{path}: the port has no {ext} decoder (ROADMAP Queue 3; the "
            "JAX package reads it through imageio's FreeImage plugin); "
            "convert the file to .exr, .hdr or .npy")
    raise IOError(f"no reader for {path} (listed: {HDR_EXTENSIONS})")


def _png_chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))


def write_png(path: str, im: np.ndarray, level: int = 1) -> str:
    """uint8 (H, W) gray or (H, W, 3) RGB -> PNG (no filter, zlib `level`)."""
    im = np.ascontiguousarray(im, np.uint8)
    if im.ndim == 2:
        color_type, ch = 0, 1
    elif im.ndim == 3 and im.shape[2] == 3:
        color_type, ch = 2, 3
    else:
        raise ValueError(f"write_png: unsupported shape {im.shape}")
    h, w = im.shape[:2]
    rows = np.zeros((h, 1 + w * ch), np.uint8)     # filter byte 0 per row
    rows[:, 1:] = im.reshape(h, w * ch)
    ihdr = struct.pack(">IIBBBBB", w, h, 8, color_type, 0, 0, 0)
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n")
        f.write(_png_chunk(b"IHDR", ihdr))
        f.write(_png_chunk(b"IDAT", zlib.compress(rows.tobytes(), level)))
        f.write(_png_chunk(b"IEND", b""))
    return path


def read_png(path: str) -> np.ndarray:
    """Read back a PNG written by `write_png`: 8-bit gray, gray + alpha, RGB
    or RGBA, filter type 0 rows only."""
    with open(path, "rb") as f:
        buf = f.read()
    if not buf.startswith(b"\x89PNG\r\n\x1a\n"):
        raise IOError(f"{path}: not a PNG")
    pos, idat, hdr = 8, b"", None
    while pos < len(buf):
        n, = struct.unpack(">I", buf[pos:pos + 4])
        kind, data = buf[pos + 4:pos + 8], buf[pos + 8:pos + 8 + n]
        pos += 12 + n
        if kind == b"IHDR":
            hdr = struct.unpack(">IIBBBBB", data)
        elif kind == b"IDAT":
            idat += data
    w, h, depth, color_type = hdr[0], hdr[1], hdr[2], hdr[3]
    ch = {0: 1, 2: 3, 4: 2, 6: 4}.get(color_type)
    if depth != 8 or ch is None:
        raise IOError(f"{path}: only 8-bit gray/RGB(A) PNGs are read")
    rows = np.frombuffer(zlib.decompress(idat), np.uint8).reshape(
        h, 1 + w * ch)
    if rows[:, 0].any():
        raise IOError(f"{path}: filtered PNG rows are not supported")
    im = rows[:, 1:].reshape(h, w, ch)
    return im[..., 0] if ch == 1 else im


def _read_with_library(path: str) -> np.ndarray:
    """An LDR file decoded by imageio, else cv2 (as RGB or RGBA, alpha
    kept); without either, a refusal by name."""
    try:
        import imageio.v2 as imageio
        return np.asarray(imageio.imread(path))
    except ImportError:
        pass
    try:
        import cv2
    except ImportError:
        raise NotImplementedError(
            f"{path}: the port reads 8-bit PNG files written without row "
            "filters; other LDR files need imageio or cv2, as the JAX "
            "reader does, and neither imports here") from None
    im = cv2.imread(path, cv2.IMREAD_UNCHANGED)
    if im is None:
        raise IOError(f"cv2 could not decode {path}")
    if im.ndim == 2:                 # IMREAD_COLOR's gray -> 3 channels
        return cv2.cvtColor(im, cv2.COLOR_GRAY2RGB)
    return cv2.cvtColor(im, cv2.COLOR_BGRA2RGBA if im.shape[2] == 4
                        else cv2.COLOR_BGR2RGB)


def decode_ldr(path: str) -> np.ndarray:
    """The samples of an LDR file as stored, alpha kept: uint8 (or uint16)
    (H, W) gray or (H, W, C) gray + alpha, RGB or RGBA.  A PNG that the
    port's reader takes is read by it; anything else by a library."""
    if path.lower().endswith(".png"):
        try:
            return read_png(path)
        except (OSError, ValueError):
            pass                     # filtered rows, 16 bits, a palette
    return _read_with_library(path)


def read_ldr_image(path: str) -> np.ndarray:
    """An LDR image as float32 in [0, 1], RGB or gray, alpha dropped (the
    JAX package's `utils/io.read_ldr_image`): scaled by the integer type's
    full range.  Gray + alpha comes back as the (H, W) gray plane, as a
    gray file does."""
    im = decode_ldr(path)
    scale = 255.0 if im.dtype != np.uint16 else 65535.0
    im = im.astype(np.float32) / scale
    if im.ndim == 3 and im.shape[-1] == 4:
        im = im[..., :3]
    elif im.ndim == 3 and im.shape[-1] == 2:
        im = im[..., 0]
    return im


def save_uint8_png(im01: np.ndarray, output_path: str, im_name: str) -> str:
    """Save an image in [0, 1] as PNG (clamp, x255, truncate), returning
    the path."""
    os.makedirs(output_path, exist_ok=True)
    im = (np.clip(np.squeeze(im01), 0, 1) * 255).astype("uint8")
    return write_png(os.path.join(output_path, im_name + ".png"), im)


def load_lambda_dict(path: str) -> dict:
    """Load a {image_name: lambda} dict saved as .npy.  Cached on
    (realpath, mtime, size), so a dict rewritten mid-run is seen."""
    st = os.stat(path)
    return dict(_load_lambda_dict_cached(os.path.realpath(path),
                                         st.st_mtime_ns, st.st_size))


@functools.lru_cache(maxsize=16)
def _load_lambda_dict_cached(realpath: str, mtime_ns: int,
                             size: int) -> dict:
    return np.load(realpath, allow_pickle=True)[()]
