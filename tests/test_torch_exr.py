"""The port's OpenEXR reader (`uncltmo_tpu_torch/utils/io.py:read_exr`).

cv2 is no oracle: its builds may lack the OpenEXR codec.  Two
independent checks instead: a file assembled byte by byte from the
OpenEXR layout (magic, version, attributes, offset table, chunks) whose
half-float values are known, decoded exactly; and a writer local to
this file that compresses as the OpenEXR library does (byte interleave,
delta predictor, then zlib or run-length code) for NONE, RLE, ZIPS and ZIP
with HALF, FLOAT and UINT samples, a data window away from the origin, an
alpha channel and a luminance-only file, read back bit for bit.  The
runner tone-maps an `.exr` as it tone-maps the same array saved as `.npy`,
and the compressions and layouts the reader does not decode are refused by
name.
"""
import struct
import zlib

import numpy as np
import pytest
import torch

from uncltmo_tpu_torch.utils.io import read_exr, read_hdr_image

_TYPES = {np.dtype("uint32"): 0, np.dtype("float16"): 1,
          np.dtype("float32"): 2}
_COMP = {"NONE": (0, 1), "RLE": (1, 1), "ZIPS": (2, 1), "ZIP": (3, 16),
         "PIZ": (4, 32), "B44": (6, 32)}


def _attr(name: str, kind: str, value: bytes) -> bytes:
    return (name.encode() + b"\0" + kind.encode() + b"\0"
            + struct.pack("<i", len(value)) + value)


def _header(channels, compression: int, window, line_order: int = 0,
            version: int = 2) -> bytes:
    x0, y0, x1, y1 = window
    chlist = b"".join(n.encode() + b"\0" + struct.pack("<iB3xii", t, 0, 1, 1)
                      for n, t in channels) + b"\0"
    return (struct.pack("<iI", 20000630, version)
            + _attr("channels", "chlist", chlist)
            + _attr("compression", "compression", bytes([compression]))
            + _attr("dataWindow", "box2i", struct.pack("<4i", *window))
            + _attr("displayWindow", "box2i",
                    struct.pack("<4i", 0, 0, x1, y1))
            + _attr("lineOrder", "lineOrder", bytes([line_order]))
            + _attr("pixelAspectRatio", "float", struct.pack("<f", 1.0))
            + _attr("screenWindowCenter", "v2f", struct.pack("<2f", 0, 0))
            + _attr("screenWindowWidth", "float", struct.pack("<f", 1.0))
            + b"\0")


def _predict(raw: bytes) -> bytes:
    """The encoder side of ZIP / RLE: even bytes then odd bytes, then
    d[i] = t[i] - t[i-1] + 128."""
    b = np.frombuffer(raw, np.uint8)
    t = np.concatenate([b[0::2], b[1::2]]).astype(np.int64)
    d = t.copy()
    d[1:] = (t[1:] - t[:-1] + 128) & 0xFF
    return d.astype(np.uint8).tobytes()


def _rle(data: bytes) -> bytes:
    """Runs of 3 or more equal bytes as (count - 1, byte), everything else
    as literal blocks (-count, bytes), at most 127 bytes a code."""
    out, i, n = bytearray(), 0, len(data)
    while i < n:
        j = i
        while j < n and data[j] == data[i] and j - i < 127:
            j += 1
        if j - i >= 3:
            out += bytes([j - i - 1, data[i]])
            i = j
            continue
        j = i
        while j < n and j - i < 127 and not (
                j + 2 < n and data[j] == data[j + 1] == data[j + 2]):
            j += 1
        out += bytes([256 - (j - i)]) + data[i:j]
        i = j
    return bytes(out)


def write_exr(path, planes: dict, comp: str = "ZIP", origin=(0, 0),
              reverse_chunks: bool = False) -> None:
    """planes: channel name -> (H, W) array of float16, float32 or uint32;
    written in the file's alphabetical channel order."""
    names = sorted(planes)
    h, w = planes[names[0]].shape
    x0, y0 = origin
    cid, lines = _COMP[comp]
    head = _header([(n, _TYPES[planes[n].dtype]) for n in names], cid,
                   (x0, y0, x0 + w - 1, y0 + h - 1),
                   line_order=1 if reverse_chunks else 0)
    chunks = []
    for r in range(0, h, lines):
        raw = b"".join(planes[n][y].astype(planes[n].dtype.newbyteorder("<"))
                       .tobytes() for y in range(r, min(r + lines, h))
                       for n in names)
        if comp == "RLE":
            data = _rle(_predict(raw))
        elif comp in ("ZIPS", "ZIP"):
            data = zlib.compress(_predict(raw))
        else:
            data = raw
        if len(data) >= len(raw):     # the library stores such chunks raw
            data = raw
        chunks.append(struct.pack("<ii", y0 + r, len(data)) + data)
    order = list(range(len(chunks)))[::-1 if reverse_chunks else 1]
    pos = len(head) + 8 * len(chunks)
    offsets = [0] * len(chunks)
    body = b""
    for i in order:
        offsets[i] = pos + len(body)
        body += chunks[i]
    with open(path, "wb") as f:
        f.write(head + struct.pack(f"<{len(chunks)}Q", *offsets) + body)


def _planes(seed, h, w, dtype, names="ABGR"):
    """Smooth fields with flat stretches, a black corner and a few
    speckles, as images are: each compression shrinks the chunks (RLE on
    FLOAT samples those through the black corner; the others are stored
    raw)."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    out = {}
    for n in names:
        f = rng.uniform(3.0, 9.0, 2)
        v = 50.0 * (1.5 + np.sin(xx / f[0]) * np.cos(yy / f[1]))
        v[:, : w // 3] = v[:, :1]                # flat runs
        v[: h // 2, : w // 4] = 0.0              # black
        v[rng.random((h, w)) < 0.05] *= 3.0      # speckles
        if dtype == np.uint32:
            v = np.floor(v)
        v = v.astype(dtype)
        if dtype != np.uint32:
            v[0, :4] = 0.0
            v[1, :3] = 1e-3
        out[n] = v
    return out


# the hand-assembled file: 3 x 2 pixels, B G R, HALF, no compression
_R = [0x3C00, 0x4000, 0x3800, 0x0000, 0x3400, 0x7BFF]   # 1 2 .5 / 0 .25 65504
_G = [0x3E00, 0x4200, 0xBC00, 0x0001, 0x3555, 0x4500]   # 1.5 3 -1 / 2^-24 ...
_B = [0x4400, 0x0000, 0x3C00, 0x3C00, 0x4800, 0x3A00]   # 4 0 1 / 1 8 .75


def test_hand_assembled_file_decodes_exactly(tmp_path):
    """Bytes written from the file layout alone, not by the writer above:
    two one-line chunks, each line the B, G, R samples of its 3 pixels."""
    head = _header([("B", 1), ("G", 1), ("R", 1)], 0, (0, 0, 2, 1))
    chunks = []
    for y in range(2):
        line = b"".join(struct.pack("<3H", *c[3 * y:3 * y + 3])
                        for c in (_B, _G, _R))
        chunks.append(struct.pack("<ii", y, len(line)) + line)
    table_end = len(head) + 16
    offs = struct.pack("<2Q", table_end, table_end + len(chunks[0]))
    path = tmp_path / "fixture.exr"
    path.write_bytes(head + offs + b"".join(chunks))
    want = np.array([[[1.0, 1.5, 4.0], [2.0, 3.0, 0.0], [0.5, -1.0, 1.0]],
                     [[0.0, 2.0 ** -24, 1.0],
                      [0.25, 0.333251953125, 8.0],
                      [65504.0, 5.0, 0.75]]], np.float32)
    got = read_exr(str(path))
    assert got.dtype == np.float32 and got.shape == (2, 3, 3)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(read_hdr_image(str(path)), want)


@pytest.mark.parametrize("dtype", [np.float16, np.float32, np.uint32],
                         ids=["HALF", "FLOAT", "UINT"])
@pytest.mark.parametrize("comp", ["NONE", "RLE", "ZIPS", "ZIP"])
def test_written_files_read_back_bit_exact(tmp_path, comp, dtype):
    """37 x 29 pixels (three ZIP chunks, the last one short), the data
    window at (5, -3), an alpha channel that is dropped; for ZIP the chunks
    lie in the file in reverse order (the offset table places them)."""
    planes = _planes(0, 37, 29, dtype)
    path = str(tmp_path / f"{comp}.exr")
    write_exr(path, planes, comp, origin=(5, -3),
              reverse_chunks=comp == "ZIP")
    got = read_exr(path)
    want = np.stack([planes[c].astype(np.float32) for c in "RGB"], -1)
    assert got.dtype == np.float32 and got.shape == (37, 29, 3)
    np.testing.assert_array_equal(got, want)


def test_luminance_only_file_comes_back_as_three_channels(tmp_path):
    planes = _planes(1, 20, 18, np.float16, names="Y")
    path = str(tmp_path / "y.exr")
    write_exr(path, planes, "ZIPS")
    got = read_exr(path)
    assert got.shape == (20, 18, 3)
    for c in range(3):
        np.testing.assert_array_equal(got[..., c],
                                      planes["Y"].astype(np.float32))


def test_incompressible_chunks_are_stored_raw(tmp_path):
    """Random float bits do not shrink; such chunks are stored raw, and the
    reader takes a chunk of the raw size as raw."""
    rng = np.random.default_rng(2)
    bits = rng.integers(0, 2 ** 31 - 2 ** 23, (17, 8, 3)).astype(np.uint32)
    planes = {c: bits[..., i].view(np.float32) for i, c in enumerate("BGR")}
    path = str(tmp_path / "raw.exr")
    write_exr(path, planes, "ZIP")
    np.testing.assert_array_equal(
        read_exr(path), np.stack([planes[c] for c in "RGB"], -1))


def test_runner_tone_maps_exr_as_the_same_array_as_npy(tmp_path):
    """The same HDR array as a ZIP / HALF `.exr` and as `.npy` gives the
    same PNG through `InferenceRunner.run_on_path`."""
    from uncltmo_tpu_torch.config import get_model_params
    from uncltmo_tpu_torch.inference.runner import InferenceRunner
    from uncltmo_tpu_torch.models.unet import UNetTMO
    from uncltmo_tpu_torch.utils.io import read_png
    rng = np.random.default_rng(3)
    im = ((rng.random((40, 52, 3)) ** 3) * 300.0).astype(np.float16)
    for d, write in (("exr", lambda p: write_exr(
            p, {c: im[..., i] for i, c in enumerate("RGB")}, "ZIP")),
            ("npy", lambda p: np.save(p, im.astype(np.float32)))):
        (tmp_path / d).mkdir()
        write(str(tmp_path / d / f"x.{d}"))
    np.save(tmp_path / "lams.npy", {"x": 100.0})
    torch.manual_seed(0)
    runner = InferenceRunner(dict(get_model_params("m"), filters=8), None,
                             state_dict=UNetTMO(filters=8).state_dict(),
                             device="cpu")
    outs = {d: runner.run_on_path(str(tmp_path / d), str(tmp_path / ("o" + d)),
                                  str(tmp_path / "lams.npy"), scale=1)
            for d in ("exr", "npy")}
    assert len(outs["exr"]) == 1
    np.testing.assert_array_equal(read_png(outs["exr"][0]),
                                  read_png(outs["npy"][0]))


def write_undecoded_exr(path, planes: dict, comp: str) -> None:
    """A NONE file whose header then names `comp` (PIZ or B44): enough for
    the reader to refuse it before it reads a chunk."""
    write_exr(path, planes, "NONE")
    buf = bytearray(open(path, "rb").read())
    at = buf.index(b"compression\0compression\0") + 28
    buf[at] = _COMP[comp][0]
    open(path, "wb").write(bytes(buf))


@pytest.mark.parametrize("comp", ["PIZ", "B44"])
def test_undecoded_compressions_are_refused_by_name(tmp_path, comp):
    path = str(tmp_path / "c.exr")
    write_undecoded_exr(path, _planes(4, 4, 4, np.float16), comp)
    with pytest.raises(NotImplementedError,
                       match=f"{comp} compression.*ROADMAP Queue 3"):
        read_hdr_image(path)


def test_tiled_and_multipart_files_are_refused_by_name(tmp_path):
    path = str(tmp_path / "t.exr")
    write_exr(path, _planes(5, 4, 4, np.float16), "NONE")
    buf = bytearray(open(path, "rb").read())
    for flag, word in ((0x200, "tiled"), (0x1000, "multi-part")):
        buf[4:8] = struct.pack("<I", 2 | flag)
        open(path, "wb").write(bytes(buf))
        with pytest.raises(NotImplementedError,
                           match=f"{word}.*ROADMAP Queue 3"):
            read_exr(path)
    (tmp_path / "bad.exr").write_bytes(b"\0" * 16)
    with pytest.raises(IOError, match="not an OpenEXR"):
        read_exr(str(tmp_path / "bad.exr"))
