"""The port's OpenEXR reader, in numpy and the standard library (the JAX
package reads `.exr` through cv2's OpenEXR codec,
`uncltmo_tpu/utils/io.py:36-40`).

It reads single-part scanline files, with subsampled channels, and level 0
of single-part tiled files (one level, mipmap or ripmap) with HALF, FLOAT
and UINT samples under every compression of the format: NONE, RLE, ZIPS,
ZIP, PIZ, PXR24, B44, B44A, DWAA and DWAB, decoding each chunk as the
OpenEXR library does (`ImfRle.cpp`, `ImfZip.cpp`, `ImfPizCompressor.cpp`
with `ImfHuf.cpp` and `ImfWav.cpp`, `ImfPxr24Compressor.cpp`,
`ImfB44Compressor.cpp`, `ImfDwaCompressor.cpp` in `exr_dwa.py`,
`ImfTiledMisc.cpp`).  Every stage works on whole arrays.  The
variable-length streams, whose next code starts where the last one ends
(RLE codes, B44A blocks, the code-length table and the Huffman code of PIZ
and DWA), are walked in lockstep lanes or by pointer doubling; no Python
loop runs per code, symbol or sample.  Luminance/chroma files (`Y`, `RY`,
`BY`) come back as RGB rebuilt as cv2 rebuilds them.
"""
from __future__ import annotations

import functools
import struct
import zlib
from typing import NamedTuple

import numpy as np

_MAGIC = 20000630
_TILED, _DEEP, _MULTIPART = 0x200, 0x800, 0x1000
# compression id -> (name, scanlines a chunk of a scanline file)
_COMPRESSIONS = {0: ("NONE", 1), 1: ("RLE", 1), 2: ("ZIPS", 1),
                 3: ("ZIP", 16), 4: ("PIZ", 32), 5: ("PXR24", 16),
                 6: ("B44", 32), 7: ("B44A", 32), 8: ("DWAA", 32),
                 9: ("DWAB", 256)}
_UINT, _HALF, _FLOAT = np.dtype("<u4"), np.dtype("<f2"), np.dtype("<f4")
_PIXEL_TYPES = {0: _UINT, 1: _HALF, 2: _FLOAT}
_QUEUE = "ROADMAP Queue 3"
# Rec. 709, the chromaticities of a file without the attribute (as float32,
# ImfChromaticities.h): red, green, blue, white (x, y)
_REC709 = np.array([0.64, 0.33, 0.3, 0.6, 0.15, 0.06, 0.3127, 0.329],
                   np.float32)


class Channel(NamedTuple):
    name: str
    dtype: np.dtype
    plinear: bool            # B44 / DWA code the channel as perceptually linear
    xs: int = 1              # x and y sampling: a sample at x % xs == 0
    ys: int = 1              # and y % ys == 0


class Chunk(NamedTuple):
    """A chunk to decode: its bytes, and per channel its (ny_c, nx_c)
    samples and on which of the chunk's lines it has samples."""
    data: bytes
    shapes: list
    lines: np.ndarray        # (lines, channels) bool


def _header(buf: bytes, pos: int) -> tuple[dict, int]:
    """Attributes name -> (type, raw value) up to the header's empty name."""
    attrs = {}
    while buf[pos] != 0:
        end = buf.index(b"\0", pos)
        name = buf[pos:end].decode("latin-1")
        pos = end + 1
        end = buf.index(b"\0", pos)
        kind = buf[pos:end].decode("latin-1")
        size, = struct.unpack_from("<i", buf, end + 1)
        pos = end + 5
        attrs[name] = (kind, buf[pos:pos + size])
        pos += size
    return attrs, pos + 1


def _channels(raw: bytes) -> list:
    """A `chlist` value -> [Channel], in the file's (alphabetical) order."""
    out, pos = [], 0
    while raw[pos] != 0:
        end = raw.index(b"\0", pos)
        name = raw[pos:end].decode("latin-1")
        ptype, plinear, xs, ys = struct.unpack_from("<iB3xii", raw, end + 1)
        pos = end + 17
        if ptype not in _PIXEL_TYPES:
            raise IOError(f"channel {name!r}: unknown pixel type {ptype}")
        if xs < 1 or ys < 1:
            raise IOError(f"channel {name!r}: sampling {xs}x{ys}")
        out.append(Channel(name, _PIXEL_TYPES[ptype], bool(plinear), xs, ys))
    return out


def _samples(s: int, a: int, n: int) -> int:
    """ImfMisc's numSamples: how many x in [a, a + n) have x % s == 0."""
    return (a + n - 1) // s - -(-a // s) + 1 if n > 0 else 0


def _wanted(path: str, names: list) -> tuple:
    """The channels that make the RGB image, as cv2's IMREAD_COLOR takes
    them: R, G, B; else Y with RY / BY (a luminance/chroma file); else a
    luminance-only `Y` three times."""
    if {"R", "G", "B"} <= set(names):
        return ("R", "G", "B")
    if "Y" in names and {"RY", "BY"} & set(names):
        return ("Y", "RY", "BY")
    if "Y" in names:
        return ("Y",) * 3
    raise IOError(f"{path}: no R, G, B or Y channel (has {names})")


def _chroma_to_rgb(y, ry, by, chroma: np.ndarray) -> np.ndarray:
    """cv2's ChromaToBGR (`grfmt_exr.cpp`) in double, each result stored
    as float32: r = (RY + 1) Y, b = (BY + 1) Y, g = (Y - b blue_y - r red_y)
    / green_y with the file's chromaticities."""
    c = chroma.astype(np.float64)
    yd = y.astype(np.float64)
    r = (ry.astype(np.float64) + 1.0) * yd
    b = (by.astype(np.float64) + 1.0) * yd
    g = (yd - b * c[5] - r * c[1]) / c[3]
    return np.stack([r, g, b], axis=-1).astype(np.float32)


def read_exr(path: str) -> np.ndarray:
    """An OpenEXR file -> float32 RGB (H, W, 3) of its data window, alpha
    dropped, as cv2's IMREAD_ANYDEPTH | IMREAD_COLOR reads it: a
    luminance-only (`Y`) file comes back as three equal channels, a
    luminance/chroma file (`Y`, `RY`, `BY`) as the RGB cv2 rebuilds from it
    with the file's chromaticities (Rec. 709 without them), and a
    subsampled channel by repeating each sample over its xs x ys pixels.

    Read: single-part scanline files and level 0 of single-part tiled
    files (ONE_LEVEL, MIPMAP or RIPMAP, either rounding mode), with HALF,
    FLOAT and UINT samples under NONE, RLE, ZIPS, ZIP, PIZ, PXR24, B44,
    B44A, DWAA or DWAB compression, and subsampled channels in scanline
    files.  Refused by name (ROADMAP Queue 3): deep and multi-part files,
    tiled files with a subsampled channel, and unknown compression ids."""
    attrs, window, channels, want, planes = _read(path, _wanted)
    chans = {c.name: c for c in channels}
    full = {n: _upsample(p.astype(np.float32), chans[n], window)
            for n, p in planes.items()}
    if want[1] != "RY":
        return np.stack([full[n] for n in want], axis=-1)
    chroma = np.frombuffer(attrs["chromaticities"][1], "<f4", 8) if (
        "chromaticities" in attrs) else _REC709
    zero = np.zeros_like(full["Y"])           # a file with RY or BY alone
    return _chroma_to_rgb(full["Y"], full.get("RY", zero),
                          full.get("BY", zero), chroma)


def read_exr_channels(path: str) -> dict:
    """Every channel of an OpenEXR file as decoded, before any color step:
    name -> (ny_c, nx_c) array of its own type (float16, float32 or
    uint32), the samples at x % xs == 0 and y % ys == 0 of the data
    window."""
    return _read(path, lambda _, names: names)[4]


def _read(path: str, select) -> tuple:
    """(attributes, data window, channels, the names `select(path,
    names)` gives, {name: samples} of those channels)."""
    with open(path, "rb") as f:
        buf = f.read()
    magic, version = struct.unpack_from("<iI", buf) if len(buf) >= 8 else (
        0, 0)
    if magic != _MAGIC:
        raise IOError(f"{path}: not an OpenEXR file")
    for flag, kind in ((_DEEP, "deep"), (_MULTIPART, "multi-part")):
        if version & flag:
            raise NotImplementedError(
                f"{path}: {kind} OpenEXR files are not read by the port "
                f"(single-part scanline and tiled files are; {_QUEUE})")
    attrs, pos = _header(buf, 8)
    comp = attrs["compression"][1][0]
    if comp not in _COMPRESSIONS:
        raise NotImplementedError(
            f"{path}: unknown OpenEXR compression id {comp} (the port reads "
            "the format's ten, "
            f"{', '.join(n for n, _ in _COMPRESSIONS.values())}; {_QUEUE})")
    cname, lines = _COMPRESSIONS[comp]
    channels = _channels(attrs["channels"][1])
    want = tuple(select(path, [c.name for c in channels]))
    window = struct.unpack("<4i", attrs["dataWindow"][1])
    x0, y0, x1, y1 = window
    if version & _TILED:
        if any((c.xs, c.ys) != (1, 1) for c in channels):
            raise NotImplementedError(
                f"{path}: a tiled OpenEXR file with a subsampled channel, "
                f"which the format forbids, is not read ({_QUEUE})")
        chunks = _tile_chunks(buf, pos, attrs, window)
    else:
        chunks = _scanline_chunks(buf, pos, lines, window)
    work = [_chunk(d, cx, cy, nx, ny, channels)
            for cx, cy, nx, ny, d in chunks]
    decoded = _decode_chunks(cname, work, channels)
    planes = {}
    for i, c in enumerate(channels):
        if c.name not in want:
            continue
        p = np.empty((_samples(c.ys, y0, y1 - y0 + 1),
                      _samples(c.xs, x0, x1 - x0 + 1)), c.dtype)
        for (cx, cy, _, _, _), k, out in zip(chunks, work, decoded):
            r, q = _samples(c.ys, y0, cy - y0), _samples(c.xs, x0, cx - x0)
            ny, nx = k.shapes[i]
            p[r:r + ny, q:q + nx] = np.ascontiguousarray(out[i]).view(
                c.dtype).reshape(ny, nx)
        planes[c.name] = p
    return attrs, window, channels, want, planes


def _upsample(p: np.ndarray, c: Channel, window) -> np.ndarray:
    """A subsampled channel over its pixels, each sample repeated over the
    xs x ys pixels from its own (cv2's UpSample; the format makes the data
    window's origin and size multiples of the sampling)."""
    if (c.xs, c.ys) == (1, 1):
        return p
    x0, y0, x1, y1 = window
    rows = (np.arange(y0, y1 + 1) // c.ys) - -(-y0 // c.ys)
    cols = (np.arange(x0, x1 + 1) // c.xs) - -(-x0 // c.xs)
    return p[rows[:, None], cols[None, :]]


def _chunk(data: bytes, x: int, y: int, nx: int, ny: int,
           channels: list) -> Chunk:
    """The chunk of pixels (x, y) + (nx, ny)'s sample layout."""
    ln = np.arange(y, y + ny)
    return Chunk(data, [(_samples(c.ys, y, ny), _samples(c.xs, x, nx))
                        for c in channels],
                 np.stack([ln % c.ys == 0 for c in channels], axis=1))


def _chunk_at(buf: bytes, off: int, head: str) -> tuple:
    """The header fields and data of the chunk at `off`."""
    fields = struct.unpack_from(head, buf, off)
    start = off + struct.calcsize(head)
    size = fields[-1]
    if size < 0 or start + size > len(buf):
        raise IOError(f"OpenEXR chunk at byte {off} runs past the file")
    return fields[:-1], buf[start:start + size]


def _scanline_chunks(buf: bytes, pos: int, lines: int, window) -> list:
    """[(x, y, nx, ny, data)] of a scanline file, one per chunk of `lines`
    scanlines (the offset table is in y order whatever the lineOrder)."""
    x0, y0, x1, y1 = window
    out = []
    for off in np.frombuffer(buf, "<u8", -(-(y1 - y0 + 1) // lines), pos):
        (y,), data = _chunk_at(buf, int(off), "<ii")
        if not y0 <= y <= y1 or (y - y0) % lines:
            raise IOError(f"OpenEXR chunk at line {y} is not in the data "
                          f"window {window}")
        out.append((x0, y, x1 - x0 + 1, min(lines, y1 - y + 1), data))
    return out


def _round_log2(x: int, up: int) -> int:
    """ImfTiledMisc's floorLog2 / ceilLog2."""
    return (x - 1).bit_length() if up else x.bit_length() - 1


def _level_tiles(extent: int, levels: int, size: int, up: int) -> list:
    """Tiles across each level of an axis (ImfTiledMisc's levelSize)."""
    out = []
    for lv in range(levels):
        n = extent >> lv
        if up and n << lv < extent:
            n += 1
        out.append(-(-max(n, 1) // size))
    return out


def _tile_chunks(buf: bytes, pos: int, attrs: dict, window) -> list:
    """[(x, y, nx, ny, data)] of the level-0 tiles of a tiled file; the
    offset table holds every level's tiles, level 0 first, row by row."""
    x0, y0, x1, y1 = window
    w, h = x1 - x0 + 1, y1 - y0 + 1
    xs, ys, mode = struct.unpack("<IIB", attrs["tiles"][1])
    level_mode, up = mode & 0xF, mode >> 4
    if level_mode == 0:
        nlx = nly = 1
    elif level_mode == 1:
        nlx = nly = _round_log2(max(w, h), up) + 1
    elif level_mode == 2:
        nlx, nly = _round_log2(w, up) + 1, _round_log2(h, up) + 1
    else:
        raise IOError(f"unknown OpenEXR tile level mode {level_mode}")
    tx, ty = _level_tiles(w, nlx, xs, up), _level_tiles(h, nly, ys, up)
    total = (sum(a * b for a, b in zip(tx, ty)) if level_mode < 2
             else sum(tx) * sum(ty))
    if pos + 8 * total > len(buf):
        raise IOError(f"the tile offset table ({total} tiles) runs past "
                      "the file")
    out = []
    for off in np.frombuffer(buf, "<u8", tx[0] * ty[0], pos):
        (dx, dy, lx, ly), data = _chunk_at(buf, int(off), "<5i")
        if (lx, ly) != (0, 0) or not (0 <= dx < tx[0] and 0 <= dy < ty[0]):
            raise IOError(f"OpenEXR tile ({dx}, {dy}) of level ({lx}, {ly}) "
                          "in level 0's offset table")
        cx, cy = x0 + dx * xs, y0 + dy * ys
        out.append((cx, cy, min(xs, x1 - cx + 1), min(ys, y1 - cy + 1),
                    data))
    return out


def _decode_chunks(cname: str, chunks: list, channels: list) -> list:
    """Compressed chunks -> per chunk, per channel its samples' bytes as a
    (ny_c, nx_c * sample bytes) uint8 array.  A chunk that did not shrink
    is stored raw (lines of the channels' samples in turn), under every
    compression."""
    sizes = [[c.dtype.itemsize * n for c, (_, n) in zip(channels, k.shapes)]
             for k in chunks]
    out, todo = [], []
    for k, widths in zip(chunks, sizes):
        raw = sum(w * ny for w, (ny, _) in zip(widths, k.shapes))
        if cname == "NONE" or len(k.data) >= raw:
            if len(k.data) < raw:
                raise IOError(f"truncated chunk ({len(k.data)} bytes, "
                              f"{raw} expected)")
            out.append(split_lines(np.frombuffer(k.data, np.uint8, raw),
                                   k.lines, widths))
        else:
            out.append(None)
            todo.append(len(out) - 1)
    if todo:
        try:
            decoded = _DECODERS[cname]([chunks[i] for i in todo], channels)
        except (IndexError, ValueError, struct.error, zlib.error) as e:
            raise IOError(f"corrupt {cname} chunk ({e})") from e
        for i, planes in zip(todo, decoded):
            for p, w, (ny, _) in zip(planes, sizes[i], chunks[i].shapes):
                if p.size * p.itemsize != ny * w:
                    raise IOError(f"corrupt {cname} chunk ({p.size} samples "
                                  f"of {p.itemsize} bytes, {ny * w} bytes "
                                  "expected)")
            out[i] = planes
    return out


def split_lines(buf: np.ndarray, lines: np.ndarray, widths: list) -> list:
    """A chunk's bytes, line after line the `widths[c]` bytes of each
    channel with samples on that line (`lines`: (lines, channels) bool), ->
    per channel a (its lines, widths[c]) uint8 array."""
    if lines.all():
        rows = buf.reshape(lines.shape[0], -1)
        cuts = np.cumsum([0] + list(widths))
        return [rows[:, a:b] for a, b in zip(cuts[:-1], cuts[1:])]
    size = (lines * np.asarray(widths, np.int64)).ravel()
    start = (np.cumsum(size) - size).reshape(lines.shape)
    return [buf[start[lines[:, c], c][:, None] + np.arange(w)]
            for c, w in enumerate(widths)]


# ---------------------------------------------------------------- helpers

def _ragged_arange(counts: np.ndarray) -> np.ndarray:
    """concatenate([arange(c) for c in counts])."""
    counts = np.asarray(counts, np.int64)
    ends = np.cumsum(counts)
    return np.arange(ends[-1] if ends.size else 0) - np.repeat(
        ends - counts, counts)


def _ranges(starts, counts) -> np.ndarray:
    """concatenate([arange(s, s + c) for s, c in zip(starts, counts)])."""
    return np.repeat(np.asarray(starts, np.int64), counts) + _ragged_arange(
        counts)


class _Lanes:
    """Lanes that walk a variable-length code in lockstep: lane i from a
    start while below its stop, `step(positions, arg, stops) -> (advance,
    value)` at a time.  Visits (the position before each code) and values
    are (steps, lanes) matrices: lane i's k-th at [k, i] for k < count[i].
    A lane that reaches its stop waits there; a step must take a lane
    that cannot go on to its stop.  Walking some lanes again overwrites
    their columns."""

    def __init__(self, n: int, step):
        self.step = step
        self.visits = np.zeros((0, n), np.int64)
        self.values = np.zeros((0, n), np.int64)
        self.count = np.zeros(n, np.int64)

    def walk(self, lanes, pos, stop, arg) -> None:
        p = np.array(pos, np.int64)
        rows, vals = [], []
        while not (p >= stop).all():
            for _ in range(8):
                adv, val = self.step(p, arg, stop)
                rows.append(p)
                vals.append(val)
                p = np.minimum(p + adv, stop)
        self.count[lanes] = 0
        if not rows:
            return
        m = np.stack(rows)
        self.count[lanes] = (m < stop).sum(axis=0)
        v = np.stack(vals) if vals[0] is not None else None
        if not self.visits.size and lanes.size == self.count.size:
            self.visits = m                     # the first walk: every lane
            self.values = m if v is None else v
            return
        grow = m.shape[0] - self.visits.shape[0]
        if grow > 0:
            pad = np.zeros((grow, self.count.size), np.int64)
            self.visits = np.concatenate([self.visits, pad])
            self.values = np.concatenate([self.values, pad])
        self.visits[:m.shape[0], lanes] = m
        if v is not None:
            self.values[:m.shape[0], lanes] = v

    def at(self, lanes, k) -> np.ndarray:
        """Flat index of each lane's k-th visit."""
        return k * self.count.size + lanes

    def ranges(self, lanes, lo, hi) -> np.ndarray:
        """Flat indices of visits lo..hi-1 of each lane, lane by lane."""
        n = hi - lo
        return (np.repeat(self.at(lanes, lo), n)
                + _ragged_arange(n) * self.count.size)

    def first_at_least(self, lanes, target, lo=None) -> np.ndarray:
        """Per lane, its first visit k (from lo) at or past target, count
        if none; a lane's visits increase."""
        lo = np.zeros(lanes.size, np.int64) if lo is None else lo.copy()
        hi = self.count[lanes].copy()
        flat = self.visits.ravel()
        top = max(flat.size - 1, 0)
        while (lo < hi).any():
            mid = (lo + hi) >> 1
            go = lo < hi
            right = go & (flat[np.minimum(self.at(lanes, mid), top)] < target)
            lo = np.where(right, mid + 1, lo)
            hi = np.where(go & ~right, mid, hi)
        return lo

    def kept(self, lo, hi) -> tuple:
        """Every lane's values lo..hi-1, lane after lane, and a function
        giving the visit of kept entries by their index."""
        k = np.arange(self.visits.shape[0])
        keep = (k >= lo[:, None]) & (k < hi[:, None])
        start = np.cumsum(hi - lo) - (hi - lo)

        def visit(j):
            lane = np.searchsorted(start, j, side="right") - 1
            return self.visits[lo[lane] + j - start[lane], lane]
        return self.values.T[keep], visit


def _chain(nxt: np.ndarray, start: int, count: int) -> np.ndarray:
    """The first `count` nodes of start -> nxt[start] -> ... by pointer
    doubling (nxt[i] > i; the last node is an end that maps to itself and
    is never returned)."""
    on = np.zeros(nxt.size, bool)
    on[start] = True
    jump, reach = nxt, 1
    while reach < count:
        on[jump[on]] = True
        jump = jump[jump]
        reach *= 2
    nodes = np.flatnonzero(on[:-1])
    if nodes.size < count:
        raise IOError(f"truncated chunk ({nodes.size} of {count} codes)")
    return nodes[:count]


def _unpredict(t: np.ndarray) -> np.ndarray:
    """Undo the ZIP / RLE byte predictor (t[i] = t[i-1] + d[i] - 128) and
    interleave the two halves the encoder split the bytes into."""
    d = t.astype(np.int64)
    d[1:] -= 128
    t = (np.cumsum(d) & 0xFF).astype(np.uint8)
    out = np.empty_like(t)
    half = (t.size + 1) // 2
    out[0::2], out[1::2] = t[:half], t[half:]
    return out


def _widths(k: Chunk, channels: list, nbytes=None) -> list:
    """Bytes of a line of each channel (`nbytes`: per channel, else its
    sample size)."""
    nbytes = nbytes or [c.dtype.itemsize for c in channels]
    return [b * nx for b, (_, nx) in zip(nbytes, k.shapes)]


# ------------------------------------------------------- RLE, ZIP, PXR24

def rle_decode(datas: list) -> list:
    """OpenEXR's run-length code (`ImfRle.cpp`): a signed count byte c,
    then -c literal bytes (c < 0) or one byte repeated c + 1 times; one lane
    per stream."""
    datas = [np.frombuffer(d, np.uint8) for d in datas]
    sizes = np.array([d.size for d in datas], np.int64)
    ends = np.cumsum(sizes)
    buf = np.concatenate(datas + [np.zeros(2, np.uint8)])
    code = buf.view(np.int8).astype(np.int64)

    def step(p, arg, stop):
        c = code[p]
        return np.where(c < 0, 1 - c, 2), None

    walk = _Lanes(len(datas), step)
    every = np.arange(len(datas))
    walk.walk(every, ends - sizes, ends, None)
    counts = walk.count
    at = walk.visits.T[np.arange(walk.visits.shape[0]) < counts[:, None]]
    c = code[at]
    literal = c < 0
    n = np.where(literal, -c, c + 1)
    last = np.cumsum(counts) - 1
    if (counts == 0).any() or (at[last] + np.where(
            literal[last], 1 - c[last], 2) != ends).any():
        raise IOError("corrupt RLE chunk (a code runs past its end)")
    # the source byte of every output byte, as a running sum: +1 inside a
    # literal block, 0 inside a run, a jump to its first source at a code
    inc = np.repeat(literal.astype(np.int64), n)
    first = at + 1
    inc[np.cumsum(n) - n] = first - np.append(0, (first + np.where(
        literal, n - 1, 0))[:-1])
    out = buf[np.cumsum(inc)]
    per_chunk = np.bincount(np.repeat(np.arange(len(datas)), counts),
                            weights=n, minlength=len(datas)).astype(np.int64)
    return np.split(out, np.cumsum(per_chunk)[:-1])


def _rle(chunks: list, channels: list) -> list:
    return [split_lines(_unpredict(b), k.lines, _widths(k, channels))
            for b, k in zip(rle_decode([k.data for k in chunks]), chunks)]


def _zip(chunks: list, channels: list) -> list:
    return [split_lines(_unpredict(np.frombuffer(zlib.decompress(k.data),
                                                 np.uint8)),
                        k.lines, _widths(k, channels)) for k in chunks]


def _pxr24(chunks: list, channels: list) -> list:
    """zlib, then per line and channel the samples' byte planes (most
    significant first: UINT 4, HALF 2, FLOAT the top 3), each sample the
    wrapping difference from the previous one in its line."""
    nbytes = [{_UINT: 4, _HALF: 2, _FLOAT: 3}[c.dtype] for c in channels]
    out = []
    for k in chunks:
        raw = np.frombuffer(zlib.decompress(k.data), np.uint8)
        widths = _widths(k, channels, nbytes)
        want = sum(w * ny for w, (ny, _) in zip(widths, k.shapes))
        if raw.size != want:
            raise IOError(f"corrupt PXR24 chunk ({raw.size} bytes, "
                          f"{want} expected)")
        planes = []
        for c, nb, rows, (ny, nx) in zip(channels, nbytes, split_lines(
                raw, k.lines, widths), k.shapes):
            b = rows.reshape(ny, nb, nx)
            diff = np.zeros((ny, nx), np.uint32)
            for j in range(nb):
                diff |= b[:, j].astype(np.uint32) << (8 * (nb - 1 - j))
            if c.dtype == _FLOAT:
                diff <<= 8
            v = np.cumsum(diff, axis=1, dtype=np.uint32)
            planes.append((v & 0xFFFF).astype("<u2") if c.dtype == _HALF
                          else v.astype("<u4"))
        out.append(planes)
    return out


# ------------------------------------------------------------------- B44

_B44_FLAT = 13 << 2          # byte 2 of a 3-byte (flat) block is 0xfc


@functools.lru_cache(maxsize=1)
def _b44_log_table() -> np.ndarray:
    """B44's logTable: half h -> half(8 log h), 0 for h negative or not
    finite, computed as the format's table generator computes it (double
    precision, rounded to float, then to half)."""
    h = np.arange(1 << 16, dtype=np.uint16).view(np.float16).astype(
        np.float64)
    ok = np.isfinite(h) & ~(h < 0)
    with np.errstate(divide="ignore"):
        v = np.where(ok, 8.0 * np.log(np.where(ok, h, 1.0)), 0.0)
    return v.astype(np.float32).astype(np.float16).view(np.uint16)


def _b44_blocks(buf: np.ndarray, start: int, count: int) -> np.ndarray:
    """Start bytes of `count` consecutive blocks from `start`: 3 bytes a
    flat block (byte 2 >= 13 << 2), else 14."""
    q = start + 14 * np.arange(count)
    if q[-1] + 14 <= buf.size - 16 and (buf[q + 2] < _B44_FLAT).all():
        return q                              # no flat block: a fixed stride
    tail = buf[start:].astype(np.int64)
    n = tail.size - 16
    nxt = np.arange(n + 1) + np.where(tail[2:n + 3] >= _B44_FLAT, 3, 14)
    nxt = np.minimum(nxt, n)
    nxt[n] = n
    return start + _chain(nxt, 0, count)


def _b44_unpack(buf: np.ndarray, at: np.ndarray) -> np.ndarray:
    """The 4x4 blocks at byte offsets `at` -> (n, 4, 4) half bits."""
    b = buf[at[:, None] + np.arange(14)].astype(np.int64)
    t0 = b[:, 0] << 8 | b[:, 1]
    shift = (b[:, 2] >> 2)[:, None]
    # bytes 2-4, 5-7, 8-10, 11-13: four 6-bit fields each, the first of
    # bytes 2-4 the shift: r0..r2, then r3..r6, r7..r10, r11..r14
    g = (b[:, 2::3][:, :4] << 16 | b[:, 3::3][:, :4] << 8
         | b[:, 4::3][:, :4])
    r = (g[:, :, None] >> np.array([18, 12, 6, 0])) & 0x3F
    d = (r.reshape(-1, 16)[:, 1:] << shift) - (0x20 << shift)
    first = np.cumsum(np.concatenate(
        [t0[:, None], d[:, :3]], axis=1), axis=1)          # s0, s4, s8, s12
    across = d[:, 3:].reshape(-1, 3, 4).transpose(0, 2, 1)  # rows' steps
    s = first[:, :, None] + np.concatenate(
        [np.zeros_like(across[:, :, :1]), np.cumsum(across, axis=2)], axis=2)
    flat = b[:, 2] >= _B44_FLAT
    s[flat] = t0[flat, None, None]
    s &= 0xFFFF
    return np.where(s & 0x8000, s & 0x7FFF, ~s & 0xFFFF).astype(np.uint16)


def _b44(chunks: list, channels: list) -> list:
    """HALF channels in 4x4 blocks, row by row over each channel's block
    grid (edge blocks padded, cropped here); FLOAT and UINT channels stored
    plain; a pLinear channel decoded through the log table."""
    out = []
    for k in chunks:
        data = k.data
        buf = np.concatenate([np.frombuffer(data, np.uint8),
                              np.zeros(16, np.uint8)])
        planes, pos = [], 0
        for c, (ny, nx) in zip(channels, k.shapes):
            nbx, nby = -(-nx // 4), -(-ny // 4)
            if c.dtype != _HALF:
                n = nx * ny * c.dtype.itemsize
                if pos + n > len(data):
                    raise IOError("truncated B44 chunk")
                planes.append(buf[pos:pos + n])
                pos += n
                continue
            if not nbx * nby:
                planes.append(np.zeros((ny, nx), "<u2"))
                continue
            at = _b44_blocks(buf, pos, nbx * nby)
            pos = int(at[-1]) + (3 if buf[at[-1] + 2] >= _B44_FLAT else 14)
            if pos > len(data):
                raise IOError("truncated B44 chunk")
            s = _b44_unpack(buf, at)
            if c.plinear:
                s = _b44_log_table()[s]
            planes.append(s.reshape(nby, nbx, 4, 4).transpose(0, 2, 1, 3)
                          .reshape(4 * nby, 4 * nbx)[:ny, :nx].astype("<u2"))
        if pos != len(data):
            raise IOError(f"corrupt B44 chunk ({len(data) - pos} bytes "
                          "left over)")
        out.append(planes)
    return out


# ------------------------------------------------------------------- PIZ

_HUF_BITS = 14               # the primary look-up table's width
_LANE_BITS = 4096            # a Huffman lane starts every this many bits
_SYNC_BITS = 512             # and walks this far into the next lane's bits
_PIZ_BATCH_WORDS = 1 << 22   # words decoded in one batch of chunks


class _Huffman(NamedTuple):
    stream: np.ndarray       # the code bits' bytes
    nbits: int
    rlc: int                 # the run-length symbol (iM)
    lengths: np.ndarray      # code length of symbols im..iM
    im: int


def _huf_lengths(table: np.ndarray, n: int) -> tuple[np.ndarray, int]:
    """The packed code-length table -> the lengths of n symbols and the bits
    it took.  6-bit fields, MSB first: a length, 59-62 for l - 57 zeros, 63
    and 8 more bits for that value + 6 zeros.  Fields lie on even bits;
    between two 63s they step by 6, so the 63s on the true path are found
    by pointer doubling over the 63s at all three offsets modulo 6."""
    bits = np.unpackbits(table).astype(np.int64)
    nb = bits.size
    if nb < 6:
        raise IOError("unexpected end of the Huffman table")
    # the 6-bit value at every even bit q, at six[q // 2]
    six = sum(bits[k:nb - 5 + k:2] << (5 - k) for k in range(6))
    q63 = np.flatnonzero(six == 63) * 2
    q63 = q63[q63 + 14 <= nb]
    # the successor of a 63 at q: the first 63 at or after q + 14 on q + 14's
    # offset modulo 6
    by_class = [q63[q63 % 6 == a] for a in (0, 2, 4)]
    succ = np.full(q63.size + 1, q63.size)
    for a, qs in enumerate(by_class):
        src = np.flatnonzero((q63 + 14) % 6 == 2 * a)
        k = np.searchsorted(qs, q63[src] + 14)
        ok = k < qs.size
        succ[src[ok]] = np.searchsorted(q63, qs[k[ok]])
    path = np.zeros(0, np.int64)
    if by_class[0].size:
        start = int(np.searchsorted(q63, by_class[0][0]))
        on = np.zeros(q63.size + 1, bool)
        on[start] = True
        jump = succ
        for _ in range(max(1, int(q63.size).bit_length())):
            on[jump[on]] = True
            jump = jump[jump]
        path = q63[np.flatnonzero(on[:-1])]
    # items in order: the fields of each segment, then the 63 that ends it
    seg_start = np.concatenate([[0], path + 14])
    seg_end = np.concatenate([path, [nb - 5]])
    nfield = np.maximum(0, -(-(seg_end - seg_start) // 6))
    fq = seg_start.repeat(nfield) + 6 * _ragged_arange(nfield)
    fv = six[fq // 2]
    run8 = sum(bits[path + 6 + k] << (7 - k) for k in range(8))
    q = np.concatenate([fq, path])
    length = np.concatenate([np.where(fv < 59, fv, 0), np.zeros_like(path)])
    count = np.concatenate([np.where(fv < 59, 1, fv - 57), run8 + 6])
    width = np.concatenate([np.full(fq.size, 6), np.full(path.size, 14)])
    cut = np.concatenate([fv == 63, np.zeros(path.size, bool)])  # no 8 bits
    order = np.argsort(q, kind="stable")
    length, count, q, width, cut = (length[order], count[order], q[order],
                                    width[order], cut[order])
    total = np.cumsum(count)
    last = int(np.searchsorted(total, n))
    if last >= total.size or cut[:last + 1].any():
        raise IOError("unexpected end of the Huffman table")
    if total[last] != n:
        raise IOError("Huffman table too long")
    return (np.repeat(length[:last + 1], count[:last + 1]).astype(np.int64),
            int(q[last] + width[last]))


def _huf_codes(lengths: np.ndarray) -> np.ndarray:
    """hufCanonicalCodeTable: for each length, from the longest, the next
    free codes in symbol order (longer codes take the smaller values)."""
    count = np.bincount(lengths, minlength=59)
    first = np.zeros(59, np.int64)
    c = 0
    for lv in range(58, 0, -1):
        first[lv] = c
        c = (c + int(count[lv])) >> 1
    used = np.flatnonzero(lengths)
    order = used[np.argsort(lengths[used].astype(np.uint8), kind="stable")]
    sl = lengths[order]
    rank = np.arange(sl.size) - np.searchsorted(sl, sl)
    codes = np.zeros(lengths.size, np.int64)
    codes[order] = first[sl] + rank
    if (codes >> lengths).any():
        raise IOError("invalid Huffman table entry")
    return codes


class _Tables(NamedTuple):
    """The batch's decoding tables.  An entry is run << 40 | sym << 16 |
    length << 8 | advance (the length, plus the 8 count bits after the run
    symbol), 0 where no code is; a primary entry that starts only longer
    codes is -(1 + (offset << 6 | bits)): the next `bits` bits index `sub`
    there."""
    primary: np.ndarray      # (streams << _HUF_BITS,)
    sub: np.ndarray


def _huf_tables(hufs: list) -> _Tables:
    size = 1 << _HUF_BITS
    primary = np.zeros(len(hufs) * size, np.int64)
    subs, n_sub = [], 0
    for i, h in enumerate(hufs):
        ln = h.lengths
        codes = _huf_codes(ln)
        sym = h.im + np.arange(ln.size)
        run = sym == h.rlc
        entry = run << 40 | sym << 16 | ln << 8 | (ln + 8 * run)
        short = np.flatnonzero((ln > 0) & (ln <= _HUF_BITS))
        lo = codes[short] << (_HUF_BITS - ln[short])
        span = np.int64(1) << (_HUF_BITS - ln[short])
        order = np.argsort(lo)
        if (lo[order][1:] < (lo + span)[order][:-1]).any():
            raise IOError("invalid Huffman table entry (codes overlap)")
        primary[i * size + _ranges(lo, span)] = np.repeat(entry[short], span)
        big = np.flatnonzero(ln > _HUF_BITS)
        if not big.size:
            continue
        extra = ln[big] - _HUF_BITS
        prefix = codes[big] >> extra
        if primary[i * size + prefix].any():
            raise IOError("invalid Huffman table entry (a short code is the "
                          "prefix of a long one)")
        order = np.argsort(prefix.astype(np.uint32), kind="stable")
        big, extra, prefix = big[order], extra[order], prefix[order]
        new = np.append(True, prefix[1:] != prefix[:-1])
        heads, group = np.flatnonzero(new), np.cumsum(new) - 1
        width = np.maximum.reduceat(extra, heads)
        offset = n_sub + np.cumsum(np.int64(1) << width) - (
            np.int64(1) << width)
        n_sub = int(offset[-1] + (1 << int(width[-1])))
        primary[i * size + prefix[heads]] = -(1 + (offset << 6 | width))
        shift = width[group] - extra
        suffix = codes[big] & ((np.int64(1) << extra) - 1)
        span = np.int64(1) << shift
        subs.append((_ranges(offset[group] + (suffix << shift), span),
                     np.repeat(entry[big], span)))
    sub = np.zeros(n_sub, np.int64)
    for idx, ent in subs:
        sub[idx] = ent
    return _Tables(primary, sub)


def _heads(buf: np.ndarray) -> np.ndarray:
    """The big-endian 32-bit word at every byte of buf but the last 3, as
    int64: one strided view of whole words for each byte offset mod 4."""
    n = buf.size - 3
    out = np.empty(n, np.int64)
    for k in range(4):
        out[k::4] = np.frombuffer(buf, ">u4", len(range(k, n, 4)), k)
    return out


def _bits_at(buf: np.ndarray, p: np.ndarray) -> np.ndarray:
    """The 64 bits from bit p on, left-aligned."""
    b, s = p >> 3, (p & 7).astype(np.uint64)
    x = buf[b[:, None] + np.arange(9)]
    w = np.ascontiguousarray(x[:, :8]).view(">u8").ravel().astype(np.uint64)
    return (w << s) | (x[:, 8].astype(np.uint64) >> (8 - s))


def _huf_decode(hufs: list) -> list:
    """Decode several Huffman streams at once -> their symbol sequences
    with the runs expanded (uint16 words).

    Lanes start every _LANE_BITS bits of each stream and walk in lockstep
    through the two-level table until _SYNC_BITS into the next lane's
    bits.  Where a lane's visits meet its predecessor's in that overlap,
    the two paths agree from there on; a lane that has not met its
    predecessor is walked again from the predecessor's first visit in its
    bits, which is true once the predecessor is, until every lane of every
    stream has met."""
    tabs = _huf_tables(hufs)
    base = np.cumsum([0] + [h.stream.size + 8 for h in hufs])[:-1] * 8
    buf = np.concatenate([x for h in hufs for x in
                          (h.stream, np.zeros(8, np.uint8))]
                         + [np.zeros(24, np.uint8)])
    head = _heads(buf)
    nbits = np.array([h.nbits for h in hufs], np.int64)
    # the last lane begins at least one longest step before the end, so
    # that a code starts in its bits
    nlane = np.maximum(1, -(-(nbits - 66) // _LANE_BITS)) * (nbits > 0)
    chunk = np.repeat(np.arange(len(hufs)), nlane)
    begin = base[chunk] + _ragged_arange(nlane) * _LANE_BITS
    end = (base + nbits)[chunk]
    last = np.append(chunk[1:] != chunk[:-1], True)
    stop = np.where(last, end, np.minimum(begin + _LANE_BITS + _SYNC_BITS,
                                          end))
    mask = (1 << _HUF_BITS) - 1
    # bits p..p+24 lie in the 32 bits at byte p >> 3 shifted by p & 7: a
    # second-level index is read there where the codes are short enough
    near = max(h.lengths.max() for h in hufs) <= 32 - 7

    def step(p, table_at, stop_at):
        w = head[p >> 3] << (p & 7)
        e = tabs.primary[table_at + ((w >> (32 - _HUF_BITS)) & mask)]
        if e.min() > 0:
            return e & 255, e
        far = np.flatnonzero(e < 0)
        if far.size:
            x = -e[far] - 1
            more = x & 63
            if near:
                k = (w[far] >> (32 - _HUF_BITS - more)) & ((1 << more) - 1)
            else:
                k = ((_bits_at(buf, p[far]) << np.uint64(_HUF_BITS))
                     >> (64 - more).astype(np.uint64)).astype(np.int64)
            e[far] = tabs.sub[(x >> 6) + k]
        adv = e & 255
        bad = np.flatnonzero(e == 0)        # no code here: the lane stops
        adv[bad] = np.maximum(stop_at[bad] - p[bad], 0)
        return adv, e

    table_at = chunk << _HUF_BITS
    lanes = _Lanes(begin.size, step)
    every = np.arange(begin.size)
    lanes.walk(every, begin, stop, table_at)
    for _ in range(nlane.max(initial=0) + 2):
        meet, met = _meetings(lanes, begin, chunk)
        if met.all():
            break
        redo = np.flatnonzero(~met)
        prev = redo - 1
        k = lanes.first_at_least(prev, begin[redo])
        has = k < lanes.count[prev]
        start = np.where(has, lanes.visits.ravel()[np.minimum(
            lanes.at(prev, k), lanes.visits.size - 1)], begin[redo])
        lanes.walk(redo, start, stop[redo], table_at[redo])
    else:
        raise IOError("Huffman lanes did not settle")
    # each lane's share: from where it met its predecessor to where its
    # successor met it
    upto = np.append(np.where(last[:-1], np.iinfo(np.int64).max, meet[1:]),
                     np.iinfo(np.int64).max)
    lo = lanes.first_at_least(every, meet)
    hi = lanes.first_at_least(every, upto, lo)
    e, visit = lanes.kept(lo, hi)
    if not e.all():
        raise IOError("invalid Huffman code")
    tail = lanes.at(np.flatnonzero(last), lanes.count[last] - 1)
    if (lanes.visits.ravel()[tail] + (lanes.values.ravel()[tail] & 255)
            != end[last]).any():
        raise IOError("Huffman code runs past its bits")
    r = np.flatnonzero(e >= 1 << 32)                  # run symbols
    sym = (e >> 16).astype(np.uint16)
    # the records of each stream, and the first of each
    per = np.bincount(chunk, weights=hi - lo, minlength=len(hufs)).astype(
        np.int64)
    first = np.cumsum(per) - per
    ch_r = np.searchsorted(first, r, side="right") - 1
    n = (_bits_at(buf, visit(r) + (e[r] >> 8 & 255)) >> np.uint64(56)
         ).astype(np.int64)
    # a run repeats the last symbol before it, in its own stream
    prev = r - 1
    while True:
        again = np.flatnonzero(np.isin(prev, r))
        if not again.size:
            break
        prev[again] -= 1
    if (prev < first[ch_r]).any():
        raise IOError("Huffman run with nothing to repeat")
    sym[r] = sym[prev]
    counts = np.ones(e.size, np.int64)
    counts[r] = n
    out = np.repeat(sym, counts) if r.size else sym
    per += np.bincount(ch_r, weights=n - 1, minlength=len(hufs)).astype(
        np.int64)
    return np.split(out, np.cumsum(per)[:-1])


def _meetings(lanes: _Lanes, begin, chunk) -> tuple:
    """Per lane, the first of its predecessor's visits in its own bits that
    it visits too, and whether there is one (a stream's first lane starts
    on a code and meets by definition)."""
    meet = begin.copy()
    met = np.ones(begin.size, bool)
    lane = np.flatnonzero(np.append(False, chunk[1:] == chunk[:-1]))
    if not lane.size:
        return meet, met
    prev = lane - 1
    s = begin[lane]
    # the lane's own visits before begin + _SYNC_BITS, marked by offset
    nh = lanes.first_at_least(lane, s + _SYNC_BITS)
    mark = np.zeros((lane.size, _SYNC_BITS), bool)
    row = np.repeat(np.arange(lane.size), nh)
    mark[row, lanes.visits.ravel()[lanes.ranges(lane, 0 * nh, nh)] - s[row]] = True
    # the predecessor's visits from begin on (all before begin + _SYNC_BITS)
    lo = lanes.first_at_least(prev, s)
    nt = lanes.count[prev] - lo
    row = np.repeat(np.arange(lane.size), nt)
    q = lanes.visits.ravel()[lanes.ranges(prev, lo, lanes.count[prev])] - s[row]
    found = mark[row, q]
    hit_row = row[found]
    first = np.flatnonzero(np.append(True, hit_row[1:] != hit_row[:-1]))
    met[lane] = False
    met[lane[hit_row[first]]] = True
    meet[lane[hit_row[first]]] = q[found][first] + s[hit_row[first]]
    return meet, met


def _lut(bitmap: np.ndarray) -> np.ndarray:
    """reverseLutFromBitmap: the k-th value present (0 always is)."""
    present = np.unpackbits(bitmap, bitorder="little").astype(bool)
    present[0] = True
    lut = np.zeros(1 << 16, np.uint16)
    values = np.flatnonzero(present)
    lut[:values.size] = values
    return lut, values.size - 1


def _wdec14(lo, hi):
    """wdec14 on int16 (wrapping) arrays."""
    a = lo + (hi & 1) + (hi >> 1)
    return a, a - hi


def _wdec16(lo, hi):
    """wdec16 on uint16 (wrapping) arrays."""
    b = lo - (hi >> 1)
    return hi + b + np.uint16(0x8000), b


def _wav2_decode(a: np.ndarray, w14: bool) -> None:
    """wav2Decode of each (ny, nx) plane of `a` (uint16, in place), level by
    level from the coarsest; every pair of a level is independent."""
    ny, nx = a.shape[-2:]
    x = a.view(np.int16) if w14 else a
    dec = _wdec14 if w14 else _wdec16
    p = 1
    while p <= min(nx, ny):
        p <<= 1
    p2, p = p >> 1, p >> 2
    while p >= 1:
        ey, ex = ny // p2 * p2, nx // p2 * p2
        y0, y1 = slice(0, ey, p2), slice(p, ey, p2)
        x0, x1 = slice(0, ex, p2), slice(p, ex, p2)
        i00, i10 = dec(x[..., y0, x0], x[..., y1, x0])
        i01, i11 = dec(x[..., y0, x1], x[..., y1, x1])
        x[..., y0, x0], x[..., y0, x1] = dec(i00, i01)
        x[..., y1, x0], x[..., y1, x1] = dec(i10, i11)
        if nx & p:
            x[..., y0, ex], x[..., y1, ex] = dec(x[..., y0, ex],
                                                 x[..., y1, ex])
        if ny & p:
            x[..., ey, x0], x[..., ey, x1] = dec(x[..., ey, x0],
                                                 x[..., ey, x1])
        p2, p = p, p >> 1


def _piz(chunks: list, channels: list) -> list:
    """PIZ: a bitmap of the 16-bit values present and its look-up table, a
    Huffman code of the words (each channel's plane of the chunk in turn),
    and a 2D Haar wavelet of each channel's word planes."""
    words = [1 if c.dtype == _HALF else 2 for c in channels]
    out, batch, total = [], [], 0
    for i, chunk in enumerate(chunks):
        batch.append(chunk)
        total += sum(w * a * b for w, (a, b) in zip(words, chunk.shapes))
        if total >= _PIZ_BATCH_WORDS or i == len(chunks) - 1:
            out += _piz_batch(batch, words)
            batch, total = [], 0
    return out


def _huf_parse(huf: np.ndarray) -> _Huffman:
    """hufUncompress's header and code-length table; the code bits start
    at the byte after the table."""
    if not huf.size:
        return _Huffman(huf, 0, 0, np.ones(1, np.int64), 0)
    im, i_m, table_len, nbits = struct.unpack_from("<4I", huf)
    if not im <= i_m < 65537:
        raise IOError("invalid Huffman table size")
    lengths, used = _huf_lengths(huf[20:20 + table_len], i_m - im + 1)
    stream = huf[20 + (used + 7) // 8:]
    if nbits > 8 * stream.size:
        raise IOError("invalid Huffman bit count")
    return _Huffman(stream, nbits, i_m, lengths, im)


def _piz_batch(chunks: list, words: list) -> list:
    hufs, luts = [], []
    for k in chunks:
        data = k.data
        d = np.frombuffer(data, np.uint8)
        lo, hi = struct.unpack_from("<HH", data)
        bitmap = np.zeros(8192, np.uint8)
        pos = 4
        if lo <= hi:
            if hi >= 8192:
                raise IOError("corrupt PIZ bitmap range")
            bitmap[lo:hi + 1] = d[4:5 + hi - lo]
            pos += hi - lo + 1
        luts.append(_lut(bitmap))
        length, = struct.unpack_from("<i", data, pos)
        hufs.append(_huf_parse(d[pos + 4:pos + 4 + length]))
    decoded = _huf_decode(hufs)
    # the wavelet, one stack of planes per shape and transform
    planes, groups = [], {}
    for k, dec, (lut, max_value) in zip(chunks, decoded, luts):
        n = [w * a * b for w, (a, b) in zip(words, k.shapes)]
        if dec.size != sum(n):
            raise IOError(f"corrupt PIZ chunk ({dec.size} words, "
                          f"{sum(n)} expected)")
        per = [c.reshape(a, b, w) for c, w, (a, b) in zip(
            np.split(dec, np.cumsum(n)[:-1]), words, k.shapes)]
        planes.append(per)
        for ci, c in enumerate(per):
            for j in range(c.shape[2]):
                groups.setdefault(c.shape[:2] + (max_value < 1 << 14,),
                                  []).append((len(planes) - 1, ci, j))
    for (ny, nx, w14), members in groups.items():
        stack = np.stack([planes[k][ci][:, :, j] for k, ci, j in members])
        _wav2_decode(stack, w14)
        for (k, ci, j), plane in zip(members, stack):
            planes[k][ci][:, :, j] = plane
    return [[lut[c].astype("<u2") for c in per]
            for per, (lut, _) in zip(planes, luts)]


def _dwa(chunks: list, channels: list) -> list:
    from .exr_dwa import decode
    return decode(chunks, channels)


_DECODERS = {"RLE": _rle, "ZIPS": _zip, "ZIP": _zip, "PIZ": _piz,
             "PXR24": _pxr24, "B44": _b44, "B44A": _b44, "DWAA": _dwa,
             "DWAB": _dwa}
