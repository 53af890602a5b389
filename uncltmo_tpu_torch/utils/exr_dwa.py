"""DWAA and DWAB chunks for the port's OpenEXR reader (`exr.py`), decoded
as OpenEXR's `ImfDwaCompressor.cpp` decodes them.

A chunk (32 lines for DWAA, 256 for DWAB) starts with 11 little-endian
uint64 sizes, then (version 2) the channel rules, then four streams:
"unknown" channels (zlib), the AC coefficients of the lossy channels
(PIZ's static Huffman code or zlib), their DC coefficients (zlib after
ZIP's byte predictor) and RLE channels (zlib, then OpenEXR's run-length
code).  The rules give each channel, by the suffix of its name after the
last dot and its pixel type, a scheme (unknown, lossy DCT or RLE) and, for
`R`, `G`, `B`-like names of one prefix, a place in a set decoded together
through the 709 Y'CbCr -> RGB inverse.  A lossy channel is 8x8 blocks of
half coefficients in zigzag order: DC from its plane, AC run-length coded
(0xffNN: NN zeros, 0xff00: zeros to the end of the block); each block goes
through the inverse DCT in float32, in the operation order of the
library's AVX code (`dctInverse8x8_avx`), which the library takes on CPUs
with AVX, to half (round to nearest even), then through the `toLinear`
table; FLOAT lossy channels come back as those halfs.

The Huffman streams of all chunks are decoded together (`exr._huf_decode`)
and every block of every chunk goes through one vectorised inverse DCT.
"""
from __future__ import annotations

import functools
import struct
import zlib
from typing import NamedTuple

import numpy as np

from . import exr as _exr

UNKNOWN, LOSSY_DCT, RLE = 0, 1, 2
STATIC_HUFFMAN, DEFLATE = 0, 1
# the uint64 fields of a chunk's header, in order
(_VERSION, _UNK_RAW, _UNK, _AC, _DC, _RLE, _RLE_MID, _RLE_RAW, _AC_COUNT,
 _DC_COUNT, _AC_COMP) = range(11)
_SIZES = 11
_PTYPE = {_exr._UINT: 0, _exr._HALF: 1, _exr._FLOAT: 2}


class Rule(NamedTuple):
    """A channel rule (`DwaCompressor::Classifier`)."""
    suffix: str
    scheme: int
    ptype: int               # 0 UINT, 1 HALF, 2 FLOAT
    csc: int                 # -1, or the place in an R, G, B set
    nocase: bool

    def match(self, suffix: str, ptype: int) -> bool:
        if ptype != self.ptype:
            return False
        return (suffix.lower() if self.nocase else suffix) == self.suffix


# version 1 chunks carry no rules: initializeLegacyChannelRules
LEGACY_RULES = tuple(Rule(s, scheme, t, csc, True) for s, scheme, t, csc in (
    ("r", LOSSY_DCT, 1, 0), ("red", LOSSY_DCT, 1, 0),
    ("g", LOSSY_DCT, 1, 1), ("grn", LOSSY_DCT, 1, 1),
    ("green", LOSSY_DCT, 1, 1), ("b", LOSSY_DCT, 1, 2),
    ("blu", LOSSY_DCT, 1, 2), ("blue", LOSSY_DCT, 1, 2),
    ("y", LOSSY_DCT, 1, -1), ("by", LOSSY_DCT, 1, -1),
    ("ry", LOSSY_DCT, 1, -1), ("a", RLE, 0, -1), ("a", RLE, 1, -1),
    ("a", RLE, 2, -1)))

# the zigzag position of each coefficient of the 8x8 block, row by row
ZIGZAG = np.array([
    0, 1, 5, 6, 14, 15, 27, 28, 2, 4, 7, 13, 16, 26, 29, 42,
    3, 8, 12, 17, 25, 30, 41, 43, 9, 11, 18, 24, 31, 40, 44, 53,
    10, 19, 23, 32, 39, 45, 52, 54, 20, 22, 33, 38, 46, 51, 55, 60,
    21, 34, 37, 47, 50, 56, 59, 61, 35, 36, 48, 49, 57, 58, 62, 63])

# the inverse DCT's constants as the library's SIMD code spells them:
# .5 cos(k pi / 16) for k = 4, 1, 2, 3, 5, 6, 7
_A, _B, _C, _D, _E, _F, _G = (np.float32(v) for v in (
    3.535536e-01, 4.903927e-01, 4.619398e-01, 4.157349e-01, 2.777855e-01,
    1.913422e-01, 9.754573e-02))


def parse_rules(d: bytes, pos: int) -> tuple[tuple, int]:
    """Version 2's rules after the sizes: a uint16 byte count (itself
    included), then per rule its suffix (NUL-terminated), a byte of
    (csc + 1) << 4 | scheme << 2 | case-insensitive, and the pixel type."""
    size, = struct.unpack_from("<H", d, pos)
    end = pos + size
    if size < 2 or end > len(d):
        raise IOError("corrupt DWA chunk (rules)")
    pos += 2
    rules = []
    while pos < end:
        stop = d.index(b"\0", pos, end)
        suffix = d[pos:stop].decode("latin-1")
        if stop + 3 > end:
            raise IOError("corrupt DWA chunk (a truncated rule)")
        value, ptype = d[stop + 1], d[stop + 2]
        csc, scheme = (value >> 4) - 1, (value >> 2) & 3
        if csc > 2 or scheme > RLE or ptype > 2:
            raise IOError("corrupt DWA chunk (a rule)")
        nocase = bool(value & 1)
        rules.append(Rule(suffix.lower() if nocase else suffix, scheme,
                          ptype, csc, nocase))
        pos = stop + 3
    return tuple(rules), end


@functools.lru_cache(maxsize=16)
def classify(names: tuple, ptypes: tuple, rules: tuple) -> tuple:
    """classifyChannels: each channel's scheme (the last rule that matches
    wins) and the R, G, B sets of one prefix whose three channels share
    their sampling (in the prefixes' sorted order)."""
    schemes, sets = [], {}
    for i, (name, ptype) in enumerate(zip(names, ptypes)):
        prefix, _, suffix = name.rpartition(".")
        place = sets.setdefault(prefix, [-1, -1, -1])
        scheme = UNKNOWN
        for r in rules:
            if r.match(suffix, ptype):
                scheme = r.scheme
                if r.csc >= 0:
                    place[r.csc] = i
        schemes.append(scheme)
    return tuple(schemes), tuple(tuple(v) for _, v in sorted(sets.items())
                                 if min(v) >= 0)


@functools.lru_cache(maxsize=1)
def to_linear() -> np.ndarray:
    """dwaCompressorToLinear: half bits -> half bits, from the format's
    generator (`dwaLookups.cpp`): |h| <= 1 -> sign |h|^2.2, else sign
    (e^2.2)^(|h| - 1), in float, then to half; inf and NaN -> 0."""
    with np.errstate(all="ignore"):
        h = np.arange(1 << 16, dtype=np.uint16).view(np.float16).astype(
            np.float32)
        a = np.abs(h).astype(np.float64)
        log_base = np.float64(np.float32(2.7182818 ** 2.2))
        lo = np.power(a, np.float64(np.float32(2.2))).astype(np.float32)
        hi = np.power(log_base, (a - 1.0).astype(np.float32).astype(
            np.float64)).astype(np.float32)
        v = np.where(a <= 1.0, lo, hi) * np.where(h < 0, np.float32(-1),
                                                  np.float32(1))
        out = v.astype(np.float16).view(np.uint16)
    out[~np.isfinite(h)] = 0
    out[0] = 0
    return out


def idct_rows(v: np.ndarray) -> np.ndarray:
    """The row pass along the last axis (8) of float32 `v`, as the AVX code
    forms it: each output the even part (y0 a + y2 k2) + (y4 k4 + y6 k6)
    plus or minus the odd part (y1 k1 + y3 k3) + (y5 k5 + y7 k7)."""
    y = [v[..., i] for i in range(8)]

    def f(i, ks):
        return (y[i] * ks[0] + y[i + 2] * ks[1]) + (y[i + 4] * ks[2]
                                                    + y[i + 6] * ks[3])
    e = [f(0, k) for k in ((_A, _C, _A, _F), (_A, _F, -_A, -_C),
                           (_A, -_F, -_A, _C), (_A, -_C, _A, -_F))]
    o = [f(1, k) for k in ((_B, _D, _E, _G), (_D, -_G, -_B, -_E),
                           (_E, -_B, _G, _D), (_G, -_E, _D, -_B))]
    return np.stack([e[0] + o[0], e[1] + o[1], e[2] + o[2], e[3] + o[3],
                     e[3] - o[3], e[2] - o[2], e[1] - o[1], e[0] - o[0]],
                    axis=-1)


def idct_columns(v: np.ndarray) -> np.ndarray:
    """The column pass along axis -2 of float32 `v` (rows r0..r7), in the
    AVX code's operation order."""
    r = [v[..., i, :] for i in range(8)]
    beta = ((r[1] * _B + r[3] * _D) + (r[5] * _E + r[7] * _G),
            (r[1] * _D - (r[3] * _G + r[5] * _B)) - r[7] * _E,
            ((r[1] * _E - r[3] * _B) + r[5] * _G) + r[7] * _D,
            (r[1] * _G + r[5] * _D) - (r[3] * _E + r[7] * _B))
    t0, t3 = r[0] * _A + r[4] * _A, r[0] * _A - r[4] * _A
    t1, t2 = r[2] * _C + r[6] * _F, r[2] * _F - r[6] * _C
    gamma = (t0 + t1, t3 + t2, t3 - t2, t0 - t1)
    return np.stack([gamma[0] + beta[0], gamma[1] + beta[1],
                     gamma[2] + beta[2], gamma[3] + beta[3],
                     gamma[3] - beta[3], gamma[2] - beta[2],
                     gamma[1] - beta[1], gamma[0] - beta[0]], axis=-2)


def idct_8x8(blocks: np.ndarray) -> np.ndarray:
    """(n, 8, 8) float32 coefficients -> pixels (`dctInverse8x8_avx`)."""
    return idct_columns(idct_rows(blocks))


def csc709_inverse(y, cb, cr) -> tuple:
    """Y'CbCr -> R'G'B' (csc709Inverse), float32."""
    return (y + np.float32(1.5747) * cr,
            (y - np.float32(0.1873) * cb) - np.float32(0.4682) * cr,
            y + np.float32(1.8556) * cb)


class _Parsed(NamedTuple):
    chunk: _exr.Chunk
    sizes: tuple             # the header's fields (_VERSION ... _AC_COMP)
    schemes: tuple
    sets: tuple
    streams: tuple           # unknown, AC, DC, RLE bytes


def _parse(k: _exr.Chunk, channels: list) -> _Parsed:
    d = k.data
    if len(d) < 8 * _SIZES:
        raise IOError("corrupt DWA chunk (truncated header)")
    sizes = struct.unpack_from(f"<{_SIZES}Q", d)
    if sizes[_VERSION] > 2:
        raise IOError(f"DWA chunk version {sizes[_VERSION]}")
    rules, pos = ((LEGACY_RULES, 8 * _SIZES) if sizes[_VERSION] < 2
                  else parse_rules(d, 8 * _SIZES))
    cuts = np.cumsum([pos] + [sizes[i] for i in (_UNK, _AC, _DC, _RLE)])
    if cuts[-1] > len(d):
        raise IOError("corrupt DWA chunk (truncated streams)")
    schemes, sets = classify(tuple(c.name for c in channels),
                             tuple(_PTYPE[c.dtype] for c in channels), rules)
    return _Parsed(k, sizes, schemes, sets,
                   tuple(d[a:b] for a, b in zip(cuts[:-1], cuts[1:])))


def decode(chunks: list, channels: list) -> list:
    """DWAA / DWAB chunks -> per chunk, per channel its samples as a
    (ny_c, nx_c) little-endian array."""
    parsed = [_parse(k, channels) for k in chunks]
    out = [[None] * len(channels) for _ in chunks]
    _plain(parsed, channels, out)
    _lossy(parsed, channels, out)
    return out


def _plain(parsed: list, channels: list, out: list) -> None:
    """The unknown channels (zlib) and the RLE channels (zlib, run-length
    code, then each channel's byte planes: byte 0 of every sample, then
    byte 1, ...)."""
    rle_in = [zlib.decompress(p.streams[3]) for p in parsed
              if p.sizes[_RLE_RAW]]
    rle_raw = iter(_exr.rle_decode(rle_in) if rle_in else [])
    for i, p in enumerate(parsed):
        k, size = p.chunk, p.sizes
        unk = (np.frombuffer(zlib.decompress(p.streams[0]), np.uint8)
               if size[_UNK] else np.zeros(0, np.uint8))
        rle = next(rle_raw) if size[_RLE_RAW] else np.zeros(0, np.uint8)
        if unk.size != size[_UNK_RAW] or rle.size != size[_RLE_RAW]:
            raise IOError("corrupt DWA chunk (unknown or RLE sizes)")
        at = {UNKNOWN: 0, RLE: 0}
        for c, (ci, scheme) in zip(channels, enumerate(p.schemes)):
            if scheme == LOSSY_DCT:
                continue
            ny, nx = k.shapes[ci]
            n, isz = ny * nx, c.dtype.itemsize
            src = unk if scheme == UNKNOWN else rle
            part = src[at[scheme]:at[scheme] + n * isz]
            if part.size != n * isz:
                raise IOError("corrupt DWA chunk (a channel runs past its "
                              "stream)")
            at[scheme] += n * isz
            if scheme == RLE:
                part = np.ascontiguousarray(part.reshape(isz, n).T)
            out[i][ci] = part.view(c.dtype).reshape(ny, nx)


def _groups(p: _Parsed, channels: list) -> list:
    """The lossy channels in decoding order: the R, G, B sets, then each
    other lossy channel alone, as (channel indices, its toLinear)."""
    done = {i for s in p.sets for i in s}
    for s in p.sets:
        if any(p.schemes[i] != LOSSY_DCT for i in s):
            raise IOError("corrupt DWA chunk (a set that is not lossy)")
    lone = [((i,), not channels[i].plinear) for i, s in enumerate(p.schemes)
            if s == LOSSY_DCT and i not in done]
    groups = [(s, True) for s in p.sets] + lone
    for g, _ in groups:
        if channels[g[0]].dtype == _exr._UINT:
            raise IOError("a lossy DWA channel of UINT samples")
    return groups


def _ac_words(parsed: list) -> list:
    """Each chunk's AC stream as uint16 words."""
    words = [None] * len(parsed)
    huf = [i for i, p in enumerate(parsed) if p.sizes[_AC] and
           p.sizes[_AC_COMP] == STATIC_HUFFMAN]
    if huf:
        dec = _exr._huf_decode([_exr._huf_parse(np.frombuffer(
            parsed[i].streams[1], np.uint8)) for i in huf])
        for i, w in zip(huf, dec):
            words[i] = w
    for i, p in enumerate(parsed):
        if not p.sizes[_AC]:
            words[i] = np.zeros(0, np.uint16)
        elif p.sizes[_AC_COMP] == DEFLATE:
            words[i] = np.frombuffer(zlib.decompress(p.streams[1]), "<u2")
        elif p.sizes[_AC_COMP] != STATIC_HUFFMAN:
            raise IOError(f"unknown DWA AC compression {p.sizes[_AC_COMP]}")
        if words[i].size != p.sizes[_AC_COUNT]:
            raise IOError("corrupt DWA chunk (AC count)")
    return words


def _lossy(parsed: list, channels: list, out: list) -> None:
    plan = []                # (chunk, channels, toLinear, nby, nbx, ny, nx)
    for i, p in enumerate(parsed):
        for g, lin in _groups(p, channels):
            ny, nx = p.chunk.shapes[g[0]]
            plan.append((i, g, lin, -(-ny // 8), -(-nx // 8), ny, nx))
    if not plan:
        return
    ac = _ac_words(parsed)
    dc = [_exr._unpredict(np.frombuffer(zlib.decompress(p.streams[2]),
                                        np.uint8)).view("<u2")
          if p.sizes[_DC] else np.zeros(0, np.uint16) for p in parsed]
    for p, d in zip(parsed, dc):
        if d.size != p.sizes[_DC_COUNT]:
            raise IOError("corrupt DWA chunk (DC count)")
    # the blocks in the AC streams' order: per chunk its groups in turn,
    # per group block by block, per block its channels in turn
    nb = np.array([a * b for _, _, _, a, b, _, _ in plan], np.int64)
    ncomp = np.array([len(g) for _, g, _, _, _, _, _ in plan], np.int64)
    chunk_of = np.array([i for i, *_ in plan], np.int64)
    nblk = nb * ncomp
    grp = np.repeat(np.arange(len(plan)), nblk)
    j = _exr._ragged_arange(nblk)
    blk, comp = j // ncomp[grp], j % ncomp[grp]
    # DC: per chunk its groups' planes in turn, per group channel by channel
    dc_base = np.cumsum([0] + [d.size for d in dc])[:-1]
    first_in_chunk = np.concatenate([[True], chunk_of[1:] != chunk_of[:-1]])
    before = np.cumsum(nblk) - nblk
    within = before - np.maximum.accumulate(np.where(first_in_chunk, before,
                                                     0))
    dc_at = dc_base[chunk_of][grp] + within[grp] + comp * nb[grp] + blk
    zz, dc_only = _ac_coefficients(ac, np.bincount(
        chunk_of, weights=nblk, minlength=len(parsed)))
    dc_all = np.concatenate(dc)
    if dc_at.size and dc_at.max() >= dc_all.size:
        raise IOError("corrupt DWA chunk (too few DC values)")
    zz[:, 0] = dc_all[dc_at]
    pix = _blocks_to_halfs(zz, dc_only, grp, comp, ncomp)
    tables = np.stack([np.arange(1 << 16, dtype=np.uint16), to_linear()])
    lin = np.array([g[2] for g in plan], np.int64)
    pix = tables[lin[grp][:, None], pix]
    start = 0
    for (i, g, _, nby, nbx, ny, nx), n in zip(plan, nblk):
        blocks = pix[start:start + n].reshape(nby, nbx, len(g), 8, 8)
        start += n
        for c, ci in enumerate(g):
            plane = blocks[:, :, c].transpose(0, 2, 1, 3).reshape(
                8 * nby, 8 * nbx)[:ny, :nx].view(np.float16)
            dt = channels[ci].dtype
            out[i][ci] = plane.astype(dt) if dt != _exr._HALF else plane


def _ac_coefficients(ac: list, expected) -> tuple:
    """The AC words of all chunks -> (blocks, 64) uint16 coefficients in
    zigzag order (DC left 0) and whether each block holds no AC word but
    runs (lastNonZero == 0).  Between two end-of-block words every block
    fills its 63 AC places exactly, so a block ends where the running count
    of places since the last end-of-block (or chunk start) reaches a
    multiple of 63."""
    words = np.concatenate(ac)
    sizes = np.array([a.size for a in ac], np.int64)
    starts = np.cumsum(sizes) - sizes
    eob = words == 0xFF00
    lit = words >> 8 != 0xFF
    adv = np.where(lit, 1, words & 0xFF).astype(np.int64)     # eob: 0
    seg = np.zeros(words.size + 1, bool)
    seg[starts] = True
    seg[np.flatnonzero(eob) + 1] = True
    excl = np.cumsum(adv) - adv
    before = excl - np.maximum.accumulate(np.where(seg[:-1], excl, 0))
    at = before % 63
    if (at + adv > 63).any():
        raise IOError("corrupt DWA chunk (an AC run past its block)")
    ends = eob | (at + adv == 63)
    count = np.concatenate([[0], np.cumsum(ends)])
    last = (starts + sizes - 1)[sizes > 0]
    if ((count[starts + sizes] - count[starts] != expected).any()
            or not ends[last].all()):
        raise IOError("corrupt DWA chunk (AC blocks)")
    block = count[:-1][lit]
    zz = np.zeros((int(count[-1]), 64), np.uint16)
    zz.ravel()[block * 64 + at[lit] + 1] = words[lit]
    dc_only = np.ones(zz.shape[0], bool)
    dc_only[block] = False
    return zz, dc_only


def _blocks_to_halfs(zz: np.ndarray, dc_only: np.ndarray, grp, comp,
                     ncomp) -> np.ndarray:
    """Zigzag half coefficients -> (blocks, 64) half bits of the pixels:
    inverse DCT (a DC-only block is DC a a everywhere), the 709 inverse on
    the three blocks of a set, then float -> half."""
    v = zz[:, ZIGZAG].view(np.float16).astype(np.float32).reshape(-1, 8, 8)
    v = idct_8x8(v).reshape(-1, 64)
    dc = zz[dc_only, 0].view(np.float16).astype(np.float32)
    v[dc_only] = ((dc * _A) * _A)[:, None]
    sets = np.flatnonzero((ncomp[grp] == 3) & (comp == 0))
    if sets.size:
        r, g, b = csc709_inverse(v[sets], v[sets + 1], v[sets + 2])
        v[sets], v[sets + 1], v[sets + 2] = r, g, b
    with np.errstate(over="ignore", invalid="ignore"):
        return v.astype(np.float16).view(np.uint16)
