"""The OpenEXR codecs of the port's reader (`uncltmo_tpu_torch/utils/exr.py`):
PIZ, PXR24, B44 and B44A, and tiled files.

cv2 is no oracle here (its build has no OpenEXR codec), so the encoders
below are written from the format (OpenEXR's `ImfPizCompressor.cpp`,
`ImfHuf.cpp`, `ImfWav.cpp`, `ImfPxr24Compressor.cpp`, `ImfB44Compressor.cpp`,
`ImfTiledMisc.cpp`), whole-array numpy so that `chip_smoke.py` can write
1080p files with them.  Lossless codecs read back bit for bit; PXR24 FLOAT
reads back as the encoder's 24-bit rounding; B44 reads back exactly on
blocks its code holds exactly, and otherwise as a plain per-block decode
written here.  A PIZ file assembled by hand, with its Huffman bits worked
out below, decodes exactly; the reader's lockstep Huffman walk equals a
plain bit-by-bit decoder on long codes, run-length symbols and a stream on
which lanes never fall into step by themselves; and each codec tone-maps
as its `.npy` twin does.  The writer also takes subsampled channels and
writes DWAA / DWAB (`dwa_compress`, and `yc_planes` for luminance/chroma
files); those files are held against the OpenEXR library in
`tests/test_torch_exr_dwa.py` and `tests/test_torch_exr_chroma.py`.
"""
import os
import struct
import zlib

import numpy as np
import pytest
import torch

from test_torch_exr import _planes as hdr_planes
from uncltmo_tpu_torch.utils import exr
from uncltmo_tpu_torch.utils.io import read_exr, read_hdr_image

COMPRESSION = {"NONE": 0, "RLE": 1, "ZIPS": 2, "ZIP": 3, "PIZ": 4,
               "PXR24": 5, "B44": 6, "B44A": 7, "DWAA": 8, "DWAB": 9}
LINES = {"NONE": 1, "RLE": 1, "ZIPS": 1, "ZIP": 16, "PIZ": 32, "PXR24": 16,
         "B44": 32, "B44A": 32, "DWAA": 32, "DWAB": 256}
PIXEL_TYPE = {np.dtype("uint32"): 0, np.dtype("float16"): 1,
              np.dtype("float32"): 2}
ONE_LEVEL, MIPMAP, RIPMAP = 0, 1, 2


# ------------------------------------------------------------ bit helpers

def ragged_arange(counts) -> np.ndarray:
    counts = np.asarray(counts, np.int64)
    ends = np.cumsum(counts)
    return np.arange(ends[-1] if ends.size else 0) - np.repeat(ends - counts,
                                                               counts)


def pack_bits(values, widths) -> tuple:
    """Fields of `widths` bits, MSB first, into bytes (zero padded)."""
    widths = np.asarray(widths, np.int64)
    v = np.repeat(np.asarray(values, np.uint64), widths)
    w = np.repeat(widths, widths)
    k = ragged_arange(widths)
    bits = (v >> (w - 1 - k).astype(np.uint64)) & np.uint64(1)
    return np.packbits(bits.astype(np.uint8)).tobytes(), int(widths.sum())


# ---------------------------------------------------------------- Huffman

def code_lengths(freq: np.ndarray) -> np.ndarray:
    """A complete prefix code for the symbols with freq > 0: Shannon's
    lengths ceil(log2(total / f)), then the shortest codes shortened until
    Kraft's sum is 1 (the canonical code needs a complete code)."""
    used = np.flatnonzero(freq)
    f = freq[used].astype(np.int64)
    total = int(f.sum())
    ln = np.maximum(1, np.ceil(np.log2(total / f)).astype(np.int64))
    while (f << ln < total).any():
        ln += f << ln < total
    while ((ln > 1) & (f << (ln - 1) >= total)).any():
        ln -= (ln > 1) & (f << (ln - 1) >= total)
    by_freq = np.argsort(-f, kind="stable")
    while True:
        top = int(ln.max())
        slack = (1 << top) - int((np.int64(1) << (top - ln)).sum())
        if not slack:
            break
        for k in range(2, top + 1):
            unit = 1 << (top - k)
            if slack < unit:
                continue
            cand = by_freq[ln[by_freq] == k]
            take = min(cand.size, slack // unit)
            ln[cand[:take]] -= 1
            slack -= take * unit
    out = np.zeros(freq.size, np.int64)
    out[used] = ln
    return out


def canonical_codes(lengths: np.ndarray) -> np.ndarray:
    """hufCanonicalCodeTable, written out: from the longest length down,
    each length's first code is (previous first + count) >> 1; codes of
    one length go to the symbols in order."""
    count = np.bincount(lengths, minlength=59)
    first, c = np.zeros(59, np.int64), 0
    for lv in range(58, 0, -1):
        first[lv] = c
        c = (c + int(count[lv])) >> 1
    codes = np.zeros(lengths.size, np.int64)
    for lv in range(1, 59):
        syms = np.flatnonzero(lengths == lv)
        codes[syms] = first[lv] + np.arange(syms.size)
    return codes


def pack_table(lengths: np.ndarray) -> bytes:
    """hufPackEncTable: 6-bit lengths; a run of 2-5 zeros as 59-62; 6-261
    zeros as 63 and 8 bits of (run - 6); a single zero as 0."""
    zero = np.concatenate([[0], (lengths == 0).astype(np.int8), [0]])
    edges = np.flatnonzero(np.diff(zero))
    zs, zl = edges[::2], edges[1::2] - edges[::2]
    nz = np.flatnonzero(lengths)
    full = zl // 261
    pos = [nz, np.repeat(zs, full) + 261 * ragged_arange(full)]
    val = [lengths[nz], np.full(full.sum(), 63 << 8 | 255)]
    wid = [np.full(nz.size, 6), np.full(full.sum(), 14)]
    r, at = zl % 261, zs + 261 * full
    for sel, v, w in ((r >= 6, (63 << 8) | (r - 6), 14),
                      ((r >= 2) & (r < 6), 57 + r, 6), (r == 1, 0 * r, 6)):
        pos.append(at[sel])
        val.append(np.broadcast_to(v, r.shape)[sel])
        wid.append(np.full(sel.sum(), w))
    order = np.argsort(np.concatenate(pos))
    return pack_bits(np.concatenate(val)[order],
                     np.concatenate(wid)[order])[0]


def huf_compress(words: np.ndarray, lengths: np.ndarray = None) -> bytes:
    """hufCompress: header (im, iM, table bytes, bits, 0), the packed
    lengths of symbols im..iM, then the code.  iM is the run-length symbol
    (one past the largest word); a run of 2-256 equal words goes out as
    the word, the run symbol and 8 bits of (run - 1) where that is shorter
    (`sendCode`).  `lengths` (65537 entries) replaces the computed code."""
    words = np.asarray(words, np.int64)
    if not words.size:
        return b""
    rl = int(words.max()) + 1
    if lengths is None:
        freq = np.bincount(words, minlength=65537)
        freq[rl] = 1
        lengths = code_lengths(freq)
    im = int(np.flatnonzero(lengths)[0])
    assert lengths[rl] > 0 and not lengths[rl + 1:].any()
    codes = canonical_codes(lengths)
    table = pack_table(lengths[im:rl + 1])
    starts = np.flatnonzero(np.concatenate([[True], words[1:] != words[:-1]]))
    runs = np.diff(np.append(starts, words.size))
    pieces = -(-runs // 256)
    sym = np.repeat(words[starts], pieces)
    k = ragged_arange(pieces)
    plen = np.minimum(256, np.repeat(runs, pieces) - 256 * k)
    cs = plen - 1
    ls = lengths[sym]
    use_rl = ls + lengths[rl] + 8 < ls * cs
    n_out = np.where(use_rl, 3, cs + 1)
    pid = np.repeat(np.arange(sym.size), n_out)
    j = ragged_arange(n_out)
    rlp = use_rl[pid]
    val = np.where(rlp & (j == 1), codes[rl],
                   np.where(rlp & (j == 2), cs[pid], codes[sym[pid]]))
    wid = np.where(rlp & (j == 1), lengths[rl],
                   np.where(rlp & (j == 2), 8, ls[pid]))
    data, nbits = pack_bits(val, wid)
    return (struct.pack("<5I", im, rl, len(table), nbits, 0) + table + data)


def huf_decode_sequential(huf: bytes) -> np.ndarray:
    """hufUncompress as a plain loop, bit by bit and symbol by symbol."""
    if not huf:
        return np.zeros(0, np.uint16)
    im, i_m, _, nbits, _ = struct.unpack_from("<5I", huf)
    bits = "".join(f"{b:08b}" for b in huf[20:])
    lengths = np.zeros(65537, np.int64)
    pos, s = 0, im
    while s <= i_m:
        v = int(bits[pos:pos + 6], 2)
        pos += 6
        if v == 63:
            s += int(bits[pos:pos + 8], 2) + 6
            pos += 8
        elif v >= 59:
            s += v - 57
        else:
            lengths[s] = v
            s += 1
    assert s == i_m + 1
    data = bits[-(-pos // 8) * 8:]
    codes = canonical_codes(lengths)
    table = {(int(lengths[x]), int(codes[x])): x
             for x in np.flatnonzero(lengths)}
    out, pos = [], 0
    while pos < nbits:
        for lv in range(1, 59):
            x = table.get((lv, int(data[pos:pos + lv], 2)))
            if x is not None:
                break
        else:
            raise AssertionError("invalid code")
        pos += lv
        if x == i_m:
            out += [out[-1]] * int(data[pos:pos + 8], 2)
            pos += 8
        else:
            out.append(x)
    assert pos == nbits
    return np.array(out, np.uint16)


# --------------------------------------------------------------- wavelet

def _wenc14(a, b):
    a = (a ^ 0x8000) - 0x8000
    b = (b ^ 0x8000) - 0x8000
    return ((a + b) >> 1) & 0xFFFF, (a - b) & 0xFFFF


def _wenc16(a, b):
    ao = (a + 0x8000) & 0xFFFF
    m, d = (ao + b) >> 1, ao - b
    return np.where(d < 0, (m + 0x8000) & 0xFFFF, m), d & 0xFFFF


def wav2_encode(a: np.ndarray, max_value: int) -> np.ndarray:
    """wav2Encode of (..., ny, nx) planes, finest level first; int64."""
    a = a.astype(np.int64)
    enc = _wenc14 if max_value < 1 << 14 else _wenc16
    ny, nx = a.shape[-2:]
    p, p2 = 1, 2
    while p2 <= min(nx, ny):
        ey, ex = ny // p2 * p2, nx // p2 * p2
        y0, y1 = slice(0, ey, p2), slice(p, ey, p2)
        x0, x1 = slice(0, ex, p2), slice(p, ex, p2)
        i00, i01 = enc(a[..., y0, x0], a[..., y0, x1])
        i10, i11 = enc(a[..., y1, x0], a[..., y1, x1])
        a[..., y0, x0], a[..., y1, x0] = enc(i00, i10)
        a[..., y0, x1], a[..., y1, x1] = enc(i01, i11)
        if nx & p:
            a[..., y0, ex], a[..., y1, ex] = enc(a[..., y0, ex],
                                                 a[..., y1, ex])
        if ny & p:
            a[..., ey, x0], a[..., ey, x1] = enc(a[..., ey, x0],
                                                 a[..., ey, x1])
        p, p2 = p2, p2 << 1
    return a


# ------------------------------------------------------------ the codecs

def _word_planes(chan: list) -> list:
    """Per channel (ny, nx, words a sample) uint16, Xdr order (low word of
    a 32-bit sample first)."""
    return [np.ascontiguousarray(c).astype(c.dtype.newbyteorder("<"))
            .view("<u2").reshape(*c.shape, c.dtype.itemsize // 2)
            for c in chan]


def piz_compress(chan: list) -> bytes:
    planes = _word_planes(chan)
    flat = np.concatenate([p.ravel() for p in planes])
    present = np.zeros(1 << 16, bool)
    present[flat] = True
    present[0] = False
    bitmap = np.packbits(present, bitorder="little")
    nzb = np.flatnonzero(bitmap)
    lo, hi = (int(nzb[0]), int(nzb[-1])) if nzb.size else (8191, 0)
    present[0] = True
    fwd = np.zeros(1 << 16, np.int64)
    fwd[present] = np.arange(present.sum())
    max_value = int(present.sum()) - 1
    coded = []
    for p in planes:
        p = fwd[p]
        for j in range(p.shape[2]):
            p[:, :, j] = wav2_encode(p[:, :, j], max_value)
        coded.append(p.ravel())
    huf = huf_compress(np.concatenate(coded))
    return (struct.pack("<HH", lo, hi)
            + (bitmap[lo:hi + 1].tobytes() if lo <= hi else b"")
            + struct.pack("<i", len(huf)) + huf)


def float_to_float24(f: np.ndarray) -> np.ndarray:
    """ImfPxr24Compressor's floatToFloat24: the top 24 bits, rounded."""
    u = np.ascontiguousarray(f, np.float32).view(np.uint32).astype(np.int64)
    s, e, m = u & 0x80000000, u & 0x7F800000, u & 0x007FFFFF
    m8 = m >> 8
    nan = (e >> 8) | m8 | (m8 == 0)
    rounded = ((e | m) + (m & 0x80)) >> 8
    rounded = np.where(rounded >= 0x7F8000, (e | m) >> 8, rounded)
    i = np.where(e == 0x7F800000, np.where(m != 0, nan, e >> 8), rounded)
    return ((s >> 8) | i).astype(np.uint32)


def pxr24_compress(chan: list, lines=None) -> bytes:
    parts = []
    for c in chan:
        if c.dtype == np.float16:
            v, nb = c.view(np.uint16).astype(np.uint32), 2
        elif c.dtype == np.float32:
            v, nb = float_to_float24(c), 3
        else:
            v, nb = c.astype(np.uint32), 4
        d = np.diff(v.astype(np.int64), axis=1, prepend=0) & 0xFFFFFFFF
        parts.append(np.stack([(d >> (8 * (nb - 1 - k))) & 0xFF
                               for k in range(nb)], axis=1
                              ).reshape(c.shape[0], nb * c.shape[1])
                     .astype(np.uint8))
    return zlib.compress(interleave_lines(parts, lines))


@np.errstate(over="ignore", invalid="ignore")
def b44_exp_table() -> np.ndarray:
    """B44's expTable (half h -> half(exp(h / 8)), 0 where h is not finite,
    HALF_MAX from 8 log(HALF_MAX) up), as the format's generator makes it."""
    h = np.arange(1 << 16, dtype=np.uint16).view(np.float16).astype(
        np.float32)
    big = h.astype(np.float64) >= 8 * np.log(65504.0)
    v = np.exp((h / np.float32(8)).astype(np.float64)).astype(np.float32)
    v = np.where(big, 65504.0, v)
    v = np.where(np.isfinite(h), v, 0.0)
    return v.astype(np.float16).view(np.uint16)


def _shift_and_round(x, shift):
    x = x << 1
    a = (1 << shift) - 1
    b = (x >> (shift + 1)) & 1
    return (x + a + b) >> (shift + 1)


_B44_PAIRS = [(0, 4), (4, 8), (8, 12), (0, 1), (4, 5), (8, 9), (12, 13),
              (1, 2), (5, 6), (9, 10), (13, 14), (2, 3), (6, 7), (10, 11),
              (14, 15)]


def b44_pack(s: np.ndarray, flat_fields: bool, exact_max: bool) -> bytes:
    """`pack` of (n, 16) half bits -> the blocks' bytes, 14 or 3 each."""
    s = s.astype(np.int64)
    t = np.where((s & 0x7C00) == 0x7C00, 0x8000,
                 np.where(s & 0x8000, ~s & 0xFFFF, s | 0x8000))
    t_max = t.max(axis=1, keepdims=True)
    shift = np.full(len(s), -1)
    d = r = None
    for sh in range(32):
        dd = _shift_and_round(t_max - t, sh)
        rr = np.stack([dd[:, i] - dd[:, j] for i, j in _B44_PAIRS], 1) + 0x20
        new = (shift < 0) & (rr.min(1) >= 0) & (rr.max(1) <= 0x3F)
        if d is None:
            d, r = dd.copy(), rr.copy()
        d[new], r[new], shift[new] = dd[new], rr[new], sh
        if (shift >= 0).all():
            break
    flat = flat_fields & (r == 0x20).all(1)
    t0 = np.where(exact_max & ~flat, t_max[:, 0] - (d[:, 0] << shift), t[:, 0])
    b = np.zeros((len(s), 14), np.int64)
    b[:, 0], b[:, 1] = t0 >> 8, t0 & 0xFF
    f = np.concatenate([shift[:, None], r], 1).reshape(-1, 4, 4)
    g = f[:, :, 0] << 18 | f[:, :, 1] << 12 | f[:, :, 2] << 6 | f[:, :, 3]
    b[:, 2:] = ((g[:, :, None] >> [16, 8, 0]) & 0xFF).reshape(-1, 12)
    b[flat, 2] = 0xFC
    keep = np.arange(14) < np.where(flat, 3, 14)[:, None]
    return b[keep].astype(np.uint8).tobytes()


def b44_compress(chan: list, flat_fields: bool, plinear=None) -> bytes:
    plinear = plinear or [False] * len(chan)
    out = b""
    for c, lin in zip(chan, plinear):
        if c.dtype != np.float16:
            out += np.ascontiguousarray(c).astype(
                c.dtype.newbyteorder("<")).tobytes()
            continue
        ny, nx = c.shape
        h = c.view(np.uint16)
        h = h[np.minimum(np.arange(-(-ny // 4) * 4), ny - 1)]
        h = h[:, np.minimum(np.arange(-(-nx // 4) * 4), nx - 1)]
        blocks = h.reshape(ny // 4 + (ny % 4 > 0), 4, -1, 4).transpose(
            0, 2, 1, 3).reshape(-1, 16)
        if lin:
            blocks = b44_exp_table()[blocks]
        out += b44_pack(blocks, flat_fields, not lin)
    return out


def b44_decode_plain(data: bytes, shapes: list, plinear=None) -> list:
    """The HALF channels of a B44(A) chunk decoded block by block in a
    plain loop (`unpack14` / `unpack3`); shapes [(ny, nx)], all HALF."""
    plinear = plinear or [False] * len(shapes)
    log = exr._b44_log_table()
    out, pos = [], 0
    for (ny, nx), lin in zip(shapes, plinear):
        plane = np.zeros((-(-ny // 4) * 4, -(-nx // 4) * 4), np.uint16)
        for by in range(0, ny, 4):
            for bx in range(0, nx, 4):
                b = data[pos:pos + 14]
                s = [0] * 16
                if b[2] >= 13 << 2:
                    s = [(b[0] << 8) | b[1]] * 16
                    pos += 3
                else:
                    s[0] = (b[0] << 8) | b[1]
                    shift = b[2] >> 2
                    bias = 0x20 << shift
                    r = [((b[2] << 4) | (b[3] >> 4)) & 0x3F,
                         ((b[3] << 2) | (b[4] >> 6)) & 0x3F, b[4] & 0x3F,
                         b[5] >> 2, ((b[5] << 4) | (b[6] >> 4)) & 0x3F,
                         ((b[6] << 2) | (b[7] >> 6)) & 0x3F, b[7] & 0x3F,
                         b[8] >> 2, ((b[8] << 4) | (b[9] >> 4)) & 0x3F,
                         ((b[9] << 2) | (b[10] >> 6)) & 0x3F, b[10] & 0x3F,
                         b[11] >> 2, ((b[11] << 4) | (b[12] >> 4)) & 0x3F,
                         ((b[12] << 2) | (b[13] >> 6)) & 0x3F, b[13] & 0x3F]
                    for k, (i, j) in enumerate(_B44_PAIRS):
                        s[j] = (s[i] + (r[k] << shift) - bias) & 0xFFFF
                    pos += 14
                s = [x & 0x7FFF if x & 0x8000 else ~x & 0xFFFF for x in s]
                if lin:
                    s = [int(log[x]) for x in s]
                plane[by:by + 4, bx:bx + 4] = np.reshape(s, (4, 4))
        out.append(plane[:ny, :nx].view(np.float16))
    return out


def predict(raw: bytes) -> np.ndarray:
    """ZIP / RLE's byte split (even bytes, then odd) and delta + 128."""
    b = np.frombuffer(raw, np.uint8)
    t = np.concatenate([b[0::2], b[1::2]]).astype(np.int64)
    t[1:] = (t[1:] - t[:-1] + 128) & 0xFF
    return t.astype(np.uint8)


def rle_compress(data: np.ndarray) -> bytes:
    """Runs of 3-128 equal bytes as (run - 1, byte), the bytes between as
    literal blocks of at most 127 (-count, bytes)."""
    n = data.size
    starts = np.flatnonzero(np.concatenate([[True], data[1:] != data[:-1]]))
    runs = np.diff(np.append(starts, n))
    long = runs >= 3
    # literal stretches: each maximal group of consecutive short runs
    grp = np.flatnonzero(~long & np.concatenate([[True], long[:-1]]))
    gend = np.searchsorted(np.flatnonzero(long), grp)
    gend = np.append(np.flatnonzero(long), starts.size)[gend]
    lit_start = starts[grp]
    lit_len = np.where(gend < starts.size, starts[np.minimum(
        gend, starts.size - 1)], n) - lit_start
    run_start, run_len = starts[long], runs[long]
    kinds = [(lit_start, lit_len, 127, True), (run_start, run_len, 128, False)]
    pstart, plen, plit = [], [], []
    for st, ln, cap, lit in kinds:
        k = -(-ln // cap)
        j = ragged_arange(k)
        pstart.append(np.repeat(st, k) + cap * j)
        plen.append(np.minimum(cap, np.repeat(ln, k) - cap * j))
        plit.append(np.full(k.sum(), lit))
    order = np.argsort(np.concatenate(pstart))
    pstart, plen, plit = (np.concatenate(x)[order]
                          for x in (pstart, plen, plit))
    size = np.where(plit, 1 + plen, 2)
    head = np.cumsum(size) - size
    out = np.zeros(int(size.sum()), np.uint8)
    out[head] = np.where(plit, 256 - plen, plen - 1)
    out[head + 1] = data[pstart]
    lit = np.flatnonzero(plit)
    idx = ragged_arange(plen[lit])
    out[np.repeat(head[lit] + 1, plen[lit]) + idx] = data[
        np.repeat(pstart[lit], plen[lit]) + idx]
    return out.tobytes()


def interleave_lines(rows: list, lines=None) -> bytes:
    """Per channel its rows of bytes -> the chunk's lines, each the rows of
    the channels with samples on it (`lines`: (lines, channels) bool; all
    on every line when None)."""
    if lines is None:
        return np.concatenate(rows, axis=1).tobytes()
    nxt = [0] * len(rows)
    out = []
    for on in lines:
        for c in np.flatnonzero(on):
            out.append(rows[c][nxt[c]].tobytes())
            nxt[c] += 1
    assert nxt == [r.shape[0] for r in rows]
    return b"".join(out)


def compress(comp: str, chan: list, plinear=None, names=None, lines=None,
             dwa=None) -> bytes:
    """One chunk's pixels (per channel (ny_c, nx_c) arrays) under `comp`;
    `lines` as in `interleave_lines`; `names` and `dwa` (options of
    `dwa_compress`) for DWAA / DWAB.  A chunk that does not shrink is
    stored raw, as the library stores it."""
    raw = interleave_lines([np.ascontiguousarray(c).astype(
        c.dtype.newbyteorder("<")).view(np.uint8).reshape(
            c.shape[0], c.shape[1] * c.dtype.itemsize) for c in chan], lines)
    if comp == "RLE":
        data = rle_compress(predict(raw))
    elif comp in ("ZIPS", "ZIP"):
        data = zlib.compress(predict(raw).tobytes())
    elif comp == "PIZ":
        data = piz_compress(chan)
    elif comp == "PXR24":
        data = pxr24_compress(chan, lines)
    elif comp in ("B44", "B44A"):
        data = b44_compress(chan, comp == "B44A", plinear)
    elif comp in ("DWAA", "DWAB"):
        data = dwa_compress(chan, names, plinear, **(dwa or {}))
    else:
        data = raw
    return data if len(data) < len(raw) else raw


# ------------------------------------------------------------------ DWA

# initializeDefaultChannelRules: (suffix, scheme, pixel type, csc place);
# schemes 0 unknown, 1 lossy DCT, 2 RLE
DWA_RULES = [("R", 1, 1, 0), ("R", 1, 2, 0), ("G", 1, 1, 1), ("G", 1, 2, 1),
             ("B", 1, 1, 2), ("B", 1, 2, 2), ("Y", 1, 1, -1),
             ("Y", 1, 2, -1), ("BY", 1, 1, -1), ("BY", 1, 2, -1),
             ("RY", 1, 1, -1), ("RY", 1, 2, -1), ("A", 2, 0, -1),
             ("A", 2, 1, -1), ("A", 2, 2, -1)]
# version 1 chunks: initializeLegacyChannelRules, case-insensitive
DWA_LEGACY_RULES = [("r", 1, 1, 0), ("red", 1, 1, 0), ("g", 1, 1, 1),
                    ("grn", 1, 1, 1), ("green", 1, 1, 1), ("b", 1, 1, 2),
                    ("blu", 1, 1, 2), ("blue", 1, 1, 2), ("y", 1, 1, -1),
                    ("by", 1, 1, -1), ("ry", 1, 1, -1), ("a", 2, 0, -1),
                    ("a", 2, 1, -1), ("a", 2, 2, -1)]


def dct_matrix() -> np.ndarray:
    """The orthonormal 8-point DCT-II, rows by frequency."""
    k, n = np.mgrid[0:8, 0:8]
    m = 0.5 * np.cos((2 * n + 1) * k * np.pi / 16)
    m[0] = np.sqrt(1 / 8)
    return m


def to_nonlinear(x: np.ndarray) -> np.ndarray:
    """The encoder's perceptual curve (the inverse of the decoder's
    toLinear): |x|^(1/2.2) up to 1, then 1 + ln|x| / 2.2; not finite -> 0."""
    a = np.abs(np.where(np.isfinite(x), x, 0.0))
    with np.errstate(divide="ignore"):
        v = np.where(a <= 1, a ** (1 / 2.2), 1 + np.log(np.maximum(a, 1)) / 2.2)
    return np.sign(x) * np.where(np.isfinite(x), v, 0.0)


def _dwa_classify(names, ptypes, rules, nocase):
    schemes, sets = [], {}
    for i, (n, t) in enumerate(zip(names, ptypes)):
        prefix, _, suffix = n.rpartition(".")
        key = suffix.lower() if nocase else suffix
        place = sets.setdefault(prefix, [-1, -1, -1])
        scheme = 0
        for s, sch, rt, csc in rules:
            if s == key and rt == t:
                scheme = sch
                if csc >= 0:
                    place[csc] = i
        schemes.append(scheme)
    return schemes, [v for _, v in sorted(sets.items()) if min(v) >= 0]


def _ac_tokens(zz: np.ndarray) -> np.ndarray:
    """(blocks, 64) zigzag half bits -> the AC words: each nonzero value
    and each lone zero as itself, a run of n >= 2 zeros as 0xff00 | n, or
    0xff00 where it runs to the block's end."""
    ac = zz[:, 1:].astype(np.int64)
    zero = ac == 0
    n, m = ac.shape
    start = zero & ~np.concatenate([np.zeros((n, 1), bool), zero[:, :-1]],
                                   axis=1)
    # the length of the zero run from each start: the next nonzero after it
    nxt = np.where(~zero, np.arange(m), m)
    nxt = np.minimum.accumulate(nxt[:, ::-1], axis=1)[:, ::-1]
    run = nxt - np.arange(m)
    tok = np.where(~zero, ac, np.where(run == 1, 0, np.where(
        nxt == m, 0xFF00, 0xFF00 | run)))
    return tok[~zero | start].astype(np.uint16)


def dwa_compress(chan: list, names: list, plinear=None, level: float = 0.02,
                 ac: str = "huffman", version: int = 2) -> bytes:
    """A DWAA / DWAB chunk of per channel (ny_c, nx_c) planes: the rules
    (version 2), unknown channels through zlib, RLE channels (A) as byte
    planes through OpenEXR's run-length code and zlib, lossy channels (R, G,
    B, Y, RY, BY of HALF or FLOAT) as 8x8 blocks: the perceptual curve, the
    709 R'G'B' -> Y'CbCr of an R, G, B set, the DCT in float64, coefficients
    rounded to multiples of `level` x (1 + u + v) / 8 and then to half,
    zigzag and run-length coded, AC through PIZ's Huffman code (`ac`
    "huffman") or zlib ("deflate"), DC through ZIP's predictor and zlib."""
    plinear = plinear or [False] * len(chan)
    ptypes = [PIXEL_TYPE[c.dtype] for c in chan]
    rules = DWA_RULES if version >= 2 else DWA_LEGACY_RULES
    schemes, sets = _dwa_classify(names, ptypes, rules, version < 2)
    unknown, rle = [], []
    for c, s in zip(chan, schemes):
        b = np.ascontiguousarray(c).astype(c.dtype.newbyteorder("<")).view(
            np.uint8).reshape(c.size, -1)
        if s == 0:
            unknown.append(b.tobytes())
        elif s == 2:
            rle.append(b.T.tobytes())        # byte planes
    in_set = {i for s in sets for i in s}
    groups = [(s, True) for s in sets] + [
        ((i,), not plinear[i]) for i, s in enumerate(schemes)
        if s == 1 and i not in in_set]
    m = dct_matrix()
    u, v = np.mgrid[0:8, 0:8]
    step = level * (1 + u + v) / 8.0
    zig = np.zeros(64, np.int64)
    zig[np.array(exr_zigzag())] = np.arange(64)
    tokens, dcs = [], []
    for g, lin in groups:
        planes = []
        for i in g:
            x = chan[i].astype(np.float16).astype(np.float64)
            planes.append(to_nonlinear(x) if lin else np.where(
                np.isfinite(x), x, 0.0))
        if len(g) == 3:
            r, gg, b = planes
            y = 0.2126 * r + 0.7152 * gg + 0.0722 * b
            planes = [y, (b - y) / 1.8556, (r - y) / 1.5747]
        ny, nx = planes[0].shape
        nby, nbx = -(-ny // 8), -(-nx // 8)
        zz = []
        for p in planes:
            p = p[np.minimum(np.arange(8 * nby), ny - 1)][
                :, np.minimum(np.arange(8 * nbx), nx - 1)]
            blocks = p.reshape(nby, 8, nbx, 8).transpose(0, 2, 1, 3)
            coef = m @ blocks @ m.T
            if level:
                coef = np.round(coef / step) * step
            half = coef.reshape(-1, 64).astype(np.float16).view(np.uint16)
            zz.append(half[:, zig])                       # zigzag order
            dcs.append(half[:, 0])
        tokens.append(_ac_tokens(np.stack(zz, axis=1).reshape(-1, 64)))
    words = np.concatenate(tokens) if tokens else np.zeros(0, np.uint16)
    dc = np.concatenate(dcs) if dcs else np.zeros(0, np.uint16)
    if not words.size:
        zac = b""
    elif ac == "huffman":
        zac = huf_compress(words)
    else:
        zac = zlib.compress(words.astype("<u2").tobytes())
    zdc = zlib.compress(predict(dc.astype("<u2").tobytes()).tobytes()) \
        if dc.size else b""
    unk = b"".join(unknown)
    zunk = zlib.compress(unk) if unk else b""
    rle_raw = b"".join(rle)
    rle_mid = rle_compress(np.frombuffer(rle_raw, np.uint8)) if rle_raw \
        else b""
    zrle = zlib.compress(rle_mid) if rle_raw else b""
    head = struct.pack("<11Q", version, len(unk), len(zunk), len(zac),
                       len(zdc), len(zrle), len(rle_mid), len(rle_raw),
                       words.size, dc.size, 0 if ac == "huffman" else 1)
    if version >= 2:
        body = b"".join(s.encode() + b"\0" + bytes([
            (csc + 1) << 4 | sch << 2, t]) for s, sch, t, csc in rules)
        head += struct.pack("<H", len(body) + 2) + body
    return head + zunk + zac + zdc + zrle


def exr_zigzag() -> list:
    """The zigzag position of each coefficient of an 8x8 block, row by
    row (the JPEG order the format uses), built by walking the
    anti-diagonals."""
    order = sorted(((r, c) for r in range(8) for c in range(8)),
                   key=lambda rc: (rc[0] + rc[1], rc[0] if (rc[0] + rc[1])
                                   % 2 else rc[1]))
    pos = [0] * 64
    for k, (r, c) in enumerate(order):
        pos[8 * r + c] = k
    return pos


def yc_planes(rgb: np.ndarray, chroma=None) -> tuple:
    """float RGB (H, W, 3), H and W even -> ({Y, RY, BY} HALF planes,
    sampling): Y with the luminance weights of the chromaticities
    (Rec. 709 by default) at full size, RY = (R - Y) / Y and BY =
    (B - Y) / Y averaged over 2x2 pixels, as a luminance/chroma file holds
    them."""
    w = np.array([0.2126, 0.7152, 0.0722]) if chroma is None else chroma
    rgb = rgb.astype(np.float64)
    y = rgb @ w
    safe = np.where(y > 0, y, 1.0)
    ry = np.where(y > 0, (rgb[..., 0] - y) / safe, 0.0)
    by = np.where(y > 0, (rgb[..., 2] - y) / safe, 0.0)
    h, wd = y.shape

    def down(p):
        return p.reshape(h // 2, 2, wd // 2, 2).mean(axis=(1, 3))
    return ({"Y": y.astype(np.float16), "RY": down(ry).astype(np.float16),
             "BY": down(by).astype(np.float16)},
            {"RY": (2, 2), "BY": (2, 2)})


def _attr(name: str, kind: str, value: bytes) -> bytes:
    return (name.encode() + b"\0" + kind.encode() + b"\0"
            + struct.pack("<i", len(value)) + value)


def level_tiles(extent: int, levels: int, size: int, up: int) -> list:
    out = []
    for lv in range(levels):
        n = extent // (1 << lv)
        if up and n * (1 << lv) < extent:
            n += 1
        out.append(-(-max(n, 1) // size))
    return out


def round_log2(x: int, up: int) -> int:
    y, r = 0, 0
    while x > 1:
        r |= x & 1
        y, x = y + 1, x >> 1
    return y + (r if up else 0)


def write_exr(path, planes: dict, comp: str = "ZIP", origin=(0, 0),
              decreasing: bool = False, tiles=None, plinear=(),
              seed: int = 0, sampling=None, size=None, dwa=None,
              chromaticities=None) -> None:
    """planes: channel name -> (H, W) array of float16, float32 or uint32,
    written in alphabetical channel order; `tiles` = (xs, ys, level mode,
    round up): a tiled file whose lower levels hold junk (the reader reads
    level 0); `plinear`: channels flagged for B44's / DWA's log tables;
    `sampling`: name -> (xs, ys) for subsampled channels, whose planes hold
    their samples only (x % xs == 0, y % ys == 0 of the data window, of
    `size` (H, W)); `dwa`: options of `dwa_compress`; `chromaticities`:
    8 floats for the attribute."""
    names = sorted(planes)
    sampling = sampling or {}
    samp = [sampling.get(n, (1, 1)) for n in names]
    h, w = size or planes[names[0]].shape
    x0, y0 = origin
    window = (x0, y0, x0 + w - 1, y0 + h - 1)
    chlist = b"".join(n.encode() + b"\0" + struct.pack(
        "<iB3xii", PIXEL_TYPE[planes[n].dtype], n in plinear, *s)
        for n, s in zip(names, samp)) + b"\0"
    attrs = [("channels", "chlist", chlist),
             ("compression", "compression", bytes([COMPRESSION[comp]])),
             ("dataWindow", "box2i", struct.pack("<4i", *window)),
             ("displayWindow", "box2i", struct.pack("<4i", 0, 0, w - 1,
                                                    h - 1)),
             ("lineOrder", "lineOrder", bytes([int(decreasing)])),
             ("pixelAspectRatio", "float", struct.pack("<f", 1.0)),
             ("screenWindowCenter", "v2f", struct.pack("<2f", 0, 0)),
             ("screenWindowWidth", "float", struct.pack("<f", 1.0))]
    if chromaticities is not None:
        attrs.append(("chromaticities", "chromaticities",
                      struct.pack("<8f", *chromaticities)))
    lin = [n in plinear for n in names]
    chunks = []                     # (offset-table slot, chunk bytes)
    if tiles is None:
        version = 2
        for r in range(0, h, LINES[comp]):
            ys = np.arange(y0 + r, y0 + min(h, r + LINES[comp]))
            on = np.stack([ys % sy == 0 for _, sy in samp], axis=1)
            rows = [planes[n][ys[on[:, i]] // sy - -(-y0 // sy)]
                    for i, (n, (_, sy)) in enumerate(zip(names, samp))]
            data = compress(comp, rows, lin, names, on, dwa)
            chunks.append(struct.pack("<ii", y0 + r, len(data)) + data)
        n_table = len(chunks)
    else:
        version = 2 | 0x200
        xs, ys, mode, up = tiles
        attrs.append(("tiles", "tiledesc",
                      struct.pack("<IIB", xs, ys, mode | up << 4)))
        nlx = nly = 1
        if mode == MIPMAP:
            nlx = nly = round_log2(max(w, h), up) + 1
        elif mode == RIPMAP:
            nlx, nly = round_log2(w, up) + 1, round_log2(h, up) + 1
        tx, ty = level_tiles(w, nlx, xs, up), level_tiles(h, nly, ys, up)
        for dy in range(ty[0]):
            for dx in range(tx[0]):
                sl = (slice(dy * ys, (dy + 1) * ys),
                      slice(dx * xs, (dx + 1) * xs))
                data = compress(comp, [planes[n][sl] for n in names], lin,
                                names, None, dwa)
                chunks.append(struct.pack("<5i", dx, dy, 0, 0, len(data))
                              + data)
        levels = ([(lv, lv) for lv in range(nlx)] if mode != RIPMAP else
                  [(lx, ly) for ly in range(nly) for lx in range(nlx)])
        rng = np.random.default_rng(seed)
        for lx, ly in levels[1:]:
            for dy in range(ty[ly]):
                for dx in range(tx[lx]):
                    junk = rng.integers(0, 256, 7, np.uint8).tobytes()
                    chunks.append(struct.pack("<5i", dx, dy, lx, ly, 7)
                                  + junk)
        n_table = len(chunks)
    attrs.sort()
    head = struct.pack("<iI", 20000630, version) + b"".join(
        _attr(*a) for a in attrs) + b"\0"
    order = list(range(n_table))[::-1 if decreasing else 1]
    pos = len(head) + 8 * n_table
    offsets, body = [0] * n_table, []
    for i in order:
        offsets[i] = pos
        pos += len(chunks[i])
        body.append(chunks[i])
    with open(path, "wb") as f:
        f.write(head + struct.pack(f"<{n_table}Q", *offsets) + b"".join(body))


# ------------------------------------------------------------- test data

def b44_exact_planes(seed, h, w, names="ABGR"):
    """HALF planes that B44 holds exactly: every 4x4 block (edge blocks
    padded by repeating) either flat or within 31 of its largest value at
    shift 0, positive values around 1."""
    rng = np.random.default_rng(seed)
    out = {}
    hb, wb = -(-h // 4), -(-w // 4)
    for n in names:
        base = rng.integers(0x3000, 0x4800, (hb, wb))
        step = rng.integers(0, 16, (hb, wb, 4, 4)) * (
            rng.random((hb, wb, 1, 1)) < 0.6)
        t = (base[:, :, None, None] + step).transpose(0, 2, 1, 3).reshape(
            4 * hb, 4 * wb)
        out[n] = t[:h, :w].astype(np.uint16).view(np.float16)
    return out


def _rgb(planes):
    return np.stack([planes[c].astype(np.float32) for c in "RGB"], -1)


def _24(planes):
    return {n: (float_to_float24(p) << 8).view(np.float32)
            if p.dtype == np.float32 else p for n, p in planes.items()}


# ----------------------------------------------------------------- tests

@pytest.mark.parametrize("dtype", [np.float16, np.float32, np.uint32],
                         ids=["HALF", "FLOAT", "UINT"])
@pytest.mark.parametrize("comp", ["PIZ", "PXR24", "B44", "B44A"])
def test_codecs_read_back_bit_exact(tmp_path, comp, dtype):
    """69 x 37 pixels (three PIZ / B44 chunks and five PXR24 ones, the last
    short; widths and heights not multiples of 4), the data window at
    (5, -3), an alpha channel, and for B44 the chunks in decreasing line
    order.  PIZ reaches the 14-bit wavelet on HALF and UINT and the 16-bit
    one on FLOAT; PXR24 FLOAT comes back as its 24-bit rounding; B44 holds
    HALF blocks that its code holds exactly and stores the rest plain."""
    h, w = 69, 37
    planes = (b44_exact_planes(0, h, w) if comp.startswith("B44")
              and dtype == np.float16 else hdr_planes(0, h, w, dtype))
    path = str(tmp_path / f"{comp}.exr")
    write_exr(path, planes, comp, origin=(5, -3),
              decreasing=comp.startswith("B44"))
    got = read_exr(path)
    assert got.dtype == np.float32 and got.shape == (h, w, 3)
    want = _rgb(_24(planes) if comp == "PXR24" else planes)
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))


@pytest.mark.parametrize("bits", [14, 16])
def test_piz_reaches_both_wavelet_transforms(tmp_path, bits):
    """A chunk with fewer than 2^14 distinct 16-bit words takes the 14-bit
    wavelet, one with more the modular 16-bit one (FLOAT samples of random
    mantissas, 33 x 300: 19,200 distinct words in the first chunk)."""
    rng = np.random.default_rng(12)
    if bits == 14:
        planes = hdr_planes(12, 33, 300, np.float16, names="BGR")
    else:
        planes = {c: rng.uniform(0.5, 2.0, (33, 300)).astype(np.float32)
                  for c in "BGR"}
    first = np.concatenate([p[:32].view(np.uint16).ravel()
                            for p in planes.values()])
    assert (np.unique(np.append(first, 0)).size - 1 >= 1 << 14) == (
        bits == 16)
    path = str(tmp_path / "w.exr")
    write_exr(path, planes, "PIZ")
    np.testing.assert_array_equal(read_exr(path), _rgb(planes))


def test_pxr24_float_keeps_24_bits_inf_and_nan(tmp_path):
    """FLOAT through PXR24 is the top 24 bits rounded, as the library's
    floatToFloat24 rounds them; infinities stay, NaNs stay NaN with their
    sign, values near FLT_MAX truncate; HALF and UINT stay exact."""
    rng = np.random.default_rng(1)
    v = (rng.standard_normal((19, 23)) * 1e3).astype(np.float32)
    v.ravel()[:6] = [np.inf, -np.inf, np.nan, -np.nan, 3.4028235e38, -0.0]
    v.view(np.uint32).ravel()[6] = 0x7F800001     # NaN of a low payload
    planes = {"R": v, "G": v[::-1].copy(), "B": -v}
    path = str(tmp_path / "p.exr")
    write_exr(path, planes, "PXR24")
    got = read_exr(path)
    want = _rgb(_24(planes))
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))
    bits = got[..., 0].view(np.uint32).ravel()
    assert np.isposinf(got[0, 0, 0]) and np.isneginf(got[0, 1, 0])
    assert np.isnan(got[0, 2, 0]) and np.isnan(got[0, 6, 0])
    assert bits[3] >> 31 and bits[4] == 0x7F7FFF00 and bits[5] == 0x80000000
    assert ((bits & 0xFF) == 0).all()


@pytest.mark.parametrize("comp", ["B44", "B44A"])
@pytest.mark.parametrize("plinear", [False, True], ids=["linear", "pLinear"])
def test_b44_blocks_match_a_plain_block_decode(tmp_path, comp, plinear):
    """General HALF data (large steps, negative values, infinities that
    the code turns into zeros, flat blocks) against a block-by-block decode
    of the same bytes; pLinear channels go through the exp table on the way
    in and the log table on the way out."""
    rng = np.random.default_rng(2)
    h, w = 37, 22
    v = (rng.standard_normal((h, w)) * 40).astype(np.float16)
    v[:8, :8] = 2.5                        # flat blocks
    v[10, 3], v[11, 4] = np.inf, -np.inf
    v[12:16, 12:16] = -v[12:16, 12:16]
    planes = {"B": v, "G": v[::-1].copy(), "R": np.abs(v)}
    path = str(tmp_path / "b.exr")
    write_exr(path, planes, comp, plinear=("G",) if plinear else ())
    got = read_exr(path)
    for i, c in enumerate("RGB"):
        lin = plinear and c == "G"
        want = np.concatenate([b44_decode_plain(
            b44_compress([planes[c][r:r + 32]], comp == "B44A", [lin]),
            [planes[c][r:r + 32].shape], [lin])[0] for r in range(0, h, 32)])
        np.testing.assert_array_equal(got[..., i].view(np.uint32),
                                      want.astype(np.float32).view(np.uint32))


def test_b44_exact_blocks_and_flat_blocks_take_3_bytes():
    """B44A codes a flat block in 3 bytes and B44 in 14; blocks within 31
    of their maximum at shift 0 decode to themselves."""
    t = 0x3C00 + np.arange(64).reshape(8, 8) % 13
    t[:4, :4] = 0x3E00                                 # 1.5, flat
    y = t.astype(np.uint16).view(np.float16)
    a, b = (b44_compress([y], flat) for flat in (True, False))
    assert len(b) == 4 * 14 and len(a) == 3 + 3 * 14
    for data in (a, b):
        got, = b44_decode_plain(data, [(8, 8)])
        np.testing.assert_array_equal(got.view(np.uint16), y.view(np.uint16))
        buf = np.frombuffer(data + bytes(16), np.uint8)
        s = exr._b44_unpack(buf, exr._b44_blocks(buf, 0, 4))
        np.testing.assert_array_equal(
            s.reshape(2, 2, 4, 4).transpose(0, 2, 1, 3).reshape(8, 8),
            y.view(np.uint16))


def test_hand_assembled_piz_file_decodes_exactly(tmp_path):
    """An 8 x 4 `Y` HALF file in one PIZ chunk, every byte written here.

    Y is 1.0 (0x3C00) everywhere but the right half of the top two rows,
    1.0009765625 (0x3C01).  Bitmap: both values lie in byte 0x3C00 >> 3 =
    1920 (bits 0 and 1), so min = max = 1920 and the bitmap is 0x03; the
    look-up table maps 0 -> 0, 0x3C00 -> 1, 0x3C01 -> 2 (max 2: the 14-bit
    wavelet).  Level 1 leaves each flat 2x2 block as (v, 0, 0, 0); level 2
    takes the block at rows 0, 2 and columns 4, 6 (2, 2, 1, 1) to (1, 0,
    1, 0) and the one at columns 0, 2 to (1, 0, 0, 0).  The words are 1,
    0 x 3, 1, 0 x 15, 1, 0 x 11.  Huffman: symbol 0 length 1, 1 and the
    run symbol 2 length 2, so canonically 1 -> 00, 2 -> 01, 0 -> 1; the
    table packs lengths 1, 2, 2 as 6-bit fields."""
    bits = ("00" "1" "01" "00000010"      # 1, 0, run of 2 more zeros
            "00" "1" "01" "00001110"      # 1, 0, run of 14
            "00" "1" "01" "00001010")     # 1, 0, run of 10
    data = int(bits + "0", 2).to_bytes(5, "big")
    table = int("000001" "000010" "000010" + "000000", 2).to_bytes(3, "big")
    huf = struct.pack("<5I", 0, 2, 3, len(bits), 0) + table + data
    chunk = struct.pack("<HH", 1920, 1920) + b"\x03" + struct.pack(
        "<i", len(huf)) + huf
    assert len(chunk) < 8 * 4 * 2                     # smaller than raw
    head = (struct.pack("<iI", 20000630, 2)
            + _attr("channels", "chlist",
                    b"Y\0" + struct.pack("<iB3xii", 1, 0, 1, 1) + b"\0")
            + _attr("compression", "compression", b"\x04")
            + _attr("dataWindow", "box2i", struct.pack("<4i", 0, 0, 7, 3))
            + _attr("displayWindow", "box2i", struct.pack("<4i", 0, 0, 7, 3))
            + _attr("lineOrder", "lineOrder", b"\0")
            + _attr("pixelAspectRatio", "float", struct.pack("<f", 1))
            + _attr("screenWindowCenter", "v2f", struct.pack("<2f", 0, 0))
            + _attr("screenWindowWidth", "float", struct.pack("<f", 1))
            + b"\0")
    body = struct.pack("<ii", 0, len(chunk)) + chunk
    path = tmp_path / "hand.exr"
    path.write_bytes(head + struct.pack("<Q", len(head) + 8) + body)
    want = np.ones((4, 8), np.float32)
    want[:2, 4:] = 1.0009765625
    got = read_exr(str(path))
    np.testing.assert_array_equal(got, np.stack([want] * 3, -1))
    np.testing.assert_array_equal(huf_decode_sequential(huf),
                                  [1, 0, 0, 0, 1] + [0] * 15 + [1] + [0] * 11)


def _long_code_stream(rng):
    """Lengths 1, 2, ..., 29, 29 over symbols 0..29 (29 the run symbol):
    codes up to 29 bits, every symbol present."""
    lengths = np.zeros(65537, np.int64)
    lengths[:30] = list(range(1, 30)) + [29]
    p = 0.5 ** np.arange(1, 30)
    words = rng.choice(29, 6000, p=p / p.sum())
    words[rng.permutation(6000)[:29]] = np.arange(29)
    return huf_compress(words, lengths)


def _run_stream(rng):
    """Runs of 1-700 equal words: run symbols with counts up to 255."""
    vals = rng.integers(0, 50, 500)
    return huf_compress(np.repeat(vals, rng.integers(1, 700, 500)))


def _unsynced_stream(rng):
    """Eight symbols of 3 bits (seven words and the run symbol) and no
    repeats: lanes start every 4096 bits, 4096 = 1 mod 3, so a lane falls
    into step only when re-walked from its predecessor's path."""
    words = rng.integers(0, 7, 9000)
    words[1:][words[1:] == words[:-1]] = (words[:-1][
        words[1:] == words[:-1]] + 1) % 7
    words = words[np.concatenate([[True], words[1:] != words[:-1]])]
    lengths = np.zeros(65537, np.int64)
    lengths[:8] = 3
    return huf_compress(words, lengths)


def _image_stream(rng):
    """PIZ-like words: wavelet coefficients of a smooth field, near 0 and
    near 65535, and the table's long zero runs between them."""
    yy, xx = np.mgrid[0:48, 0:96]
    v = (np.sin(xx / 7.0) * np.cos(yy / 5.0) * 900 + 1000
         + rng.integers(0, 30, (48, 96))).astype(np.int64)
    return huf_compress(wav2_encode(v, int(v.max())).ravel() & 0xFFFF)


STREAMS = {"long_codes": _long_code_stream, "runs": _run_stream,
           "unsynced": _unsynced_stream, "image": _image_stream}


@pytest.mark.parametrize("case", list(STREAMS))
def test_huffman_walk_matches_the_sequential_decoder(case):
    """The lockstep walk against the bit-by-bit decoder, alone and in one
    batch with the other streams (lanes of several chunks at once)."""
    rng = np.random.default_rng(4)
    huf = STREAMS[case](rng)
    want = huf_decode_sequential(huf)
    parse = exr._huf_parse(np.frombuffer(huf, np.uint8))
    assert parse.nbits > 3 * exr._LANE_BITS             # several lanes
    if case == "long_codes":
        assert parse.lengths.max() > exr._HUF_BITS
    got, = exr._huf_decode([parse])
    np.testing.assert_array_equal(got, want)
    others = [STREAMS[c](np.random.default_rng(5)) for c in STREAMS]
    batch = exr._huf_decode([exr._huf_parse(np.frombuffer(b, np.uint8))
                             for b in others + [huf]])
    for b, g in zip(others + [huf], batch):
        np.testing.assert_array_equal(g, huf_decode_sequential(b))


def test_code_length_table_runs():
    """Zero runs of every packed form (one zero, 2-5, 6-261, longer than
    261) unpack to the lengths they came from."""
    lengths = np.zeros(3000, np.int64)
    on = np.array([0, 2, 5, 11, 17, 300, 301, 900, 2999])
    lengths[on] = np.arange(1, on.size + 1)
    table = np.frombuffer(pack_table(lengths), np.uint8)
    got, used = exr._huf_lengths(table, lengths.size)
    np.testing.assert_array_equal(got, lengths)
    assert -(-used // 8) == table.size


@pytest.mark.parametrize("max_value", [(1 << 14) - 1, 65535])
def test_wavelet_round_trip(max_value):
    """wav2Decode undoes wav2Encode on odd and even sizes, for the 14-bit
    transform and the modular 16-bit one."""
    rng = np.random.default_rng(6)
    for ny, nx in ((1, 9), (7, 5), (32, 37), (13, 64)):
        a = rng.integers(0, max_value + 1, (3, ny, nx))
        enc = (wav2_encode(a, max_value) & 0xFFFF).astype(np.uint16)
        exr._wav2_decode(enc, max_value < 1 << 14)
        np.testing.assert_array_equal(enc, a)


TILED = [(ONE_LEVEL, 0), (MIPMAP, 0), (MIPMAP, 1), (RIPMAP, 0), (RIPMAP, 1)]


@pytest.mark.parametrize("mode,up", TILED,
                         ids=["one_level", "mipmap_down", "mipmap_up",
                              "ripmap_down", "ripmap_up"])
def test_tiled_levels_read_level_0(tmp_path, mode, up):
    """A 45 x 70 tiled file of 16 x 12 tiles (partial at the right and
    bottom edges): the offset table holds every level, the lower levels
    are junk, level 0 reads back."""
    planes = hdr_planes(7, 45, 70, np.float16)
    path = str(tmp_path / "t.exr")
    write_exr(path, planes, "ZIP", origin=(-4, 9), tiles=(16, 12, mode, up),
              seed=mode + 3 * up)
    np.testing.assert_array_equal(read_exr(path), _rgb(planes))


@pytest.mark.parametrize("comp", [c for c in COMPRESSION
                                  if not c.startswith("DWA")])
def test_tiled_files_under_every_compression(tmp_path, comp):
    """Each tile is a chunk of its own under every decoded compression,
    HALF and FLOAT channels in one file; tiles stored in decreasing
    order."""
    planes = hdr_planes(8, 50, 41, np.float16, names="BR")
    planes["G"] = hdr_planes(9, 50, 41, np.float32, names="G")["G"]
    if comp.startswith("B44"):
        planes.update(b44_exact_planes(10, 50, 41, names="BR"))
    path = str(tmp_path / "t.exr")
    write_exr(path, planes, comp, tiles=(32, 20, MIPMAP, 0), decreasing=True)
    want = _rgb(_24(planes) if comp == "PXR24" else planes)
    np.testing.assert_array_equal(read_exr(path), want)


def _runner(tmp_path):
    from uncltmo_tpu_torch.config import get_model_params
    from uncltmo_tpu_torch.inference.runner import InferenceRunner
    from uncltmo_tpu_torch.models.unet import UNetTMO
    torch.manual_seed(0)
    return InferenceRunner(dict(get_model_params("m"), filters=8), None,
                           state_dict=UNetTMO(filters=8).state_dict(),
                           device="cpu")


@pytest.mark.parametrize("comp,tiles", [
    ("PIZ", None), ("PXR24", None), ("B44", None), ("B44A", None),
    ("PIZ", (24, 16, ONE_LEVEL, 0))], ids=["PIZ", "PXR24", "B44", "B44A",
                                           "tiled_PIZ"])
def test_runner_tone_maps_each_codec_as_its_npy_twin(tmp_path, comp, tiles):
    """An image directory (`run_on_path`) and a two-frame scene
    (`run_on_video_path`) of `.exr` files give the PNGs of the decoded
    arrays saved as `.npy`."""
    from uncltmo_tpu_torch.utils.io import read_png
    runner = _runner(tmp_path)
    rng = np.random.default_rng(11)
    frames = [((rng.random((40, 52, 3)) ** 3) * 300.0).astype(np.float16)
              for _ in range(2)]
    for d in ("exr", "npy", "sexr/s", "snpy/s"):
        (tmp_path / d).mkdir(parents=True)
    for k, im in enumerate(frames):
        planes = {c: im[..., i] for i, c in enumerate("RGB")}
        for d in ("exr", "sexr/s"):
            write_exr(str(tmp_path / d / f"x{k}.exr"), planes, comp,
                      tiles=tiles)
        arr = read_hdr_image(str(tmp_path / "exr" / f"x{k}.exr"))
        for d in ("npy", "snpy/s"):
            np.save(tmp_path / d / f"x{k}.npy", arr)
    np.save(tmp_path / "lams.npy", {"x0": 100.0, "x1": 80.0, "s": 90.0})
    lam = str(tmp_path / "lams.npy")
    outs = {d: runner.run_on_path(str(tmp_path / d), str(tmp_path / ("o" + d)),
                                  lam, scale=1) for d in ("exr", "npy")}
    outs.update({d: runner.run_on_video_path(
        str(tmp_path / d), str(tmp_path / ("o" + d)), lam)
        for d in ("sexr", "snpy")})
    for a, b in (("exr", "npy"), ("sexr", "snpy")):
        assert len(outs[a]) == 2 and [os.path.basename(p) for p in outs[a]] \
            == [os.path.basename(p) for p in outs[b]]
        for pa, pb in zip(outs[a], outs[b]):
            np.testing.assert_array_equal(read_png(pa), read_png(pb))
