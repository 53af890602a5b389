"""DWAA / DWAB in the port's OpenEXR reader
(`uncltmo_tpu_torch/utils/exr_dwa.py`), held bit for bit against the
OpenEXR 3.1 library.

The library is the oracle: `scripts/exr_oracle.cpp` writes files from raw
planes and dumps its decode of every channel.  The committed fixtures
(`tests/data/exr/dwa*.exr` beside the library's decode, `.npz`; rebuilt by
`python scripts/make_exr_fixtures.py`) are read bit for bit.  Where g++ and
OpenEXR 3's headers are present (they are named in the skip reason
otherwise), the oracle is rebuilt and checks seeded random images, sizes,
data windows, compression levels and channel sets, the `toLinear` table
entry by entry, and files of the tests' own DWA encoder
(`tests/test_torch_exr_codecs.py:dwa_compress`: PIZ's Huffman code and zlib
for AC, version 1's legacy rules and version 2's, tiles, subsampled
channels).  The decoder follows the library's AVX inverse DCT, which the
library takes on every CPU with AVX; see `exr_dwa.py`.
"""
import os
import struct
import sys
import zlib

import numpy as np
import pytest

import test_torch_exr_codecs as codecs
from uncltmo_tpu_torch.utils import exr_dwa
from uncltmo_tpu_torch.utils.exr import read_exr, read_exr_channels

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "scripts"))
import make_exr_fixtures as fx  # noqa: E402

FIXTURES = fx.FIXTURES
DWA_FIXTURES = sorted(f[:-4] for f in os.listdir(FIXTURES)
                      if f.startswith("dwa") and f.endswith(".exr"))


def bits(a: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(a).view(f"<u{a.dtype.itemsize}")


def assert_same_channels(got: dict, want: dict) -> None:
    assert sorted(got) == sorted(want)
    for n in want:
        assert got[n].dtype == want[n].dtype and got[n].shape == want[n].shape
        bad = bits(got[n]) != bits(want[n])
        assert not bad.any(), f"{n}: {int(bad.sum())} samples differ"


@pytest.fixture(scope="module")
def oracle():
    why = fx.oracle_missing()
    if why:
        pytest.skip(f"the OpenEXR library oracle cannot be built: {why}")
    fx.build_oracle()
    return fx


@pytest.mark.parametrize("name", DWA_FIXTURES)
def test_dwa_fixtures_equal_the_library_bit_for_bit(name):
    """Every channel of each library-written fixture, and the RGB image
    `read_exr` makes of it (R, G, B, or Y three times where no set is
    named R, G, B)."""
    path = os.path.join(FIXTURES, name + ".exr")
    want = dict(np.load(os.path.join(FIXTURES, name + ".npz")))
    assert_same_channels(read_exr_channels(path), want)
    rgb = ("R", "G", "B") if "R" in want else ("Y",) * 3
    np.testing.assert_array_equal(
        read_exr(path), np.stack([want[n].astype(np.float32) for n in rgb],
                                 axis=-1))


def dc_only_file(path: str, dc: np.ndarray, nbx: int) -> None:
    """A DWAA file of one lossy HALF channel `Y` whose 8x8 blocks hold only
    DC (each block's AC one end-of-block word), DC values `dc` row by row
    over `nbx` blocks a row; assembled from the format by hand."""
    nby = len(dc) // nbx
    w, h = 8 * nbx, 8 * nby
    rules = b"Y\0" + bytes([1 << 2, 1])
    rules = struct.pack("<H", len(rules) + 2) + rules
    chunks = []
    for r in range(0, nby, 4):
        d = dc[r * nbx:(r + 4) * nbx].astype("<u2")
        zac = zlib.compress(np.full(d.size, 0xFF00, "<u2").tobytes())
        zdc = zlib.compress(codecs.predict(d.tobytes()).tobytes())
        data = struct.pack("<11Q", 2, 0, 0, len(zac), len(zdc), 0, 0, 0,
                           d.size, d.size, 1) + rules + zac + zdc
        chunks.append(struct.pack("<ii", 8 * r, len(data)) + data)
    chlist = b"Y\0" + struct.pack("<iB3xii", 1, 0, 1, 1) + b"\0"
    box = struct.pack("<4i", 0, 0, w - 1, h - 1)
    head = struct.pack("<iI", 20000630, 2) + b"".join(codecs._attr(*a) for a in [
        ("channels", "chlist", chlist),
        ("compression", "compression", bytes([8])),
        ("dataWindow", "box2i", box), ("displayWindow", "box2i", box),
        ("lineOrder", "lineOrder", b"\0"),
        ("pixelAspectRatio", "float", struct.pack("<f", 1.0)),
        ("screenWindowCenter", "v2f", struct.pack("<2f", 0, 0)),
        ("screenWindowWidth", "float", struct.pack("<f", 1.0))]) + b"\0"
    pos = len(head) + 8 * len(chunks)
    offsets = np.cumsum([pos] + [len(c) for c in chunks])[:-1]
    with open(path, "wb") as f:
        f.write(head + struct.pack(f"<{len(chunks)}Q", *offsets)
                + b"".join(chunks))


def test_to_linear_table_equals_the_library(oracle, tmp_path):
    """Every half below 8192 in magnitude, both signs, reaches the table
    through a DC-only block (DC 8 h, which the DC-only path takes to h);
    the library's pixels equal the port's table at each.  Halfs from 8192
    up map to infinity by the formula (e^2.2 to the power 8191 overflows),
    inf and NaN to 0."""
    h = np.arange(0x7000, dtype=np.uint16)
    h = np.concatenate([h, h | 0x8000])
    dc = (h.view(np.float16).astype(np.float32) * 8).astype(
        np.float16).view(np.uint16)
    nbx = 256
    n = -(-dc.size // (4 * nbx)) * 4 * nbx
    dc = np.concatenate([dc, np.zeros(n - dc.size, np.uint16)])
    path = str(tmp_path / "dc.exr")
    dc_only_file(path, dc, nbx)
    lib = oracle.oracle_read(path)["Y"].view(np.uint16)
    np.testing.assert_array_equal(read_exr_channels(path)["Y"].view(
        np.uint16), lib)
    a = exr_dwa._A
    at = ((dc.view(np.float16).astype(np.float32) * a) * a).astype(
        np.float16).view(np.uint16)
    table = exr_dwa.to_linear()
    np.testing.assert_array_equal(table[at], lib[::8, ::8].ravel())
    assert len(np.unique(at[:2 * 0x7000])) > 2 * 0x7000 - 64
    big = np.arange(0x7000, 0x7C00)
    assert (table[big] == 0x7C00).all() and (table[big | 0x8000]
                                            == 0xFC00).all()
    special = np.arange(0x7C00, 0x8000)
    assert not table[special].any() and not table[special | 0x8000].any()


def _random_file(rng, path: str, oracle) -> None:
    """The library writes a seeded random image: DWAA or DWAB, an odd or
    even size up to 140 x 90, a data window anywhere, a compression level
    from 0 to 400 and a channel set from the menu."""
    menu = [
        {"R": np.float16, "G": np.float16, "B": np.float16},
        {"R": np.float16, "G": np.float16, "B": np.float16, "A": np.float16},
        {"R": np.float32, "G": np.float32, "B": np.float32, "A": np.float32},
        {"Y": np.float16, "A": np.uint32, "Z": np.float32},
        {"a.R": np.float16, "a.G": np.float16, "a.B": np.float16,
         "b.R": np.float32, "b.G": np.float32, "b.B": np.float32,
         "RY": np.float16, "BY": np.float16},
        {"R": np.float16, "G": np.float32, "B": np.float16, "Y": np.float16,
         "depth": np.float16},
    ]
    chans = menu[rng.integers(len(menu))]
    h, w = (int(v) for v in rng.integers(1, [140, 90]))
    scale = float(rng.choice([0.01, 1.0, 40.0, 3000.0]))
    planes = {}
    for n, t in sorted(chans.items()):
        p = fx._field(rng, h, w, scale * rng.uniform(0.5, 2.0),
                      noise=float(rng.choice([0.0, 0.01, 0.2])))
        if rng.random() < 0.3:
            p -= scale                                   # negative values
        if t == np.uint32:
            p = np.abs(p) * 1000
        planes[n] = p.astype(t)
    plinear = tuple(n for n in planes if rng.random() < 0.2)
    oracle.oracle_write(path, str(rng.choice(["DWAA", "DWAB"])), planes,
                        (h, w), tuple(int(v) for v in rng.integers(-50, 50, 2)),
                        float(rng.choice([0.0, 5.0, 45.0, 150.0, 400.0])),
                        plinear=plinear)


@pytest.mark.parametrize("seed", range(8))
def test_library_files_of_random_images(oracle, tmp_path, seed):
    rng = np.random.default_rng(1000 + seed)
    for k in range(3):
        path = str(tmp_path / f"r{k}.exr")
        _random_file(rng, path, oracle)
        assert_same_channels(read_exr_channels(path), oracle.oracle_read(path))


ENCODER_CASES = {
    "huffman_v2": dict(dwa={}),
    "deflate_v2": dict(dwa={"ac": "deflate", "level": 0.5}),
    "unquantized": dict(dwa={"level": 0.0}),
    "legacy_v1": dict(dwa={"version": 1}, legacy=True),
    "legacy_v1_deflate": dict(dwa={"version": 1, "ac": "deflate"},
                              legacy=True),
    "tiled": dict(dwa={}, tiles=(24, 16, codecs.ONE_LEVEL, 0)),
    "subsampled": dict(dwa={}, subsampled=True),
}


@pytest.mark.parametrize("comp", ["DWAA", "DWAB"])
@pytest.mark.parametrize("case", sorted(ENCODER_CASES))
def test_tests_encoder_files_are_read_as_the_library_reads_them(
        oracle, tmp_path, case, comp):
    """The tests' DWA encoder writes R, G, B (HALF), A (run-length coded),
    a FLOAT and a UINT channel of unknown names, a second R, G, B set
    (FLOAT) and a pLinear Y; the library's decode of its files is the
    port's.  Version 1 files (legacy rules, case-insensitive) hold HALF
    channels only: the library sizes its buffers for version 1 by its
    default rules and refuses a chunk whose legacy classification needs
    more room for unknown channels."""
    opts = ENCODER_CASES[case]
    rng = np.random.default_rng(7)
    h, w = 74, 58
    spec = ({"B": np.float16, "G": np.float16, "R": np.float16,
             "A": np.float16, "Y": np.float16, "depth": np.float16,
             "l.red": np.float16, "l.grn": np.float16, "l.blu": np.float16}
            if opts.get("legacy") else
            {"B": np.float16, "G": np.float16, "R": np.float16,
             "A": np.float16, "Y": np.float16, "Z": np.float32,
             "id": np.uint32, "s.R": np.float32, "s.G": np.float32,
             "s.B": np.float32})
    planes = {n: (fx._field(rng, h, w, 6.0, noise=0.02) * (
        1000 if t == np.uint32 else 1)).astype(t) for n, t in spec.items()}
    planes["R"][0, :4] = [np.inf, -np.inf, np.nan, -0.0]
    sampling, size = None, None
    if opts.get("subsampled"):
        sampling = {"R": (2, 2), "G": (2, 2), "B": (2, 2), "Z": (1, 2),
                    "A": (2, 1)}
        for n, (sx, sy) in sampling.items():
            planes[n] = planes[n][::sy, ::sx]
        size = (h, w)
    path = str(tmp_path / "e.exr")
    codecs.write_exr(path, planes, comp, origin=(4, -6), plinear=("Y",),
                     dwa=opts["dwa"], tiles=opts.get("tiles"),
                     sampling=sampling, size=size)
    assert_same_channels(read_exr_channels(path), oracle.oracle_read(path))


def test_idct_is_the_inverse_dct():
    """The float32 inverse DCT against the orthonormal one in float64, to
    float32 rounding of the sums."""
    rng = np.random.default_rng(3)
    coef = rng.standard_normal((500, 8, 8)).astype(np.float32) * 10
    m = codecs.dct_matrix()
    want = m.T @ coef.astype(np.float64) @ m
    np.testing.assert_allclose(exr_dwa.idct_8x8(coef), want, rtol=0,
                               atol=2e-5 * np.abs(coef).max())


def test_ac_runs_and_end_of_block_words():
    """Three blocks of one chunk by hand: a literal at every place (63
    words, no end word), a run to place 10 then one value and an
    end-of-block, a lone end-of-block (DC only)."""
    full = np.arange(1, 64, dtype=np.uint16)
    second = np.array([0xFF09, 0x3C00, 0xFF00], np.uint16)
    words = np.concatenate([full, second, [0xFF00]]).astype(np.uint16)
    zz, dc_only = exr_dwa._ac_coefficients([words], np.array([3]))
    want = np.zeros((3, 64), np.uint16)
    want[0, 1:] = full
    want[1, 10] = 0x3C00
    np.testing.assert_array_equal(zz, want)
    np.testing.assert_array_equal(dc_only, [False, False, True])
    with pytest.raises(IOError, match="AC"):
        exr_dwa._ac_coefficients([np.array([0xFF40], np.uint16)],
                                 np.array([1]))


def test_corrupt_dwa_chunks_raise_ioerror(tmp_path):
    """A chunk whose AC stream is cut short, or whose header claims more
    than the chunk holds, is an IOError naming DWA, not a wrong image."""
    from uncltmo_tpu_torch.utils import exr
    buf = open(os.path.join(FIXTURES, "dwab_rgb_l200.exr"), "rb").read()
    _, pos = exr._header(buf, 8)
    sizes = struct.unpack_from("<Q", buf, pos)[0] + 8   # after y and size
    bad = bytearray(buf)
    struct.pack_into("<Q", bad, sizes + 8 * 3, 10 ** 6)      # AC bytes
    path = str(tmp_path / "bad.exr")
    open(path, "wb").write(bytes(bad))
    with pytest.raises(IOError, match="DWA"):
        read_exr(path)
    bad = bytearray(buf)
    count = struct.unpack_from("<Q", buf, sizes + 8 * 8)[0]
    struct.pack_into("<Q", bad, sizes + 8 * 8, count + 5)    # AC words
    open(path, "wb").write(bytes(bad))
    with pytest.raises(IOError, match="DWA"):
        read_exr(path)


def test_runner_tone_maps_dwa_as_its_npy_twin(tmp_path):
    """A directory of DWAA / DWAB files through `run_on_path` gives the
    PNGs of their decoded arrays saved as `.npy`."""
    from uncltmo_tpu_torch.utils.io import read_png
    runner = codecs._runner(tmp_path)
    rng = np.random.default_rng(12)
    for d in ("exr", "npy"):
        (tmp_path / d).mkdir()
    lams = {}
    for k, comp in enumerate(("DWAA", "DWAB")):
        im = ((rng.random((40, 52, 3)) ** 3) * 300.0).astype(np.float16)
        path = str(tmp_path / "exr" / f"x{k}.exr")
        codecs.write_exr(path, {c: im[..., i] for i, c in enumerate("RGB")},
                         comp)
        np.save(tmp_path / "npy" / f"x{k}.npy", read_exr(path))
        lams[f"x{k}"] = 100.0 + k
    np.save(tmp_path / "lams.npy", lams)
    outs = {d: runner.run_on_path(str(tmp_path / d), str(tmp_path / ("o" + d)),
                                  str(tmp_path / "lams.npy"), scale=1)
            for d in ("exr", "npy")}
    assert len(outs["exr"]) == 2
    for a, b in zip(outs["exr"], outs["npy"]):
        np.testing.assert_array_equal(read_png(a), read_png(b))
