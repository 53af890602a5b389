"""Luminance/chroma OpenEXR files and subsampled channels in the port's
reader (`uncltmo_tpu_torch/utils/exr.py`).

Two oracles.  The OpenEXR 3.1 library for the samples: the committed
luminance/chroma fixtures (`tests/data/exr/yc_*.exr`, written by
`RgbaOutputFile` with WRITE_YC / WRITE_YCA under each of the ten
compressions, the chroma 2x2 subsampled) decode to the library's `Y`,
`RY`, `BY` (and `A`) bit for bit, and, where g++ and OpenEXR 3's headers
are present, the rebuilt oracle reads subsampled files of the tests'
writer under every compression.  cv2 for the colour: `*_cv2.npy` are cv2
4.13's reads of the fixtures on a machine whose cv2 has OpenEXR
(`scripts/cv2_exr_reads.py`), as the JAX package reads `.exr`, and
`read_exr` equals them bit for bit.
"""
import os
import sys

import numpy as np
import pytest

import test_torch_exr_codecs as codecs
from uncltmo_tpu_torch.utils.exr import read_exr, read_exr_channels

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "scripts"))
import make_exr_fixtures as fx  # noqa: E402

FIXTURES = fx.FIXTURES
YC_FIXTURES = [f"yc_{c.lower()}" for c in fx.COMPRESSIONS]


def bits(a: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(a).view(f"<u{a.dtype.itemsize}")


@pytest.fixture(scope="module")
def oracle():
    why = fx.oracle_missing()
    if why:
        pytest.skip(f"the OpenEXR library oracle cannot be built: {why}")
    fx.build_oracle()
    return fx


@pytest.mark.parametrize("name", YC_FIXTURES)
def test_yc_fixture_planes_equal_the_library(name):
    """Y at full size, RY and BY at half size each way (and A), as the
    library decodes them."""
    path = os.path.join(FIXTURES, name + ".exr")
    want = dict(np.load(os.path.join(FIXTURES, name + ".npz")))
    got = read_exr_channels(path)
    assert sorted(got) == sorted(want)
    for n in want:
        assert got[n].shape == want[n].shape and got[n].dtype == np.float16
        np.testing.assert_array_equal(bits(got[n]), bits(want[n]))
    h, w = want["Y"].shape
    assert want["RY"].shape == want["BY"].shape == (h // 2, w // 2)


@pytest.mark.parametrize("name", YC_FIXTURES)
def test_yc_fixture_rgb_equals_cv2(name):
    """The RGB image equals cv2.imread's (BGR reversed) bit for bit: each
    chroma sample repeated over its 2x2 pixels, then r = (RY + 1) Y,
    b = (BY + 1) Y, g = (Y - b 0.06 - r 0.33) / 0.6 in double (Rec. 709's
    y coordinates as float32), each stored as float32."""
    got = read_exr(os.path.join(FIXTURES, name + ".exr"))
    want = np.load(os.path.join(FIXTURES, name + "_cv2.npy"))
    assert got.shape == want.shape and got.dtype == np.float32
    np.testing.assert_array_equal(bits(got), bits(want))


def _cv2_chroma_to_bgr(y, ry, by, chroma):
    """cv2's ChromaToBGR for one pixel in Python floats (doubles)."""
    r = (ry + 1.0) * y
    b = (by + 1.0) * y
    g = (y - b * chroma[5] - r * chroma[1]) / chroma[3]
    return np.float32(r), np.float32(g), np.float32(b)


def test_yc_file_chromaticities_are_used(tmp_path):
    """A file with its own chromaticities (DCI-P3's primaries) rebuilds
    green with their y coordinates, pixel by pixel as cv2 does."""
    rng = np.random.default_rng(4)
    rgb = np.abs(rng.standard_normal((6, 8, 3))) * 3 + 0.1
    p3 = [0.68, 0.32, 0.265, 0.69, 0.15, 0.06, 0.314, 0.351]
    planes, sampling = codecs.yc_planes(rgb)
    path = str(tmp_path / "p3.exr")
    codecs.write_exr(path, planes, "ZIP", sampling=sampling, size=(6, 8),
                     chromaticities=p3)
    got = read_exr(path)
    c = [float(np.float32(v)) for v in p3]
    y = planes["Y"].astype(np.float64)
    ry = np.repeat(np.repeat(planes["RY"], 2, 0), 2, 1).astype(np.float64)
    by = np.repeat(np.repeat(planes["BY"], 2, 0), 2, 1).astype(np.float64)
    for i in range(6):
        for j in range(8):
            want = _cv2_chroma_to_bgr(y[i, j], ry[i, j], by[i, j], c)
            assert tuple(got[i, j]) == want


SAMPLINGS = {"Y": (1, 1), "RY": (2, 2), "BY": (2, 2), "A": (2, 1),
             "Z": (1, 3), "id": (3, 1)}


@pytest.mark.parametrize("comp", fx.COMPRESSIONS)
def test_subsampled_channels_under_every_compression(oracle, tmp_path, comp):
    """The tests' writer: Y, RY, BY as a luminance/chroma file holds them,
    A (HALF) at 2 x 1, Z (FLOAT) at 1 x 3, id (UINT) at 3 x 1, in a
    data window away from the origin; every channel decodes as the
    library decodes it, and for the lossless codecs as written (PXR24's
    FLOAT as its 24-bit rounding)."""
    rng = np.random.default_rng(11)
    h, w = 78, 66                              # multiples of the samplings
    rgb = np.stack([fx._field(rng, h, w, s, noise=0.01) for s in (5, 3, 2)],
                   axis=-1)
    planes, _ = codecs.yc_planes(rgb)
    planes["A"] = fx._field(rng, h, w // 2, 0.5).astype(np.float16)
    planes["Z"] = fx._field(rng, h // 3, w, 200.0).astype(np.float32)
    planes["id"] = (fx._field(rng, h, w // 3, 1e4)).astype(np.uint32)
    path = str(tmp_path / "s.exr")
    codecs.write_exr(path, planes, comp, origin=(6, -12), sampling=SAMPLINGS,
                     size=(h, w))
    got = read_exr_channels(path)
    lib = oracle.oracle_read(path)
    assert sorted(got) == sorted(lib) == sorted(planes)
    for n in planes:
        np.testing.assert_array_equal(bits(got[n]), bits(lib[n]))
        if comp in ("NONE", "RLE", "ZIPS", "ZIP", "PIZ") or (
                comp == "PXR24" and n != "Z"):
            np.testing.assert_array_equal(bits(got[n]), bits(planes[n]))


@pytest.mark.parametrize("seed", range(3))
def test_library_yc_files_of_random_images(oracle, tmp_path, seed):
    """RgbaOutputFile's luminance/chroma files of seeded random images
    (WRITE_YC and WRITE_YCA, random even sizes, every compression in
    turn)."""
    rng = np.random.default_rng(500 + seed)
    for k, comp in enumerate(fx.COMPRESSIONS):
        h, w = (2 * int(v) for v in rng.integers(1, [40, 60]))
        rgba = np.abs(np.stack([fx._field(rng, h, w, s, noise=0.05)
                                for s in (6.0, 4.0, 3.0, 1.0)], axis=-1))
        path = str(tmp_path / f"y{k}.exr")
        oracle.oracle_yc(path, comp, rgba.astype(np.float16), (k + seed) % 2)
        got, lib = read_exr_channels(path), oracle.oracle_read(path)
        assert sorted(got) == sorted(lib)
        for n in lib:
            np.testing.assert_array_equal(bits(got[n]), bits(lib[n]))


def test_subsampled_rgb_repeats_each_sample(tmp_path):
    """R, G, B each at 2 x 2 (cv2 repeats such samples before anything
    else): every sample fills its 2 x 2 pixels."""
    rng = np.random.default_rng(5)
    planes = {c: rng.random((5, 7)).astype(np.float16) for c in "RGB"}
    path = str(tmp_path / "rgb.exr")
    codecs.write_exr(path, planes, "PIZ", sampling={c: (2, 2) for c in "RGB"},
                     size=(10, 14), origin=(2, 4))
    want = np.stack([np.repeat(np.repeat(planes[c], 2, 0), 2, 1) for c in
                     "RGB"], -1).astype(np.float32)
    np.testing.assert_array_equal(read_exr(path), want)


def test_yc_runner_tone_maps_as_its_npy_twin(tmp_path):
    """A luminance/chroma file through `run_on_path` gives the PNG of its
    decoded RGB saved as `.npy`."""
    from uncltmo_tpu_torch.utils.io import read_png
    runner = codecs._runner(tmp_path)
    rng = np.random.default_rng(13)
    for d in ("exr", "npy"):
        (tmp_path / d).mkdir()
    rgb = (rng.random((40, 52, 3)) ** 3) * 300.0 + 0.01
    planes, sampling = codecs.yc_planes(rgb)
    path = str(tmp_path / "exr" / "x.exr")
    codecs.write_exr(path, planes, "ZIP", sampling=sampling, size=(40, 52))
    np.save(tmp_path / "npy" / "x.npy", read_exr(path))
    np.save(tmp_path / "lams.npy", {"x": 120.0})
    outs = {d: runner.run_on_path(str(tmp_path / d), str(tmp_path / ("o" + d)),
                                  str(tmp_path / "lams.npy"), scale=1)
            for d in ("exr", "npy")}
    assert len(outs["exr"]) == 1
    np.testing.assert_array_equal(read_png(outs["exr"][0]),
                                  read_png(outs["npy"][0]))

