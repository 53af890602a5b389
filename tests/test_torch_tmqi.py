"""The port's full TMQI and TMQIr against the JAX package (CPU): the
helpers (`window_mean_auto`, `moving_std_mean`, `haar_half`,
`to_gray_709`), structural fidelity, the revised naturalness, `tmqi`,
`tmqi_gray` and the `TMQI` / `TMQIr` classes.

Inputs are seeded numpy arrays handed to both sides.  Tolerances: the
golden pack at 5e-5 (rtol and atol, as `tests/test_golden.py`); Q, S, N and
the five s_l at the same 5e-5; the s-maps entry by entry at 2e-3 of their
max-abs.  The s-map divides the windowed covariance E[xy] - E[x]E[y] by the
product of two stds, so on independent textures it is a small difference
of large float32 sums: the JAX package and the port each differ from a
float64 evaluation by up to 5e-4 of max-abs at levels 1-2 on these inputs,
and by up to 1e-3 from each other, while their means (the s_l) agree to
1e-6.  The port computes Q, S and the s-maps in float64, the JAX package
in float32, so these inputs are textured and unclipped: on exactly flat
patches (a render's clipped highlights) the JAX package's float32 goes
astray (`metrics/tmqi.py`'s docstring), and there the port is held
against the reference's algorithm in float64 numpy instead.
"""
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from uncltmo_tpu.metrics import tmqi as jtmqi
from uncltmo_tpu.ops import color as jcolor
from uncltmo_tpu.ops import resize as jresize
from uncltmo_tpu.ops import windows as jwin
from uncltmo_tpu_torch.metrics import tmqi as ttmqi
from uncltmo_tpu_torch.ops import color as tcolor
from uncltmo_tpu_torch.ops import resize as tresize
from uncltmo_tpu_torch.ops import windows as twin

GOLDEN = os.path.join(os.path.dirname(__file__), "golden", "golden.npz")
FLOAT_TOL = 5e-5
SMAP_TOL = 2e-3          # of the s-map's max-abs


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x)).permute(0, 3, 1, 2)


def _textured(seed, h=200, w=260):
    """A smooth scene over ~6 decades with coloured regions and 5% noise,
    and an LDR rendering of it in (0, 255) with noise of its own."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    f = rng.uniform(2.0, 6.0, 4).astype(np.float32)
    logl = (2.0 * np.sin(f[0] * xx / w + f[1] * yy / h)
            + 1.5 * np.cos(f[2] * yy / h) + 1.0 * np.sin(f[3] * xx / w)) / 1.5
    tint = rng.uniform(0.3, 1.0, (3, 1, 1)).astype(np.float32)
    rgb = 10.0 ** logl[None] * (tint + 0.3 * np.sin(xx / (40 + 10 * tint)))
    rgb *= 1.0 + 0.05 * rng.standard_normal((3, h, w)).astype(np.float32)
    hdr = np.clip(rgb, 1e-4, None).transpose(1, 2, 0).astype(np.float32)
    t = (hdr / hdr.max()) ** 0.3
    ldr = np.clip(20.0 + 200.0 * t + 8.0 * rng.standard_normal(hdr.shape),
                  0.0, 255.0).astype(np.float32)
    return hdr, ldr


def _assert_tmqi_close(got, ref):
    q, s, n, s_local, s_maps = got
    np.testing.assert_allclose([q, s, n], ref[:3], rtol=FLOAT_TOL,
                               atol=FLOAT_TOL)
    np.testing.assert_allclose(s_local, ref[3], rtol=FLOAT_TOL,
                               atol=FLOAT_TOL)
    assert len(s_maps) == len(ref[4]) == 5
    for mine, theirs in zip(s_maps, ref[4]):
        mine = mine.numpy()
        assert mine.shape == theirs.shape
        scale = np.abs(theirs).max()
        assert np.abs(mine - theirs).max() <= SMAP_TOL * scale


def test_tmqi_matches_golden():
    golden = np.load(GOLDEN)
    rng = np.random.default_rng(5)
    hdr = (rng.random((192, 240, 3), np.float32) ** 2) * 900.0
    ldr = np.clip(hdr / hdr.max() * 400.0, 0, 255).astype(np.float32)
    q, s, n, s_local, _ = ttmqi.tmqi(hdr, ldr, device="cpu")
    np.testing.assert_allclose([q, s, n], golden["tmqi/qsn"],
                               rtol=FLOAT_TOL, atol=FLOAT_TOL)
    np.testing.assert_allclose(s_local, golden["tmqi/s_local"],
                               rtol=FLOAT_TOL, atol=FLOAT_TOL)


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("gray", [False, True], ids=["rgb", "gray"])
@pytest.mark.parametrize("revised", [False, True], ids=["tmqi", "tmqir"])
def test_tmqi_matches_jax(seed, gray, revised):
    hdr, ldr = _textured(seed)
    if gray:
        hdr, ldr = hdr[..., 1], ldr[..., 1]
    ref = jtmqi.tmqi(hdr, ldr, revised=revised)
    got = ttmqi.tmqi(hdr, ldr, revised=revised, device="cpu")
    _assert_tmqi_close(got, ref)


def test_tmqi_takes_tensors_and_the_classes_call_it():
    hdr, ldr = _textured(2, 120, 150)
    ref = jtmqi.TMQI()(hdr, ldr)
    ref_r = jtmqi.TMQIr()(hdr, ldr)
    _assert_tmqi_close(ttmqi.TMQI(device="cpu")(torch.from_numpy(hdr),
                                                torch.from_numpy(ldr)), ref)
    _assert_tmqi_close(ttmqi.TMQIr(device="cpu")(hdr, ldr), ref_r)
    with pytest.raises(ValueError, match="one shape"):
        ttmqi.tmqi(hdr, ldr[..., 0], device="cpu")


def test_tmqi_gray_matches_jax():
    hdr, ldr = _textured(3, 176, 210)
    ref = [float(v) for v in jtmqi.tmqi_gray(jnp.asarray(hdr[..., 0]),
                                             jnp.asarray(ldr[..., 0]))]
    got = [float(v) for v in ttmqi.tmqi_gray(hdr[..., 0], ldr[..., 0],
                                             device="cpu")]
    np.testing.assert_allclose(got, ref, rtol=FLOAT_TOL, atol=FLOAT_TOL)


def test_structural_fidelity_and_revised_naturalness_match_jax():
    hdr, ldr = _textured(4, 150, 180)
    h, l = hdr[..., 0] / hdr[..., 0].max(), ldr[..., 0]
    s, sl, sm = jtmqi.structural_fidelity(jnp.asarray(h), jnp.asarray(l))
    ts, tsl, tsm = ttmqi.structural_fidelity(torch.from_numpy(h),
                                             torch.from_numpy(l))
    np.testing.assert_allclose(float(ts), float(s), rtol=FLOAT_TOL)
    np.testing.assert_allclose([float(v) for v in tsl],
                               [float(v) for v in sl], rtol=FLOAT_TOL)
    for a, b in zip(tsm, sm):
        assert a.shape == b.shape
    for revised in (False, True):
        ref = float(jtmqi.statistical_naturalness(jnp.asarray(l), revised))
        got = float(ttmqi.statistical_naturalness(torch.from_numpy(l),
                                                  revised))
        np.testing.assert_allclose(got, ref, rtol=1e-5)


def test_a_128_image_reaches_the_swapped_window_and_mixed_sizes_raise():
    """At 128 x 128 the fifth level is 8 x 8, smaller than the 11-tap
    window in both dimensions: scipy's 'valid' swaps roles.  128 x 200
    reaches 8 x 12 there, which has no 'valid' output."""
    rng = np.random.default_rng(8)
    hdr = (rng.random((128, 128), np.float32) ** 2) * 100.0
    ldr = np.clip(hdr * 2.5, 0, 255).astype(np.float32)
    ref = jtmqi.tmqi(hdr, ldr)
    got = ttmqi.tmqi(hdr, ldr, device="cpu")
    assert got[4][-1].shape == ref[4][-1].shape == (4, 4)
    _assert_tmqi_close(got, ref)
    x = rng.random((1, 8, 6, 1), np.float32)
    k = jwin.fspecial_gauss_1d(11, 1.5)
    np.testing.assert_allclose(
        twin.window_mean_auto(_nchw(x), k).permute(0, 2, 3, 1).numpy(),
        np.asarray(jwin.window_mean_auto(jnp.asarray(x), k)), rtol=1e-5,
        atol=1e-7)
    wide = rng.random((128, 200), np.float32)
    with pytest.raises(ValueError, match="mixed window/image containment"):
        ttmqi.tmqi(wide, wide * 100.0, device="cpu")
    with pytest.raises(ValueError, match="mixed window/image containment"):
        twin.window_mean_auto(torch.zeros(1, 1, 8, 12), k)


def test_moving_std_mean_matches_jax_and_scipy():
    from scipy import ndimage
    rng = np.random.default_rng(9)
    for shape in ((23, 31), (11, 11), (4, 9)):
        x = rng.random(shape, np.float32) * 255.0
        ref = float(np.mean(ndimage.generic_filter(x.astype(np.float64),
                                                   np.std, 11)))
        got = float(twin.moving_std_mean(torch.from_numpy(x), 11))
        jax_ref = float(jwin.moving_std_mean(jnp.asarray(x), 11))
        np.testing.assert_allclose(got, ref, rtol=1e-5)
        np.testing.assert_allclose(got, jax_ref, rtol=1e-5)
    batch = rng.random((2, 3, 15, 17), np.float32)
    got = twin.moving_std_mean(torch.from_numpy(batch))
    assert got.shape == (2, 3)
    np.testing.assert_allclose(
        got[1, 2].item(), float(jwin.moving_std_mean(jnp.asarray(
            batch[1, 2]))), rtol=1e-5)


@pytest.mark.parametrize("h,w", [(9, 13), (16, 16), (21, 8)])
def test_haar_half_and_rec709_match_jax(h, w):
    rng = np.random.default_rng(h * w)
    x = rng.random((2, h, w, 3), np.float32)
    got = tresize.haar_half(_nchw(x)).permute(0, 2, 3, 1).numpy()
    ref = np.asarray(jresize.haar_half(jnp.asarray(x)))
    assert got.shape == ref.shape == (2, h // 2, w // 2, 3)
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(
        tcolor.to_gray_709(torch.from_numpy(x)).numpy(),
        np.asarray(jcolor.to_gray_709(jnp.asarray(x))), rtol=1e-6)


def _reference_s(hdr, ldr):
    """S of gray images by the reference's algorithm in float64 numpy /
    scipy (`TMQI.py:145-207`: 2-D 'valid' convolutions with the 11 x 11
    window, 2x2 means between the levels), the HDR std scaled by 2^32 - 1
    as the packages scale it."""
    from scipy.signal import convolve2d
    from scipy.special import ndtr
    g = jwin.gaussian_kernel_1d(11, 1.5)
    win = np.outer(g, g) / np.outer(g, g).sum()
    x = (hdr - hdr.min()) / (hdr.max() - hdr.min())
    y = ldr.astype(np.float64)
    f, s = 32.0, 1.0
    for w_l in (0.0448, 0.2856, 0.3001, 0.2363, 0.1333):
        f /= 2.0
        mu1 = convolve2d(x, win, "valid")
        mu2 = convolve2d(y, win, "valid")
        s1 = np.sqrt(np.maximum(convolve2d(x * x, win, "valid") - mu1 ** 2,
                                0)) * (2.0 ** 32 - 1)
        s2 = np.sqrt(np.maximum(convolve2d(y * y, win, "valid") - mu2 ** 2,
                                0))
        s12 = (convolve2d(x * y, win, "valid") - mu1 * mu2) * (2.0 ** 32 - 1)
        csf = 100 * 2.6 * (0.0192 + 0.114 * f) * np.exp(-(0.114 * f) ** 1.1)
        u = 128 / (1.4 * csf)
        p1, p2 = ndtr((s1 - u) / (u / 3)), ndtr((s2 - u) / (u / 3))
        smap = ((2 * p1 * p2 + 0.01) / (p1 ** 2 + p2 ** 2 + 0.01)
                * ((s12 + 10) / (s1 * s2 + 10)))
        s *= smap.mean() ** w_l
        h, w = x.shape[0] // 2 * 2, x.shape[1] // 2 * 2
        x = x[:h, :w].reshape(h // 2, 2, w // 2, 2).mean(axis=(1, 3))
        y = y[:h, :w].reshape(h // 2, 2, w // 2, 2).mean(axis=(1, 3))
    return s


def _render(hdr_gray, rng):
    """An LDR rendering in [0, 255] that, like a Tester render, clips its
    brightest 1% and darkest 0.1% flat."""
    t = np.log10(hdr_gray + 1e-3) + 0.02 * rng.standard_normal(
        hdr_gray.shape)
    lo, hi = np.percentile(t, (0.1, 99.0))
    return (np.clip((t - lo) / (hi - lo), 0, 1) * 255.0).astype(np.float32)


def test_saturated_renders_match_a_float64_reference():
    """The port's S against the reference's algorithm in float64 at 1e-6
    (measured 1e-7).  The JAX package's float32 S on the same inputs is
    0.7998 and 1.0896 against 0.7938 and 0.8890 (flat clipped patches: a
    rounding residue of a window covariance, scaled by 2^32 - 1;
    `metrics/tmqi.py`'s docstring); the port's N, which has no such term,
    agrees with JAX's at 1e-5."""
    jax_off = []
    for seed, shape in ((5, (176, 176)), (6, (270, 480))):
        hdr, _ = _textured(seed, *shape)
        gray = hdr @ np.asarray([0.2126, 0.7152, 0.0722], np.float32)
        ldr = _render(gray, np.random.default_rng(seed))
        assert (ldr == 255).mean() >= 0.009
        q, s, n, _, _ = ttmqi.tmqi(gray, ldr, device="cpu")
        np.testing.assert_allclose(s, _reference_s(gray, ldr), rtol=1e-6)
        assert 0.0 < s <= 1.0 and 0.0 < q <= 1.0
        ref = jtmqi.tmqi(gray, ldr)
        np.testing.assert_allclose(n, ref[2], rtol=1e-5, atol=1e-12)
        jax_off.append(abs(ref[1] - s))
    assert max(jax_off) > 1e-2
