"""BTMQI of the port (`uncltmo_tpu_torch/metrics/btmqi.py`,
`btmqi_validation.py`) against the golden pack and the JAX package.

The entropy features truncate `x * 4095` of the smoothed image to a bin,
so a smoothed value on the other side of a bin edge moves an entropy by
up to ~log2(N) / N bits (N pixels).  The port smooths in float64 and
casts to float32; the tests count the pixels whose bin differs from the
JAX package's float32 smoothing and report them beside the error.  On the
golden 128 px render no bin moves; on the 192 px renders below a few do,
and every feature stays within 5e-5 (the golden tolerance).
"""
import os

import numpy as np
import pytest
import torch

from uncltmo_tpu.metrics import btmqi as jb
from uncltmo_tpu.metrics import btmqi_validation as jv
from uncltmo_tpu_torch.metrics import btmqi as tb
from uncltmo_tpu_torch.metrics import btmqi_validation as tv

FLOAT_TOL = 5e-5                # tests/test_golden.py
GOLDEN = os.path.join(os.path.dirname(__file__), "golden", "golden.npz")


def flipped_bins(gray01: np.ndarray) -> int:
    """Pixels whose entropy bin differs between the JAX package's smoothing
    and the port's, summed over the five exposures."""
    import jax.numpy as jnp
    g = gray01.astype(np.float32)
    k = jb.fspecial_gauss_1d(11, 1.5)
    mj = np.asarray(jnp.clip(jb._smoothed_mean(jnp.asarray(g), k), 0, 1))
    mt = tb._smoothed_mean(torch.from_numpy(g), k).clamp(0, 1).numpy()
    return sum(int(np.sum(((mj ** (2.0 ** e)) * 4095).astype(np.int32)
                          != ((mt ** (2.0 ** e)) * 4095).astype(np.int32)))
               for e in range(5))


def test_golden_btmqi():
    """`golden_cases.case_btmqi` through the port: score and features."""
    golden = np.load(GOLDEN)
    im = tv.make_base_render(0, size=128)
    np.testing.assert_array_equal(im, jv.make_base_render(0, size=128))
    score, feats = tb.btmqi(im, device="cpu")
    assert flipped_bins(im) == 0
    np.testing.assert_allclose(np.asarray(feats, np.float32),
                               golden["btmqi/feats"], rtol=FLOAT_TOL,
                               atol=FLOAT_TOL)
    np.testing.assert_allclose([score], golden["btmqi/score"],
                               rtol=FLOAT_TOL, atol=FLOAT_TOL)


def _render(kind: str) -> np.ndarray:
    base = tv.make_base_render({"gray": 0, "rgb": 1, "u8": 2}[kind], 192)
    if kind == "rgb":
        tint = np.array([1.0, 0.9, 0.75])
        return np.clip(base[..., None] * tint + 0.05 * base[..., None] ** 2,
                       0.0, 1.0)
    if kind == "u8":
        return np.round(base * 255.0)
    return base


@pytest.mark.parametrize("kind", ["gray", "rgb", "u8"])
def test_features_and_score_match_jax(kind, capsys):
    im = _render(kind)
    s_ref, f_ref = jb.btmqi(im)
    s_got, f_got = tb.btmqi(im, device="cpu")
    gray = np.asarray(im, np.float32)
    gray = gray / 255.0 if gray.max() > 1.5 else gray
    if gray.ndim == 3:
        gray = gray @ np.asarray(tb.P.REC709, np.float32)
    err = float(np.abs(np.asarray(f_got) - np.asarray(f_ref)).max())
    with capsys.disabled():
        print(f"\n[btmqi {kind}] flipped bins {flipped_bins(gray)}, max "
              f"feature error {err:.3g}, score error {abs(s_got - s_ref):.3g}")
    assert f_got.shape == (11,) and f_got.dtype == np.float32
    np.testing.assert_allclose(f_got, f_ref, rtol=FLOAT_TOL, atol=FLOAT_TOL)
    assert abs(s_got - s_ref) <= FLOAT_TOL


def _model_mat(path, rng, sparse: bool):
    import scipy.io as sio
    import scipy.sparse as sp
    svs = rng.normal(4.0, 2.0, (9, 11))
    model = {"Parameters": np.array([[4.0], [2.0], [3.0], [1.0 / 11.0],
                                     [0.0]]),
             "SVs": sp.csr_matrix(svs) if sparse else svs,
             "sv_coef": rng.normal(0.0, 1.0, (9, 1)),
             "rho": np.array([[-6.2008]])}
    sio.savemat(path, {"model": model})
    return svs


@pytest.mark.parametrize("sparse", [False, True], ids=["dense", "sparse"])
def test_svr_model_matches_jax(tmp_path, sparse):
    """A libsvm model struct written by `scipy.io.savemat` (the SVs dense
    and MATLAB-sparse): parsed alike, predictions within 1e-10, one vector
    and a batch; the score through `btmqi(model_mat=...)` as well."""
    rng = np.random.default_rng(7)
    path = str(tmp_path / "model.mat")
    svs = _model_mat(path, rng, sparse)
    mt, mj = tb.load_svr_model(path), jb.load_svr_model(path)
    np.testing.assert_array_equal(mt.support_vectors, svs)
    assert (mt.rho, mt.gamma) == (mj.rho, mj.gamma) == (-6.2008, 1.0 / 11.0)
    x = rng.normal(4.0, 2.0, (5, 11))
    np.testing.assert_allclose(mt.predict(x), mj.predict(x), rtol=1e-10,
                               atol=1e-10)
    assert np.ndim(mt.predict(x[0])) == 0
    im = tv.make_base_render(3, size=96)
    s_t, f_t = tb.btmqi(im, model_mat=path, device="cpu")
    assert abs(s_t - float(mj.predict(f_t))) <= 1e-10
    assert abs(s_t - jb.btmqi(im, model_mat=mj)[0]) <= 1e-4


def test_svr_refusals(tmp_path):
    import scipy.io as sio
    with pytest.raises(FileNotFoundError):
        tb.load_svr_model(str(tmp_path / "none.mat"))
    sio.savemat(str(tmp_path / "lin.mat"), {"model": {
        "Parameters": np.array([[4.0], [0.0], [3.0], [0.1], [0.0]]),
        "SVs": np.ones((2, 11)), "sv_coef": np.ones((2, 1)),
        "rho": np.array([[0.0]])}})
    with pytest.raises(ValueError, match="RBF"):
        tb.load_svr_model(str(tmp_path / "lin.mat"))
    with pytest.raises(ValueError, match="coefficients"):
        tb.SVRModel(np.ones((3, 11)), np.ones(2), 0.0, 0.1)


def test_validate_matches_jax(tmp_path):
    """The harness on a small corpus (one seed at 96 px) with an SVR: the
    ladders' monotone fractions and the pooled Spearman agree with the JAX
    package's (ranks of scores within 5e-5; every fraction equal), and
    the score ranges within 5e-5."""
    rng = np.random.default_rng(8)
    path = str(tmp_path / "model.mat")
    _model_mat(path, rng, sparse=False)
    model_t, model_j = tb.load_svr_model(path), jb.load_svr_model(path)
    got = tv.validate(seeds=(0,), model=model_t, size=96, device="cpu")
    ref = jv.validate(seeds=(0,), model=model_j, size=96)
    assert got["n_images"] == ref["n_images"] == 27
    assert got["sweeps"] == ref["sweeps"]
    for k, v in ref["spearman"].items():
        assert abs(got["spearman"][k] - v) <= 1e-6, k
    for k, (lo, hi) in ref["score_range"].items():
        np.testing.assert_allclose(got["score_range"][k], (lo, hi),
                                   rtol=FLOAT_TOL, atol=FLOAT_TOL)
    assert tv._spearman([1, 2, 3], [3, 2, 1]) == -1.0
    assert tv._monotone_frac([3.0, 2.0, 2.0]) == 0.5
