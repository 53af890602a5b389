"""The port's training data (`uncltmo_tpu_torch/data/`) against the JAX
package's (CPU).

Both are numpy producers with one RNG definition per batch, so batches are
held bit for bit: `SyntheticDataSource`, and `TrainDataSource` over npy
files already at the crop size (every pool: static HDR and LDR, HDR and
sRGB video scenes, negatives).  Resizing is cv2's INTER_LINEAR in the JAX
package and `F.interpolate`'s bilinear rule in the port: the same weights,
but each computes the source coordinate in float32 its own way, and on a
noise image a coordinate that differs in its last bit moves a value by up
to 3e-5 of the image's range (measured).  So samples that are resized are
held to `RESIZED_TOL` of their range; HDR samples then pass through
log10(x / max * lambda + 1), whose slope at the dark end is up to
lambda / ln 10 (110 at the lambda of 255 used here) of the range, and are
held to `RESIZED_HDR_TOL` (measured 1.7e-4).  The transforms are held bit
for bit, the bicubic `scale` to `SCALE_TOL`.
"""
import os
import threading

import numpy as np
import pytest

from uncltmo_tpu.data import pipeline as jpipe
from uncltmo_tpu.data import transforms as jT
from uncltmo_tpu_torch.data import pipeline as tpipe
from uncltmo_tpu_torch.data import transforms as tT

RESIZED_TOL = 1e-4                 # of the value range
RESIZED_HDR_TOL = 1e-3
SCALE_TOL = 1e-5


# ------------------------------------------------------------- transforms
def _img(seed, shape=(9, 13, 3)):
    return np.random.default_rng(seed).random(shape).astype(np.float32)


@pytest.mark.parametrize("name, args", [
    ("to_tensor", ((_img(0, (5, 7)).astype(np.float64),),)),
    ("to_tensor", ((_img(1),),)),
    ("center_crop", ((_img(2, (10, 10, 3)), 6), (_img(3, (8, 12, 1)),
                                                 (4, 6)))),
    ("center_crop", ((_img(4, (9, 9)), 5),)),
    ("normalize", ((_img(5), [0.1, 0.2, 0.3], [0.5, 2.0, 4.0]),)),
    ("max_normalization", ((_img(6, (3, 4, 5, 1)) + 0.1,),)),
    ("minmax_normalization", ((_img(7, (3, 4, 5, 2)),),)),
    ("clip_display", ((_img(8) * 1.2 - 0.1,),)),
    ("exp_display", ((_img(9) - 0.5,),)),
])
def test_transform_matches_jax(name, args):
    for a in args:
        got, ref = getattr(tT, name)(*a), getattr(jT, name)(*a)
        assert got.dtype == ref.dtype and got.shape == ref.shape
        np.testing.assert_array_equal(got, ref)
    assert tT.hdr_im_transform is tT.to_tensor


def test_exp_display_with_clipping_and_scale_match_jax():
    x = _img(10) - 0.5
    np.testing.assert_array_equal(tT.exp_display(x, add_clipping=True),
                                  jT.exp_display(x, add_clipping=True))
    for im, size in ((_img(11, (17, 23, 3)), 11), (_img(12, (16, 20)),
                                                   (8, 30))):
        got, ref = tT.scale(im, size), jT.scale(im, size)
        assert got.shape == ref.shape and got.dtype == np.float32
        np.testing.assert_allclose(got, ref, rtol=SCALE_TOL, atol=SCALE_TOL)


# -------------------------------------------------------- sample helpers
def test_sample_helpers_match_jax():
    rgb = _img(13, (20, 24, 3)) * 500
    np.testing.assert_array_equal(tpipe._rgb_to_yuv_luma(rgb),
                                  jpipe._rgb_to_yuv_luma(rgb))
    gray = jpipe._rgb_to_yuv_luma(rgb)
    np.testing.assert_array_equal(tpipe.hdr_log_input(gray, 37.0),
                                  jpipe.hdr_log_input(gray, 37.0))
    for mode in ("max_normalization", "bugy_max_normalization", "stretch",
                 "none"):
        np.testing.assert_array_equal(
            tpipe.normalize_ldr(rgb, mode, 0.9, 0.05),
            jpipe.normalize_ldr(rgb, mode, 0.9, 0.05))
    assert tpipe.NEG_REPLICATION == jpipe.NEG_REPLICATION


@pytest.mark.parametrize("shape", [(256, 256, 3), (300, 340, 3),
                                   (260, 257, 3)])
def test_random_resize_crop_matches_jax(shape):
    """The same draws in the same order; a 256 x 256 input is returned
    as it is, a resized one agrees to float rounding."""
    im = _img(14, shape) * 100
    for seed in range(4):
        got = tpipe.random_resize_crop(im, np.random.default_rng(seed))
        ref = jpipe.random_resize_crop(im, np.random.default_rng(seed))
        assert got.shape == ref.shape == (256, 256, 3)
        if shape[:2] == (256, 256):
            np.testing.assert_array_equal(got, ref)
        else:
            np.testing.assert_allclose(got, ref, rtol=0,
                                       atol=RESIZED_TOL * 100)


def test_lambda_table_scaling_missing_key_and_missing_file(tmp_path):
    path = str(tmp_path / "lam.npy")
    np.save(path, {"a": 3.0})
    t, j = tpipe.LambdaTable(path, 0.1), jpipe.LambdaTable(path, 0.1)
    assert t("a") == j("a") == pytest.approx(3.0 * 255 * 0.1)
    with pytest.raises(KeyError, match="no lambda found for 'b'"):
        t("b")
    assert tpipe.LambdaTable(path, 0.1, default=2.0)("b") == \
        jpipe.LambdaTable(path, 0.1, default=2.0)("b")
    with pytest.raises(FileNotFoundError, match="lambda dict not found"):
        tpipe.LambdaTable(str(tmp_path / "nope.npy"), 0.1)
    assert tpipe.LambdaTable("none", 0.1).table == {}


# -------------------------------------------------------------- sources
def _write_pools(root, size=256, resized=False):
    """Every pool of the reference layout, npy files at the crop size (or,
    with `resized`, static files that need a resize)."""
    rng = np.random.default_rng(21)
    dirs = {}
    for pool, n in (("hdr", 3), ("ldr", 3), ("neg", 2)):
        d = root / pool
        d.mkdir()
        for i in range(n):
            h, w = ((size + 31 + 7 * i, size + 50) if resized
                    else (size, size))
            im = rng.random((h, w, 3)).astype(np.float32)
            np.save(d / f"{pool}{i}.npy", im * (900 if pool == "hdr" else 255))
        dirs[pool] = str(d)
    for pool in ("hdrvid", "srgbvid"):
        for scene in ("s0", "s1"):
            d = root / pool / scene
            d.mkdir(parents=True)
            for f in range(3):
                im = rng.random((size, size + 40, 3)).astype(np.float32)
                np.save(d / f"{f:03d}.npy", im * 300)
        dirs[pool] = str(root / pool)
    lam = str(root / "lam.npy")
    np.save(lam, {"hdr0": 10.0, "hdr1": 20.0, "hdr2": 30.0})
    vlam = str(root / "vlam.npy")
    np.save(vlam, {"s0": 5.0, "s1": 6.0})
    return dirs, lam, vlam


def _sources(pkg, dirs, lam, vlam, video=True):
    kw = {}
    if video:
        kw = dict(hdr_video_glob=os.path.join(dirs["hdrvid"], "*", "*.npy"),
                  srgb_video_glob=os.path.join(dirs["srgbvid"], "*",
                                               "*.npy"),
                  video_lambda_table=pkg.LambdaTable(vlam, 0.1))
    return pkg.TrainDataSource(
        hdr_glob=os.path.join(dirs["hdr"], "*.npy"),
        ldr_glob=os.path.join(dirs["ldr"], "*.npy"),
        lambda_table=pkg.LambdaTable(lam, 0.1),
        neg_ldr_glob=os.path.join(dirs["neg"], "*.npy"), **kw)


def _epochs(pipe, epoch, stream, start=0):
    return list(pipe.epoch(epoch, stream=stream, start=start))


def _assert_batches(got, ref, tol=None):
    assert len(got) == len(ref)
    for g, r in zip(got, ref):
        assert sorted(g) == sorted(r) == ["hdr", "ldr_neg", "ldr_pos"]
        for k in r:
            assert g[k].dtype == r[k].dtype and g[k].shape == r[k].shape
            if tol is None:
                np.testing.assert_array_equal(g[k], r[k], err_msg=k)
            else:
                np.testing.assert_allclose(
                    g[k], r[k], rtol=0, err_msg=k,
                    atol=RESIZED_HDR_TOL if k == "hdr" else tol)


def test_synthetic_batches_are_bit_equal_to_jax():
    args = dict(batch_size=2, seed=999, workers=2)
    t = tpipe.TrainPipeline(tpipe.SyntheticDataSource(size=64, n_items=6),
                            **args)
    j = jpipe.TrainPipeline(jpipe.SyntheticDataSource(size=64, n_items=6),
                            **args)
    assert t.steps_per_epoch() == j.steps_per_epoch() == 3
    for epoch, stream in ((0, 0), (0, 1), (3, 0)):
        _assert_batches(_epochs(t, epoch, stream), _epochs(j, epoch, stream))
    assert _epochs(t, 0, 0)[0]["hdr"].shape == (2, 2, 64, 64, 1)


def test_npy_batches_at_the_crop_size_are_bit_equal_to_jax(tmp_path):
    """All five pools, video scenes included (width-cropped, never
    resized); the epoch length is the reference's zip of three loaders."""
    dirs, lam, vlam = _write_pools(tmp_path)
    t = tpipe.TrainPipeline(_sources(tpipe, dirs, lam, vlam), 2, seed=5,
                            workers=3)
    j = jpipe.TrainPipeline(_sources(jpipe, dirs, lam, vlam), 2, seed=5,
                            workers=1)
    assert len(t.source) == len(j.source) == 3
    for epoch in range(3):
        _assert_batches(_epochs(t, epoch, 0), _epochs(j, epoch, 0))


def test_resized_samples_agree_to_float_rounding(tmp_path):
    dirs, lam, vlam = _write_pools(tmp_path, resized=True)
    t = tpipe.TrainPipeline(_sources(tpipe, dirs, lam, vlam, video=False), 1,
                            seed=8)
    j = jpipe.TrainPipeline(_sources(jpipe, dirs, lam, vlam, video=False), 1,
                            seed=8)
    _assert_batches(_epochs(t, 0, 0), _epochs(j, 0, 0), tol=RESIZED_TOL)


def test_source_refusals(tmp_path):
    dirs, lam, vlam = _write_pools(tmp_path)
    empty = str(tmp_path / "empty" / "*.npy")
    with pytest.raises(FileNotFoundError, match="negative-LDR"):
        tpipe.TrainDataSource(os.path.join(dirs["hdr"], "*.npy"),
                              os.path.join(dirs["ldr"], "*.npy"),
                              tpipe.LambdaTable(lam, 0.1),
                              neg_ldr_glob=empty)
    with pytest.raises(ValueError, match="video_lambda_table"):
        tpipe.TrainDataSource(os.path.join(dirs["hdr"], "*.npy"),
                              os.path.join(dirs["ldr"], "*.npy"),
                              tpipe.LambdaTable(lam, 0.1),
                              hdr_video_glob=os.path.join(
                                  dirs["hdrvid"], "*", "*.npy"))
    with pytest.raises(ValueError, match="no HDR training pool"):
        tpipe.TrainDataSource("", os.path.join(dirs["ldr"], "*.npy"),
                              tpipe.LambdaTable(lam, 0.1))
    with pytest.warns(UserWarning, match="no negative-LDR pool"):
        src = tpipe.TrainDataSource(os.path.join(dirs["hdr"], "*.npy"),
                                    os.path.join(dirs["ldr"], "*.npy"),
                                    tpipe.LambdaTable(lam, 0.1))
    assert len(src) == 3
    # a file whose lambda is missing raises at its first draw
    nolam = tpipe.TrainDataSource(os.path.join(dirs["hdr"], "*.npy"),
                                  os.path.join(dirs["ldr"], "*.npy"),
                                  tpipe.LambdaTable(vlam, 0.1),
                                  neg_ldr_glob=os.path.join(dirs["neg"],
                                                            "*.npy"))
    with pytest.raises(KeyError, match="no lambda found"):
        nolam.sample(np.random.default_rng(0))


# ------------------------------------------------------------- pipeline
class _Counting:
    """SyntheticDataSource that counts its samples."""

    def __init__(self, fail_at=None):
        self.inner = tpipe.SyntheticDataSource(size=16, n_items=12)
        self.calls = 0
        self.fail_at = fail_at
        self.lock = threading.Lock()

    def __len__(self):
        return len(self.inner)

    def sample(self, rng):
        with self.lock:
            self.calls += 1
            if self.fail_at is not None and self.calls >= self.fail_at:
                raise RuntimeError("sample failed")
        return self.inner.sample(rng)


def test_worker_count_does_not_change_the_stream():
    src = tpipe.SyntheticDataSource(size=24, n_items=10)
    one = _epochs(tpipe.TrainPipeline(src, 2, seed=3, workers=1), 2, 1)
    many = _epochs(tpipe.TrainPipeline(src, 2, seed=3, workers=4), 2, 1)
    _assert_batches(many, one)
    other = _epochs(tpipe.TrainPipeline(src, 2, seed=3, workers=4), 2, 0)
    assert not np.array_equal(other[0]["hdr"], one[0]["hdr"])


def test_epoch_start_yields_batch_k_without_producing_the_prefix():
    src = _Counting()
    pipe = tpipe.TrainPipeline(src, 2, seed=4, workers=2)
    full = _epochs(pipe, 0, 0)
    src.calls = 0
    tail = _epochs(pipe, 0, 0, start=4)
    assert src.calls == 2 * 2          # batches 4 and 5 only
    _assert_batches(tail, full[4:])


def test_worker_exception_reraises_in_the_consumer():
    pipe = tpipe.TrainPipeline(_Counting(fail_at=5), 2, seed=0, workers=3)
    with pytest.raises(RuntimeError, match="sample failed"):
        _epochs(pipe, 0, 0)


def test_device_prefetch_order_errors_and_early_exit():
    prepared = []

    def prepare(x):
        prepared.append(x)
        return x * 10

    assert list(tpipe.device_prefetch(range(7), prepare, depth=2)) == \
        [10 * i for i in range(7)]

    def bad(x):
        if x == 3:
            raise ValueError("prepare failed")
        return x

    with pytest.raises(ValueError, match="prepare failed"):
        list(tpipe.device_prefetch(range(6), bad))
    prepared.clear()
    gen = tpipe.device_prefetch(range(1000), prepare, depth=2)
    assert next(gen) == 0
    gen.close()                          # stops the thread
    n = len(prepared)
    assert n <= 5 and len(prepared) == n


def test_the_runner_uses_the_shared_device_prefetch():
    from uncltmo_tpu_torch.inference import runner
    assert runner.device_prefetch is tpipe.device_prefetch
    assert not hasattr(runner, "_prefetch")
