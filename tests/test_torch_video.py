"""The PyTorch port's video path against the JAX package (CPU): window
statistics, the generator's temporal carry, `video_apply`, the video tiler
and the scene runner.

Weights come from `UNetTMO(...).init` and cross over with the port's
`state_dict_from_flax`; inputs come from numpy seeds.  Tolerances: 5e-5 for
the golden pack and the real generator (as `tests/test_golden.py`), 1e-6
for the chunking stand-in (elementwise float32 in the same order), <= 1
uint8 level for PNGs (a float32 round-off can cross a truncation step).
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from uncltmo_tpu.config import get_model_params as jax_model_params
from uncltmo_tpu.inference.engine import TileEngine as JaxEngine
from uncltmo_tpu.inference.runner import InferenceRunner as JaxRunner
from uncltmo_tpu.models.unet import UNetTMO as JaxUNet
from uncltmo_tpu.ops import windows as jwindows
from uncltmo_tpu_torch.config import get_model_params
from uncltmo_tpu_torch.inference.engine import TileEngine
from uncltmo_tpu_torch.inference.runner import InferenceRunner
from uncltmo_tpu_torch.models.unet import UNetTMO, video_apply
from uncltmo_tpu_torch.ops import windows
from uncltmo_tpu_torch.utils.convert import load_state, state_dict_from_flax
from uncltmo_tpu_torch.utils.io import read_png

GOLDEN = os.path.join(os.path.dirname(__file__), "golden", "golden.npz")
FLOAT_TOL = 5e-5
CARRY_WIDTHS = [1, 2, 4, 8, 8, 4, 2, 1]


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x)).permute(0, 3, 1, 2)


def _nhwc(t):
    return t.detach().permute(0, 2, 3, 1).numpy()


@pytest.fixture(scope="module")
def golden():
    return np.load(GOLDEN)


@pytest.fixture(scope="module")
def golden_gen():
    """The golden pack's generator (128^2 input, gcn_grid 4, key 0): the
    flax module, its variables and the port's model with the same
    weights."""
    gen = JaxUNet(gcn_grid=4)
    v = jax.jit(gen.init)(jax.random.PRNGKey(0), jnp.zeros((1, 128, 128, 1)))
    sd = state_dict_from_flax(jax.tree_util.tree_map(np.asarray,
                                                     v["params"]))
    return gen, v, load_state(UNetTMO(gcn_grid=4), sd).eval()


def test_contrast_map_matches_golden(golden):
    x = np.random.default_rng(6).random((1, 64, 64, 1), np.float32)
    out = windows.contrast_map(_nchw(x))
    np.testing.assert_allclose(_nhwc(out), golden["ops/contrast_map"],
                               rtol=FLOAT_TOL, atol=FLOAT_TOL)


def test_window_statistics_match_jax():
    rng = np.random.default_rng(11)
    x = rng.random((2, 20, 23, 3), np.float32)
    y = rng.random((2, 20, 23, 3), np.float32)
    for k1d, jk1d in ((windows.box_kernel_1d(5), jwindows.box_kernel_1d(5)),
                      (windows.fspecial_gauss_1d(7, 1.0),
                       jwindows.fspecial_gauss_1d(7, 1.0))):
        np.testing.assert_array_equal(k1d, jk1d)
        ref = jwindows.window_stats(jnp.asarray(x), jnp.asarray(y), jk1d)
        got = windows.window_stats(_nchw(x), _nchw(y), k1d)
        for g, r in zip(got, ref):
            np.testing.assert_allclose(_nhwc(g), np.asarray(r), rtol=1e-5,
                                       atol=1e-6)
    np.testing.assert_array_equal(windows.gaussian_kernel_1d(11, 1.5),
                                  jwindows.gaussian_kernel_1d(11, 1.5))
    np.testing.assert_allclose(
        _nhwc(windows.adaptive_avg_pool_1(_nchw(x))),
        np.asarray(jwindows.adaptive_avg_pool_1(jnp.asarray(x))), rtol=1e-6)


@pytest.mark.parametrize("grad", [False, True], ids=["no_grad", "grad"])
def test_video_apply_matches_golden_unet_video(golden, golden_gen, grad):
    """T = 3: frame 2 reads the carry that frame 1 recorded, so a recorded
    slice that aliased a tensor overwritten later in frame 1 (the in-place
    splice of the no_grad path) would show here; T = 2 would not.  The
    autograd path builds new tensors instead and must agree too."""
    _, _, model = golden_gen
    x = np.random.default_rng(2).random((1, 3, 128, 128, 1), np.float32)
    xt = torch.from_numpy(x).permute(0, 1, 4, 2, 3)
    with torch.set_grad_enabled(grad):
        out, fea = video_apply(model, xt)
    assert out.requires_grad == grad
    assert out.shape == (1, 3, 1, 128, 128) and fea.shape == (1, 3, 64)
    np.testing.assert_allclose(
        out.detach().permute(0, 1, 3, 4, 2).numpy(), golden["unet_video/out"],
        rtol=FLOAT_TOL, atol=FLOAT_TOL)
    np.testing.assert_allclose(fea.detach().numpy(), golden["unet_video/fea"],
                               rtol=FLOAT_TOL, atol=FLOAT_TOL)
    with torch.no_grad():
        _, no_fea = video_apply(model, xt[:, :1], with_features=False)
    assert no_fea.shape == (1, 1, 0)


def test_carry_matches_jax_frame(golden_gen):
    """The eight recorded slices after frame 0 (no carry in) and frame 1
    (carry in), the outputs, and the image-mode forward, which is frame 0."""
    gen, v, model = golden_gen
    x = np.random.default_rng(12).random((2, 2, 128, 128, 1), np.float32)
    frame = jax.jit(lambda v, x, c: gen.apply(v, x, c, method=JaxUNet.frame))
    carry_j, carry_t = None, None
    for k in range(2):
        out_j, up_j, carry_j = frame(v, jnp.asarray(x[:, k]), carry_j)
        with torch.no_grad():
            out_t, up_t, carry_t = model.frame(_nchw(x[:, k]), carry_t)
        assert [c.shape[1] for c in carry_t] == CARRY_WIDTHS
        for ct, cj in zip(carry_t, carry_j):
            np.testing.assert_allclose(_nhwc(ct), np.asarray(cj),
                                       rtol=FLOAT_TOL, atol=FLOAT_TOL)
        np.testing.assert_allclose(_nhwc(out_t), np.asarray(out_j),
                                   rtol=FLOAT_TOL, atol=FLOAT_TOL)
        np.testing.assert_allclose(_nhwc(up_t), np.asarray(up_j),
                                   rtol=FLOAT_TOL, atol=FLOAT_TOL)
    with torch.no_grad():
        out, up_x = model(_nchw(x[:, 0]))
        out0, up0, _ = model.frame(_nchw(x[:, 0]))
    assert torch.equal(out, out0) and torch.equal(up_x, up0)


def test_run_video_matches_jax_engine_real_generator(golden_gen):
    """A 4-tile plan (tile 128, overlap 32) with the 32-filter generator,
    T = 3; `run_videos` equals `run_video` scene by scene."""
    gen, v, model = golden_gen
    clips = np.random.default_rng(13).random((2, 3, 144, 176, 1), np.float32)
    ref = JaxEngine(gen, v, tile=128, overlap=32).run_video(
        jnp.asarray(clips[0]))
    eng = TileEngine(model, tile=128, overlap=32, device="cpu")
    out = eng.run_video(torch.from_numpy(clips[0]))
    assert out.shape == (3, 144, 176, 1) and out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=FLOAT_TOL,
                               atol=FLOAT_TOL)
    both = eng.run_videos(torch.from_numpy(clips))
    assert both.shape == (2, 3, 144, 176, 1)
    np.testing.assert_allclose(both[0].numpy(), out.numpy(), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(
        both[1].numpy(), eng.run_video(torch.from_numpy(clips[1])).numpy(),
        rtol=1e-5, atol=1e-5)


class _JaxBatchMeanVideo:
    """A stand-in generator coupled over the conv batch (a mean over all
    tiles of the chunk) and over time (the previous frame's output is the
    carry), so the result depends on how tiles are chunked and padded and
    on each tile keeping its own carry.  `video_apply` of the JAX package
    only ever calls `model.apply(..., method=UNetTMO.frame)`."""

    def apply(self, variables, x, carry=None, **kw):
        out = x / (jnp.mean(x) + 1.0)
        if carry is not None:
            out = out + 0.25 * carry[0]
        return out, x, [out]


class _TorchBatchMeanVideo(torch.nn.Module):
    def frame(self, x, carry=None):
        out = x / (torch.mean(x) + 1.0)
        if carry is not None:
            out = out + 0.25 * carry[0]
        return out, x, [out]


@pytest.mark.parametrize("h,w,chunk", [(64, 88, None), (64, 88, 12),
                                       (160, 172, None)])
def test_video_chunking_and_padding_match_jax(h, w, chunk):
    """A plan of <= 120 tiles whose last chunk is padded with zero tiles
    (35 tiles: one chunk of 36, or three of 12), and one above 120 tiles
    (equalised chunks padded with weightless origin tiles), for `run_video`
    and for `run_videos` (all scenes in one unpadded batch; scene by scene
    above 120)."""
    scenes = np.random.default_rng(14).random((2, 3, h, w, 1),
                                              np.float32) + 0.5
    jeng = JaxEngine(_JaxBatchMeanVideo(), {}, tile=16, overlap=4,
                     chunk=chunk)
    eng = TileEngine(_TorchBatchMeanVideo(), tile=16, overlap=4, chunk=chunk,
                     device="cpu")
    ref = jeng.run_video(jnp.asarray(scenes[0]))
    out = eng.run_video(torch.from_numpy(scenes[0]))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-6,
                               atol=1e-6)
    refs = jeng.run_videos(jnp.asarray(scenes))
    outs = eng.run_videos(torch.from_numpy(scenes))
    np.testing.assert_allclose(outs.numpy(), np.asarray(refs), rtol=1e-6,
                               atol=1e-6)


def _png(path):
    import cv2
    return cv2.cvtColor(cv2.imread(str(path)), cv2.COLOR_BGR2RGB)


def _tile_gen(filters):
    gen = JaxUNet(filters=filters)
    v = jax.jit(gen.init)(jax.random.PRNGKey(1), jnp.zeros((1, 256, 256, 1)))
    sd = state_dict_from_flax(jax.tree_util.tree_map(np.asarray,
                                                     v["params"]))
    return v, sd


@pytest.fixture(scope="module")
def small_gen():
    """An 8-filter generator at the 256 tile (gcn_grid 12).  Its carry
    slices are empty (int(C / 32) = 0 below 32 channels): it serves the
    tests of the scene plumbing, not of the recurrence."""
    return _tile_gen(8)


def _write_scenes(root, shapes, frames=2, seed=15):
    rng = np.random.default_rng(seed)
    lams = {}
    for scene, (h, w) in shapes.items():
        d = root / "scenes" / scene
        d.mkdir(parents=True)
        for i in range(frames):
            np.save(d / f"{i:03d}.npy",
                    (rng.random((h, w, 3)).astype(np.float32) ** 2) * 700)
        (d / "README.txt").write_text("not a frame")
        lams[scene] = 40.0 + len(lams)
    (root / "scenes" / "stray.npy").write_bytes(b"")     # not a directory
    lam = str(root / "lambdas.npy")
    np.save(lam, lams)
    return str(root / "scenes"), lam


def test_run_on_video_path_matches_jax_runner(tmp_path):
    """The published width (32 filters), so the carry is live."""
    v, sd = _tile_gen(32)
    scenes, lam = _write_scenes(tmp_path, {"scene_a": (140, 220)})
    JaxRunner(jax_model_params("videoTMO"), "unused", video=True,
              params_G=v["params"]).run_on_video_path(
        scenes, str(tmp_path / "jax"), lam)
    outs = InferenceRunner(get_model_params("videoTMO"), None, video=True,
                           state_dict=sd, device="cpu").run_on_video_path(
        scenes, str(tmp_path / "port"), lam)
    assert [os.path.relpath(o, tmp_path / "port") for o in outs] == [
        "scene_a/000_UnCLTMO.png", "scene_a/001_UnCLTMO.png"]
    for o in outs:
        got = read_png(o)
        ref = _png(tmp_path / "jax" / os.path.relpath(o, tmp_path / "port"))
        assert got.shape == ref.shape == (140, 220, 3)
        assert np.abs(got.astype(np.int16) - ref.astype(np.int16)).max() <= 1


def test_scene_batch_matches_sequential(tmp_path, small_gen):
    """scene_a has another shape than scene_b and scene_c: the group that
    starts with scene_a meets a lookahead that does not match (kept as
    `pending`), then scene_b and scene_c share one conv batch."""
    _, sd = small_gen
    scenes, lam = _write_scenes(tmp_path, {"scene_a": (140, 300),
                                           "scene_b": (140, 220),
                                           "scene_c": (140, 220)})
    runner = InferenceRunner(dict(get_model_params("videoTMO"), filters=8),
                             None, video=True, state_dict=sd, device="cpu")
    calls = []
    run_videos = runner.engine.run_videos
    runner.engine.run_videos = lambda s: calls.append(tuple(s.shape)) or \
        run_videos(s)
    seq = runner.run_on_video_path(scenes, str(tmp_path / "seq"), lam)
    assert calls == []
    bat = runner.run_on_video_path(scenes, str(tmp_path / "bat"), lam,
                                   scene_batch=2)
    assert calls == [(1, 2, 256, 304, 1), (2, 2, 256, 256, 1)]
    assert len(seq) == len(bat) == 6
    for a, b in zip(seq, bat):
        assert (os.path.relpath(a, tmp_path / "seq")
                == os.path.relpath(b, tmp_path / "bat"))
        d = np.abs(read_png(a).astype(np.int16) - read_png(b).astype(np.int16))
        assert d.max() <= 1


def test_video_cli_end_to_end_on_cpu(tmp_path, small_gen):
    from uncltmo_tpu_torch.cli.test_videoTMO import get_args, main
    _, sd = small_gen
    model_dir = tmp_path / "model"
    model_dir.mkdir()
    torch.save({"epoch": 10, "modelG_state_dict": {
        "module." + k: torch.tensor(val) for k, val in sd.items()}},
        str(model_dir / "net_epoch10_iter124.pth"))
    np.save(model_dir / "run_settings.npy", {"filters": 8})
    scenes, lam = _write_scenes(tmp_path, {"scene_a": (100, 130)})
    args = ["--model_path", str(model_dir), "--input_images_path", scenes,
            "--output_path", str(tmp_path / "out"), "--f_factor_path", lam,
            "--device", "cpu"]
    parsed = get_args(args)
    assert (parsed.scene_batch, parsed.overlap, parsed.dtype,
            parsed.model_name) == (1, 64, "float32", "videoTMO")
    assert get_args([]).device == "cuda"
    assert get_model_params("videoTMO") == jax_model_params("videoTMO")
    main(args)
    outs = sorted((tmp_path / "out" / "scene_a").glob("*.png"))
    assert [o.name for o in outs] == ["000_UnCLTMO.png", "001_UnCLTMO.png"]
    im = read_png(str(outs[0]))
    assert im.shape == (100, 130, 3) and im.std() > 0.001
