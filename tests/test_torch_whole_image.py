"""The PyTorch port's whole-image path against the JAX package (CPU): the
bicubic resize, the GCN block on a bottleneck that is not its grid, the
add_frame output crop, and the whole-image / add_frame runners.

Weights come from flax `init` and cross over with the port's
`state_dict_from_flax`; inputs come from numpy seeds.  Tolerances: 1e-5 for
the resize (the same float64-built matrices, float32 products in another
order), 5e-5 for the GCN block and the generator (as `tests/test_golden.py`),
<= 1 uint8 level for PNGs.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from uncltmo_tpu.config import get_model_params as jax_model_params
from uncltmo_tpu.inference.runner import InferenceRunner as JaxRunner
from uncltmo_tpu.models import gcn as jgcn
from uncltmo_tpu.models.unet import UNetTMO as JaxUNet
from uncltmo_tpu.ops import preprocess as jpreprocess
from uncltmo_tpu.ops import resize as jresize
from uncltmo_tpu_torch.config import get_model_params, options_from_model_params
from uncltmo_tpu_torch.inference.runner import InferenceRunner
from uncltmo_tpu_torch.models.gcn import GCNBlock
from uncltmo_tpu_torch.models.unet import (UNetTMO, make_generator,
                                           min_input_size)
from uncltmo_tpu_torch.ops import preprocess, resize
from uncltmo_tpu_torch.utils.convert import (gcn_state_from_flax, load_state,
                                             state_dict_from_flax)
from uncltmo_tpu_torch.utils.io import read_png

FLOAT_TOL = 5e-5


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x)).permute(0, 3, 1, 2)


def _nhwc(t):
    return t.detach().permute(0, 2, 3, 1).numpy()


@pytest.mark.parametrize("h,w,oh,ow", [(80, 96, 73, 85), (12, 12, 29, 52),
                                       (37, 53, 37, 41)],
                         ids=["down", "up", "one_axis"])
def test_bicubic_resize_matches_jax(h, w, oh, ow):
    x = np.random.default_rng(20).random((2, h, w, 3), np.float32)
    ref = jresize.bicubic_resize(jnp.asarray(x), oh, ow)
    out = resize.bicubic_resize(_nchw(x), oh, ow)
    assert out.shape == (2, 3, oh, ow)
    np.testing.assert_allclose(_nhwc(out), np.asarray(ref), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_array_equal(resize._bicubic_matrix(h, oh),
                                  jresize._bicubic_matrix(h, oh))


@pytest.mark.parametrize("d", [0, 2, 3, 7, 11])
def test_crop_center_batch_matches_jax(d):
    """Including d % 4 == 3, where the reference's rounded start index is
    one row off the pad's."""
    x = np.random.default_rng(21).random((2, 40, 48, 1), np.float32)
    ref = jpreprocess.crop_center_batch(jnp.asarray(x), d, d + 1)
    out = preprocess.crop_center_batch(_nchw(x), d, d + 1)
    np.testing.assert_array_equal(_nhwc(out), np.asarray(ref))


def _gcn_pair(ch, grid, seed):
    rng = np.random.default_rng(seed)
    blk = jgcn.GCNBlock(ch, grid=grid)
    v = blk.init(jax.random.PRNGKey(seed), jnp.zeros((1, grid, grid, ch)))
    pos = rng.standard_normal((1, grid, grid, ch)).astype(np.float32) * 0.1
    v = {"params": dict(v["params"], pos_embed=jnp.asarray(pos))}
    sd = gcn_state_from_flax(jax.tree_util.tree_map(np.asarray, v["params"]))
    return blk, v, load_state(GCNBlock(ch, grid=grid), sd), sd


@pytest.mark.parametrize("h,w", [(5, 9), (7, 4), (2, 2)])
def test_gcn_block_rectangular_bottleneck_matches_jax(h, w):
    """pos_embed bicubic-resized to (h, w), relative-position bias
    regenerated for the rectangular layout; 2x2 has fewer nodes than k."""
    ch, grid = 32, 6
    blk, v, port, sd = _gcn_pair(ch, grid, 22)
    x = np.random.default_rng(23).standard_normal(
        (2, h, w, ch)).astype(np.float32)
    ref = blk.apply(v, jnp.asarray(x))
    keys = list(port.state_dict())
    with torch.no_grad():
        out = port(_nchw(x))
    np.testing.assert_allclose(_nhwc(out), np.asarray(ref), rtol=FLOAT_TOL,
                               atol=FLOAT_TOL)
    grapher = port.module[0][0]
    np.testing.assert_allclose(
        grapher._relative_pos_for(h, w, "cpu").numpy(),
        jgcn.relative_pos_bias(ch, (h, w)), rtol=1e-6, atol=1e-7)
    # the regenerated table is cached, is no buffer, and a reference
    # checkpoint still loads strict=True after a non-grid forward
    assert (grapher._relative_pos_for(h, w, "cpu")
            is grapher._relative_pos_for(h, w, "cpu"))
    assert list(port.state_dict()) == keys == list(sd)
    load_state(port, sd)
    with torch.no_grad():       # and the grid case still reads the buffer
        port(torch.zeros(1, ch, grid, grid))
    assert grapher._relative_pos_for(grid, grid, "cpu").data_ptr() == \
        grapher.relative_pos.data_ptr()


@pytest.fixture(scope="module")
def small_gen():
    gen = JaxUNet(filters=8)
    v = jax.jit(gen.init)(jax.random.PRNGKey(2), jnp.zeros((1, 256, 256, 1)))
    sd = state_dict_from_flax(jax.tree_util.tree_map(np.asarray,
                                                     v["params"]))
    return v, sd


def test_generator_whole_frame_and_output_crop_match_jax(small_gen):
    """A 112x160 frame (3x6 bottleneck against a 12x12 grid) through both
    generators, with and without the add_frame output crop."""
    v, sd = small_gen
    x = np.random.default_rng(24).random((1, 112, 160, 1), np.float32)
    keys = sorted(sd)
    for to_crop in (False, True):
        ref, _ = JaxUNet(filters=8, to_crop=to_crop).apply(
            v, jnp.asarray(x), apply_crop=True, diffY=7, diffX=10)
        model = load_state(UNetTMO(filters=8, to_crop=to_crop), sd).eval()
        with torch.no_grad():
            out, _ = model(_nchw(x), apply_crop=True, diffY=7, diffX=10)
        assert out.shape[2:] == ((105, 150) if to_crop else (112, 160))
        np.testing.assert_allclose(_nhwc(out), np.asarray(ref),
                                   rtol=FLOAT_TOL, atol=FLOAT_TOL)
        assert sorted(model.state_dict()) == keys
    mp = dict(get_model_params("m"), add_frame=1)
    assert make_generator(options_from_model_params(mp)).to_crop


def _png(path):
    import cv2
    return cv2.cvtColor(cv2.imread(str(path)), cv2.COLOR_BGR2RGB)


@pytest.mark.parametrize("add_frame,whole", [(0, True), (1, False)],
                         ids=["whole_image", "add_frame"])
def test_whole_image_runner_matches_jax(tmp_path, small_gen, add_frame,
                                        whole):
    """add_frame=0: one forward of the padded frame, the pad removed by a
    bicubic downscale.  add_frame=1: whole-image too, with the model's own
    output crop.  PNGs within 1 level of the JAX runner's."""
    v, sd = small_gen
    in_dir = tmp_path / "in"
    in_dir.mkdir()
    rng = np.random.default_rng(25)
    np.save(in_dir / "scene.npy",
            (rng.random((100, 150, 3)).astype(np.float32) ** 4) * 50.0)
    lam = str(tmp_path / "lams.npy")
    np.save(lam, {"scene": 400.0})
    JaxRunner(dict(jax_model_params("m"), filters=8, add_frame=add_frame),
              "unused", params_G=v["params"],
              whole_image=whole).run_on_path(str(in_dir),
                                             str(tmp_path / "jax"), lam,
                                             scale=1)
    runner = InferenceRunner(dict(get_model_params("m"), filters=8,
                                  add_frame=add_frame), None, state_dict=sd,
                             whole_image=whole, device="cpu")
    assert runner.whole_image and runner.add_frame == bool(add_frame)
    outs = runner.run_on_path(str(in_dir), str(tmp_path / "port"), lam,
                              scale=1)
    got = read_png(outs[0])
    ref = _png(tmp_path / "jax" / "scene_UnCLTMO.png")
    assert got.shape == ref.shape == (100, 150, 3)
    assert np.abs(got.astype(np.int16) - ref.astype(np.int16)).max() <= 1


def test_whole_image_tiny_input_and_add_frame_video_rejection(tmp_path,
                                                              small_gen):
    """100x97 pads to 112x112 only (not to the tiler's 256): the smallest
    frame the valid convolutions take, with a 3x3 bottleneck.  A smaller
    one is refused by name (XLA would return a frame made of biases).
    add_frame checkpoints are refused by every video entry."""
    _, sd = small_gen
    rng = np.random.default_rng(26)
    np.save(tmp_path / "tiny.npy",
            (rng.random((100, 97, 3)).astype(np.float32) ** 2) * 900)
    np.save(tmp_path / "less.npy",
            (rng.random((24, 20, 3)).astype(np.float32) ** 2) * 900)
    lam = str(tmp_path / "lams.npy")
    np.save(lam, {"tiny": 300.0, "less": 300.0})
    mp = dict(get_model_params("m"), filters=8)
    runner = InferenceRunner(mp, None, state_dict=sd, whole_image=True,
                             device="cpu")
    assert min_input_size(4) == 108
    loaded = runner.load_image(str(tmp_path / "tiny.npy"), lam, scale=1)
    assert loaded[1].shape == (112, 112, 1)
    out = runner.run_single_image(str(tmp_path / "tiny.npy"), "tiny",
                                  str(tmp_path / "out"), lam, scale=1)
    assert read_png(out).shape == (100, 97, 3)
    with pytest.raises(ValueError, match="at least 108 x 108"):
        runner.run_single_image(str(tmp_path / "less.npy"), "less",
                                str(tmp_path / "out"), lam, scale=1)

    mp_af = dict(mp, add_frame=1)
    with pytest.raises(ValueError, match="video path"):
        InferenceRunner(mp_af, None, video=True, state_dict=sd, device="cpu")
    runner_af = InferenceRunner(mp_af, None, state_dict=sd, device="cpu")
    with pytest.raises(ValueError, match="video path"):
        runner_af.run_video_scene([str(tmp_path / "tiny.npy")], ["tiny"],
                                  str(tmp_path / "v"), lam)
    with pytest.raises(ValueError, match="video path"):
        runner_af.run_on_video_path(str(tmp_path), str(tmp_path / "v"), lam,
                                    scene_batch=2)


def test_image_cli_whole_image_on_cpu(tmp_path, small_gen):
    from uncltmo_tpu_torch.cli.test_imageTMO import main
    _, sd = small_gen
    model_dir = tmp_path / "model"
    model_dir.mkdir()
    torch.save({"modelG_state_dict": {k: torch.tensor(val)
                                      for k, val in sd.items()}},
               str(model_dir / "trained_weights.pth"))
    np.save(model_dir / "run_settings.npy", {"filters": 8})
    in_dir = tmp_path / "in"
    in_dir.mkdir()
    np.save(in_dir / "a.npy", (np.random.default_rng(27).random(
        (120, 100, 3)).astype(np.float32) ** 3) * 100)
    lam = str(tmp_path / "lams.npy")
    np.save(lam, {"a": 200.0})
    main(["--model_path", str(model_dir), "--input_images_path", str(in_dir),
          "--output_path", str(tmp_path / "out"), "--f_factor_path", lam,
          "--scale", "1", "--whole_image", "1", "--device", "cpu"])
    im = read_png(str(tmp_path / "out" / "a_UnCLTMO.png"))
    assert im.shape == (120, 100, 3) and im.std() > 0.001
