"""The port's tiled engine, color math and runner against the JAX package
(CPU).  Tolerances: 5e-5 / <=1 uint8 for the golden pack (as
`tests/test_golden.py`), 1e-6 for the percentile stretches, <=1 uint8 for
the end-to-end PNGs (a float32 round-off can cross a truncation step)."""
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
from uncltmo_tpu.ops import color as jcolor
from uncltmo_tpu_torch.config import get_model_params
from uncltmo_tpu_torch.inference.engine import TileEngine
from uncltmo_tpu_torch.inference.runner import InferenceRunner
from uncltmo_tpu_torch.inference.tiling import axis_plan
from uncltmo_tpu_torch.models.unet import UNetTMO
from uncltmo_tpu_torch.ops import color
from uncltmo_tpu_torch.utils.convert import load_state, state_dict_from_flax
from uncltmo_tpu_torch.utils.io import read_png, write_radiance_hdr

GOLDEN = os.path.join(os.path.dirname(__file__), "golden", "golden.npz")


@pytest.fixture(scope="module")
def golden():
    return np.load(GOLDEN)


def _golden_model():
    gen = JaxUNet(gcn_grid=4)
    v = jax.jit(gen.init)(jax.random.PRNGKey(0), jnp.zeros((1, 128, 128, 1)))
    sd = state_dict_from_flax(jax.tree_util.tree_map(np.asarray,
                                                     v["params"]))
    return load_state(UNetTMO(gcn_grid=4), sd)


def test_tile_engine_matches_golden(golden):
    eng = TileEngine(_golden_model(), tile=128, overlap=32, chunk=4,
                     device="cpu")
    img = np.random.default_rng(4).random((160, 224, 1), np.float32)
    out = eng.run_image(torch.from_numpy(img)).numpy()
    np.testing.assert_allclose(out, golden["tile_engine/out_f32"],
                               rtol=5e-5, atol=5e-5)
    u8 = np.clip(out * 255.0, 0, 255).astype(np.uint8)
    diff = np.abs(u8.astype(np.int16)
                  - golden["tile_engine/render_u8"].astype(np.int16))
    assert diff.max() <= 1
    # run_images (tiles of two frames in one conv batch) == run_image
    both = eng.run_images(torch.from_numpy(np.stack([img, img[::-1].copy()])))
    np.testing.assert_allclose(both[0].numpy(), out, rtol=1e-5, atol=1e-6)


def test_bf16_engine_casts_params_once_and_stays_close_to_f32(golden):
    """The bfloat16 mode casts the parameters (not the GCN's float32
    relative-position buffer) once; its render stays within 0.05 of the
    float32 golden render."""
    eng = TileEngine(_golden_model(), tile=128, overlap=32, chunk=4,
                     dtype=torch.bfloat16, device="cpu")
    assert all(p.dtype == torch.bfloat16 for p in eng.model.parameters())
    assert eng.model.gcn.module[0][0].relative_pos.dtype == torch.float32
    img = np.random.default_rng(4).random((160, 224, 1), np.float32)
    out = eng.run_image(torch.from_numpy(img))
    assert out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), golden["tile_engine/out_f32"],
                               atol=0.05)


def test_axis_plan_matches_golden(golden):
    p = axis_plan(1080 + 16, 256, 64)
    np.testing.assert_array_equal(p.origins, golden["axis_plan/origins"])
    np.testing.assert_allclose(p.weights, golden["axis_plan/weights"],
                               rtol=5e-5, atol=5e-5)


class _JaxBatchMean:
    """A batch-coupled stand-in generator: tile / mean over the whole conv
    batch, so the output depends on how the tiles are chunked and padded."""

    def apply(self, variables, x):
        return x / (jnp.mean(x) + 1.0), x


class _TorchBatchMean(torch.nn.Module):
    def forward(self, x):
        return x / (torch.mean(x) + 1.0), x


@pytest.mark.parametrize("h,w,chunk", [(64, 88, None), (160, 172, None),
                                       (160, 172, 40)])
def test_chunking_and_padding_match_jax(h, w, chunk):
    """Small plans (zero-tile padding) and plans above 120 tiles (equalised
    chunks padded with weightless origin tiles) chunk exactly as the JAX
    engine does."""
    img = np.random.default_rng(7).random((h, w, 1), np.float32) + 0.5
    ref = JaxEngine(_JaxBatchMean(), {}, tile=16, overlap=4,
                    chunk=chunk).run_image(jnp.asarray(img))
    out = TileEngine(_TorchBatchMean(), tile=16, overlap=4, chunk=chunk,
                     device="cpu").run_image(torch.from_numpy(img))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-6,
                               atol=1e-6)


def test_percentile_stretches_match_jax():
    rng = np.random.default_rng(8)
    fake = rng.random((96, 130, 1), np.float32)
    im = (rng.random((90, 120, 3), np.float32) ** 3)
    np.testing.assert_allclose(
        color.percentile_clamp_stretch(torch.from_numpy(fake)).numpy(),
        np.asarray(jcolor.percentile_clamp_stretch(jnp.asarray(fake))),
        rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(
        color.to_01_outlier(torch.from_numpy(im)).numpy(),
        np.asarray(jcolor.to_01_outlier(jnp.asarray(im))),
        rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(
        color.percentiles(torch.from_numpy(im), (0.1, 50.0, 99.0)).numpy(),
        np.percentile(im, (0.1, 50.0, 99.0)), rtol=1e-6)


def test_runner_end_to_end_matches_jax(tmp_path):
    """A synthetic .hdr through both InferenceRunners at float32 (8-filter
    generator, 2 tiles): the PNGs agree within 1 uint8 level."""
    gen = JaxUNet(filters=8)
    v = jax.jit(gen.init)(jax.random.PRNGKey(1), jnp.zeros((1, 256, 256, 1)))
    in_dir = tmp_path / "in"
    in_dir.mkdir()
    rng = np.random.default_rng(9)
    hdr = (rng.random((200, 300, 3), np.float32) ** 4) * 50.0
    write_radiance_hdr(str(in_dir / "scene.hdr"), hdr)
    lam = str(tmp_path / "lams.npy")
    np.save(lam, {"scene": 400.0})

    mp_jax = dict(jax_model_params("m"), filters=8)
    JaxRunner(mp_jax, "unused", params_G=v["params"]).run_on_path(
        str(in_dir), str(tmp_path / "jax"), lam, scale=1)
    mp = dict(get_model_params("m"), filters=8)
    sd = state_dict_from_flax(jax.tree_util.tree_map(np.asarray,
                                                     v["params"]))
    outs = InferenceRunner(mp, None, state_dict=sd, device="cpu").run_on_path(
        str(in_dir), str(tmp_path / "port"), lam, scale=1)
    assert [os.path.basename(o) for o in outs] == ["scene_UnCLTMO.png"]
    import cv2
    ref = cv2.cvtColor(cv2.imread(str(tmp_path / "jax" / "scene_UnCLTMO.png")),
                       cv2.COLOR_BGR2RGB)
    got = read_png(outs[0])
    assert got.shape == ref.shape == (200, 300, 3)
    assert np.abs(got.astype(np.int16) - ref.astype(np.int16)).max() <= 1


def test_run_on_path_pipelined_matches_sequential(tmp_path):
    in_dir = tmp_path / "in"
    in_dir.mkdir()
    rng = np.random.default_rng(10)
    lams = {}
    for i in range(3):
        np.save(in_dir / f"im{i}.npy",
                (rng.random((150, 180, 3), np.float32) ** 3) * 20.0)
        lams[f"im{i}"] = 100.0 + 50 * i
    lam = str(tmp_path / "lams.npy")
    np.save(lam, lams)
    torch.manual_seed(0)
    runner = InferenceRunner(dict(get_model_params("m"), filters=8), None,
                             state_dict=UNetTMO(filters=8).state_dict(),
                             device="cpu")
    seq = runner.run_on_path(str(in_dir), str(tmp_path / "seq"), lam,
                             scale=1, pipeline_io=False)
    pipe = runner.run_on_path(str(in_dir), str(tmp_path / "pipe"), lam,
                              scale=1, pipeline_io=True)
    assert len(seq) == len(pipe) == 3
    for a, b in zip(seq, pipe):
        assert os.path.basename(a) == os.path.basename(b)
        np.testing.assert_array_equal(read_png(a), read_png(b))


def test_unported_paths_name_the_roadmap(tmp_path):
    """What the port still refuses on the serving path, by name: `.dng`
    files.  (`.exr` files are read now, `tests/test_torch_exr.py`; the
    other con_operators, norms, activations, `up_mode` / `bilinear` /
    single-ConvT generators are served, `tests/test_torch_options.py`
    holds them against JAX.)"""
    from uncltmo_tpu_torch.utils.io import read_hdr_image
    for ext in (".dng",):
        (tmp_path / ("x" + ext)).write_bytes(b"")
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            read_hdr_image(str(tmp_path / ("x" + ext)))
