"""The PyTorch port's generator against the JAX package (CPU).

Weights come from `UNetTMO(...).init` and cross over with the port's
`state_dict_from_flax`; inputs come from numpy seeds.  Tolerances: 5e-5 for
the golden pack (as `tests/test_golden.py`), 1e-5 for the GCN block alone
(float32 sums in another order).
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from uncltmo_tpu.models import gcn as jgcn
from uncltmo_tpu.models.unet import UNetTMO as JaxUNet
from uncltmo_tpu.utils.export_torch import export_generator
from uncltmo_tpu_torch.models.gcn import GCNBlock, relative_pos_bias
from uncltmo_tpu_torch.models.unet import UNetTMO, bottleneck_grid
from uncltmo_tpu_torch.utils.convert import (gcn_state_from_flax,
                                             load_generator, load_state,
                                             state_dict_from_flax)

GOLDEN = os.path.join(os.path.dirname(__file__), "golden", "golden.npz")
FLOAT_TOL = 5e-5


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x)).permute(0, 3, 1, 2)


def _nhwc(t):
    return t.detach().permute(0, 2, 3, 1).numpy()


@pytest.fixture(scope="module")
def golden_params():
    """The golden pack's generator (128^2 input, gcn_grid 4, key 0)."""
    gen = JaxUNet(gcn_grid=bottleneck_grid(128))
    v = jax.jit(gen.init)(jax.random.PRNGKey(0), jnp.zeros((1, 128, 128, 1)))
    return jax.tree_util.tree_map(np.asarray, v["params"])


def test_state_dict_from_flax_matches_export(golden_params):
    sd = state_dict_from_flax(golden_params)
    ref = export_generator(golden_params)
    assert list(sd) == list(ref)
    for k in ref:
        assert sd[k].dtype == ref[k].dtype, k
        np.testing.assert_array_equal(sd[k], ref[k], err_msg=k)
    model = UNetTMO(gcn_grid=4)
    assert sorted(model.state_dict()) == sorted(ref)
    load_state(model, sd)       # strict=True


def test_load_generator_reads_reference_pth(tmp_path, golden_params):
    """A `.pth` in the reference layout (with DataParallel's prefix) loads
    strict; `.msgpack` is refused with the conversion pointer."""
    sd = state_dict_from_flax(golden_params)
    path = str(tmp_path / "net.pth")
    torch.save({"epoch": 3, "modelG_state_dict": {
        "module." + k: torch.tensor(v) for k, v in sd.items()}}, path)
    model = load_generator(path, UNetTMO(gcn_grid=4))
    np.testing.assert_array_equal(model.outc.conv.weight.detach().numpy(),
                                  sd["outc.conv.weight"])
    with pytest.raises(ValueError, match="export_checkpoint"):
        load_generator(str(tmp_path / "x.msgpack"))


def test_generator_matches_golden_unet_image(golden_params):
    golden = np.load(GOLDEN)
    model = load_state(UNetTMO(gcn_grid=4), state_dict_from_flax(
        golden_params)).eval()
    x = np.random.default_rng(1).random((1, 128, 128, 1), np.float32)
    with torch.no_grad():
        out, fea = model(_nchw(x))
    np.testing.assert_allclose(_nhwc(out), golden["unet_image/out"],
                               rtol=FLOAT_TOL, atol=FLOAT_TOL)
    np.testing.assert_allclose(_nhwc(fea), golden["unet_image/fea"],
                               rtol=FLOAT_TOL, atol=FLOAT_TOL)


def test_generator_matches_jax_at_256_tile():
    """The tile size of the main path (gcn_grid 12), at 8 filters and a
    batch of 2 so the 256^2 forward stays cheap on the CPU."""
    gen = JaxUNet(filters=8)
    x = np.random.default_rng(2).random((2, 256, 256, 1), np.float32)
    v = jax.jit(gen.init)(jax.random.PRNGKey(3), jnp.zeros((1, 256, 256, 1)))
    ref, _ = jax.jit(gen.apply)(v, jnp.asarray(x))
    params = jax.tree_util.tree_map(np.asarray, v["params"])
    model = load_state(UNetTMO(filters=8),
                       state_dict_from_flax(params)).eval()
    with torch.no_grad():
        out, _ = model(_nchw(x))
    np.testing.assert_allclose(_nhwc(out), np.asarray(ref),
                               rtol=FLOAT_TOL, atol=FLOAT_TOL)


def test_gcn_block_matches_jax():
    ch, grid = 32, 6
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, grid, grid, ch)).astype(np.float32)
    blk = jgcn.GCNBlock(ch, grid=grid)
    v = blk.init(jax.random.PRNGKey(5), jnp.zeros((1, grid, grid, ch)))
    # a non-zero pos_embed so the add is exercised
    pos = rng.standard_normal((1, grid, grid, ch)).astype(np.float32) * 0.1
    v = {"params": dict(v["params"], pos_embed=jnp.asarray(pos))}
    ref = blk.apply(v, jnp.asarray(x))
    port = load_state(GCNBlock(ch, grid=grid), gcn_state_from_flax(
        jax.tree_util.tree_map(np.asarray, v["params"])))
    with torch.no_grad():
        out = port(_nchw(x))
    np.testing.assert_allclose(_nhwc(out), np.asarray(ref), rtol=1e-5,
                               atol=1e-5)


def test_relative_pos_bias_is_the_jax_table():
    np.testing.assert_array_equal(relative_pos_bias(256, 12),
                                  jgcn.relative_pos_bias(256, 12))


@pytest.mark.parametrize("size,depth,grid", [(256, 4, 12), (128, 4, 4),
                                             (112, 4, 3)])
def test_bottleneck_grid(size, depth, grid):
    assert bottleneck_grid(size, depth) == grid
