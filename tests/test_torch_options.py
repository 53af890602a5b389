"""Every generator option of the port against the JAX package (CPU).

Weights come from the JAX `UNetTMO.init` with a fixed key (batch-norm scales,
biases and running statistics moved off their initial 1 / 0 / 0 / 1 so that
they matter) and cross over through `utils/convert.py`; inputs are numpy
draws.  Depth 3, 16 filters (the carry then has channels at six of its
eight positions), 64 px for the valid-conv generators and 68 px for the
padded ones, where the first upsample is one pixel short of its skip and
the pad goes through the model's `padding_mode`.

Tolerances: 5e-5 on the sigmoid output, image forward and the video
`frame` with a carry, in eval mode and in train mode (drop path from a
table, patched into the JAX package's `gcn.drop_path` as
`tests/test_torch_train_step.py` does); 1e-6 on batch norm's running
statistics after one train-mode forward (float32 means of a few thousand
entries, summed in another order).  The inputs are draws whose GCN has no
near tie between a node's 9th and 10th neighbour: at the draw of seed 1
the padded `edge` generator has two candidates within 6e-8 of each other,
the two packages' float32 sums pick different ones, and the output moves
by 8e-4 (`topk` of a discontinuous choice, not a difference of the
options; `models/gcn.py`).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from uncltmo_tpu.models import gcn as jgcn
from uncltmo_tpu.models.unet import UNetTMO as JaxUNet
from uncltmo_tpu.utils.export_torch import save_reference_checkpoint
from uncltmo_tpu_torch.models import blocks
from uncltmo_tpu_torch.models.unet import UNetTMO, bottleneck_grid
from uncltmo_tpu_torch.utils.convert import (load_generator, load_state,
                                             state_dict_from_flax)

DEPTH, FILTERS = 3, 16
TOL = 5e-5
STATS_TOL = 1e-6
GRID = bottleneck_grid(64, DEPTH)

# (test id, UNetTMO keyword arguments shared by both packages).  Options
# that do not interact share a generator, so that every option runs in
# one of these few (each JAX init and trace costs seconds on the CPU):
# both norms, leaky ReLU, the three upsamplers, the padded and the
# post-padded cells in three padding modes, all six skip operators.
OPTIONS = [
    ("batch_norm", dict(unet_norm="batch_norm")),
    ("instance_norm_up_mode_square_root", dict(
        unet_norm="instance_norm", up_mode=True, con_operator="square_root")),
    # a leaky skip is negative somewhere and sqrt(x2 + eps) of the
    # square-root operators is NaN there, in the reference as in both
    # packages, so the leaky generators take the operators without a root
    ("leakyrelu_bilinear_square", dict(
        activation="leakyrelu", bilinear=True, con_operator="square")),
    ("no_dct_edge_original_unet", dict(double_conv_transpose=False,
                                       con_operator="original_unet")),
    ("no_dct_zeros_gamma", dict(double_conv_transpose=False,
                                padding_mode="zeros", con_operator="gamma")),
    ("no_dct_reflect_bilinear_bn", dict(
        double_conv_transpose=False, padding_mode="reflect", bilinear=True,
        unet_norm="batch_norm")),
    ("up_mode_no_dct_leaky_bn", dict(
        up_mode=True, double_conv_transpose=False, activation="leakyrelu",
        unet_norm="batch_norm", con_operator="original_unet")),
    ("manual_d", dict(con_operator="square_and_square_root_manual_d",
                      n_channels=2)),
]

MASKS = np.ones((8, 2), np.float32)
MASKS[1, 0] = 0.0
_calls = {"n": 0}


def _table_drop_path(x, rate, deterministic, rng=None):
    if deterministic or rate == 0.0:
        return x
    mask = MASKS[_calls["n"]][:x.shape[0]]
    _calls["n"] += 1
    shape = (x.shape[0],) + (1,) * (x.ndim - 1)
    return x * jnp.asarray(mask, x.dtype).reshape(shape) / (1.0 - rate)


@pytest.fixture(scope="module", autouse=True)
def table_drop_path():
    patch = pytest.MonkeyPatch()
    patch.setattr(jgcn, "drop_path", _table_drop_path)
    yield
    patch.undo()


def _size(kw) -> int:
    valid = kw.get("double_conv_transpose", True) or kw.get("up_mode")
    return 64 if valid else 68


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x)).permute(0, 3, 1, 2)


def _nhwc(t):
    return t.detach().permute(0, 2, 3, 1).numpy()


def _input(kw, seed, b=2):
    rng = np.random.default_rng(seed)
    s = _size(kw)
    x = rng.random((b, s, s, kw.get("n_channels", 1)), np.float32)
    if kw.get("n_channels", 1) == 2:
        x[..., 1] = 0.37                 # the manual-d weight channel
    return x


def _perturb(tree, rng):
    """Batch-norm leaves away from their initial values."""
    if not isinstance(tree, dict):
        return tree
    out = {}
    for k, v in tree.items():
        if k in ("scale", "var"):
            out[k] = np.asarray(v) * rng.uniform(0.6, 1.5, v.shape).astype(
                np.float32)
        elif k in ("bias", "mean") and isinstance(v, np.ndarray) and \
                v.ndim == 1 and not v.any():
            out[k] = rng.normal(0, 0.1, v.shape).astype(np.float32)
        else:
            out[k] = _perturb(v, rng)
    return out


def _models(kw, key=0):
    """(jax module, its variables, the port's module) with the same
    weights and statistics."""
    jm = JaxUNet(filters=FILTERS, depth=DEPTH, gcn_grid=GRID, **kw)
    s = _size(kw)
    args = (jax.random.PRNGKey(key),
            jnp.zeros((1, s, s, kw.get("n_channels", 1))))
    # the weights are integer draws and their scaling: XLA's lowest
    # optimisation level compiles them in a third of the time
    v = jax.jit(jm.init).lower(*args).compile(
        {"xla_backend_optimization_level": 0,
         "xla_llvm_disable_expensive_passes": True})(*args)
    v = jax.tree_util.tree_map(np.asarray, dict(v))
    if "batch_stats" in v:
        rng = np.random.default_rng(key)
        v = {"params": {k: (_perturb(p, rng) if k != "gcn" else p)
                        for k, p in v["params"].items()},
             "batch_stats": _perturb(v["batch_stats"], rng)}
    port = UNetTMO(filters=FILTERS, depth=DEPTH, gcn_grid=GRID, **kw)
    load_state(port, state_dict_from_flax(v["params"], DEPTH,
                                          stats=v.get("batch_stats")))
    return jm, v, port


def _stats_of(port):
    return {k: t.numpy().copy() for k, t in port.state_dict().items()
            if k.endswith(("running_mean", "running_var"))}


def _jax_stats_as_port(params, jstats):
    sd = state_dict_from_flax(params, DEPTH, stats=jstats)
    return {k: v for k, v in sd.items()
            if k.endswith(("running_mean", "running_var"))}


@pytest.mark.parametrize("name,kw", OPTIONS, ids=[o[0] for o in OPTIONS])
def test_option_image_and_video_frame_match_jax(name, kw):
    jm, v, port = _models(kw)
    x, x1 = _input(kw, 2), _input(kw, 3)
    jv = jax.tree_util.tree_map(jnp.asarray, v)
    frame = jax.jit(lambda x, c: jm.apply(jv, x, c, method=JaxUNet.frame))
    # eval: the image forward (the JAX image forward is its first frame),
    # then a second video frame that reads the first's carry
    r0, _, rc = frame(jnp.asarray(x), None)
    r1, _, _ = frame(jnp.asarray(x1), rc)
    with torch.no_grad():
        out, _ = port(_nchw(x))
        o0, _, carry = port.frame(_nchw(x))
        o1, _, _ = port.frame(_nchw(x1), carry)
    for got, want in ((out, r0), (o0, r0), (o1, r1)):
        assert np.isfinite(np.asarray(want)).all(), name
        np.testing.assert_allclose(_nhwc(got), np.asarray(want), rtol=TOL,
                                   atol=TOL, err_msg=name)
    # train mode: batch statistics and the drop path, from the same table
    _calls["n"] = 0
    (ref_t, _), upd = jax.jit(lambda x: jm.apply(
        jv, x, deterministic=False, rngs={"droppath": jax.random.PRNGKey(0)},
        mutable=["batch_stats"]))(jnp.asarray(x))
    masks = iter([torch.from_numpy(MASKS[i].copy()) for i in range(2)])
    with torch.no_grad():
        out_t, _ = port(_nchw(x), deterministic=False, drop_masks=masks)
    assert np.isfinite(np.asarray(ref_t)).all(), name
    np.testing.assert_allclose(_nhwc(out_t), np.asarray(ref_t), rtol=TOL,
                               atol=TOL, err_msg=name)
    if "batch_stats" in v:
        want = _jax_stats_as_port(v["params"], jax.tree_util.tree_map(
            np.asarray, upd["batch_stats"]))
        before = _jax_stats_as_port(v["params"], v["batch_stats"])
        got = _stats_of(port)
        assert sorted(got) == sorted(want)
        for k in want:
            np.testing.assert_allclose(got[k], want[k], rtol=STATS_TOL,
                                       atol=STATS_TOL, err_msg=k)
            assert not np.allclose(want[k], before[k]), k


def test_module_mode_does_not_decide_batch_norm():
    """Running statistics move exactly when the forward is not
    deterministic, whatever `.train()` / `.eval()` says."""
    _, _, port = _models(dict(unet_norm="batch_norm"))
    x = _nchw(_input(dict(unet_norm="batch_norm"), 3))
    before = _stats_of(port)
    with torch.no_grad():
        port.train()(x)                                   # deterministic
    assert all(np.array_equal(before[k], t) for k, t in
               _stats_of(port).items())
    with torch.no_grad():
        port.eval()(x, deterministic=False,
                    generator=torch.Generator().manual_seed(0))
    assert not any(np.array_equal(before[k], t) for k, t in
                   _stats_of(port).items())


@pytest.mark.parametrize("mode", ["zeros", "constant", "empty", "replicate",
                                  "edge", "reflect", "symmetric", "wrap",
                                  "linear_ramp", "maximum", "minimum",
                                  "mean", "median"])
def test_pad2d_is_jnp_pad(mode):
    """Every padding the JAX package takes (`_jnp_pad_mode`), by the
    amounts of a padded conv (1) and of the upsample's pad (up to 3 on a
    side, wider than the axis for the index modes)."""
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 3, 4, 5)).astype(np.float32)
    jmode = blocks.pad_mode(mode)
    for pads in ((1, 1, 1, 1), (0, 3, 2, 0), (2, 1, 0, 3), (5, 6, 7, 5)):
        if jmode == "reflect" and max(pads) > 4:
            continue
        want = np.asarray(jnp.pad(jnp.asarray(x), ((0, 0), (0, 0),
                                                   pads[:2], pads[2:]),
                                  mode=jmode))
        got = blocks.pad2d(torch.from_numpy(x), pads, mode).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6,
                                   err_msg=f"{mode} {pads}")
    with pytest.raises(ValueError, match="padding mode"):
        blocks.pad_mode("circular")


def test_batch_norm_reference_checkpoint_loads_strict(tmp_path):
    """A JAX batch-norm generator written by the JAX exporter
    (`save_reference_checkpoint` with its statistics) loads into the port
    with strict=True and serves the same output in eval mode."""
    kw = dict(unet_norm="batch_norm")
    jm, v, _ = _models(kw, key=4)
    path = str(tmp_path / "bn.pth")
    save_reference_checkpoint(path, v["params"], depth=DEPTH,
                              stats_G=v["batch_stats"])
    port = load_generator(path, UNetTMO(filters=FILTERS, depth=DEPTH,
                                        gcn_grid=GRID, **kw))
    x = _input(kw, 6)
    ref, _ = jax.jit(jm.apply)(jax.tree_util.tree_map(jnp.asarray, v),
                               jnp.asarray(x))
    with torch.no_grad():
        out, _ = port(_nchw(x))
    np.testing.assert_allclose(_nhwc(out), np.asarray(ref), rtol=TOL,
                               atol=TOL)
    sd = torch.load(path, weights_only=True)["modelG_state_dict"]
    assert "inc.conv.norm.num_batches_tracked" in sd


@pytest.mark.parametrize("kw,k2_cells,k1_cells", [
    (dict(), 3, 3), (dict(unet_norm="batch_norm"), 0, 3),
    (dict(activation="leakyrelu"), 0, 3),
    (dict(double_conv_transpose=False), 0, 3),
    (dict(up_mode=True), 3, 3), (dict(bilinear=True), 3, 3),
    (dict(con_operator="gamma"), 3, 0)])
def test_kernels_go_where_they_compute_the_cell(kw, k2_cells, k1_cells):
    """K2 cells are the valid relu cells without a norm, K1 the
    square_and_square_root concats; the rest are torch's own ops."""
    port = UNetTMO(filters=FILTERS, depth=DEPTH, gcn_grid=GRID, **kw)
    cells = [m for m in port.modules() if isinstance(m, blocks.DoubleConv)]
    assert sum(m.fused for m in cells) == k2_cells
    ups = [u for u in port.up_path if u.con_operator ==
           "square_and_square_root"]
    assert len(ups) == k1_cells
