"""The port's discriminator variants against the JAX package (CPU),
modelled on `tests/test_models.py:199`: every `d_model` the reference
factory builds, with each `d_norm`.

Weights come from the JAX `init` with a fixed key (batch-norm scales,
biases and running statistics moved off their initial values) and cross
over through `utils/convert.py:discriminator_state_dict_from_flax`; inputs
are numpy draws at 128 px (the DCGAN variants are built for that size).
The score maps are held to 5e-5 in eval mode and, for the variants with a
train mode (DCGAN and PatchGAN), in train mode with the running statistics
after it at 1e-6.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from uncltmo_tpu.config import Options as JaxOptions
from uncltmo_tpu.models.discriminator import (
    make_discriminator as jax_make_discriminator)
from uncltmo_tpu_torch import config as tconfig
from uncltmo_tpu_torch.models.discriminator import make_discriminator
from uncltmo_tpu_torch.utils.convert import (
    discriminator_state_dict_from_flax, load_state)

SIZE = 128
TOL = 5e-5
STATS_TOL = 1e-6

CASES = [
    ("dcgan", "none", 0), ("dcgan", "batch_norm", 0),
    ("original", "instance_norm", 1), ("original", "batch_norm", 1),
    ("patchD", "none", 0), ("patchD", "batch_norm", 0),
    ("patchD", "instance_norm", 0),
    ("multiLayerD_simpleD", "none", 0),
    ("multiLayerD_dcgan", "batch_norm", 0),
    ("multiLayerD_patchD", "batch_norm", 0),
]


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x)).permute(0, 3, 1, 2)


def _nhwc(t):
    return t.detach().permute(0, 2, 3, 1).numpy()


def _perturb(tree, rng):
    if not isinstance(tree, dict):
        return tree
    out = {}
    for k, v in tree.items():
        if k in ("scale", "var"):
            out[k] = v * rng.uniform(0.6, 1.5, v.shape).astype(np.float32)
        elif k in ("mean",) or (k == "bias" and "scale" in tree):
            out[k] = rng.normal(0, 0.1, v.shape).astype(np.float32)
        else:
            out[k] = _perturb(v, rng)
    return out


def _pair(d_model, d_norm, fc):
    kw = dict(d_model=d_model, d_norm=d_norm, d_down_dim=8, num_D=2,
              d_nlayers=2, d_fully_connected=fc)
    size_kw = {} if d_model == "patchD" else {"input_size": SIZE}
    jd = jax_make_discriminator(JaxOptions(**kw), **size_kw)
    args = (jax.random.PRNGKey(0), jnp.zeros((1, SIZE, SIZE, 1)))
    v = jax.jit(jd.init).lower(*args).compile(
        {"xla_backend_optimization_level": 0,
         "xla_llvm_disable_expensive_passes": True})(*args)
    v = _perturb(jax.tree_util.tree_map(np.asarray, dict(v)),
                 np.random.default_rng(1))
    port = make_discriminator(tconfig.Options(**kw), **size_kw)
    sd = discriminator_state_dict_from_flax(v["params"],
                                            v.get("batch_stats"))
    assert sorted(port.state_dict()) == sorted(sd)
    load_state(port, sd)                                # strict=True
    return jd, v, port


def _flat(out):
    return out if isinstance(out, list) else [out]


@pytest.mark.parametrize("d_model,d_norm,fc", CASES,
                         ids=[f"{m}-{n}-fc{f}" for m, n, f in CASES])
def test_discriminator_variant_matches_jax(d_model, d_norm, fc):
    jd, v, port = _pair(d_model, d_norm, fc)
    x = np.random.default_rng(2).random((2, SIZE, SIZE, 1), np.float32)
    jv = jax.tree_util.tree_map(jnp.asarray, v)
    ref = _flat(jax.jit(jd.apply)(jv, jnp.asarray(x)))
    with torch.no_grad():
        got = _flat(port(_nchw(x)))
    assert len(got) == len(ref) == (2 if "multiLayerD" in d_model else 1)
    for g, r in zip(got, ref):
        r = np.asarray(r)
        assert np.isfinite(r).all()
        if g.dim() == 2:                    # the fully-connected head
            np.testing.assert_allclose(g.numpy(), r, rtol=TOL, atol=TOL)
        else:
            np.testing.assert_allclose(_nhwc(g), r, rtol=TOL, atol=TOL)
    if "multiLayerD" in d_model or d_model == "simpleD":
        return
    # train mode: batch statistics, and the running statistics after it
    (ref_t, upd) = jax.jit(lambda a: jd.apply(jv, a, train=True,
                                              mutable=["batch_stats"]))(
        jnp.asarray(x))
    before = {k: t.clone() for k, t in port.state_dict().items()}
    with torch.no_grad():
        got_t = port(_nchw(x), train=True)
    got_t = got_t.numpy() if got_t.dim() == 2 else _nhwc(got_t)
    np.testing.assert_allclose(got_t, np.asarray(ref_t), rtol=TOL, atol=TOL)
    if d_norm == "batch_norm":
        want = discriminator_state_dict_from_flax(
            v["params"], jax.tree_util.tree_map(np.asarray,
                                                upd["batch_stats"]))
        sd = port.state_dict()
        stat_keys = [k for k in want if k.endswith(("running_mean",
                                                    "running_var"))]
        assert stat_keys
        for k in stat_keys:
            np.testing.assert_allclose(sd[k].numpy(), want[k],
                                       rtol=STATS_TOL, atol=STATS_TOL,
                                       err_msg=k)
            assert not torch.equal(sd[k], before[k]), k


def test_untrained_variants_keep_their_build_size():
    """As the JAX trainer inits them: a DCGAN built for 256 px by the
    factory, whatever the training input size."""
    d = make_discriminator(tconfig.Options(d_model="original",
                                           d_fully_connected=1, d_nlayers=2))
    assert d.fc.in_features == (256 // 8 - 3) ** 2
