"""Two faults of the port against the reference, repaired (CPU):

* `TileEngine` took over the module it was given: it moved it, switched
  it to `eval()` and, in bfloat16, cast its parameters in place.  It now
  runs a copy and takes new weights through `update_variables`, as the JAX
  engine keeps a cast copy of its variables
  (`uncltmo_tpu/inference/engine.py:129-155`).
* A G update with nothing to differentiate (`train_with_D=False`,
  `struct_loss_factor=0`) raised in `torch.autograd.grad`.  The JAX step
  differentiates the constant, gets zero gradients and still applies Adam
  (`uncltmo_tpu/training/train_step.py:194-219`), so warm moments move G.
"""
import jax
import jax.numpy as jnp
import numpy as np
import torch

from uncltmo_tpu.models import gcn as jgcn
from uncltmo_tpu.models.discriminator import (
    SimpleDiscriminator as JaxSimpleD)
from uncltmo_tpu.models.unet import UNetTMO as JaxUNet
from uncltmo_tpu.training import state as jstate
from uncltmo_tpu.training import train_step as jstep
from uncltmo_tpu_torch.inference.engine import TileEngine
from uncltmo_tpu_torch.models import gcn as tgcn
from uncltmo_tpu_torch.models.discriminator import SimpleDiscriminator
from uncltmo_tpu_torch.models.unet import (UNetTMO, bottleneck_grid,
                                           seeded_init_)
from uncltmo_tpu_torch.training import train_step as tstep
from uncltmo_tpu_torch.utils.convert import (
    discriminator_state_dict_from_flax, state_dict_from_flax,
    train_state_from_flax)

SIZE = 112
GRID = bottleneck_grid(SIZE)
G_LR, D_LR = 1e-3, 1.5e-3
# parameters and moments after one Adam step on zero gradients: float32
# rounding of the same update (`tests/test_torch_train_step.py`'s G_TOL is
# the bound; this measures 1e-7 of max-abs)
TOL = 1e-2
LOG_RTOL = 1e-4


def _gen(seed):
    return seeded_init_(UNetTMO(filters=8, gcn_grid=4), seed)


def test_engine_leaves_the_callers_module_alone_and_updates():
    gen = _gen(0).train()
    before = {k: v.clone() for k, v in gen.state_dict().items()}
    eng = TileEngine(gen, tile=128, overlap=32, chunk=4,
                     dtype=torch.bfloat16, device="cpu")
    assert eng.model is not gen and gen.training and not eng.model.training
    for k, v in gen.state_dict().items():
        assert v.dtype == torch.float32 and torch.equal(v, before[k]), k
    assert all(p.dtype == torch.bfloat16 for p in eng.model.parameters())
    img = torch.from_numpy(
        np.random.default_rng(4).random((160, 224, 1), np.float32))
    first = eng.run_image(img)
    # new weights, in float32 as training holds them
    new = _gen(1)
    eng.update_variables(new.state_dict())
    assert all(p.dtype == torch.bfloat16 for p in eng.model.parameters())
    assert eng.model.gcn.module[0][0].relative_pos.dtype == torch.float32
    out = eng.run_image(img)
    fresh = TileEngine(new, tile=128, overlap=32, chunk=4,
                       dtype=torch.bfloat16, device="cpu").run_image(img)
    assert torch.equal(out, fresh) and not torch.equal(out, first)
    for k, v in gen.state_dict().items():
        assert torch.equal(v, before[k]), k


def _warm(adam, seed):
    """Adam ten steps old: a first moment of its own, a flat second."""
    rng = np.random.default_rng(seed)
    return adam._replace(
        count=jnp.asarray(10, jnp.int32),
        mu=jax.tree_util.tree_map(lambda x: jnp.asarray(
            1e-3 * rng.standard_normal(x.shape), x.dtype), adam.mu),
        nu=jax.tree_util.tree_map(lambda x: jnp.full_like(x, 1e-2), adam.nu))


def test_a_g_update_with_nothing_to_differentiate_matches_jax(monkeypatch):
    cfg = dict(train_with_D=False, struct_loss_factor=0.0)
    # the drop path keeps every sample on both sides, so the `fake/*` logs
    # of the two forwards compare
    monkeypatch.setattr(jgcn, "drop_path", lambda x, *a, **k: x)
    monkeypatch.setattr(tgcn, "drop_path", lambda x, *a, **k: x)
    jgen, jdisc = JaxUNet(filters=8, gcn_grid=GRID), JaxSimpleD(
        input_size=SIZE)
    kg, kd = jax.random.split(jax.random.PRNGKey(2))
    zeros = jnp.zeros((1, SIZE, SIZE, 1))
    s0 = jstate.TrainState.create(jax.jit(jgen.init)(kg, zeros)["params"],
                                  jax.jit(jdisc.init)(kd, zeros)["params"])
    s0 = s0.replace(opt_state_G=_warm(s0.opt_state_G, 0),
                    opt_state_D=_warm(s0.opt_state_D, 1))
    rng = np.random.default_rng(3)
    batch = {k: rng.random((2, 2, SIZE, SIZE, 1), np.float32)
             for k in ("hdr", "ldr_pos", "ldr_neg")}
    step = jstep.make_train_step(jgen, jdisc, jstep.LossConfig(**cfg))
    ref, ref_logs = step(s0, {k: jnp.asarray(v) for k, v in batch.items()},
                         jax.random.PRNGKey(0), G_LR, D_LR, stage=0)

    gen = UNetTMO(filters=8, gcn_grid=GRID)
    disc = SimpleDiscriminator(input_size=SIZE)
    pstep = tstep.make_train_step(gen, disc, tstep.LossConfig(**cfg),
                                  device="cpu")
    state = train_state_from_flax(s0, gen, disc)
    start = {n: p.detach().clone() for n, p in gen.named_parameters()}
    d_start = {n: p.detach().clone() for n, p in disc.named_parameters()}
    state, logs = pstep(state, batch, torch.Generator().manual_seed(0),
                        G_LR, D_LR, stage=0)

    assert sorted(logs) == sorted(ref_logs)
    for k in ref_logs:
        if k.startswith("fake/"):
            assert abs(float(logs[k]) - float(ref_logs[k])) <= \
                LOG_RTOL * abs(float(ref_logs[k])), k
        else:                                  # losses, gradG/*: exactly 0
            assert float(logs[k]) == float(ref_logs[k]) == 0.0, k
    to_np = jax.tree_util.tree_map
    ref_g = state_dict_from_flax(to_np(np.asarray, ref.params_G))
    ref_start = state_dict_from_flax(to_np(np.asarray, s0.params_G))
    mu = state_dict_from_flax(to_np(np.asarray, ref.opt_state_G.mu))
    nu = state_dict_from_flax(to_np(np.asarray, ref.opt_state_G.nu))
    assert int(ref.opt_state_G.count) == 11
    for name, p in gen.named_parameters():
        st = state.opt_G.state[p]
        assert float(st["step"]) == 11, name
        for got, want in ((st["exp_avg"], mu[name]),
                          (st["exp_avg_sq"], nu[name])):
            assert np.abs(got.numpy() - want).max() <= \
                TOL * np.abs(want).max(), name
        moved = (p.detach() - start[name]).numpy()
        ref_moved = ref_g[name] - ref_start[name]
        assert np.abs(ref_moved).max() > 0 and np.abs(moved).max() > 0, name
        assert np.abs(moved - ref_moved).max() <= (
            TOL * np.abs(ref_moved).max() + 3e-8), name
    # D is not trained: untouched on both sides
    ref_d = discriminator_state_dict_from_flax(to_np(np.asarray,
                                                     ref.params_D))
    for name, p in disc.named_parameters():
        assert torch.equal(p.detach(), d_start[name]), name
        np.testing.assert_array_equal(p.detach().numpy(), ref_d[name])
    assert state.step == int(ref.step) == 1
