"""The port's GAN training step against the JAX package's (CPU).

Both sides start from the same parameters and Adam states (built in JAX,
carried over by `train_state_from_flax`), take the same numpy batch and the
same drop path masks, at 112 x 112 with a 3 x 3 GCN grid and B = 2 (the
shapes of `__graft_entry__._dryrun_impl`).  Flax derives its drop path keys
from module paths, so the JAX package's `drop_path` is patched here (the
package file is untouched) to take its masks from a numpy table in call
order -- the order in which the step is traced -- and the port is handed
the same table through `drop_masks`.  One mask drops a sample.

Adam's first update is close to sign(g) * lr whatever the gradient, so
parameters after a first step prove little; the single-step tests compare
the logs, the first moments (0.5 g after step one) and the second moments.
Tolerances, each with its reason (all float32 on both sides):

* loss and statistics logs 1e-4 relative; `gradG/*` logs 2e-3 (means of
  |g| over a layer); the discriminator's moments 1e-4 of their max-abs; the
  generator's 1e-2: measured 2e-4 to 3.3e-3 depending on the batch (the
  structural loss scales its gradient by up to 1 / sigma^2 = 1e5 and
  cancels, a relu mask flips at a few entries, and a bias gradient is a
  signed sum over every pixel), where a wrong term or weight shows as
  1e-1 and more; the terms one by one are held to 1e-4 in
  `tests/test_torch_losses.py`.
* The encoder cells that feed a skip (`inc`, `down0..2`) are the exception.
  Their gradient passes through `0.5 / sqrt(x2 + 1e-8)` of the skip concat,
  which is 5000 at zero and in the hundreds to thousands for the few dozen
  activations below 1e-5, and those few entries carry a visible part of
  the whole gradient.  An activation that two float32 implementations
  compute as 1.2e-7 and as 5e-8 gets the factor 1400 from one and 2000
  from the other (`scripts/encoder_grad_probe.py` finds such entries on the
  card), so the agreement depends on the draw: from one batch of `_batch`
  to another the encoder's first moments differ between JAX and the port
  by 6e-3 to more than 1 of their max-abs.  The batches used here are
  draws without
  such an entry of weight: measured 2.1e-2 of max-abs and 1.5e-2 in
  relative L2 for the image generator's first moments (stage 0; stage 2
  1.0e-2 and 4.8e-3), 1.8e-2 and 7.9e-3 for the video generator's, and up
  to twice that for the second moments, which square the gradient.  They
  are held to `ENCODER_L2_TOL` in relative L2 and to `ENCODER_TOL` entry by
  entry (twice each for the second moments), the encoder's `gradG/*` logs
  to 1e-2 (measured 3.8e-3).  The strict check of that path is the step
  with both packages' epsilon patched to 1e-2, which removes the
  singularity and nothing else, and holds every parameter to 1e-2;
  `test_encoder_gradients_are_ill_conditioned_in_float32` shows the port
  against itself in float64.
* Consecutive steps: from fresh Adam states a gradient entry inside the
  float32 noise gets +lr on one side and -lr on the other, and three steps
  multiply that to 1e-2 and more even in the well-conditioned setting.  So
  the three-step test continues from warm Adam states (count 10, a flat
  second moment), where the update is smooth in the gradient: there the
  moments, the step counts and the parameters' movement itself agree
  within 1e-2, which tests bias correction, epsilon and the learning rate.
* The learning rates are the published 1e-5 / 1.5e-5.  `model.4.bias` of
  D shifts every logit alike, the relativistic D loss does not see it, so
  its gradient is rounding noise and its Adam step a coin toss of size lr
  on both sides; at a large rate that alone moves `errG_d` by 5e-4.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from uncltmo_tpu.models import gcn as jgcn
from uncltmo_tpu.models.discriminator import (
    SimpleDiscriminator as JaxSimpleD)
from uncltmo_tpu.models.unet import UNetTMO as JaxUNet
from uncltmo_tpu.training import state as jstate
from uncltmo_tpu.training import train_step as jstep
from uncltmo_tpu_torch.models import unet as tunet
from uncltmo_tpu_torch.models.discriminator import SimpleDiscriminator
from uncltmo_tpu_torch.models.gcn import GCNBlock, drop_path
from uncltmo_tpu_torch.models.unet import UNetTMO, bottleneck_grid
from uncltmo_tpu_torch.training import state as tstate
from uncltmo_tpu_torch.training import train_step as tstep
from uncltmo_tpu_torch.utils.convert import (
    discriminator_state_dict_from_flax, gcn_state_from_flax, load_state,
    state_dict_from_flax, train_state_from_flax)

SIZE = 112
GRID = bottleneck_grid(SIZE)            # 3
G_LR, D_LR = 1e-5, 1.5e-5
LOG_RTOL = 1e-4
GRAD_LOG_RTOL = 2e-3
D_TOL = 1e-4                            # moments: of the moment's max-abs
G_TOL = 1e-2
# the encoder cells behind a skip, at the published epsilon (see the module
# docstring): relative L2 and entry by entry of max-abs, for the first
# moments; twice that for the second moments
ENCODER_L2_TOL = {"image": 3e-2, "video": 2e-2}
ENCODER_TOL = 5e-2
ENCODER_LOG_RTOL = 1e-2
ENCODER = ("inc.", "down_path.0.", "down_path.1.", "down_path.2.")
ENCODER_LOGS = ("gradG/inc", "gradG/down0", "gradG/down1", "gradG/down2")

# keep masks in call order; a step draws two per generator forward and
# frame.  Row 1 drops sample 0, row 6 drops sample 1.
MASKS = np.ones((8, 4), np.float32)
MASKS[1, 0] = 0.0
MASKS[6, 1] = 0.0
_calls = {"n": 0}


def _table_drop_path(x, rate, deterministic, rng=None):
    if deterministic or rate == 0.0:
        return x
    mask = MASKS[_calls["n"]][:x.shape[0]]
    _calls["n"] += 1
    shape = (x.shape[0],) + (1,) * (x.ndim - 1)
    return x * jnp.asarray(mask, x.dtype).reshape(shape) / (1.0 - rate)


def _port_masks(n_calls, batch):
    return iter([torch.from_numpy(MASKS[i, :batch].copy())
                 for i in range(n_calls)])


def _batch(seed, b=2):
    rng = np.random.default_rng(seed)
    level = np.linspace(0.1, 0.6, 2 * b, dtype=np.float32).reshape(b, 2, 1, 1,
                                                                   1)
    return {"hdr": rng.random((b, 2, SIZE, SIZE, 1), np.float32) * 0.4 + level,
            "ldr_pos": rng.random((b, 2, SIZE, SIZE, 1), np.float32),
            "ldr_neg": rng.random((b, 2, SIZE, SIZE, 1), np.float32) ** 3}


class _Side:
    """The JAX step and state for the image or the video generator."""

    def __init__(self, video):
        self.video = video
        self.gen = JaxUNet(gcn_grid=GRID)
        self.disc = JaxSimpleD(input_size=SIZE)
        kg, kd = jax.random.split(jax.random.PRNGKey(1))
        zeros = jnp.zeros((1, SIZE, SIZE, 1))
        self.state0 = jstate.TrainState.create(
            jax.jit(self.gen.init)(kg, zeros)["params"],
            jax.jit(self.disc.init)(kd, zeros)["params"])
        self.step = jstep.make_train_step(self.gen, self.disc,
                                          jstep.LossConfig(video=video))
        self.n_masks = 8 if video else 4      # per step, both forwards
        self.mask_batch = 2 if video else 4

    def jax_step(self, state, batch, **kw):
        _calls["n"] = 0                      # a new trace reads from row 0
        return self.step(state, {k: jnp.asarray(v) for k, v in batch.items()},
                         jax.random.PRNGKey(0), G_LR, D_LR, **kw)

    def port(self, state=None):
        gen = UNetTMO(gcn_grid=GRID)
        disc = SimpleDiscriminator(input_size=SIZE)
        step = tstep.make_train_step(gen, disc,
                                     tstep.LossConfig(video=self.video),
                                     device="cpu")
        return step, train_state_from_flax(
            self.state0 if state is None else state, gen, disc)

    def port_step(self, step, state, batch, **kw):
        return step(state, batch, torch.Generator().manual_seed(0), G_LR,
                    D_LR, drop_masks=_port_masks(self.n_masks,
                                                 self.mask_batch), **kw)


@pytest.fixture(scope="module")
def sides():
    patch = pytest.MonkeyPatch()
    patch.setattr(jgcn, "drop_path", _table_drop_path)
    made = {}

    def get(video):
        if video not in made:
            made[video] = _Side(video)
        return made[video]

    yield get
    patch.undo()


def _assert_logs(logs, ref, encoder_rtol=ENCODER_LOG_RTOL):
    assert sorted(logs) == sorted(ref)
    for k in ref:
        rtol = (encoder_rtol if k in ENCODER_LOGS
                else GRAD_LOG_RTOL if k.startswith("gradG/") else LOG_RTOL)
        np.testing.assert_allclose(float(logs[k]), float(ref[k]), rtol=rtol,
                                   atol=1e-7, err_msg=k)


def _assert_moments(opt, module, adam, to_sd, tol, count=1,
                    encoder_tol=ENCODER_TOL, encoder_l2_tol=None):
    mu = to_sd(jax.tree_util.tree_map(np.asarray, adam.mu))
    nu = to_sd(jax.tree_util.tree_map(np.asarray, adam.nu))
    assert int(adam.count) == count
    for name, p in module.named_parameters():
        st = opt.state[p]
        assert float(st["step"]) == count, name
        if name == "model.4.bias":
            # a common shift of every logit: the relativistic D loss does
            # not see it, so this gradient is rounding noise on both sides
            assert np.abs(mu[name]).max() < 1e-5 > st["exp_avg"].abs().max()
            continue
        encoder = name.startswith(ENCODER)
        limit = max(tol, encoder_tol) if encoder else tol
        for got, ref, power in ((st["exp_avg"], mu[name], 1),
                                (st["exp_avg_sq"], nu[name], 2)):
            scale = power if encoder and encoder_tol > tol else 1
            err = np.abs(got.numpy() - ref).max()
            assert err <= scale * limit * max(np.abs(ref).max(), 1e-30), (
                name, err)
            if encoder and encoder_l2_tol is not None:
                l2 = np.linalg.norm(got.numpy() - ref) / np.linalg.norm(ref)
                assert l2 <= scale * encoder_l2_tol, (name, l2)


def _assert_state(state, ref, tol=None, count_g=1, count_d=1,
                  encoder_tol=ENCODER_TOL, encoder_l2_tol=None):
    _assert_moments(state.opt_D, state.disc, ref.opt_state_D,
                    discriminator_state_dict_from_flax,
                    D_TOL if tol is None else tol, count_d)
    if count_g:
        _assert_moments(state.opt_G, state.gen, ref.opt_state_G,
                        state_dict_from_flax, G_TOL if tol is None else tol,
                        count_g, encoder_tol, encoder_l2_tol)
    assert state.step == int(ref.step)


def test_pretrain_step_matches_jax(sides):
    side = sides(False)
    batch = _batch(0)
    ref_state, ref_logs = side.jax_step(side.state0, batch, pretrain=True)
    step, state = side.port()
    before = [p.detach().clone() for p in state.gen.parameters()]
    state, logs = side.port_step(step, state, batch, pretrain=True)
    _assert_logs(logs, ref_logs)
    assert sorted(logs) == ["accDfake", "accDreal", "accG", "errD"]
    _assert_state(state, ref_state, count_g=0)
    # G untouched while D pre-trains, and its optimizer never stepped
    for p, b in zip(state.gen.parameters(), before):
        assert torch.equal(p, b)
    assert all(float(st["step"]) == 0 and not st["exp_avg"].any()
               for st in state.opt_G.state.values())


@pytest.mark.parametrize("stage", [0, 2])
def test_stage_step_matches_jax(sides, stage):
    side = sides(False)
    batch = _batch(1 + stage)
    ref_state, ref_logs = side.jax_step(side.state0, batch, stage=stage)
    step, state = side.port()
    d_before = [p.detach().clone() for p in state.disc.parameters()]
    state, logs = side.port_step(step, state, batch, stage=stage)
    _assert_logs(logs, ref_logs)
    for top in ("inc", "down0", "down1", "down2", "last_down", "gcn", "up0",
                "up1", "up2", "up3", "outc"):
        assert f"gradG/{top}" in logs
    _assert_state(state, ref_state, encoder_l2_tol=ENCODER_L2_TOL["image"])
    # the G phase left D's gradients alone: they are still the D loss's
    # (first moment = 0.5 g after step one), and D moved exactly once
    for (name, p), b in zip(state.disc.named_parameters(), d_before):
        torch.testing.assert_close(p.grad,
                                   2.0 * state.opt_D.state[p]["exp_avg"])
        assert name == "model.4.bias" or not torch.equal(p, b), name
    for p in state.gen.parameters():
        assert p.grad is not None and torch.isfinite(p.grad).all()
        assert p.grad.abs().sum() > 0
    if stage == 0:
        # the G phase sees the UPDATED D: with a D rate a thousand times
        # larger its loss moves, on both sides alike
        _calls["n"] = 0
        _, big_ref = side.step(side.state0,
                               {k: jnp.asarray(v) for k, v in batch.items()},
                               jax.random.PRNGKey(0), G_LR, 1e3 * D_LR,
                               stage=0)
        step, state = side.port()
        _, big = step(state, batch, torch.Generator(), G_LR, 1e3 * D_LR,
                      drop_masks=_port_masks(4, 4), stage=0)
        assert abs(float(big_ref["errG_d"]) - float(ref_logs["errG_d"])) \
            > 0.02 * abs(float(ref_logs["errG_d"]))
        assert float(big["errG_d"]) == pytest.approx(
            float(big_ref["errG_d"]), rel=5e-3)


def test_stage0_step_matches_jax_everywhere_without_the_singularity(sides):
    """Both packages' epsilon patched to 1e-2: `0.5 / sqrt(x2 + eps)` is at
    most 5, the encoder's gradient is well conditioned, and every parameter
    of G is held to the common tolerance."""
    import uncltmo_tpu.params as jparams
    import uncltmo_tpu_torch.params as tparams
    sides(False)                           # the drop path patch is in place
    patch = pytest.MonkeyPatch()
    patch.setattr(jparams, "EPSILON", 1e-2)
    patch.setattr(tparams, "EPSILON", 1e-2)
    try:
        side = _Side(False)                # a fresh trace reads the patch
        batch = _batch(4)
        ref_state, ref_logs = side.jax_step(side.state0, batch, stage=0)
        step, state = side.port()
        state, logs = side.port_step(step, state, batch, stage=0)
    finally:
        patch.undo()
    _assert_logs(logs, ref_logs, encoder_rtol=GRAD_LOG_RTOL)
    _assert_state(state, ref_state, encoder_tol=G_TOL)


def test_encoder_gradients_are_ill_conditioned_in_float32():
    """The port against itself: the same generator and loss in float64 and
    in float32.  Behind the skips' square root the two differ by far more
    than anywhere else, which is why the encoder's moments have limits of
    their own."""
    import copy
    gen = tunet.seeded_init_(UNetTMO(gcn_grid=GRID), 1)
    x = torch.rand(4, 1, SIZE, SIZE,
                   generator=torch.Generator().manual_seed(0)) * 0.4 + 0.2

    def grads(model, inp):
        out, _ = model(inp)
        return torch.autograd.grad((out - 0.3).pow(2).mean(),
                                   list(model.parameters()))

    g32 = grads(gen, x)
    g64 = grads(copy.deepcopy(gen).double(), x.double())
    rel = {n: ((a - b.float()).abs().max() / b.abs().max()).item()
           for (n, _), a, b in zip(gen.named_parameters(), g32, g64)}
    assert rel["inc.conv.conv1.weight"] > 1e-3
    assert max(v for n, v in rel.items() if n.startswith(ENCODER)) \
        <= ENCODER_TOL
    assert max(v for n, v in rel.items()
               if n.startswith(("up_path.3.", "outc."))) < 1e-4


def test_video_stage0_step_matches_jax(sides):
    side = sides(True)
    batch = _batch(5)
    ref_state, ref_logs = side.jax_step(side.state0, batch, stage=0)
    step, state = side.port()
    state, logs = side.port_step(step, state, batch, stage=0)
    _assert_logs(logs, ref_logs)
    _assert_state(state, ref_state, encoder_l2_tol=ENCODER_L2_TOL["video"])


def _warm(adam):
    """The Adam state of a run ten steps old with a flat second moment."""
    return adam._replace(
        count=jnp.asarray(10, jnp.int32),
        nu=jax.tree_util.tree_map(lambda x: jnp.full_like(x, 1e-2), adam.nu))


def test_three_consecutive_steps_match_jax(sides):
    """A JAX run continued in the port from warm Adam states, three steps
    on, in the well-conditioned setting (see the module docstring): the
    moments, the counts and the parameters' movement."""
    import uncltmo_tpu.params as jparams
    import uncltmo_tpu_torch.params as tparams
    sides(False)                           # the drop path patch is in place
    patch = pytest.MonkeyPatch()
    patch.setattr(jparams, "EPSILON", 1e-2)
    patch.setattr(tparams, "EPSILON", 1e-2)
    try:
        side = _Side(False)
        ref_state = side.state0.replace(
            opt_state_G=_warm(side.state0.opt_state_G),
            opt_state_D=_warm(side.state0.opt_state_D))
        step, state = side.port(ref_state)
        _assert_state(state, ref_state, tol=0.0, count_g=10, count_d=10,
                      encoder_tol=0.0)
        start = {n: p.detach().clone()
                 for n, p in state.gen.named_parameters()}
        for i in range(3):
            batch = _batch(10 + i)
            ref_state, ref_logs = side.jax_step(ref_state, batch, stage=0)
            state, logs = side.port_step(step, state, batch, stage=0)
            _assert_logs(logs, ref_logs, encoder_rtol=GRAD_LOG_RTOL)
            _assert_state(state, ref_state, tol=G_TOL, count_g=11 + i,
                          count_d=11 + i, encoder_tol=G_TOL)
    finally:
        patch.undo()
    assert state.step == 3
    ref_start = state_dict_from_flax(jax.tree_util.tree_map(
        np.asarray, side.state0.params_G))
    ref_end = state_dict_from_flax(jax.tree_util.tree_map(
        np.asarray, ref_state.params_G))
    for name, p in state.gen.named_parameters():
        moved = (p.detach() - start[name]).numpy()
        ref_moved = ref_end[name] - ref_start[name]
        assert np.abs(ref_moved).max() > 0, name
        # float32 parameters of order 0.1 carry their movement (1e-6 to
        # 1e-4) with a rounding of 1e-8
        assert np.abs(moved - ref_moved).max() <= (
            G_TOL * np.abs(ref_moved).max() + 3e-8), name


def test_converter_carries_parameters_and_adam_states(sides):
    side = sides(False)
    _, state = side.port()
    sd = state_dict_from_flax(jax.tree_util.tree_map(np.asarray,
                                                     side.state0.params_G))
    for name, p in state.gen.named_parameters():
        np.testing.assert_array_equal(p.detach().numpy(), sd[name])
    dsd = discriminator_state_dict_from_flax(jax.tree_util.tree_map(
        np.asarray, side.state0.params_D))
    assert sorted(dsd) == sorted(state.disc.state_dict())
    for name, p in state.disc.named_parameters():
        np.testing.assert_array_equal(p.detach().numpy(), dsd[name])
    for opt, module in ((state.opt_G, state.gen), (state.opt_D, state.disc)):
        for p in module.parameters():
            st = opt.state[p]
            assert float(st["step"]) == 0.0
            assert not st["exp_avg"].any() and not st["exp_avg_sq"].any()
            assert st["exp_avg"].shape == p.shape
        assert opt.defaults["betas"] == (0.5, 0.999)
        assert opt.defaults["eps"] == 1e-8
    assert state.step == 0


def test_step_refuses_a_state_of_other_modules_and_defaults_to_the_card():
    gen, disc = UNetTMO(gcn_grid=GRID), SimpleDiscriminator(input_size=SIZE)
    step = tstep.make_train_step(gen, disc, tstep.LossConfig(), device="cpu")
    other = tstate.TrainState.create(UNetTMO(gcn_grid=GRID), disc)
    with pytest.raises(ValueError, match="other modules"):
        step(other, _batch(0), torch.Generator(), G_LR, D_LR)
    if not torch.cuda.is_available():
        # no device argument means the card; there is no fallback to the CPU
        with pytest.raises((RuntimeError, AssertionError)):
            tstep.make_train_step(gen, disc, tstep.LossConfig())


def test_step_without_the_discriminator_or_without_the_struct_loss():
    """`train_with_D=False` trains G on the structural loss alone and
    leaves D as it was; `struct_loss_factor=0` drops that term
    (`uncltmo_tpu/training/train_step.py:156`, `:199`, `:209`)."""
    batch = _batch(7)
    for cfg, keys in (
            (tstep.LossConfig(train_with_D=False),
             {"errG_d": 0.0, "errD": None}),
            (tstep.LossConfig(struct_loss_factor=0.0),
             {"errG_struct": 0.0})):
        gen = tunet.seeded_init_(UNetTMO(filters=8, gcn_grid=GRID), 0)
        disc = tunet.seeded_init_(SimpleDiscriminator(input_size=SIZE), 1)
        step = tstep.make_train_step(gen, disc, cfg, device="cpu")
        state = tstate.TrainState.create(gen, disc)
        d_before = [p.detach().clone() for p in disc.parameters()]
        g_before = [p.detach().clone() for p in gen.parameters()]
        state, logs = step(state, batch, torch.Generator().manual_seed(0),
                           G_LR, D_LR)
        for k, v in keys.items():
            assert (k not in logs) if v is None else float(logs[k]) == v
        moved = [not torch.equal(p, b)
                 for p, b in zip(disc.parameters(), d_before)]
        assert any(moved) == cfg.train_with_D
        assert all(not torch.equal(p, b)
                   for p, b in zip(gen.parameters(), g_before))


def test_lr_schedule():
    assert tstate.lr_schedule(1e-5, 0, 50) == pytest.approx(1e-5)
    assert tstate.lr_schedule(1e-5, 50, 50) == pytest.approx(0.5e-5)
    for epoch in (0, 3, 17):
        assert tstate.lr_schedule(2e-4, epoch, 7.0) == jstate.lr_schedule(
            2e-4, epoch, 7.0)


def test_stage_for_epoch():
    assert [tstep.stage_for_epoch(e) for e in (0, 6, 7, 9, 10, 20)] == \
        [0, 0, 1, 1, 2, 2]
    assert all(tstep.stage_for_epoch(e, 2, 4) == jstep.stage_for_epoch(e, 2, 4)
               for e in range(8))


# ------------------------------------------------ the training forward
def test_gcn_drop_path_matches_jax_with_the_same_masks():
    ch, grid = 32, 4
    rng = np.random.default_rng(6)
    x = rng.standard_normal((3, grid, grid, ch)).astype(np.float32)
    blk = jgcn.GCNBlock(ch, grid=grid)
    v = blk.init(jax.random.PRNGKey(5), jnp.zeros((1, grid, grid, ch)))
    masks = np.array([[1, 0, 1], [0, 1, 1]], np.float32)
    table = iter(masks)
    patch = pytest.MonkeyPatch()
    patch.setattr(jgcn, "drop_path", lambda a, rate, det, rng=None: (
        a if det else a * jnp.asarray(next(table)).reshape(-1, 1, 1)
        / (1.0 - rate)))
    try:
        ref = blk.apply(v, jnp.asarray(x), deterministic=False,
                        rngs={"droppath": jax.random.PRNGKey(0)})
    finally:
        patch.undo()
    port = load_state(GCNBlock(ch, grid=grid), gcn_state_from_flax(
        jax.tree_util.tree_map(np.asarray, v["params"])))
    xt = torch.from_numpy(x).permute(0, 3, 1, 2)
    with torch.no_grad():
        out = port(xt, deterministic=False,
                   drop_masks=iter(torch.from_numpy(masks)))
        plain = port(xt)
    np.testing.assert_allclose(out.permute(0, 2, 3, 1).numpy(),
                               np.asarray(ref), rtol=1e-5, atol=1e-5)
    assert not torch.allclose(out, plain)


def test_drop_path_draws_from_the_generator():
    x = torch.ones(4000, 2, 1, 1)
    g = torch.Generator().manual_seed(3)
    out = drop_path(x, 0.05, False, g)
    kept = (out[:, 0, 0, 0] > 0)
    assert 0.93 < kept.float().mean().item() < 0.97
    torch.testing.assert_close(out[kept], x[kept] / 0.95)
    assert not torch.equal(out, drop_path(x, 0.05, False, g))   # fresh draws
    again = drop_path(x, 0.05, False, torch.Generator().manual_seed(3))
    assert torch.equal(out, again)
    assert drop_path(x, 0.05, True) is x and drop_path(x, 0.0, False) is x
    with pytest.raises(ValueError, match="Generator"):
        drop_path(x, 0.05, False)


def test_video_apply_draws_fresh_masks_for_every_frame():
    model = tunet.seeded_init_(UNetTMO(filters=8, gcn_grid=GRID), 0)
    x = torch.rand(3, 2, 1, SIZE, SIZE,
                   generator=torch.Generator().manual_seed(1))
    seen = []

    def masks():
        while True:
            seen.append(len(seen))
            yield torch.ones(3)

    with torch.no_grad():
        ref, _ = tunet.video_apply(model, x)
        out, _ = tunet.video_apply(model, x, deterministic=False,
                                   drop_masks=masks())
    assert len(seen) == 4                   # two per frame
    assert out.shape == ref.shape and not torch.allclose(out, ref)
    g = torch.Generator().manual_seed(2)
    with torch.no_grad():
        a, _ = tunet.video_apply(model, x, deterministic=False, generator=g)
    assert a.shape == ref.shape and torch.isfinite(a).all()


def test_splice_builds_a_new_tensor_under_autograd():
    x = torch.rand(2, 8, 5, 5, requires_grad=True)
    rec = torch.rand(2, 2, 5, 5, requires_grad=True)
    y = x * 1.0
    kept = y.detach().clone()
    out = tunet._splice(y, rec)
    assert out is not y and torch.equal(y, kept)       # y is intact
    assert torch.equal(out[:, :2], rec) and torch.equal(out[:, 2:], y[:, 2:])
    out.sum().backward()
    assert torch.equal(rec.grad, torch.ones_like(rec))
    assert not x.grad[:, :2].any() and x.grad[:, 2:].all()
    with torch.no_grad():                              # inference: in place
        z = torch.rand(2, 8, 5, 5)
        assert tunet._splice(z, rec) is z and torch.equal(z[:, :2], rec)
