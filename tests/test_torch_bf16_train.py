"""bfloat16 training (`compute_dtype=torch.bfloat16`) against the JAX
package's bfloat16 step and against the port's own float32 step (CPU).

The setting is `tests/test_torch_train_step.py`'s: 112 x 112, GCN grid 3,
B = 2, one stage-0 step from the same JAX parameters and Adam states, the
drop path from one table on both sides.  JAX on the CPU ignores
`jax_default_matmul_precision`, so its bfloat16 step there is float32 math
on a bfloat16 batch (the trainer's `_put`); the port's runs G's and D's
forwards under autocast, with bfloat16 activations between ops.

Measured over draws 1-5 (image and video generator), bf16 against JAX
and against the port's float32 step alike (the `__main__` below); the
tests run draw 1, which reads the largest of the five:

* the losses (`errD`, `errG_d`, `errG_struct`) and the fake's statistics
  differ by 1e-5 to 2.8e-2 relative; the fake of a forward on the same
  batch by 1.8e-3 to 1.9e-3 in relative L2 (image and video).  Held to
  5e-2 and 3e-2.
* D's first moments by 4.0e-2 to 7.4e-2 in relative L2 (8.4e-2 with the
  epsilon patched, below); held to 0.1.
* G's first moments outside the encoder by 2.0e-2 to 5.4e-2 in relative
  L2, and 0.23 on draw 1 of the image generator: the skips' 0.5/sqrt(x2 +
  1e-8) (ROADMAP Queue 3) reaches the decoder through the contrastive
  terms, as the patched run shows (4.3e-2 to 5.9e-2 there).  Held to 0.3.
* The encoder behind the skips (`inc`, `down0..2`), the two-sided check of
  ROADMAP Queue 3, in relative L2 only (entry by entry a bf16 encoder
  gradient says nothing): at the published epsilon 0.14 to 0.35, held to
  0.4; with both packages' epsilon patched to 1e-2 every group is within
  3.9e-2 to 8.4e-2, held to 0.1.  The float32 steps themselves differ
  in the encoder by up to 0.11 at the published epsilon (draw 4, image)
  and by 4.5e-3 patched.

What makes these figures, kept in the port: the KNN distances, window
statistics, structural loss, TMQI's naturalness, the global average pool,
the generator's output head, D's logit and every loss term are float32
islands (`ops/precision.py`).  Without the last four, D's logits and
pooled features are bfloat16 and the relativistic and `k = 1e3`
contrastive terms see their rounding: the output head's gradient was 20
times off in relative L2.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import uncltmo_tpu.params as jparams
import uncltmo_tpu_torch.params as tparams
from uncltmo_tpu.models import gcn as jgcn
from uncltmo_tpu.models.discriminator import (
    SimpleDiscriminator as JaxSimpleD)
from uncltmo_tpu.models.unet import UNetTMO as JaxUNet
from uncltmo_tpu.models.unet import video_apply as jax_video_apply
from uncltmo_tpu.training import state as jstate
from uncltmo_tpu.training import train_step as jstep
from uncltmo_tpu_torch.models.discriminator import SimpleDiscriminator
from uncltmo_tpu_torch.models.unet import (UNetTMO, bottleneck_grid,
                                           video_apply)
from uncltmo_tpu_torch.training import train_step as tstep
from uncltmo_tpu_torch.utils.convert import (
    discriminator_state_dict_from_flax, load_state, state_dict_from_flax,
    train_state_from_flax)

SIZE = 112
GRID = bottleneck_grid(SIZE)
G_LR, D_LR = 1e-5, 1.5e-5
LOG_RTOL = 5e-2
FAKE_L2_TOL = 3e-2
D_L2_TOL = 0.1
G_L2_TOL = 0.3
ENCODER_L2_TOL = 0.4
PATCHED_L2_TOL = 0.1
DRAWS = (1,)              # the largest readings of draws 1-5
ENCODER = ("inc.", "down_path.0.", "down_path.1.", "down_path.2.")
LOGS = ("errD", "errG_d", "errG_struct", "fake/min", "fake/max", "fake/mean")

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


@pytest.fixture(scope="module", autouse=True)
def table_drop_path():
    patch = pytest.MonkeyPatch()
    patch.setattr(jgcn, "drop_path", _table_drop_path)
    yield
    patch.undo()


def _batch(seed, b=2):
    rng = np.random.default_rng(seed)
    level = np.linspace(0.1, 0.6, 2 * b, dtype=np.float32).reshape(
        b, 2, 1, 1, 1)
    return {"hdr": rng.random((b, 2, SIZE, SIZE, 1), np.float32) * 0.4 + level,
            "ldr_pos": rng.random((b, 2, SIZE, SIZE, 1), np.float32),
            "ldr_neg": rng.random((b, 2, SIZE, SIZE, 1), np.float32) ** 3}


def _bf16(batch):
    """The batch as the bfloat16 trainers hand it over."""
    return {k: np.array(jnp.asarray(v, jnp.bfloat16).astype(jnp.float32))
            for k, v in batch.items()}


def _rel(a, b):
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


class _Run:
    """One JAX step and the port's float32 and bfloat16 steps from the same
    state, batch and drop path masks."""

    def __init__(self, video, seed, jax_side):
        self.video = video
        self.gen, self.state0, step = jax_side
        batch = _bf16(_batch(seed))
        _calls["n"] = 0
        self.jax_state, self.jax_logs = step(
            self.state0, {k: jnp.asarray(v, jnp.bfloat16)
                          for k, v in batch.items()},
            jax.random.PRNGKey(0), G_LR, D_LR, stage=0)
        self.batch = batch
        self.port = {d: self._port_step(d) for d in (torch.float32,
                                                     torch.bfloat16)}

    def _port_step(self, dtype):
        gen, disc = UNetTMO(gcn_grid=GRID), SimpleDiscriminator(
            input_size=SIZE)
        step = tstep.make_train_step(gen, disc,
                                     tstep.LossConfig(video=self.video),
                                     device="cpu", compute_dtype=dtype)
        state = train_state_from_flax(self.state0, gen, disc)
        n, b = (8, 2) if self.video else (4, 4)
        masks = iter([torch.from_numpy(MASKS[i, :b].copy())
                      for i in range(n)])
        return step(state, self.batch, torch.Generator(), G_LR, D_LR,
                    stage=0, drop_masks=masks)


def _jax_side(video):
    """The JAX generator, the initial state and the jitted step."""
    gen, disc = JaxUNet(gcn_grid=GRID), JaxSimpleD(input_size=SIZE)
    kg, kd = jax.random.split(jax.random.PRNGKey(1))
    zeros = jnp.zeros((1, SIZE, SIZE, 1))
    state0 = jstate.TrainState.create(
        jax.jit(gen.init)(kg, zeros)["params"],
        jax.jit(disc.init)(kd, zeros)["params"])
    return gen, state0, jstep.make_train_step(
        gen, disc, jstep.LossConfig(video=video))


def _groups(module, moments):
    """First moments by group, flattened: (encoder, rest of G) for a
    generator, everything for a discriminator."""
    enc, rest = [], []
    for name, _ in module.named_parameters():
        (enc if name.startswith(ENCODER) else rest).append(
            np.asarray(moments[name]).ravel())
    return [np.concatenate(g) for g in (enc, rest) if g]


def _port_moments(opt, module):
    return {n: opt.state[p]["exp_avg"].numpy()
            for n, p in module.named_parameters()}


def _readings(state, logs, ref_logs, ref_g, ref_d):
    """The worst relative error of the logs, and the relative L2 error of
    D's, the encoder's and the rest of G's first moments."""
    (got_d,) = _groups(state.disc, _port_moments(state.opt_D, state.disc))
    (want_d,) = _groups(state.disc, ref_d)
    enc, rest = _groups(state.gen, _port_moments(state.opt_G, state.gen))
    want_enc, want_rest = _groups(state.gen, ref_g)
    return {"logs": max(abs(float(logs[k]) / float(ref_logs[k]) - 1.0)
                        for k in LOGS),
            "D": _rel(got_d, want_d), "encoder": _rel(enc, want_enc),
            "rest": _rel(rest, want_rest)}


def _check_step(state, logs, ref_logs, ref_g, ref_d, encoder_tol, g_tol):
    for k in LOGS:
        assert float(logs[k]) == pytest.approx(float(ref_logs[k]),
                                               rel=LOG_RTOL), k
    got = _readings(state, logs, ref_logs, ref_g, ref_d)
    assert got["D"] <= D_L2_TOL
    assert got["rest"] <= g_tol
    assert got["encoder"] <= encoder_tol
    for p in state.gen.parameters():
        assert p.dtype == torch.float32
        assert state.opt_G.state[p]["exp_avg"].dtype == torch.float32


def _jax_moments(run):
    g = state_dict_from_flax(jax.tree_util.tree_map(
        np.asarray, run.jax_state.opt_state_G.mu))
    d = discriminator_state_dict_from_flax(jax.tree_util.tree_map(
        np.asarray, run.jax_state.opt_state_D.mu))
    return g, d


@pytest.fixture(scope="module")
def runs():
    """`_Run`s by (video, epsilon, draw); the draws of one (video, epsilon)
    share the JAX step's compilation, which reads the epsilon."""
    made, sides = {}, {}

    def get(video, draw, eps=None):
        key = (video, eps, draw)
        if key not in made:
            patch = pytest.MonkeyPatch()
            if eps is not None:
                patch.setattr(jparams, "EPSILON", eps)
                patch.setattr(tparams, "EPSILON", eps)
            try:
                if (video, eps) not in sides:
                    sides[video, eps] = _jax_side(video)
                made[key] = _Run(video, draw, sides[video, eps])
            finally:
                patch.undo()
        return made[key]
    return get


@pytest.mark.parametrize("video", [False, True], ids=["image", "video"])
@pytest.mark.parametrize("draw", DRAWS)
def test_bf16_step_matches_jax_bf16_step(runs, video, draw):
    run = runs(video, draw)
    state, logs = run.port[torch.bfloat16]
    ref_g, ref_d = _jax_moments(run)
    _check_step(state, logs, run.jax_logs, ref_g, ref_d, ENCODER_L2_TOL,
                G_L2_TOL)


@pytest.mark.parametrize("video", [False, True], ids=["image", "video"])
@pytest.mark.parametrize("draw", DRAWS)
def test_bf16_step_matches_the_ports_f32_step(runs, video, draw):
    run = runs(video, draw)
    state, logs = run.port[torch.bfloat16]
    ref_state, ref_logs = run.port[torch.float32]
    _check_step(state, logs, ref_logs,
                _port_moments(ref_state.opt_G, ref_state.gen),
                _port_moments(ref_state.opt_D, ref_state.disc),
                ENCODER_L2_TOL, G_L2_TOL)


@pytest.mark.parametrize("video", [False, True], ids=["image", "video"])
@pytest.mark.parametrize("draw", DRAWS)
def test_bf16_step_without_the_singularity(runs, video, draw):
    """Both packages' epsilon at 1e-2: the encoder is well conditioned and
    every group is held to the same relative L2."""
    run = runs(video, draw, eps=1e-2)
    state, logs = run.port[torch.bfloat16]
    ref_g, ref_d = _jax_moments(run)
    _check_step(state, logs, run.jax_logs, ref_g, ref_d, PATCHED_L2_TOL,
                PATCHED_L2_TOL)


def _fake(run):
    """The port's fake under autocast on the run's bfloat16 batch and the
    JAX forward's on the same batch."""
    gen = UNetTMO(gcn_grid=GRID)
    load_state(gen, state_dict_from_flax(jax.tree_util.tree_map(
        np.asarray, run.state0.params_G)))
    hdr = run.batch["hdr"]
    v = {"params": run.state0.params_G}
    x = torch.from_numpy(hdr).permute(0, 1, 4, 2, 3).to(torch.bfloat16)
    with torch.no_grad(), torch.autocast("cpu", torch.bfloat16):
        if run.video:
            out, _ = video_apply(gen, x)
        else:
            out, _ = gen(x.reshape(-1, 1, SIZE, SIZE))
    hx = jnp.asarray(hdr)
    if run.video:
        ref, _ = jax.jit(lambda a: jax_video_apply(run.gen, v, a))(hx)
    else:
        ref, _ = jax.jit(run.gen.apply)(v, hx.reshape(-1, SIZE, SIZE, 1))
    return out, np.asarray(ref).reshape(-1, SIZE, SIZE)


@pytest.mark.parametrize("video", [False, True], ids=["image", "video"])
@pytest.mark.parametrize("draw", DRAWS)
def test_bf16_fake_matches_jax(runs, video, draw):
    """The generator's forward under autocast on a bfloat16 batch against
    the JAX forward of the same batch: relative L2 of the fake."""
    out, ref = _fake(runs(video, draw))
    assert out.dtype == torch.float32        # the head is a float32 island
    err = _rel(out.numpy().reshape(-1, SIZE, SIZE), ref)
    assert err <= FAKE_L2_TOL


if __name__ == "__main__":
    # PYTHONPATH=. JAX_PLATFORMS=cpu python tests/test_torch_bf16_train.py
    # [draws]: the readings the module
    # docstring quotes, at the published epsilon and at 1e-2
    import sys
    jgcn.drop_path = _table_drop_path
    draws = [int(d) for d in (sys.argv[1] if len(sys.argv) > 1
                              else "1,2,3,4,5").split(",")]
    published = jparams.EPSILON
    for eps in (published, 1e-2):
        jparams.EPSILON = tparams.EPSILON = eps
        for video in (False, True):
            side = _jax_side(video)
            for draw in draws:
                run = _Run(video, draw, side)
                state, logs = run.port[torch.bfloat16]
                f32_state, f32_logs = run.port[torch.float32]
                ref_g, ref_d = _jax_moments(run)
                f32_g = _port_moments(f32_state.opt_G, f32_state.gen)
                f32_d = _port_moments(f32_state.opt_D, f32_state.disc)
                out, ref = _fake(run)
                fake = _rel(out.numpy().reshape(-1, SIZE, SIZE), ref)
                rows = {
                    "bf16 vs JAX": _readings(state, logs, run.jax_logs,
                                             ref_g, ref_d),
                    "bf16 vs f32": _readings(state, logs, f32_logs, f32_g,
                                             f32_d),
                    "f32 vs JAX": _readings(f32_state, f32_logs,
                                            run.jax_logs, ref_g, ref_d)}
                print(f"epsilon {eps} {'video' if video else 'image'} "
                      f"draw {draw}: fake {fake:.2e}", flush=True)
                for what, r in rows.items():
                    print(f"  {what}: " + " ".join(
                        f"{k} {v:.2e}" for k, v in r.items()), flush=True)
