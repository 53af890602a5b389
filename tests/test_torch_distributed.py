"""More than one card: the port's data-parallel step, trainer and sharded
engine on the CPU (two gloo processes; JAX as the oracle).

* Two rank processes (`subprocess`, a free port, one torch thread each,
  120 s at most) run the GAN step of the image generator at 112 px
  (`gcn_grid` 3) on a batch of 4, 2 a rank, D on, stages 0-2, and of the
  video generator, a batch-norm generator and a `batchMax` generator at
  stage 0.  Each rank's step must be the one-process port step from the
  same state and batch, with the drop path drawn from the same generator
  (a rank draws the global mask and keeps its rows): logs to 1e-5
  relative; with epsilon 1e-2 on both sides every parameter and Adam
  moment in relative L2 to 1e-4, and at the published epsilon by
  `tests/test_torch_train_step.py`'s two-sided encoder check (that file's
  docstring says why the encoder behind the skips is ill-conditioned).
  The ranks' states must have one digest after every step.
* The batch-norm generator runs `tests/test_torch_batch_norm.py`'s setting
  (192 px, 16 filters, epsilon 1e-2): the running statistics to 1e-5
  relative, the moments in relative L2 to 1e-2 (measured 2.6e-3: that
  file's docstring shows the batch-norm gradient ill-conditioned on its
  own; the formula of the global statistics alone agrees with
  `F.batch_norm` to 2e-7), the conv biases a norm follows (gradient
  exactly zero) as small as that file holds them.
* A batch of 2, one sample a rank, against the JAX step at the shapes and
  tolerances of `tests/test_torch_train_step.py` (JAX's sharded step
  equals its unsharded one: `tests/test_training.py::
  test_train_step_data_parallel`), with that file's drop path table.
* The draw of the image steps is one where the per-rank
  `contrastive_d_loss`, `info_nce2` and `pseudo_label_loss` of a plain DDP
  (each rank on its own rows) average to more than 1e-3 away from the
  global ones: a port without the gathers fails the logs.
* `TileEngine(devices=["cpu", "cpu"])` against JAX's
  `TileEngine(mesh=get_mesh(2))` (`tests/conftest.py`'s virtual CPU
  devices): `run_image`, `run_videos` and a `batchMax` generator, at the
  golden tolerance (5e-5).
* `main_train_image --data_parallel 2 --device cpu`, resumed on two ranks
  from a warm checkpoint, writes after two iterations the one-process
  run's `.pth` within the step tolerances, layer by layer.
"""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import uncltmo_tpu_torch.params as tparams
from uncltmo_tpu_torch.losses import adversarial as adv
from uncltmo_tpu_torch.models.discriminator import SimpleDiscriminator
from uncltmo_tpu_torch.models.unet import (UNetTMO, bottleneck_grid,
                                           seeded_init_)
from uncltmo_tpu_torch.parallel import mesh
from uncltmo_tpu_torch.training import train_step as tstep
from uncltmo_tpu_torch.training.state import TrainState

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TESTS = os.path.join(REPO, "tests")
SIZE = 112
G_LR, D_LR = 1e-5, 1.5e-5
PUBLISHED_EPS = tparams.EPSILON
STRICT_EPS = 1e-2
LOG_RTOL = 1e-5
STATE_L2_TOL = 1e-4          # epsilon 1e-2: parameters and moments
BN_L2_TOL = 1e-2             # the batch-norm generator's moments
BN_STATS_RTOL = 1e-5
ZERO_GRAD_SHARE = 1e-3       # as tests/test_torch_batch_norm.py
DRAW = 21                    # the image steps' batch (per-rank gap > 1e-3)
DROP_SEED = 4                # drops a sample of rank 1 (checked below)
CHILD_TIMEOUT_S = 120


def _batch(seed, b, size=SIZE):
    rng = np.random.default_rng(seed)
    level = np.linspace(0.1, 0.6, 2 * b, dtype=np.float32).reshape(
        b, 2, 1, 1, 1)
    return {"hdr": rng.random((b, 2, size, size, 1), np.float32) * 0.4
            + level,
            "ldr_pos": rng.random((b, 2, size, size, 1), np.float32),
            "ldr_neg": rng.random((b, 2, size, size, 1), np.float32) ** 3}


def _spec(name, stage=0, eps=STRICT_EPS, video=False, gen=None, b=4,
          size=SIZE, seed=DRAW):
    return dict(name=name, stage=stage, eps=eps, video=video,
                gen=gen or {}, size=size, batch=_batch(seed, b, size),
                state=None, masks=None, warm=eps == STRICT_EPS)


SPECS = [_spec("image-s0-published", eps=PUBLISHED_EPS)] + [
    _spec(f"image-s{s}", stage=s) for s in (0, 1, 2)] + [
    _spec("video-s0", video=True),
    _spec("batchmax-s0", gen={"stretch_g": "batchMax"}),
    _spec("batchnorm-s0", gen={"unet_norm": "batch_norm", "filters": 16},
          size=192, seed=1)]


# ------------------------------------------------------------ the scenario
def run_scenario(spec, rank=0, world=1):
    """One step of a scenario on this rank's rows (all of them in one
    process): {logs, params, moments, stats, digest} on the host."""
    size = spec["size"]
    gen = seeded_init_(UNetTMO(gcn_grid=bottleneck_grid(size), **spec["gen"]),
                       1)
    disc = seeded_init_(SimpleDiscriminator(input_size=size), 2)
    if spec["state"] is not None:
        gen.load_state_dict(spec["state"]["gen"])
        disc.load_state_dict(spec["state"]["disc"])
    step = tstep.make_train_step(gen, disc,
                                 tstep.LossConfig(video=spec["video"]),
                                 device="cpu")
    state = TrainState.create(gen, disc)
    if spec["warm"]:
        # a run ten steps old with a flat second moment: the update is
        # smooth in the gradient (`tests/test_torch_train_step.py`)
        for opt, module in ((state.opt_G, gen), (state.opt_D, disc)):
            for p in module.parameters():
                opt.state[p] = {"step": torch.tensor(10.0),
                                "exp_avg": torch.zeros_like(p),
                                "exp_avg_sq": torch.full_like(p, 1e-2)}
    masks = None
    if spec["masks"] is not None:
        n = spec["masks"].shape[1] // world
        masks = iter([torch.from_numpy(row[rank * n:(rank + 1) * n].copy())
                      for row in spec["masks"]])
    eps0 = tparams.EPSILON
    tparams.EPSILON = spec["eps"]
    try:
        state, logs = step(state, mesh.shard_batch(spec["batch"], rank, world),
                           torch.Generator().manual_seed(DROP_SEED), G_LR,
                           D_LR, stage=spec["stage"], drop_masks=masks)
    finally:
        tparams.EPSILON = eps0
    moments = {}
    for opt, module in ((state.opt_G, gen), (state.opt_D, disc)):
        for name, p in module.named_parameters():
            st = opt.state[p]
            moments[name] = (st["exp_avg"].clone(), st["exp_avg_sq"].clone(),
                             float(st["step"]))
    params = {n: p.detach().clone() for m in (gen, disc)
              for n, p in m.named_parameters()}
    stats = {k: v.clone() for k, v in gen.state_dict().items()
             if k.endswith(("running_mean", "running_var"))}
    return dict(logs={k: float(v) for k, v in logs.items()}, params=params,
                moments=moments, stats=stats, step=state.step,
                digest=mesh.state_digest(state))


def rank_main(rank, port, spec_path, out_path):
    """A rank process: join the group, run every scenario, save."""
    torch.set_num_threads(1)
    mesh.initialize_distributed(f"localhost:{port}", 2, rank, "cpu")
    try:
        specs = torch.load(spec_path, weights_only=False)
        torch.save({s["name"]: run_scenario(s, rank, 2) for s in specs},
                   out_path)
    finally:
        mesh.dist.destroy_process_group()


_CHILD = """
import sys
sys.path[:0] = [{repo!r}, {tests!r}]
import test_torch_distributed as t
t.rank_main({rank}, {port}, {spec!r}, {out!r})
"""


def one_main(spec_path, out_path):
    """The one-process reference, in a process of its own at the ranks'
    thread count (torch's kernels sum in another order at another count)."""
    torch.set_num_threads(1)
    specs = torch.load(spec_path, weights_only=False)
    torch.save({s["name"]: run_scenario(s) for s in specs}, out_path)


_ONE = """
import sys
sys.path[:0] = [{repo!r}, {tests!r}]
import test_torch_distributed as t
t.one_main({spec!r}, {out!r})
"""


def _start(tmp, specs, one_specs):
    """The two ranks and the one-process reference, in three processes."""
    spec_path = os.path.join(tmp, "specs.pt")
    one_path = os.path.join(tmp, "one_specs.pt")
    torch.save(specs, spec_path)
    torch.save(one_specs, one_path)
    port = mesh.free_port()
    env = {k: v for k, v in os.environ.items()
           if k not in ("XLA_FLAGS", "JAX_PLATFORMS")}
    env["OMP_NUM_THREADS"] = "1"
    codes = [_CHILD.format(repo=REPO, tests=TESTS, rank=r, port=port,
                           spec=spec_path,
                           out=os.path.join(tmp, f"rank{r}.pt"))
             for r in range(2)]
    codes.append(_ONE.format(repo=REPO, tests=TESTS, spec=one_path,
                             out=os.path.join(tmp, "one.pt")))
    return [subprocess.Popen(
        [sys.executable, "-c", code], env=env, cwd=REPO,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for code in codes]


def _finish(tmp, procs):
    """[rank 0's, rank 1's, the one process's] results."""
    outs = []
    try:
        for name, p in zip(("rank0", "rank1", "one"), procs):
            out, _ = p.communicate(timeout=CHILD_TIMEOUT_S)
            assert p.returncode == 0, f"{name} failed:\n{out[-3000:]}"
            outs.append(torch.load(os.path.join(tmp, f"{name}.pt"),
                                   weights_only=False))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait(timeout=10)
    return outs


def _jax_spec():
    """The batch-of-2 scenario from the JAX initial state of
    `tests/test_torch_train_step.py` (its `_Side`), with its mask table,
    and the JAX step's result."""
    import test_torch_train_step as tts
    from uncltmo_tpu_torch.utils.convert import train_state_from_flax
    side = tts._Side(False)
    gen = UNetTMO(gcn_grid=bottleneck_grid(SIZE))
    disc = SimpleDiscriminator(input_size=SIZE)
    port = train_state_from_flax(side.state0, gen, disc)
    spec = _spec("jax-s0", eps=PUBLISHED_EPS, b=2)
    spec["batch"] = tts._batch(1)
    spec["state"] = {"gen": port.gen.state_dict(),
                     "disc": port.disc.state_dict()}
    spec["masks"] = tts.MASKS[:side.n_masks, :side.mask_batch].copy()
    return spec, side


@pytest.fixture(scope="module")
def steps(tmp_path_factory):
    """{name: (one-process result, [rank 0's, rank 1's])}, and the JAX
    scenario's (side, JAX state, JAX logs)."""
    import jax
    import jax.numpy as jnp
    import test_torch_train_step as tts
    from uncltmo_tpu.models import gcn as jgcn
    tmp = str(tmp_path_factory.mktemp("ranks"))
    patch = pytest.MonkeyPatch()
    patch.setattr(jgcn, "drop_path", tts._table_drop_path)
    try:
        jax_spec, side = _jax_spec()
        procs = _start(tmp, SPECS + [jax_spec], SPECS)
        try:
            tts._calls["n"] = 0
            ref_state, ref_logs = side.step(
                side.state0, {k: jnp.asarray(v)
                              for k, v in jax_spec["batch"].items()},
                jax.random.PRNGKey(0), G_LR, D_LR, stage=0)
        finally:
            r0, r1, one = _finish(tmp, procs)
    finally:
        patch.undo()
    results = {n: (one.get(n), [r0[n], r1[n]]) for n in r0}
    return results, (ref_state, ref_logs)


# ---------------------------------------------------------------- checks
def _rel_l2(a, b):
    return float(torch.linalg.norm(a - b) / max(torch.linalg.norm(b), 1e-30))


def _before_a_norm(name):
    return name.endswith(("conv.bias", "conv1.bias")) and \
        name != "outc.conv.bias"


def _assert_logs(got, want):
    """Losses and statistics to 1e-5 relative, the gradient logs (means of
    |g| over a layer) to the gradients' 1e-4."""
    assert sorted(got) == sorted(want)
    for k in want:
        rtol = STATE_L2_TOL if k.startswith("gradG/") else LOG_RTOL
        assert got[k] == pytest.approx(want[k], rel=rtol, abs=1e-7), k


def _assert_same_ranks(ranks):
    assert ranks[0]["digest"] == ranks[1]["digest"]
    assert ranks[0]["logs"] == ranks[1]["logs"]


def _assert_strict(got, want, tol=STATE_L2_TOL):
    """Every parameter and both moments in relative L2 (D's
    `model.4.bias`, a common shift of the logits that the relativistic loss
    does not see, is rounding noise: held below 1e-5 instead)."""
    for name, (m, v, count) in want["moments"].items():
        gm, gv, gcount = got["moments"][name]
        assert gcount == count, name
        if name == "model.4.bias":
            assert max(m.abs().max(), gm.abs().max()) < 1e-5
            continue
        for a, b in ((got["params"][name], want["params"][name]), (gm, m),
                     (gv, v)):
            assert _rel_l2(a, b) <= tol, (name, _rel_l2(a, b))


def _assert_two_sided(got, want):
    """`tests/test_torch_train_step.py`'s check at the published epsilon:
    the encoder behind the skips in relative L2 and entry by entry, the
    rest of G entry by entry to G_TOL of max-abs, D to D_TOL."""
    import test_torch_train_step as tts
    for name, (m, v, _) in want["moments"].items():
        gm, gv, _ = got["moments"][name]
        if name == "model.4.bias":
            continue
        encoder = name.startswith(tts.ENCODER)
        d = name.startswith(("model.", "tail."))
        tol = tts.D_TOL if d else max(tts.G_TOL, tts.ENCODER_TOL) \
            if encoder else tts.G_TOL
        for power, a, b in ((1, gm, m), (2, gv, v)):
            scale = power if encoder else 1
            assert float((a - b).abs().max()) <= scale * tol * max(
                float(b.abs().max()), 1e-30), name
            if encoder:
                assert _rel_l2(a, b) <= scale * tts.ENCODER_L2_TOL["image"], \
                    name


def test_the_drop_path_draw_drops_a_sample_of_each_rank():
    """The steps' drop path generator drops at least one frame in each
    rank's rows: the global draw and its slicing are exercised."""
    g = torch.Generator().manual_seed(DROP_SEED)
    draws = torch.stack([torch.rand(8, generator=g) for _ in range(4)])
    dropped = draws >= 0.95
    assert dropped[:, :4].any() and dropped[:, 4:].any()


@pytest.mark.parametrize("name", ["image-s0", "image-s1", "image-s2"])
def test_two_ranks_take_the_one_process_step(steps, name):
    """Epsilon 1e-2 on both sides: logs to 1e-5, every parameter and Adam
    moment in relative L2 to 1e-4, one digest on both ranks."""
    results, _ = steps
    one, ranks = results[name]
    _assert_same_ranks(ranks)
    _assert_logs(ranks[0]["logs"], one["logs"])
    _assert_strict(ranks[0], one)
    assert ranks[0]["step"] == one["step"] == 1


def test_two_ranks_at_the_published_epsilon(steps):
    results, _ = steps
    one, ranks = results["image-s0-published"]
    _assert_same_ranks(ranks)
    _assert_logs(ranks[0]["logs"], one["logs"])
    _assert_two_sided(ranks[0], one)


@pytest.mark.parametrize("name", ["video-s0", "batchmax-s0"])
def test_two_ranks_video_and_batch_max(steps, name):
    results, _ = steps
    one, ranks = results[name]
    _assert_same_ranks(ranks)
    _assert_logs(ranks[0]["logs"], one["logs"])
    _assert_strict(ranks[0], one)


def test_two_ranks_batch_norm_statistics(steps):
    """The global batch's statistics, two momentum updates a step, on both
    ranks alike; the moments within the batch-norm generator's own
    conditioning (module docstring)."""
    results, _ = steps
    one, ranks = results["batchnorm-s0"]
    _assert_same_ranks(ranks)
    _assert_logs(ranks[0]["logs"], one["logs"])
    assert one["stats"]
    for k, want in one["stats"].items():
        got = ranks[0]["stats"][k]
        assert float((got - want).abs().max()) <= BN_STATS_RTOL * float(
            want.abs().max()), k
    for name, (m, _, _) in one["moments"].items():
        gm = ranks[0]["moments"][name][0]
        if name == "model.4.bias":
            continue
        if _before_a_norm(name):
            w = one["moments"][name[:-len("bias")] + "weight"][0]
            assert float(gm.abs().max()) <= ZERO_GRAD_SHARE * float(
                w.abs().max()), name
            continue
        assert _rel_l2(gm, m) <= BN_L2_TOL, (name, _rel_l2(gm, m))


def test_two_ranks_match_the_jax_step(steps):
    """A batch of 2 (one sample a rank) against the JAX step at
    `tests/test_torch_train_step.py`'s tolerances."""
    import test_torch_train_step as tts
    from uncltmo_tpu_torch.utils.convert import (
        discriminator_state_dict_from_flax, state_dict_from_flax)
    import jax
    results, (ref_state, ref_logs) = steps
    _, ranks = results["jax-s0"]
    _assert_same_ranks(ranks)
    got = ranks[0]
    tts._assert_logs(got["logs"], ref_logs)
    for adam, to_sd, tol in (
            (ref_state.opt_state_D, discriminator_state_dict_from_flax,
             tts.D_TOL),
            (ref_state.opt_state_G, state_dict_from_flax, tts.G_TOL)):
        mu = to_sd(jax.tree_util.tree_map(np.asarray, adam.mu))
        nu = to_sd(jax.tree_util.tree_map(np.asarray, adam.nu))
        for name in got["moments"]:
            if name not in mu:
                continue                     # the other module's
            gm, gv, count = got["moments"][name]
            assert count == int(adam.count)
            if name == "model.4.bias":
                continue
            encoder = name.startswith(tts.ENCODER)
            limit = max(tol, tts.ENCODER_TOL) if encoder else tol
            for power, a, b in ((1, gm.numpy(), mu[name]),
                                (2, gv.numpy(), nu[name])):
                scale = power if encoder else 1
                assert np.abs(a - b).max() <= scale * limit * max(
                    np.abs(b).max(), 1e-30), name
                if encoder:
                    l2 = np.linalg.norm(a - b) / np.linalg.norm(b)
                    assert l2 <= scale * tts.ENCODER_L2_TOL["image"], name
    assert got["step"] == int(ref_state.step)


def test_per_rank_losses_differ_from_the_global_ones():
    """On the image steps' draw, each rank's own `contrastive_d_loss`,
    `info_nce2` and `pseudo_label_loss` (a plain DDP's) average to more
    than 1e-3 away from the global loss the steps above hold."""
    spec = SPECS[1]
    gen = seeded_init_(UNetTMO(gcn_grid=bottleneck_grid(SIZE)), 1)
    disc = seeded_init_(SimpleDiscriminator(input_size=SIZE), 2)
    b = spec["batch"]
    to = lambda x: torch.from_numpy(x).reshape(  # noqa: E731
        -1, SIZE, SIZE, 1).permute(0, 3, 1, 2)
    with torch.no_grad():
        fake, fea = gen(to(b["hdr"]))
        real_logits, _ = disc(to(b["ldr_pos"]))
        fake_logits, _ = disc(fake)
    halves = lambda x: x.chunk(2)  # noqa: E731
    terms = {
        "contrastive_d_loss": lambda r, f, x, y: adv.contrastive_d_loss(r, f),
        "info_nce2": lambda r, f, x, y: adv.info_nce2(y, x, 1.0, 1e-2),
        "pseudo_label_loss": lambda r, f, x, y: adv.pseudo_label_loss(x)}
    for name, fn in terms.items():
        whole = float(fn(real_logits, fake_logits, fake, fea))
        per_rank = np.mean([float(fn(*parts)) for parts in zip(
            halves(real_logits), halves(fake_logits), halves(fake),
            halves(fea))])
        assert abs(per_rank - whole) > 1e-3 * abs(whole), name


# ------------------------------------------------------- the sharded engine
def _golden_models(stretch="none"):
    import jax
    import jax.numpy as jnp
    from uncltmo_tpu.models.unet import UNetTMO as JaxUNet
    from uncltmo_tpu_torch.utils.convert import (load_state,
                                                 state_dict_from_flax)
    jgen = JaxUNet(gcn_grid=4, stretch_g=stretch)
    v = jax.jit(jgen.init)(jax.random.PRNGKey(0),
                           jnp.zeros((1, 128, 128, 1)))
    sd = state_dict_from_flax(jax.tree_util.tree_map(np.asarray,
                                                     v["params"]))
    return jgen, v, load_state(UNetTMO(gcn_grid=4, stretch_g=stretch), sd)


@pytest.mark.parametrize("case", ["image", "videos", "batchmax-image",
                                  "batchmax-videos"])
def test_sharded_engine_matches_jax_mesh(case):
    """The tile batch split over two devices against JAX's engine over a
    2-device mesh (chunk granularity 2: nine tiles run as ten, one of them
    a zero tile that batchMax's max sees), and against the one-device
    port engine, at the golden tolerance."""
    import jax.numpy as jnp
    from uncltmo_tpu.inference.engine import TileEngine as JaxEngine
    from uncltmo_tpu.parallel import mesh as jmesh
    from uncltmo_tpu_torch.inference.engine import TileEngine
    jgen, v, gen = _golden_models("batchMax" if "batchmax" in case
                                  else "none")
    kw = dict(tile=128, overlap=32)
    rng = np.random.default_rng(4)
    jeng = JaxEngine(jgen, v, mesh=jmesh.get_mesh(2), **kw)
    eng = TileEngine(gen, devices=["cpu", "cpu"], **kw)
    one = TileEngine(gen, device="cpu", **kw)
    assert len(eng.models) == 2 and eng._chunk_for(9) == 10
    if case.endswith("image"):
        x = rng.random((224, 224, 1), np.float32)       # 3 x 3 tiles
        ref = np.asarray(jeng.run_image(jnp.asarray(x)))
        out = eng.run_image(torch.from_numpy(x)).numpy()
    else:
        x = rng.random((2, 2, 128, 160, 1), np.float32)  # 2 scenes x 2 tiles
        ref = np.asarray(jeng.run_videos(jnp.asarray(x)))
        out = eng.run_videos(torch.from_numpy(x)).numpy()
        single = one.run_videos(torch.from_numpy(x)).numpy()
        np.testing.assert_allclose(out, single, rtol=5e-5, atol=5e-5)
    np.testing.assert_allclose(out, ref, rtol=5e-5, atol=5e-5)


def test_sharded_engine_keeps_its_copies_in_step():
    from uncltmo_tpu_torch.inference.engine import TileEngine
    gen = seeded_init_(UNetTMO(gcn_grid=4), 3)
    eng = TileEngine(gen, tile=128, overlap=32, devices=["cpu", "cpu"])
    new = seeded_init_(UNetTMO(gcn_grid=4), 5).state_dict()
    eng.update_variables(new)
    for m in eng.models:
        for k, t in m.state_dict().items():
            assert torch.equal(t, new[k]), k
    with pytest.raises(ValueError, match="3-device mesh"):
        TileEngine(gen, devices=mesh.get_mesh(3, ["cpu", "cpu"]))


# ------------------------------------------------------------ the helpers
def test_mesh_helpers_keep_the_jax_names_and_rules(monkeypatch):
    assert mesh.get_mesh(2, ["cpu", "cpu", "cpu"]) == [torch.device("cpu")] * 2
    batch = {"hdr": np.arange(8).reshape(4, 2)}
    np.testing.assert_array_equal(mesh.shard_batch(batch, 1, 2)["hdr"],
                                  [[4, 5], [6, 7]])
    with pytest.raises(ValueError, match="not divisible by 3 ranks"):
        mesh.shard_batch(batch, 0, 3)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    assert mesh.resolve_data_parallel(0, 8, "cuda") == 4
    assert mesh.resolve_data_parallel(0, 6, "cuda") == 1
    assert mesh.resolve_data_parallel(0, 8, "cpu") == 1
    assert mesh.resolve_data_parallel(3, 6, "cpu") == 3
    assert mesh.backend_for("cuda", 4) == "nccl"
    assert mesh.backend_for("cuda", 5) == "gloo"
    assert mesh.backend_for("cpu", 2) == "gloo"
    with pytest.raises(ValueError, match="only 4 devices are visible"):
        mesh.resolve_data_parallel(8, 8, "cuda")
    # a trainer outside a group is one process; a count is its group's
    assert mesh.trainer_data_parallel(0, 8, "cuda") == 1
    with pytest.raises(ValueError, match="this process group has 1"):
        mesh.trainer_data_parallel(2, 8, "cuda")
    # one process: every collective is the identity
    x = torch.arange(6.0).reshape(3, 2).requires_grad_()
    assert mesh.all_gather_batch(x) is x
    assert torch.equal(mesh.gather_rows(x, torch.tensor([2, 0])), x[[2, 0]])
    assert mesh.rank_world() == (0, 1)


# ------------------------------------------------------------ the CLI
_LAUNCHER = """
import sys
sys.path.insert(0, {repo!r})
import uncltmo_tpu_torch.params as P
P.EPSILON = {eps!r}     # read again by every spawned rank
from uncltmo_tpu_torch.cli import main_train_image
if __name__ == "__main__":
    main_train_image.main(sys.argv[1:])
"""


def _write_npy_dirs(root):
    """Four training items with `SyntheticDataSource`'s value ranges (a
    squared-uniform HDR to 3000 at lambda 400, uniform LDR): there the
    one-process step agrees with itself at one and four threads to 5e-4,
    and the two ranks with one process at one thread to 1.2e-5.  (Uniform
    noise to 200 at lambda 20, `tests/test_torch_trainer.py`'s pools, makes
    the step ill-conditioned on its own: the ranks then differ from one
    process by as much as one process at another thread count, 5e-4.)"""
    rng = np.random.default_rng(7)
    for pool in ("hdr", "ldr", "neg"):
        (root / pool).mkdir()
    for i in range(4):
        np.save(root / "hdr" / f"hdr{i}.npy",
                (rng.random((SIZE, SIZE, 3), np.float32) ** 2) * 3000)
        np.save(root / "ldr" / f"ldr{i}.npy",
                rng.random((SIZE, SIZE, 3), np.float32) * 255)
        np.save(root / "neg" / f"neg{i}.npy",
                rng.random((SIZE, SIZE, 3), np.float32) * 128)
    np.save(root / "lam.npy", {f"hdr{i}": 400.0 for i in range(4)})
    return dict(data_root_npy=str(root / "hdr"),
                data_root_ldr=str(root / "ldr"),
                neg_ldr_root=str(root / "neg"),
                f_train_dict_path=str(root / "lam.npy"))


def _cli_args(data, out, epochs):
    args = ["--device", "cpu", "--train_input_size", str(SIZE),
            "--batch_size", "2", "--num_epochs", str(epochs),
            "--d_pretrain_epochs", "0", "--filters", "8", "--d_down_dim",
            "8", "--result_dir_prefix", str(out),
            "--test_dataroot_original_hdr", "none", "--data_workers", "1"]
    for k, v in data.items():
        args += [f"--{k}", v]
    return args


def _warm_checkpoint(data, out):
    """The trainer's initial state with warm Adam states (ten steps old, a
    flat second moment: the update is smooth in the gradient,
    `tests/test_torch_train_step.py`), saved as the checkpoint of
    iteration 0 that `--checkpoint 1` resumes from."""
    from uncltmo_tpu_torch.cli import main_train
    from uncltmo_tpu_torch.training.trainer import GanTrainer
    from uncltmo_tpu_torch.utils import checkpoint as ckpt
    opt, _ = main_train.parse(_cli_args(data, out, 1))
    trainer = GanTrainer(opt, video=False, device="cpu")
    st = trainer.state
    for adam, module in ((st.opt_G, st.gen), (st.opt_D, st.disc)):
        for p in module.parameters():
            adam.state[p] = {"step": torch.tensor(10.0),
                             "exp_avg": torch.zeros_like(p),
                             "exp_avg_sq": torch.full_like(p, 1e-2)}
    ckpt.save_train_state(os.path.join(str(out), "models"), 0, 0, st,
                          extra_meta={"num_iter": 0})


def _pth(out, epoch, it):
    return torch.load(os.path.join(str(out), "models",
                                   f"net_epoch{epoch}_iter{it}.pth"),
                      weights_only=True)


def _layer(name):
    """The top-level module of a parameter: `down_path.0`, `gcn`, `outc`,
    D's `model.0`, ..."""
    parts = name.split(".")
    return ".".join(parts[:2] if parts[0] in ("down_path", "up_path",
                                              "model", "tail") else parts[:1])


def _by_layer(tensors):
    """{top-level module: its tensors flattened into one}."""
    layers = {}
    for k, t in tensors.items():
        if k != "model.4.bias":              # rounding noise, see above
            layers.setdefault(_layer(k), []).append(t.float().reshape(-1))
    return {k: torch.cat(v) for k, v in layers.items()}


def _assert_same_pth(got, want):
    """The parameters and both Adam moments layer by layer (the unit of the
    `gradG/*` logs) in relative L2 to 1e-4.  Layer by layer, because the
    output head's bias takes the sum of the upstream gradient over every
    output pixel, which the shift-invariant structural loss cancels to
    1e-4 of its layer's gradient: one process differs from itself by 4e-3
    there at another thread count."""
    for key in ("modelG_state_dict", "modelD_state_dict"):
        a, b = _by_layer(got[key]), _by_layer(want[key])
        for layer in b:
            assert _rel_l2(a[layer], b[layer]) <= STATE_L2_TOL, (key, layer)
    for key, module in (("optimizerG_state_dict", "modelG_state_dict"),
                        ("optimizerD_state_dict", "modelD_state_dict")):
        # Adam's state is indexed in the order of the module's parameters
        names = [k for k in want[module]
                 if not k.endswith(("running_mean", "running_var",
                                    "num_batches_tracked", "relative_pos"))]
        sw, sg = want[key]["state"], got[key]["state"]
        assert sorted(sw) == sorted(sg) == list(range(len(names)))
        for m in ("exp_avg", "exp_avg_sq"):
            a = _by_layer({n: sg[i][m] for i, n in enumerate(names)})
            b = _by_layer({n: sw[i][m] for i, n in enumerate(names)})
            for layer in b:
                assert _rel_l2(a[layer], b[layer]) <= STATE_L2_TOL, \
                    (key, m, layer)
        assert all(float(sg[i]["step"]) == float(sw[i]["step"]) for i in sw)
    assert got["step"] == want["step"]


def test_training_cli_on_two_ranks_writes_the_one_process_pth(tmp_path):
    """Two iterations on two gloo ranks (epsilon 1e-2 in every process)
    against one process, both resumed from one warm checkpoint: every rank
    loads it (a rank that did not would average other gradients in).  The
    same two ranks started by torchrun write the same `.pth`."""
    launcher = tmp_path / "launch.py"
    launcher.write_text(_LAUNCHER.format(repo=REPO, eps=STRICT_EPS))
    data = _write_npy_dirs(tmp_path)
    env = dict(os.environ, OMP_NUM_THREADS="1")
    env.pop("XLA_FLAGS", None)
    torchrun = [sys.executable, "-m", "torch.distributed.run",
                "--nproc_per_node", "2", "--master_port",
                str(mesh.free_port()), str(launcher)]
    runs = {}
    for out, cmd in (("one", [sys.executable, str(launcher)]),
                     ("two", [sys.executable, str(launcher),
                              "--data_parallel", "2"]),
                     ("torchrun", torchrun)):
        _warm_checkpoint(data, tmp_path / out)
        runs[out] = subprocess.Popen(
            cmd + ["--checkpoint", "1"] + _cli_args(data, tmp_path / out, 1),
            env=env, cwd=REPO, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True)
    logs = {}
    try:
        for out, p in runs.items():
            logs[out], _ = p.communicate(timeout=CHILD_TIMEOUT_S)
            assert p.returncode == 0, logs[out][-3000:]
    finally:
        for p in runs.values():
            if p.poll() is None:
                p.kill()
    assert logs["two"].count("restored checkpoint") == 1   # rank 0 prints
    _assert_same_pth(_pth(tmp_path / "two", 0, 2),
                     _pth(tmp_path / "one", 0, 2))
    assert not (tmp_path / "two" / "models" / "net_epoch1_iter1.pth").exists()
    # the ranks that torchrun starts join its group: the same run, bit for
    # bit (`data_parallel` 0 takes the group's size)
    got, want = (_pth(tmp_path / "torchrun", 0, 2),
                 _pth(tmp_path / "two", 0, 2))
    for key in ("modelG_state_dict", "modelD_state_dict"):
        for k, w in want[key].items():
            assert torch.equal(got[key][k], w), (key, k)
