"""Batch-norm training and serving against the JAX package (CPU).

* One image step and one video step of a `unet_norm='batch_norm'`
  generator against the JAX step with its `stats_G` (models:
  `tests/test_trainer.py:161,195`), in `tests/test_torch_train_step.py`'s
  setting (B = 2, the drop path from one table on both sides, both
  packages' skip epsilon patched to 1e-2), on draws 1 and 4.  The size
  is 192 px at 16 filters: the bottleneck's norm then normalises over
  B x 6 x 6 values a channel (at 112 px it saw B x 1 x 1 = 2, where batch
  norm outputs +-1 whatever its input and its gradient is rounding noise).
  Losses are held at 1e-4 relative (`gradG/*` 2e-3) and the running
  statistics at 1e-5.  The Adam moments are held parameter by parameter in
  relative L2, not entry by entry, because the batch-norm generator's
  float32 gradient is ill-conditioned on its own: JAX against JAX on the
  same draw, with the HDR input moved by one ulp, moves single entries of
  the moments by as much as the port differs from JAX, at the same
  parameters (video draw 6: `down_path.3`'s conv1 weight 0.14 of its
  max-abs on both comparisons; image draw 3: the encoder 0.11 on both;
  image draw 4: D's `model.2.bias` 1.4e-2 against the port's 1.7e-2), and
  the port's own readings move with torch's thread count.  Readings of
  the `__main__` below over draws 1-6, image and video, at the default
  thread count and at `OMP_NUM_THREADS=3`: losses 3.2e-5 (`gradG/*`
  9.4e-4), statistics 2.8e-6; per-parameter relative L2 of the moments,
  port against JAX / JAX against JAX with one ulp, at most 2.7e-2 / 6.7e-2
  around the bottleneck (`down_path.3`, the GCN, `up_path.0`,
  `up_path.1`), 2.6e-2 / 5.0e-2 in the encoder behind the skips (ROADMAP
  Queue 3), 8.1e-3 / 2.1e-2 in the rest of the decoder and the head, and
  1.2e-2 / 2.9e-2 in D.  The limits, 8e-2, 6e-2, 3e-2 and 4e-2, lie above
  both: the port is not asked to be closer to JAX than JAX is to itself.
  The conv biases that a batch norm follows have a gradient of exactly
  zero, so their moments are rounding noise on both sides: they are held
  to be that small instead.
* The running statistics move twice a step (the D phase's generator
  forward, then the G phase's from there; frame by frame for the video
  generator) and are held at 1e-5 relative (measured up to 2.8e-6; a
  single forward is held at 1e-6 in `tests/test_torch_options.py`).
* A batch-norm `GanTrainer` run killed mid-epoch and resumed from disk
  ends bit for bit where the unbroken run ends, running statistics
  included; the statistics advance, and the sample grid serves with them.
* A batch-norm `.pth` written by the JAX exporter, served by the port's
  `InferenceRunner`, gives the JAX runner's PNG within one level.
"""
import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import uncltmo_tpu.params as jparams
import uncltmo_tpu_torch.params as tparams
from uncltmo_tpu.config import get_model_params as jax_model_params
from uncltmo_tpu.inference.runner import InferenceRunner as JaxRunner
from uncltmo_tpu.models import gcn as jgcn
from uncltmo_tpu.models.discriminator import (
    SimpleDiscriminator as JaxSimpleD)
from uncltmo_tpu.models.unet import UNetTMO as JaxUNet
from uncltmo_tpu.training import state as jstate
from uncltmo_tpu.training import train_step as jstep
from uncltmo_tpu.utils.export_torch import save_reference_checkpoint
from uncltmo_tpu_torch.config import (Options, create_output_dirs,
                                      get_model_params, save_run_settings)
from uncltmo_tpu_torch.data.pipeline import SyntheticDataSource
from uncltmo_tpu_torch.inference.runner import InferenceRunner
from uncltmo_tpu_torch.models.discriminator import SimpleDiscriminator
from uncltmo_tpu_torch.models.unet import UNetTMO, bottleneck_grid
from uncltmo_tpu_torch.training import train_step as tstep
from uncltmo_tpu_torch.training.trainer import GanTrainer
from uncltmo_tpu_torch.utils import checkpoint as ckpt
from uncltmo_tpu_torch.utils.convert import (
    discriminator_state_dict_from_flax, state_dict_from_flax,
    train_state_from_flax)
from uncltmo_tpu_torch.utils.io import read_png, write_radiance_hdr

SIZE = 112                 # of the trainer runs
STEP_SIZE, STEP_FILTERS = 192, 16
DRAWS = (1, 4)             # 4: the largest of D's readings
G_LR, D_LR = 1e-5, 1.5e-5
LOG_RTOL = 1e-4
GRAD_LOG_RTOL = 2e-3
STATS_RTOL = 1e-5
ZERO_GRAD_SHARE = 1e-3     # a pre-norm bias moment, of its conv's weight's
# the Adam moments, parameter by parameter in relative L2, by where they
# sit (module docstring)
AROUND_BOTTLENECK = ("down_path.3.", "gcn.", "up_path.0.", "up_path.1.")
ENCODER = ("inc.", "down_path.0.", "down_path.1.", "down_path.2.")
L2_TOL = {"bottleneck": 8e-2, "encoder": 6e-2, "decoder": 3e-2, "D": 4e-2}

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


@pytest.fixture(scope="module")
def table_drop_path():
    patch = pytest.MonkeyPatch()
    patch.setattr(jgcn, "drop_path", _table_drop_path)
    yield
    patch.undo()


def _batch(seed, size, b=2):
    rng = np.random.default_rng(seed)
    level = np.linspace(0.1, 0.6, 2 * b, dtype=np.float32).reshape(
        b, 2, 1, 1, 1)
    return {"hdr": rng.random((b, 2, size, size, 1), np.float32) * 0.4 + level,
            "ldr_pos": rng.random((b, 2, size, size, 1), np.float32),
            "ldr_neg": rng.random((b, 2, size, size, 1), np.float32) ** 3}


def _stats(sd):
    return {k: np.asarray(v) for k, v in sd.items()
            if k.endswith(("running_mean", "running_var"))}


def _tree(x):
    return jax.tree_util.tree_map(np.asarray, x)


@functools.lru_cache(maxsize=None)
def _jax_side(video):
    """The JAX generator's initial state and its jitted step, once for each
    generator (the draws share the compilation; epsilon 1e-2 when traced)."""
    gen = JaxUNet(gcn_grid=bottleneck_grid(STEP_SIZE), filters=STEP_FILTERS,
                  unet_norm="batch_norm")
    disc = JaxSimpleD(input_size=STEP_SIZE)
    kg, kd = jax.random.split(jax.random.PRNGKey(1))
    zeros = jnp.zeros((1, STEP_SIZE, STEP_SIZE, 1))
    g = jax.jit(gen.init)(kg, zeros)
    state0 = jstate.TrainState.create(
        g["params"], jax.jit(disc.init)(kd, zeros)["params"],
        stats_G=g["batch_stats"])
    return state0, jstep.make_train_step(gen, disc,
                                         jstep.LossConfig(video=video))


def _jax_step(video, batch):
    state0, step = _jax_side(video)
    _calls["n"] = 0
    return step(state0, {k: jnp.asarray(v) for k, v in batch.items()},
                jax.random.PRNGKey(0), G_LR, D_LR, stage=0)


def _port_step(video, batch):
    """The port's step from the JAX initial state: (state, logs)."""
    pg = UNetTMO(gcn_grid=bottleneck_grid(STEP_SIZE), filters=STEP_FILTERS,
                 unet_norm="batch_norm")
    pd = SimpleDiscriminator(input_size=STEP_SIZE)
    step = tstep.make_train_step(pg, pd, tstep.LossConfig(video=video),
                                 device="cpu")
    state = train_state_from_flax(_jax_side(video)[0], pg, pd)
    n, b = (8, 2) if video else (4, 4)
    masks = iter([torch.from_numpy(MASKS[i, :b].copy()) for i in range(n)])
    return step(state, batch, torch.Generator(), G_LR, D_LR, stage=0,
                drop_masks=masks)


def _group(name):
    if name.startswith(("model.", "tail.")):
        return "D"
    if name.startswith(AROUND_BOTTLENECK):
        return "bottleneck"
    return "encoder" if name.startswith(ENCODER) else "decoder"


def _rel_l2(got, want):
    return np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30)


def _jax_moments(state):
    """A JAX state's Adam first moments, G's and D's, by the port's names."""
    return {**state_dict_from_flax(_tree(state.opt_state_G.mu)),
            **discriminator_state_dict_from_flax(_tree(state.opt_state_D.mu))}


def _moment_errors(got, want):
    """{name: (entry-by-entry error of max-abs, relative L2)} over the
    moments that carry a gradient: `model.4.bias` is a common shift of the
    logits (rounding noise) and a conv bias that a batch norm follows has a
    zero gradient (`_before_a_norm`)."""
    out = {}
    for name, got_m in got.items():
        if name == "model.4.bias" or _before_a_norm(name):
            continue
        want_m = want[name]
        out[name] = (np.abs(got_m - want_m).max()
                     / max(np.abs(want_m).max(), 1e-30),
                     _rel_l2(got_m, want_m))
    return out


def _before_a_norm(name):
    return name.endswith(("conv.bias", "conv1.bias")) and \
        name != "outc.conv.bias"


def _port_moments(state):
    return {n: opt.state[p]["exp_avg"].numpy()
            for opt, module in ((state.opt_G, state.gen),
                                (state.opt_D, state.disc))
            for n, p in module.named_parameters()}


@pytest.mark.parametrize("video", [False, True], ids=["image", "video"])
@pytest.mark.parametrize("draw", DRAWS)
def test_batch_norm_step_matches_jax(table_drop_path, monkeypatch, video,
                                     draw):
    monkeypatch.setattr(jparams, "EPSILON", 1e-2)
    monkeypatch.setattr(tparams, "EPSILON", 1e-2)
    batch = _batch(draw, STEP_SIZE)
    ref, ref_logs = _jax_step(video, batch)
    state, logs = _port_step(video, batch)

    for k in ref_logs:
        rtol = GRAD_LOG_RTOL if k.startswith("gradG/") else LOG_RTOL
        np.testing.assert_allclose(float(logs[k]), float(ref_logs[k]),
                                   rtol=rtol, atol=1e-7, err_msg=k)
    # the running statistics after two momentum updates (four for video)
    state0 = _jax_side(video)[0]
    want = _stats(state_dict_from_flax(_tree(ref.params_G),
                                       stats=_tree(ref.stats_G)))
    start = _stats(state_dict_from_flax(_tree(state0.params_G),
                                        stats=_tree(state0.stats_G)))
    got = _stats(state.gen.state_dict())
    assert sorted(got) == sorted(want) and len(got) == 2 * 2 * 9
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=STATS_RTOL,
                                   atol=STATS_RTOL, err_msg=k)
        assert not np.allclose(want[k], start[k]), k
    assert int(state.gen.inc.conv.norm.num_batches_tracked) == (
        4 if video else 2)
    # both Adam states
    mine = _port_moments(state)
    mu = _jax_moments(ref)
    for name, got_m in mine.items():
        if _before_a_norm(name):
            # a batch norm follows: the gradient is zero
            w = np.abs(mu[name[:-len("bias")] + "weight"]).max()
            assert np.abs(got_m).max() <= ZERO_GRAD_SHARE * w, name
            assert np.abs(mu[name]).max() <= ZERO_GRAD_SHARE * w, name
    for name, (_, l2) in _moment_errors(mine, mu).items():
        assert l2 <= L2_TOL[_group(name)], (name, l2)


def _moved_by_one_ulp(batch, seed):
    moved = dict(batch)
    sign = np.random.default_rng(seed).choice([-1.0, 1.0],
                                              batch["hdr"].shape)
    moved["hdr"] = (batch["hdr"] * (1.0 + sign * 2.0 ** -23)).astype(
        np.float32)
    return moved


def test_the_batch_norm_gradient_is_ill_conditioned_in_float32(
        table_drop_path, monkeypatch):
    """JAX against JAX, video draw 1, the HDR input moved by one ulp: the
    moments around the bottleneck move by more than 3e-2 of their max-abs
    entry by entry, three times the float32 limit of
    `tests/test_torch_train_step.py`, which is why
    `test_batch_norm_step_matches_jax` holds the port in relative L2."""
    monkeypatch.setattr(jparams, "EPSILON", 1e-2)
    batch = _batch(1, STEP_SIZE)
    a, _ = _jax_step(True, batch)
    b, _ = _jax_step(True, _moved_by_one_ulp(batch, 101))
    errs = _moment_errors(_jax_moments(b), _jax_moments(a))
    assert max(e for k, (e, _) in errs.items()
               if _group(k) == "bottleneck") > 3e-2


def _opt(out, **kw):
    base = dict(batch_size=2, num_epochs=2, d_pretrain_epochs=0, G_lr=1e-4,
                D_lr=1.5e-4, lr_decay_step=50, loss_g_d_factor=0.1,
                pyramid_weight_list="0.2,0.4,0.6", adv_weight_list="1,1,0",
                log_every=1, train_input_size=SIZE, filters=8,
                d_down_dim=8, unet_norm="batch_norm",
                result_dir_prefix=str(out), output_dir=str(out),
                data_workers=2)
    base.update(kw)
    opt = Options(**base)
    create_output_dirs(opt.output_dir)
    save_run_settings(opt, opt.output_dir)
    return opt


def test_batch_norm_trainer_kill_and_resume_is_bit_equal(tmp_path):
    """Killed at iteration 2 of epoch 0, resumed from the iteration-1
    checkpoint: parameters, both Adam states and the running statistics end
    where the unbroken run's end, bit for bit."""
    def make(out, **kw):
        return GanTrainer(_opt(out, **kw), video=False,
                          source=SyntheticDataSource(size=SIZE, n_items=4),
                          device="cpu")

    unbroken = make(tmp_path / "a")
    start = {k: v.clone() for k, v in unbroken.state.gen.state_dict().items()}
    unbroken.train()
    end = unbroken.state.gen.state_dict()
    assert not torch.equal(end["inc.conv.norm.running_mean"],
                           start["inc.conv.norm.running_mean"])
    # the sample grid's generator serves with the running statistics
    grid = unbroken._grid_gen
    grid.load_state_dict(unbroken._generator_state_dict())
    x = torch.rand(1, 1, SIZE, SIZE)
    with torch.no_grad():
        before = {k: v.clone() for k, v in grid.state_dict().items()}
        out, _ = grid(x)
    assert torch.isfinite(out).all()
    assert all(torch.equal(v, grid.state_dict()[k])
               for k, v in before.items())

    killed = make(tmp_path / "b")
    real_step, calls = killed.train_step, {"n": 0}

    def dies_at_the_second_step(*a, **kw):
        if calls["n"] == 1:
            raise KeyboardInterrupt
        calls["n"] += 1
        return real_step(*a, **kw)

    killed.train_step = dies_at_the_second_step
    with pytest.raises(KeyboardInterrupt):
        killed.train()
    resumed = make(tmp_path / "b", checkpoint=1)
    resumed.train()
    assert (resumed.num_iter, resumed.state.step) == (4, 4)
    a, b = unbroken.state, resumed.state
    sa, sb = a.gen.state_dict(), b.gen.state_dict()
    assert sa.keys() == sb.keys()
    for k in sa:
        assert torch.equal(sa[k], sb[k]), k
    for ma, mb in ((a.disc, b.disc),):
        for (n, p), q in zip(ma.named_parameters(), mb.parameters()):
            assert torch.equal(p, q), n
    for oa, ob in ((a.opt_G, b.opt_G), (a.opt_D, b.opt_D)):
        xa, xb = oa.state_dict()["state"], ob.state_dict()["state"]
        assert xa.keys() == xb.keys() and xa
        for i in xa:
            for k in ("step", "exp_avg", "exp_avg_sq"):
                assert torch.equal(xa[i][k], xb[i][k]), (i, k)
    # the checkpoint holds the statistics in the reference layout
    path = ckpt.latest_checkpoint(str(tmp_path / "b" / "models"))
    sd = torch.load(path, weights_only=True)["modelG_state_dict"]
    assert "down_path.0.mpconv.1.norm1.running_var" in sd


def test_batch_norm_pth_is_served_like_the_jax_runner(tmp_path):
    """A JAX batch-norm generator with moved statistics, exported to a
    reference `.pth`, through both InferenceRunners at float32 (8 filters,
    2 tiles, eval mode): the PNGs agree within one uint8 level."""
    gen = JaxUNet(filters=8, unet_norm="batch_norm")
    v = jax.jit(gen.init)(jax.random.PRNGKey(1), jnp.zeros((1, 256, 256, 1)))
    rng = np.random.default_rng(4)
    stats = jax.tree_util.tree_map(
        lambda a: np.asarray(a) + rng.uniform(0.0, 0.3, a.shape).astype(
            np.float32), v["batch_stats"])
    variables = {"params": v["params"], "batch_stats": stats}
    in_dir = tmp_path / "in"
    in_dir.mkdir()
    hdr = (rng.random((200, 300, 3), np.float32) ** 4) * 50.0
    write_radiance_hdr(str(in_dir / "scene.hdr"), hdr)
    lam = str(tmp_path / "lams.npy")
    np.save(lam, {"scene": 400.0})
    mp_jax = dict(jax_model_params("m"), filters=8, unet_norm="batch_norm")
    JaxRunner(mp_jax, "unused", params_G=variables).run_on_path(
        str(in_dir), str(tmp_path / "jax"), lam, scale=1)
    path = str(tmp_path / "bn.pth")
    save_reference_checkpoint(path, jax.tree_util.tree_map(
        np.asarray, v["params"]), stats_G=stats)
    mp = dict(get_model_params("m"), filters=8, unet_norm="batch_norm")
    outs = InferenceRunner(mp, path, device="cpu").run_on_path(
        str(in_dir), str(tmp_path / "port"), lam, scale=1)
    import cv2
    ref = cv2.cvtColor(cv2.imread(str(tmp_path / "jax" / "scene_UnCLTMO.png")),
                       cv2.COLOR_BGR2RGB)
    got = read_png(outs[0])
    assert got.shape == ref.shape == (200, 300, 3) and got.std() > 0
    assert np.abs(got.astype(np.int16) - ref.astype(np.int16)).max() <= 1
    # a bfloat16 engine holds the statistics in bfloat16, as the JAX
    # engine casts every float32 leaf
    runner = InferenceRunner(mp, path, device="cpu", dtype=torch.bfloat16)
    norm = runner.engine.model.inc.conv.norm
    assert norm.running_mean.dtype == torch.bfloat16
    assert os.path.exists(path)


def test_training_cli_takes_the_options_and_serving_reads_them(tmp_path):
    """`main_train_image` trains a batch-norm, bfloat16, leaky, bilinear,
    `square` generator on the CPU; a checkpoint of those options at the
    serving size is read back by `test_imageTMO` through its
    `run_settings.npy` (norms, upsampler and activation included)."""
    import subprocess
    import sys
    from uncltmo_tpu_torch.cli import test_imageTMO
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    rng = np.random.default_rng(7)
    pools = {}
    for pool in ("hdr", "ldr", "neg"):
        (tmp_path / pool).mkdir()
        for i in range(2):
            np.save(tmp_path / pool / f"{pool}{i}.npy",
                    rng.random((SIZE, SIZE, 3)).astype(np.float32) * 200)
        pools[pool] = str(tmp_path / pool)
    np.save(tmp_path / "lam.npy", {f"hdr{i}": 100.0 for i in range(2)})
    options = ["--unet_norm", "batch_norm", "--compute_dtype", "bfloat16",
               "--g_activation", "leakyrelu", "--bilinear", "1",
               "--con_operator", "square"]
    argv = ["--device", "cpu", "--batch_size", "2", "--num_epochs", "1",
            "--d_pretrain_epochs", "0", "--train_input_size", str(SIZE),
            "--filters", "8", "--data_workers", "1", "--log_every", "1",
            "--result_dir_prefix", str(tmp_path / "run"),
            "--data_root_npy", pools["hdr"], "--data_root_ldr", pools["ldr"],
            "--neg_ldr_root", pools["neg"],
            "--f_train_dict_path", str(tmp_path / "lam.npy"),
            "--test_dataroot_original_hdr", "none"] + options
    out = subprocess.run(
        [sys.executable, "-m", "uncltmo_tpu_torch.cli.main_train_image"]
        + argv, capture_output=True, text=True,
        env=dict(os.environ, PYTHONPATH=root), cwd=str(tmp_path),
        timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    sd = torch.load(ckpt.latest_checkpoint(str(tmp_path / "run" / "models")),
                    weights_only=True)["modelG_state_dict"]
    assert "up_path.0.up.1.weight" in sd and "inc.conv.norm.running_var" in sd
    assert all(v.dtype in (torch.float32, torch.int64) for v in sd.values())

    # the same options at the serving size, served from the .pth
    opt = _opt(tmp_path / "serve", train_input_size=0, g_activation="leakyrelu",
               bilinear=1, con_operator="square")
    trainer = GanTrainer(opt, device="cpu",
                         source=SyntheticDataSource(size=256, n_items=2))
    ckpt.save_train_state(os.path.join(opt.output_dir, "models"), 0, 1,
                          trainer.state)
    mp = get_model_params("serve", os.path.join(opt.output_dir,
                                                "run_settings.npy"))
    assert (mp["unet_norm"], mp["g_activation"], mp["bilinear"]) == (
        "batch_norm", "leakyrelu", 1)
    runner = InferenceRunner(mp, os.path.join(
        opt.output_dir, "models", "net_epoch0_iter1.pth"), device="cpu")
    assert runner.engine.model.inc.conv.activation == "leakyrelu"
    images = tmp_path / "in"
    images.mkdir()
    write_radiance_hdr(str(images / "a.hdr"),
                       (rng.random((136, 150, 3)) ** 2 * 300).astype(
                           np.float32))
    lam = str(tmp_path / "serve_lam.npy")
    np.save(lam, {"a": 30.0})
    ref = read_png(runner.run_on_path(str(images), str(tmp_path / "r"), lam,
                                      scale=1)[0])
    test_imageTMO.main(["--model_path", opt.output_dir, "--net_name",
                        "models/net_epoch0_iter1.pth", "--input_images_path",
                        str(images), "--output_path", str(tmp_path / "c"),
                        "--f_factor_path", lam, "--scale", "1",
                        "--device", "cpu"])
    np.testing.assert_array_equal(
        read_png(str(tmp_path / "c" / "a_UnCLTMO.png")), ref)


if __name__ == "__main__":
    # PYTHONPATH=. JAX_PLATFORMS=cpu python tests/test_torch_batch_norm.py
    # [draws]: the readings the module
    # docstring quotes, port against JAX and JAX against JAX with one ulp
    # on the HDR input, the worst of each group of moments
    import sys
    jgcn.drop_path = _table_drop_path
    jparams.EPSILON = tparams.EPSILON = 1e-2
    draws = [int(d) for d in (sys.argv[1] if len(sys.argv) > 1
                              else "1,2,3,4,5,6").split(",")]

    def worst(errs):
        by = {}
        for name, (e, l2) in errs.items():
            g = by.setdefault(_group(name), [0.0, 0.0, ""])
            if e > g[0]:
                g[0], g[2] = e, name
            g[1] = max(g[1], l2)
        return " ".join(f"{g}: {e:.2e} ({n}) l2 {l2:.2e}"
                        for g, (e, l2, n) in sorted(by.items()))

    for video in (False, True):
        for draw in draws:
            batch = _batch(draw, STEP_SIZE)
            ref, ref_logs = _jax_step(video, batch)
            state, logs = _port_step(video, batch)
            moved, _ = _jax_step(video, _moved_by_one_ulp(batch, 100 + draw))
            rel = {k: abs(float(logs[k]) - float(ref_logs[k]))
                   / max(abs(float(ref_logs[k])), 1e-7) for k in ref_logs}
            log_err = max(v for k, v in rel.items()
                          if not k.startswith("gradG/"))
            grad_err = max(v for k, v in rel.items() if k.startswith("gradG/"))
            want = _stats(state_dict_from_flax(_tree(ref.params_G),
                                               stats=_tree(ref.stats_G)))
            got = _stats(state.gen.state_dict())
            stats_err = max(float(np.max(np.abs(got[k] - want[k])
                                         / (1.0 + np.abs(want[k]))))
                            for k in want)
            mu = _jax_moments(ref)
            port = worst(_moment_errors(_port_moments(state), mu))
            ulp = worst(_moment_errors(_jax_moments(moved), mu))
            print(f"{'video' if video else 'image'} draw {draw}: logs "
                  f"{log_err:.2e} gradG {grad_err:.2e} stats {stats_err:.2e}"
                  f"\n  port vs JAX  {port}\n  JAX one ulp  {ulp}",
                  flush=True)
