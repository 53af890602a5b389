"""The port's `GanTrainer` and training CLIs (CPU), at `train_input_size`
112, batch 2, two steps an epoch, with a narrow generator where the test is
about bookkeeping.

* A run of one D pre-train epoch and two epochs, image and video G, from
  `SyntheticDataSource` and from npy directories, trains, saves and writes
  the JAX trainer's JSONL keys.
* A run killed mid-epoch and resumed from disk ends with parameters and
  Adam states equal, bit for bit, to the unbroken run's.
* From one JAX `TrainState` (`train_state_from_flax`) and the same batches,
  three trainer iterations agree with the JAX trainer's within
  `tests/test_torch_train_step.py`'s tolerances, in its well-conditioned
  setting: warm Adam states and the skip concat's epsilon patched to 1e-2
  on both sides (that file's docstring says why); `drop_path` is patched on
  both sides to read its masks from one table, as there.
* Each refusal raises by name (the data-parallel ones are the JAX
  trainer's `ValueError`s); both training CLIs run a tiny `--device
  cpu` run with an evaluation directory in a subprocess; a training
  checkpoint is served by
  `InferenceRunner` and both serving CLIs from its `.pth`.
"""
import dataclasses
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import uncltmo_tpu.params as jparams
import uncltmo_tpu_torch.params as tparams
from uncltmo_tpu.config import Options as JaxOptions
from uncltmo_tpu.data.pipeline import SyntheticDataSource as JaxSynthetic
from uncltmo_tpu.models import gcn as jgcn
from uncltmo_tpu.training.trainer import GanTrainer as JaxTrainer
from uncltmo_tpu_torch.config import (Options, create_output_dirs,
                                      get_model_params, save_run_settings)
from uncltmo_tpu_torch.data.pipeline import SyntheticDataSource
from uncltmo_tpu_torch.models import gcn as tgcn
from uncltmo_tpu_torch.parallel import mesh
from uncltmo_tpu_torch.training.trainer import GanTrainer
from uncltmo_tpu_torch.utils import checkpoint as ckpt
from uncltmo_tpu_torch.utils.convert import (state_dict_from_flax,
                                             train_state_from_flax)
from uncltmo_tpu_torch.utils.io import read_png, write_radiance_hdr

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SIZE = 112
LOG_RTOL = 1e-4          # as tests/test_torch_train_step.py
GRAD_LOG_RTOL = 2e-3
G_TOL = 1e-2
D_TOL = 1e-4
JAX_KEYS = (
    ["errD", "accDreal", "accDfake", "accG", "errG_d", "errG_struct",
     "fake/min", "fake/max", "fake/mean"]
    + [f"gradG/{k}" for k in ("inc", "down0", "down1", "down2", "last_down",
                              "gcn", "up0", "up1", "up2", "up3", "outc")]
    + ["pretrain/errD", "pretrain/accDreal", "pretrain/accDfake",
       "pretrain/accG"])


def _opt(out, **kw):
    base = dict(batch_size=2, num_epochs=2, d_pretrain_epochs=1, G_lr=1e-4,
                D_lr=1.5e-4, lr_decay_step=50, loss_g_d_factor=0.1,
                pyramid_weight_list="0.2,0.4,0.6", adv_weight_list="1,1,0",
                log_every=1, train_input_size=SIZE, filters=8,
                d_down_dim=8, result_dir_prefix=str(out), output_dir=str(out),
                data_workers=2)
    base.update(kw)
    opt = Options(**base)
    create_output_dirs(opt.output_dir)
    save_run_settings(opt, opt.output_dir)
    return opt


def _records(out):
    return [json.loads(line) for line in
            open(os.path.join(str(out), "train_metrics.jsonl"))]


def _write_npy_dirs(root):
    rng = np.random.default_rng(7)
    for pool in ("hdr", "ldr", "neg"):
        (root / pool).mkdir()
        for i in range(4):
            np.save(root / pool / f"{pool}{i}.npy",
                    rng.random((SIZE, SIZE, 3)).astype(np.float32) * 200)
    np.save(root / "lam.npy", {f"hdr{i}": 20.0 + i for i in range(4)})
    return dict(data_root_npy=str(root / "hdr"),
                data_root_ldr=str(root / "ldr"),
                neg_ldr_root=str(root / "neg"),
                f_train_dict_path=str(root / "lam.npy"))


@pytest.mark.parametrize("video, data", [(False, "synthetic"),
                                         (False, "npy"), (True, "synthetic")])
def test_trainer_runs_saves_and_logs_the_jax_keys(tmp_path, video, data):
    kw = _write_npy_dirs(tmp_path) if data == "npy" else {}
    opt = _opt(tmp_path / "run", **kw)
    source = (SyntheticDataSource(size=SIZE, n_items=4) if data != "npy"
              else None)
    trainer = GanTrainer(opt, video=video, source=source, device="cpu")
    if data == "npy":
        assert len(trainer.pipeline.source) == 4
    trainer.train()
    assert trainer.state.step == 6           # 2 pre-train + 2 x 2 steps
    assert trainer.num_iter == 4 and trainer.last_epoch_timings["steps"] == 2
    assert all(trainer.last_epoch_timings[k] >= 0.0 for k in
               ("wait_s", "dispatch_s", "log_s", "summary_s"))
    recs = _records(opt.output_dir)
    keys = {k for r in recs for k in r} - {"step", "time", "epoch", "phase",
                                           "sec_per_step"}
    assert keys == set(JAX_KEYS)
    assert [r["phase"] for r in recs] == ["pretrain"] * 2 + ["train"] * 4
    assert [r["step"] for r in recs] == [1, 2, 1, 2, 3, 4]
    models = os.path.join(opt.output_dir, "models")
    assert sorted(f for f in os.listdir(models) if f.endswith(".pth")) == [
        f"net_epoch{e}_iter{i}.pth" for e in (0, 1) for i in (1, 2)]
    grid = os.path.join(opt.output_dir, "result_images",
                        "images_epoch1_iter2", "grid.png")
    assert os.path.exists(grid)
    # the grid ran a generator of its own, loaded at the last summary (the
    # epoch's last step): the live weights, not the live module
    assert trainer._grid_gen is not trainer.state.gen
    for (n, p), q in zip(trainer._grid_gen.named_parameters(),
                         trainer.state.gen.parameters()):
        assert p is not q and torch.equal(p, q), n
    # every parameter of G and D moved from the seeded init
    init = GanTrainer(opt, video=video, source=SyntheticDataSource(
        size=SIZE, n_items=4), device="cpu").state
    for a, b in ((trainer.state.gen, init.gen), (trainer.state.disc,
                                                 init.disc)):
        for (n, p), q in zip(a.named_parameters(), b.parameters()):
            assert n == "model.4.bias" or not torch.equal(p, q), n


def _assert_equal_states(a, b):
    for ma, mb in ((a.gen, b.gen), (a.disc, b.disc)):
        for (n, p), q in zip(ma.named_parameters(), mb.parameters()):
            assert torch.equal(p, q), n
    for oa, ob in ((a.opt_G, b.opt_G), (a.opt_D, b.opt_D)):
        sa, sb = oa.state_dict()["state"], ob.state_dict()["state"]
        assert sa.keys() == sb.keys() and sa
        for i in sa:
            for k in ("step", "exp_avg", "exp_avg_sq"):
                assert torch.equal(sa[i][k], sb[i][k]), (i, k)
    assert a.step == b.step


def test_kill_mid_epoch_and_resume_equals_the_unbroken_run(tmp_path):
    """Killed at iteration 2 of epoch 0 (after the iteration-1 checkpoint),
    resumed from disk: the run finishes epoch 0 and goes through epoch 1,
    and ends where the unbroken run ends, bit for bit."""
    def make(out, **kw):
        return GanTrainer(_opt(out, d_pretrain_epochs=0, **kw), video=False,
                          source=SyntheticDataSource(size=SIZE, n_items=4),
                          device="cpu")

    unbroken = make(tmp_path / "a")
    unbroken.train()
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
    _assert_equal_states(resumed.state, unbroken.state)
    a = {r["step"]: r["errG_d"] for r in _records(tmp_path / "a")}
    b = {r["step"]: r["errG_d"] for r in _records(tmp_path / "b")}
    assert all(a[i] == b[i] for i in (2, 3, 4))


# ------------------------------------------------- against the JAX trainer
# keep masks in call order, four a step (two generator forwards, the
# Grapher's and the FFN's draw each); row 1 drops sample 0, row 2 sample 3
MASKS = np.ones((4, 4), np.float32)
MASKS[1, 0] = 0.0
MASKS[2, 3] = 0.0


def _jax_drop_path(calls):
    def drop_path(x, rate, deterministic, rng=None):
        if deterministic or rate == 0.0:
            return x
        mask = MASKS[calls["jax"] % 4][:x.shape[0]]
        calls["jax"] += 1
        shape = (x.shape[0],) + (1,) * (x.ndim - 1)
        return x * jnp.asarray(mask, x.dtype).reshape(shape) / (1.0 - rate)
    return drop_path


def _port_drop_path(calls):
    def drop_path(x, rate, deterministic, generator=None, masks=None):
        if deterministic or rate == 0.0:
            return x
        mask = torch.from_numpy(MASKS[calls["port"] % 4][:x.shape[0]].copy())
        calls["port"] += 1
        return x * mask.reshape(-1, 1, 1, 1) / (1.0 - rate)
    return drop_path


def _warm(adam):
    """The Adam state of a run ten steps old with a flat second moment."""
    return adam._replace(
        count=jnp.asarray(10, jnp.int32),
        nu=jax.tree_util.tree_map(lambda x: jnp.full_like(x, 1e-2), adam.nu))


def _moments_close(opt, module, adam, to_sd, tol, count):
    mu = to_sd(jax.tree_util.tree_map(np.asarray, adam.mu))
    nu = to_sd(jax.tree_util.tree_map(np.asarray, adam.nu))
    assert int(adam.count) == count
    for name, p in module.named_parameters():
        st = opt.state[p]
        assert float(st["step"]) == count, name
        if name == "model.4.bias":
            continue        # its gradient is rounding noise on both sides
        for got, ref in ((st["exp_avg"], mu[name]),
                         (st["exp_avg_sq"], nu[name])):
            err = np.abs(got.numpy() - ref).max()
            assert err <= tol * max(np.abs(ref).max(), 1e-30), (name, err)


def test_three_trainer_iterations_match_the_jax_trainer(tmp_path,
                                                        monkeypatch):
    from uncltmo_tpu_torch.utils.convert import (
        discriminator_state_dict_from_flax)
    calls = {"jax": 0, "port": 0}
    monkeypatch.setattr(jgcn, "drop_path", _jax_drop_path(calls))
    monkeypatch.setattr(tgcn, "drop_path", _port_drop_path(calls))
    monkeypatch.setattr(jparams, "EPSILON", 1e-2)
    monkeypatch.setattr(tparams, "EPSILON", 1e-2)
    kw = dict(num_epochs=1, d_pretrain_epochs=0, G_lr=1e-5, D_lr=1.5e-5)
    opt = _opt(tmp_path / "port", **kw)
    jopt = JaxOptions(**dict(dataclasses.asdict(opt),
                             output_dir=str(tmp_path / "jax"),
                             result_dir_prefix=str(tmp_path / "jax")))
    os.makedirs(jopt.output_dir)
    jtr = JaxTrainer(jopt, video=False,
                     source=JaxSynthetic(size=SIZE, n_items=6),
                     use_mesh=False)
    ptr = GanTrainer(opt, video=False,
                     source=SyntheticDataSource(size=SIZE, n_items=6),
                     device="cpu")
    start = jtr.state.replace(opt_state_G=_warm(jtr.state.opt_state_G),
                              opt_state_D=_warm(jtr.state.opt_state_D))
    jtr.state = start
    ptr.state = train_state_from_flax(start, ptr.state.gen, ptr.state.disc)
    # the 1/4-epoch summaries (checkpoint, plots, the sample grid) leave the
    # training state alone; skipped here to spare the JAX grid's compile
    monkeypatch.setattr(jtr, "print_epoch_summary", lambda *a: None)
    monkeypatch.setattr(ptr, "print_epoch_summary", lambda *a: None)
    p0 = {n: p.detach().clone() for n, p in ptr.state.gen.named_parameters()}
    for tr in (jtr, ptr):
        tr.train_epoch(0)
        tr._host_worker.wait()
    assert calls["port"] == calls["jax"] * 3 == 12   # JAX traces once
    ref = jtr.state
    assert ptr.state.step == int(ref.step) == 3 and ptr.num_iter == 3
    _moments_close(ptr.state.opt_D, ptr.state.disc, ref.opt_state_D,
                   discriminator_state_dict_from_flax, D_TOL, 13)
    _moments_close(ptr.state.opt_G, ptr.state.gen, ref.opt_state_G,
                   state_dict_from_flax, G_TOL, 13)
    j0 = state_dict_from_flax(jax.tree_util.tree_map(np.asarray,
                                                     start.params_G))
    j3 = state_dict_from_flax(jax.tree_util.tree_map(np.asarray,
                                                     ref.params_G))
    for name, p in ptr.state.gen.named_parameters():
        moved = (p.detach() - p0[name]).numpy()
        ref_moved = j3[name] - j0[name]
        assert np.abs(ref_moved).max() > 0, name
        assert np.abs(moved - ref_moved).max() <= (
            G_TOL * np.abs(ref_moved).max() + 3e-8), name
    # the metrics streams: the same records, values within the step test's
    # tolerances
    recs, jrecs = _records(opt.output_dir), _records(jopt.output_dir)
    assert len(recs) == len(jrecs) == 3
    for r, j in zip(recs, jrecs):
        for d in (r, j):
            d.pop("time"), d.pop("sec_per_step")
        assert sorted(r) == sorted(j)
        for k, v in j.items():
            if isinstance(v, float):
                rtol = GRAD_LOG_RTOL if k.startswith("gradG/") else LOG_RTOL
                assert r[k] == pytest.approx(v, rel=rtol, abs=1e-7), k
            else:
                assert r[k] == v, k


# ------------------------------------------------------------ refusals
@pytest.mark.parametrize("kw, device, error, match", [
    (dict(data_parallel=2, batch_size=3), "cpu", ValueError,
     "batch_size=3 is not divisible by data_parallel=2"),
    (dict(data_parallel=4), "cuda", ValueError,
     "data_parallel=4 requested but only 2 devices are visible"),
    (dict(add_frame=1), "cpu", ValueError, "add_frame"),
    (dict(final_shape_addition=8), "cpu", ValueError,
     "final_shape_addition"),
    (dict(d_model="patchD"), "cpu", ValueError, "simpleD"),
    (dict(compute_dtype="float16"), "cpu", ValueError,
     "float32 or bfloat16"),
    (dict(unet_norm="group_norm"), "cpu", ValueError, "Unsupported norm"),
], ids=["dp-batch", "dp-devices", "add_frame", "shape_addition", "patchD",
        "float16", "unknown_norm"])
def test_each_refusal_raises_by_name(tmp_path, monkeypatch, kw, device,
                                     error, match):
    """The data-parallel checks are the JAX trainer's, word for word
    (`uncltmo_tpu/training/trainer.py:49-66`), with two cards visible."""
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    with pytest.raises(error, match=match):
        GanTrainer(_opt(tmp_path, **kw), device=device)


def test_more_than_one_card_is_refused_by_name(tmp_path, monkeypatch):
    """A `GanTrainer` is one rank of its process group.  Built outside one
    it runs one process whatever cards are visible (`data_parallel` 0),
    and a count above one that passes the JAX checks says how to start
    the ranks; the training CLI's 0 takes every visible card when the
    batch divides over them."""
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    with pytest.raises(ValueError, match="--data_parallel 2 or with torchrun"):
        GanTrainer(_opt(tmp_path, data_parallel=2), device="cuda")
    assert mesh.trainer_data_parallel(0, 4, "cuda") == 1
    assert mesh.resolve_data_parallel(0, 4, "cuda") == 4
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(ValueError, match="only 1 devices are visible"):
        GanTrainer(_opt(tmp_path, data_parallel=2), device="cuda")
    assert GanTrainer(_opt(tmp_path, data_parallel=0), device="cpu").world \
        == 1


# ----------------------------------------------------------------- CLIs
@pytest.mark.parametrize("cli", ["main_train_image", "main_train"])
def test_training_cli_runs_on_the_cpu(tmp_path, cli):
    """A tiny run of each training CLI in a subprocess, with an evaluation
    directory: the Tester scores the generator at each 1/4-epoch summary
    (the video CLI also on the scene root of $UNCLTMO_TEST_HDRVIDEO) and
    writes model_results/."""
    env = dict(os.environ, PYTHONPATH=ROOT)
    out = subprocess.run([sys.executable, "-m", f"uncltmo_tpu_torch.cli.{cli}",
                          "--help"], capture_output=True, text=True, env=env,
                         cwd=ROOT, timeout=120)
    assert out.returncode == 0 and "--device" in out.stdout
    assert "--train_input_size" in out.stdout
    kw = _write_npy_dirs(tmp_path)
    rng = np.random.default_rng(8)
    (tmp_path / "eval" / "scene").mkdir(parents=True)
    (tmp_path / "scenes" / "scene").mkdir(parents=True)
    for i in range(2):
        np.save(tmp_path / "eval" / f"im{i}.npy",
                (rng.random((64, 80, 3)).astype(np.float32) ** 2) * 300.0)
        # above the warp error's 2 x 32-px crop; 10 x 10 at the fifth level
        np.save(tmp_path / "scenes" / "scene" / f"{i:03d}.npy",
                (rng.random((80, 80, 3)).astype(np.float32) ** 2) * 300.0)
    np.save(tmp_path / "eval_lams.npy",
            {"im0": 300.0, "im1": 500.0, "scene": 400.0})
    env["UNCLTMO_TEST_HDRVIDEO"] = str(tmp_path / "scenes")
    argv = ["--device", "cpu", "--batch_size", "2", "--num_epochs", "1",
            "--d_pretrain_epochs", "1", "--train_input_size", str(SIZE),
            "--filters", "8", "--data_workers", "1", "--log_every", "1",
            "--result_dir_prefix", str(tmp_path / "run"),
            "--test_dataroot_original_hdr", str(tmp_path / "eval"),
            "--f_factor_path", str(tmp_path / "eval_lams.npy")]
    for k, v in kw.items():
        argv += [f"--{k}", v]
    out = subprocess.run([sys.executable, "-m", f"uncltmo_tpu_torch.cli.{cli}"]
                         + argv, capture_output=True, text=True, env=env,
                         cwd=str(tmp_path), timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    recs = _records(tmp_path / "run")
    assert [r["phase"] for r in recs if r["phase"] != "test"] == \
        ["pretrain"] * 2 + ["train"] * 2
    tests = [r for r in recs if r["phase"] == "test"]
    want = {"test/tmqi"} | ({"test/warp_e1", "test/warp_e2"}
                            if cli == "main_train" else set())
    assert len(tests) == 2 and all(want <= set(r) for r in tests)
    assert os.path.exists(tmp_path / "run" / "run_settings.npy")
    assert ckpt.latest_checkpoint(str(tmp_path / "run" / "models")).endswith(
        "net_epoch0_iter2.pth")
    results = tmp_path / "run" / "model_results"
    tag = "_m1st" if cli == "main_train" else "_tmqi"
    dirs = sorted(os.listdir(results))
    assert [d.split(tag)[0] for d in dirs] == ["epoch0_iter1", "epoch0_iter2"]
    for d in dirs:
        assert sorted(os.listdir(results / d / "color_stretch")) == [
            "im0_color_stretch.png", "im1_color_stretch.png"]


def test_a_training_checkpoint_is_served_from_its_pth(tmp_path):
    """Saved at the published crop (its GCN grid is the serving tile's),
    read by `InferenceRunner` and both serving CLIs with no conversion."""
    from uncltmo_tpu_torch.cli import test_imageTMO, test_videoTMO
    from uncltmo_tpu_torch.inference.runner import InferenceRunner
    opt = _opt(tmp_path / "run", train_input_size=0)
    trainer = GanTrainer(opt, device="cpu",
                         source=SyntheticDataSource(size=256, n_items=2))
    path = ckpt.save_train_state(os.path.join(opt.output_dir, "models"), 0,
                                 1, trainer.state)
    rng = np.random.default_rng(3)
    images = tmp_path / "in"
    (images / "scene").mkdir(parents=True)
    for name in ("a", "scene/000", "scene/001"):
        write_radiance_hdr(str(images / f"{name}.hdr"),
                           (rng.random((136, 150, 3)) ** 2 * 300).astype(
                               np.float32))
    lam = str(tmp_path / "lam.npy")
    np.save(lam, {"a": 30.0, "scene": 30.0})
    mp = get_model_params("run", os.path.join(opt.output_dir,
                                              "run_settings.npy"))
    assert mp["filters"] == 8
    pngs = InferenceRunner(mp, net_path=path, device="cpu").run_on_path(
        str(images), str(tmp_path / "r"), lam, scale=1)
    ref = read_png(pngs[0])
    assert ref.shape == (136, 150, 3) and ref.std() > 0
    test_imageTMO.main(["--model_path", opt.output_dir, "--net_name",
                        "models/net_epoch0_iter1.pth", "--input_images_path",
                        str(images), "--output_path", str(tmp_path / "c"),
                        "--f_factor_path", lam, "--scale", "1",
                        "--device", "cpu"])
    np.testing.assert_array_equal(
        read_png(str(tmp_path / "c" / "a_UnCLTMO.png")), ref)
    test_videoTMO.main(["--model_path", opt.output_dir, "--net_name",
                        "models/net_epoch0_iter1.pth", "--input_images_path",
                        str(images), "--output_path", str(tmp_path / "v"),
                        "--f_factor_path", lam, "--device", "cpu"])
    frames = sorted(os.listdir(tmp_path / "v" / "scene"))
    assert frames == ["000_UnCLTMO.png", "001_UnCLTMO.png"]
