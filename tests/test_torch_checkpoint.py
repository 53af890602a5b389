"""The port's checkpoints, logging and profiling utilities (CPU): save and
restore of a whole training state, the background saver's copy-before-
return contract, atomic writes, the resume bookkeeping; the metrics
stream against the JAX logger's; the host worker; the profiling helpers."""
import json
import os
import threading
import time

import numpy as np
import pytest
import torch

from uncltmo_tpu.utils import logging as jlog
from uncltmo_tpu_torch.models.discriminator import SimpleDiscriminator
from uncltmo_tpu_torch.models.unet import (UNetTMO, bottleneck_grid,
                                           seeded_init_)
from uncltmo_tpu_torch.training import state as tstate
from uncltmo_tpu_torch.training import train_step as tstep
from uncltmo_tpu_torch.utils import checkpoint as ckpt
from uncltmo_tpu_torch.utils import logging as tlog
from uncltmo_tpu_torch.utils import profiling
from uncltmo_tpu_torch.utils.convert import read_generator_state
from uncltmo_tpu_torch.utils.io import read_png

SIZE = 112


def _batch(seed, b=1):
    rng = np.random.default_rng(seed)
    return {k: rng.random((b, 2, SIZE, SIZE, 1), np.float32) * 0.5 + 0.2
            for k in ("hdr", "ldr_pos", "ldr_neg")}


def _trained_state(seed=0, steps=2):
    """A small G and D after `steps` real steps: Adam states that are not
    zero, step count `steps`."""
    gen = seeded_init_(UNetTMO(filters=4, gcn_grid=bottleneck_grid(SIZE)),
                       seed)
    disc = seeded_init_(SimpleDiscriminator(input_size=SIZE, dim=4),
                        seed + 1)
    step = tstep.make_train_step(gen, disc, tstep.LossConfig(), device="cpu")
    state = tstate.TrainState.create(gen, disc)
    for i in range(steps):
        state, _ = step(state, _batch(seed + i),
                        torch.Generator().manual_seed(i), 1e-3, 1e-3)
    return state


def _fresh_like(seed=5):
    gen = seeded_init_(UNetTMO(filters=4, gcn_grid=bottleneck_grid(SIZE)),
                       seed)
    disc = seeded_init_(SimpleDiscriminator(input_size=SIZE, dim=4), seed)
    return tstate.TrainState.create(gen, disc)


def _assert_same_state(a, b):
    for ma, mb in ((a.gen, b.gen), (a.disc, b.disc)):
        for (n, pa), pb in zip(ma.named_parameters(), mb.parameters()):
            assert torch.equal(pa, pb), n
    for oa, ob in ((a.opt_G, b.opt_G), (a.opt_D, b.opt_D)):
        sa, sb = oa.state_dict(), ob.state_dict()
        assert sa["param_groups"] == sb["param_groups"]
        assert sa["state"].keys() == sb["state"].keys() and sa["state"]
        for i in sa["state"]:
            for k in ("step", "exp_avg", "exp_avg_sq"):
                assert torch.equal(sa["state"][i][k], sb["state"][i][k]), k
    assert a.step == b.step


@pytest.fixture(scope="module")
def trained():
    return _trained_state()


def test_save_and_restore_a_whole_training_state(trained, tmp_path):
    path = ckpt.save_train_state(str(tmp_path), 3, 7, trained,
                                 extra_meta={"num_iter": 41})
    assert os.path.basename(path) == ckpt.checkpoint_name(3, 7) == \
        "net_epoch3_iter7.pth"
    restored, meta = ckpt.load_train_state(path, _fresh_like())
    _assert_same_state(restored, trained)
    assert restored.step == 2
    assert meta == {"epoch": 3, "epoch_iter": 7, "step": 2, "num_iter": 41}
    # the reference's layout, tensors and plain values only
    raw = torch.load(path, weights_only=True)
    assert sorted(raw) == ["epoch", "modelD_state_dict", "modelG_state_dict",
                           "optimizerD_state_dict", "optimizerG_state_dict",
                           "step"]
    assert raw["epoch"] == 3
    # ... so a serving loader reads the generator as from a published one
    sd = read_generator_state(path)
    assert sorted(sd) == sorted(trained.gen.state_dict())


def test_async_save_copies_before_it_returns(tmp_path):
    """The state changes in place right after `save` returns, and while the
    write is held back; the file holds the state as it was."""
    trained = _trained_state(seed=3)
    gate = threading.Event()
    saver = ckpt.AsyncSaver()
    saver._pool.submit(gate.wait)          # the writer is busy
    expect = {n: p.detach().clone()
              for n, p in trained.gen.named_parameters()}
    moment = {n: trained.opt_G.state[p]["exp_avg"].clone()
              for n, p in trained.gen.named_parameters()}
    saver.save(str(tmp_path), 0, 1, trained, extra_meta={"num_iter": 1})
    with torch.no_grad():
        for p in trained.gen.parameters():
            p.add_(1.0)
            trained.opt_G.state[p]["exp_avg"].mul_(3.0)
    trained.step += 5
    gate.set()
    saver.wait()
    raw = torch.load(os.path.join(str(tmp_path), "net_epoch0_iter1.pth"),
                     weights_only=True)
    for n, v in expect.items():
        assert torch.equal(raw["modelG_state_dict"][n], v), n
    saved = raw["optimizerG_state_dict"]["state"]
    for i, (n, _) in enumerate(trained.gen.named_parameters()):
        assert torch.equal(saved[i]["exp_avg"], moment[n]), n
    assert raw["step"] == 2


def test_async_saver_reraises_a_failed_write_once(trained, tmp_path):
    saver = ckpt.AsyncSaver()
    blocker = tmp_path / "file"
    blocker.write_text("")
    saver.save(str(blocker / "models"), 0, 1, trained)
    with pytest.raises(OSError):
        saver.wait()
    saver.wait()                           # reaped: does not raise again
    saver.save(str(tmp_path / "ok"), 0, 1, trained)
    saver.wait()
    assert ckpt.latest_checkpoint(str(tmp_path / "ok")).endswith(
        "net_epoch0_iter1.pth")


def test_newest_by_name_never_a_truncated_file(trained, tmp_path,
                                               monkeypatch):
    d = str(tmp_path)
    ckpt.save_train_state(d, 0, 9, trained)
    ckpt.save_train_state(d, 1, 2, trained)
    old = os.path.join(d, "net_epoch1_iter2.pth")
    # mtime order inverted, as after a copy: the name decides
    os.utime(old, (1, 1))
    assert ckpt.latest_checkpoint(d) == old

    def killed(obj, f):
        f.write(b"PK\x03\x04 trunc")
        raise KeyboardInterrupt          # the process dies mid-write

    monkeypatch.setattr(torch, "save", killed)
    with pytest.raises(KeyboardInterrupt):
        ckpt.save_train_state(d, 2, 0, trained)
    assert os.path.exists(os.path.join(d, "net_epoch2_iter0.pth.tmp"))
    assert ckpt.latest_checkpoint(d) == old
    assert ckpt.latest_checkpoint(str(tmp_path / "none")) is None


def test_missing_sidecar_falls_back_to_the_name(trained, tmp_path):
    path = ckpt.save_train_state(str(tmp_path), 4, 11, trained,
                                 extra_meta={"num_iter": 99})
    os.remove(path + ".meta.json")
    _, meta = ckpt.load_train_state(path, _fresh_like())
    assert meta == {"epoch": 4, "epoch_iter": 11}


# ------------------------------------------------------------- logging
def _records(path):
    recs = [json.loads(line) for line in open(path)]
    for r in recs:
        assert isinstance(r.pop("time"), float)
    return recs


def test_metrics_jsonl_equals_the_jax_loggers(tmp_path):
    entries = [
        (1, {"errD": 0.5, "accG": np.float32(0.25)}, {"epoch": 0,
                                                     "phase": "train"}),
        (2, {"test/tmqi": float("nan"), "x": float("inf"),
             "errG_d": torch.tensor(0.125)}, {"phase": "test"}),
        (3, {"pretrain/errD": 1.0}, {"epoch": 1, "sec_per_step": 0.5}),
    ]
    loggers = (tlog.MetricsLogger(str(tmp_path / "t")),
               jlog.MetricsLogger(str(tmp_path / "j")))
    for lg in loggers:
        for step, metrics, extra in entries:
            if lg is loggers[1]:
                metrics = {k: float(v) for k, v in metrics.items()}
            lg.log(step, metrics, **extra)
        lg.close()
    t, j = (_records(lg.path) for lg in loggers)
    assert t == j
    assert t[1]["test/tmqi"] is None and t[1]["x"] is None
    assert "NaN" not in open(loggers[0].path).read()
    snap = loggers[0].snapshot()
    assert np.isnan(snap["test/tmqi"][0][1]) and snap["errD"] == [(1, 0.5)]


def test_plots_and_the_grid_with_and_without_matplotlib(tmp_path,
                                                        monkeypatch):
    pytest.importorskip("matplotlib")
    lg = tlog.MetricsLogger(str(tmp_path))
    for i in range(2500):
        lg.log(i, {"errD": 1.0 / (i + 1), "gradG/inc": 0.1})
    out = lg.plot(str(tmp_path / "plots"), "summary epoch 0")
    assert out.endswith("summary_epoch_0.png") and os.path.exists(out)
    assert tlog.plot_grad_flow({"inc": torch.ones(3), "inc.bias": 1.0,
                                "outc": np.zeros(2)}, str(tmp_path), "e0")
    assert tlog.plot_general_accuracy([0.1], [0.2, 0.3], [0.4, 0.5], "acc",
                                      str(tmp_path))
    ims = [np.full((8, 8), 0.5, np.float32), torch.zeros(1, 8, 8),
           np.ones((8, 8, 1), np.float32)]
    assert tlog.save_image_grid(ims, str(tmp_path / "g" / "grid.png"),
                                cols=2, titles=["a", "b", "c"])
    # without matplotlib: no plots, and the grid through the PNG writer
    monkeypatch.setattr(tlog, "_pyplot", lambda: None)
    assert lg.plot(str(tmp_path), "t") is None
    assert tlog.plot_grad_flow({"inc": 1.0}, str(tmp_path), "e1") is None
    path = tlog.save_image_grid(ims, str(tmp_path / "grid2.png"), cols=2)
    png = read_png(path)
    assert png.shape == (16, 16)
    assert png[0, 0] == 127 and png[0, 8] == 0 and png[8, 0] == 255


def test_console_lines_equal_the_jax_printers(capsys):
    logs = {"errD": 0.5, "accG": 0.25}
    tlog.print_epoch_losses_summary(3, 21, logs)
    jlog.print_epoch_losses_summary(3, 21, logs)
    x = np.linspace(-1, 2, 12, dtype=np.float32).reshape(3, 4)
    tlog.print_tensor_stats(torch.from_numpy(x), "fake")
    jlog.print_tensor_stats(x, "fake")
    lines = capsys.readouterr().out.splitlines()
    assert lines[0] == lines[1] and lines[2] == lines[3]


def test_async_host_worker_contract():
    """In order; a failure re-raises on `wait()` once; at most
    `max_pending` tasks wait, so a slow host holds the caller back."""
    w = tlog.AsyncHostWorker(max_pending=2)
    ran = []
    for i in range(6):
        w.submit(ran.append, i)
    w.wait()
    assert ran == list(range(6))
    w.submit(lambda: (_ for _ in ()).throw(RuntimeError("render failed")))
    with pytest.raises(RuntimeError, match="render failed"):
        w.wait()
    w.wait()
    gate = threading.Event()
    w.submit(gate.wait)
    w.submit(ran.append, "queued")
    t0 = time.perf_counter()
    threading.Timer(0.3, gate.set).start()
    w.submit(ran.append, "after-gate")     # blocks until the gate opens
    assert time.perf_counter() - t0 > 0.15
    assert len(w._pending) <= 2
    w.wait()
    assert ran[-2:] == ["queued", "after-gate"]


# ----------------------------------------------------------- profiling
def test_timed_and_checked():
    def work(n):
        return torch.ones(n).sum()

    s = profiling.timed(work, 1000, warmup=1, iters=3)
    assert 0.0 < s < 1.0
    ok = profiling.checked(lambda: {"a": torch.ones(2), "b": [1, 2]})
    assert ok()["b"] == [1, 2]
    bad = profiling.checked(lambda: (torch.ones(2),
                                     {"x": torch.tensor([0.0, float("nan")])}))
    with pytest.raises(FloatingPointError, match=r"\[1\]\['x'\]"):
        bad()


def test_enable_anomaly_detection_toggles_autograd():
    try:
        profiling.enable_anomaly_detection(True)
        assert torch.is_anomaly_enabled()
        x = torch.tensor([-1.0], requires_grad=True)
        with pytest.raises(RuntimeError, match="nan|NaN"):
            torch.sqrt(x).backward()
        profiling.enable_anomaly_detection(False)
        assert not torch.is_anomaly_enabled()
    finally:
        torch.autograd.set_detect_anomaly(False)


def test_trace_spans_and_traced_to(tmp_path):
    with profiling.traced_to(str(tmp_path / "tr")):
        with profiling.trace("my_span"):
            torch.ones(64).mul(2.0).sum()
    path = tmp_path / "tr" / "trace.json"
    assert path.exists() and "my_span" in path.read_text()
    with profiling.traced_to(None):
        pass
    with pytest.raises(RuntimeError, match="already running"):
        profiling.start_trace(str(tmp_path))
        try:
            profiling.start_trace(str(tmp_path))
        finally:
            profiling.stop_trace()
