"""Training checkpoints: save, load, find the newest, write in the background.

Port of `uncltmo_tpu/utils/checkpoint.py`.  The file is the reference's
`net_epoch{E}_iter{I}.pth`, written by `torch.save` in its dict layout
(`utils/model_save_util.py:121-131`: `epoch`, `modelG_state_dict`,
`modelD_state_dict`, `optimizerG_state_dict`, `optimizerD_state_dict`) plus
the step count, so `InferenceRunner`, both serving CLIs and
`utils/convert.py:read_generator_state` read it as they read a published
checkpoint.  It holds tensors and plain Python values only, so
`torch.load(..., weights_only=True)` reads it.  Each file has a
`.meta.json` sidecar with the resume bookkeeping (`epoch`, `epoch_iter`,
`step`, `num_iter`); both are written to a temporary name and renamed, so a
kill mid-write never leaves a truncated file under a checkpoint's name.

The port's `TrainState` is updated in place (`training/state.py`), so
`AsyncSaver.save` copies the state to the host on the calling thread before
it returns; only serialisation and the write run on its thread.  (The JAX
package can hand its immutable arrays to the thread instead.)
"""
from __future__ import annotations

import json
import os
import re
from concurrent.futures import ThreadPoolExecutor
from typing import Optional

import torch

_NAME = re.compile(r"net_epoch(\d+)_iter(\d+)\.pth$")


def checkpoint_name(epoch: int, epoch_iter: int) -> str:
    return f"net_epoch{epoch}_iter{epoch_iter}.pth"


def _host_copy(obj):
    """Tensors anywhere in dicts, lists and tuples -> detached CPU copies
    (a CPU tensor is copied too: the original changes at the next step)."""
    if isinstance(obj, torch.Tensor):
        return obj.detach().to("cpu", copy=True)
    if isinstance(obj, dict):
        return {k: _host_copy(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_host_copy(v) for v in obj)
    return obj


def host_checkpoint(state, epoch: int) -> dict:
    """The checkpoint dict of a `TrainState`, copied to the host now."""
    return {"epoch": int(epoch),
            "modelG_state_dict": _host_copy(state.gen.state_dict()),
            "modelD_state_dict": _host_copy(state.disc.state_dict()),
            "optimizerG_state_dict": _host_copy(state.opt_G.state_dict()),
            "optimizerD_state_dict": _host_copy(state.opt_D.state_dict()),
            "step": int(state.step)}


def _atomic_write(path: str, write) -> None:
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        write(f)
    os.replace(tmp, path)


def write_checkpoint(models_dir: str, epoch_iter: int, host: dict,
                     extra_meta: Optional[dict] = None) -> str:
    """Write a `host_checkpoint` dict as {models_dir}/net_epoch{E}_iter{I}.pth
    and its sidecar; `extra_meta` carries resume bookkeeping such as the
    global `num_iter`."""
    os.makedirs(models_dir, exist_ok=True)
    path = os.path.join(models_dir, checkpoint_name(host["epoch"],
                                                    epoch_iter))
    _atomic_write(path, lambda f: torch.save(host, f))
    meta = {"epoch": host["epoch"], "epoch_iter": epoch_iter,
            "step": host["step"]}
    if extra_meta:
        meta.update(extra_meta)
    data = json.dumps(meta).encode("utf-8")
    _atomic_write(path + ".meta.json", lambda f: f.write(data))
    return path


def save_train_state(models_dir: str, epoch: int, epoch_iter: int, state,
                     extra_meta: Optional[dict] = None) -> str:
    """Synchronous save of a `TrainState`."""
    return write_checkpoint(models_dir, epoch_iter,
                            host_checkpoint(state, epoch), extra_meta)


class AsyncSaver:
    """Background checkpoint writer.

    `save(...)` copies the state to the host on the calling thread and
    queues serialisation and the write on one worker thread.  A failed save
    re-raises on the next `save()` or on `wait()`; call `wait()` before
    reading checkpoints back or exiting (the trainer drains it in a
    `finally`, so a killed run still lands its last queued checkpoint).
    """

    def __init__(self):
        self._pool = ThreadPoolExecutor(max_workers=1,
                                        thread_name_prefix="ckpt-saver")
        self._pending = []

    def save(self, models_dir: str, epoch: int, epoch_iter: int, state,
             extra_meta: Optional[dict] = None):
        self._reap(block=False)
        host = host_checkpoint(state, epoch)
        fut = self._pool.submit(write_checkpoint, models_dir, epoch_iter,
                                host, extra_meta)
        self._pending.append(fut)
        return fut

    def _reap(self, block: bool):
        rest = []
        try:
            for i, f in enumerate(self._pending):
                if block or f.done():
                    f.result()   # re-raises a worker-side failure
                else:
                    rest.append(f)
        except BaseException:
            # drop the failed future (it was consumed) but keep the ones
            # not yet examined, so they still land / report later
            rest.extend(self._pending[i + 1:])
            raise
        finally:
            self._pending = rest

    def wait(self):
        """Block until every queued checkpoint is on disk."""
        self._reap(block=True)


def load_train_state(path: str, state):
    """Restore a checkpoint into `state` (modules, both Adam states and the
    step) where its tensors lie; returns (state, meta).

    The metadata comes from the `.meta.json` sidecar, or, when it is
    missing, from the epoch and iteration in the file name, so the schedule
    does not restart at epoch 0."""
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    state.gen.load_state_dict(ckpt["modelG_state_dict"], strict=True)
    state.disc.load_state_dict(ckpt["modelD_state_dict"], strict=True)
    state.opt_G.load_state_dict(ckpt["optimizerG_state_dict"])
    state.opt_D.load_state_dict(ckpt["optimizerD_state_dict"])
    state.step = int(ckpt["step"])
    meta_path = path + ".meta.json"
    meta = {}
    if os.path.exists(meta_path):
        with open(meta_path) as f:
            meta = json.load(f)
    else:
        ei = _epoch_iter_of(os.path.basename(path))
        if ei is not None:
            meta = {"epoch": ei[0], "epoch_iter": ei[1]}
    return state, meta


def _epoch_iter_of(name: str):
    """(epoch, iter) of net_epoch{E}_iter{I}.pth, else None."""
    m = _NAME.match(name)
    return (int(m.group(1)), int(m.group(2))) if m else None


def latest_checkpoint(models_dir: str) -> Optional[str]:
    """The newest checkpoint by the (epoch, iter) in its name, never by
    mtime (a copy or a restore can invert mtimes).  Temporary files of an
    unfinished write do not match the name and are never picked."""
    if not os.path.isdir(models_dir):
        return None
    parsed = [(ei, f) for f in os.listdir(models_dir)
              if (ei := _epoch_iter_of(f)) is not None]
    if not parsed:
        return None
    return os.path.join(models_dir, max(parsed)[1])
