"""Observability: the JSONL metrics stream, loss and accuracy curves, the
grad-flow plot, the sample grid, and a worker thread for host work.

Port of `uncltmo_tpu/utils/logging.py`, which replaces the reference's
stdout printers (`utils/printer.py`) and per-epoch matplotlib dumps
(`utils/plot_util.py:10-60`).  matplotlib is imported inside each plotting
body; without it the plots return None, and the sample grid is written
through the port's own PNG writer.
"""
from __future__ import annotations

import json
import math
import os
import threading
import time
from collections import defaultdict
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Optional

import numpy as np

from uncltmo_tpu_torch.utils.io import write_png

# Serialises every pyplot-touching body of this module: pyplot's figure
# registry is global, and the trainer renders on its host worker while
# other threads may render too.
_MPL_LOCK = threading.RLock()


def _pyplot():
    """matplotlib's pyplot on the Agg backend, or None without matplotlib."""
    try:
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except Exception:
        return None
    return plt


def _as_numpy(x) -> np.ndarray:
    """A tensor (any device) or array-like -> numpy."""
    if hasattr(x, "detach"):
        x = x.detach().float().cpu().numpy()
    return np.asarray(x)


class AsyncHostWorker:
    """One thread for host work that must not ride the training thread
    (metric fetches and writes, plot renders, the sample grid).

    Tasks run in submit order.  A failed task re-raises on a later
    `submit()` or on `wait()`; call `wait()` before reading the artifacts
    back or exiting.  At most `max_pending` tasks wait: a host slower than
    the training loop holds the loop back instead of queueing without
    limit."""

    def __init__(self, max_pending: int = 4):
        self._pool = ThreadPoolExecutor(max_workers=1,
                                        thread_name_prefix="host-worker")
        self._pending = []
        self._max = max_pending

    def submit(self, fn, *args, **kwargs):
        self._reap(block=False)
        while len(self._pending) >= self._max:
            self._pending.pop(0).result()
        fut = self._pool.submit(fn, *args, **kwargs)
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
            rest.extend(self._pending[i + 1:])
            raise
        finally:
            self._pending = rest

    def wait(self):
        """Block until every queued task has run; re-raise the first
        failure."""
        self._reap(block=True)


class MetricsLogger:
    """Metrics as JSON lines in {output_dir}/{name}.jsonl, and in memory
    for the curves."""

    def __init__(self, output_dir: str, name: str = "train_metrics"):
        os.makedirs(output_dir, exist_ok=True)
        self.path = os.path.join(output_dir, f"{name}.jsonl")
        self.history = defaultdict(list)
        self._f = open(self.path, "a")

    def log(self, step: int, metrics: Dict[str, float], **extra) -> None:
        rec = {"step": int(step), "time": time.time(), **extra}
        for k, v in metrics.items():
            v = float(v)
            # a bare NaN literal is not JSON: non-finite values are written
            # as null; the history keeps the NaN so the curves show a gap
            rec[k] = v if math.isfinite(v) else None
            self.history[k].append((step, v))
        self._f.write(json.dumps(rec) + "\n")
        self._f.flush()

    def snapshot(self) -> Dict[str, list]:
        """A copy of the history, for plotting on another thread."""
        return {k: list(v) for k, v in self.history.items()}

    def plot(self, loss_dir: str, title: str,
             history: Optional[Dict[str, list]] = None) -> Optional[str]:
        """Loss curves (reference `plot_util.plot_general_losses`); each
        series decimated to 2000 points, its newest point kept."""
        plt = _pyplot()
        if plt is None:
            return None
        hist_by_key = self.history if history is None else history
        os.makedirs(loss_dir, exist_ok=True)
        with _MPL_LOCK:
            fig, ax = plt.subplots(figsize=(10, 5))
            drew = False
            for k, hist in hist_by_key.items():
                if not hist or k.startswith(("gradG/", "fake/")):
                    continue      # grad flow and fake stats: not losses
                if len(hist) > 2000:
                    hist = hist[:-1: -(-len(hist) // 2000)] + [hist[-1]]
                steps, vals = zip(*hist)
                ax.plot(steps, vals, label=k)
                drew = True
            ax.set_xlabel("iterations")
            ax.set_ylabel("loss")
            ax.set_title(title)
            if drew:
                ax.legend(loc="upper right")
            out = os.path.join(loss_dir, title.replace(" ", "_") + ".png")
            fig.savefig(out)
            plt.close(fig)
        return out

    def close(self):
        self._f.close()


def plot_grad_flow(grads, out_dir: str, tag: str) -> Optional[str]:
    """Mean |grad| per layer (reference `plot_util.plot_grad_flow`,
    `plot_util.py:130-146`).  `grads` maps a layer name to its gradient (a
    tensor, an array or a scalar); names with "bias" are skipped, as in the
    reference."""
    plt = _pyplot()
    if plt is None:
        return None
    layers, ave_grads = [], []
    for name, g in grads.items():
        if "bias" in name:
            continue
        layers.append(name)
        ave_grads.append(float(np.abs(_as_numpy(g)).mean()))
    if not layers:
        return None
    os.makedirs(out_dir, exist_ok=True)
    with _MPL_LOCK:
        fig, ax = plt.subplots(figsize=(max(6, 0.35 * len(layers)), 5))
        ax.plot(ave_grads, alpha=0.3, color="b")
        ax.hlines(0, 0, len(ave_grads) + 1, linewidth=1, color="k")
        ax.set_xticks(range(len(layers)))
        ax.set_xticklabels(layers, rotation="vertical", fontsize=6)
        ax.set_xlim(0, len(ave_grads))
        ax.set_xlabel("Layers")
        ax.set_ylabel("average gradient")
        ax.set_title("Gradient flow")
        ax.grid(True)
        out = os.path.join(out_dir, f"grad_flow_{tag}.png")
        fig.savefig(out, bbox_inches="tight")
        plt.close(fig)
    return out


def plot_general_accuracy(acc_G, acc_D_fake, acc_D_real, title: str,
                          path: str) -> Optional[str]:
    """D accuracy curves (reference `plot_util.plot_general_accuracy`,
    `plot_util.py:48-60`; acc_G is taken and not drawn, as there)."""
    plt = _pyplot()
    if plt is None:
        return None
    os.makedirs(path, exist_ok=True)
    with _MPL_LOCK:
        fig, ax = plt.subplots()
        ax.plot(range(len(acc_D_fake)), acc_D_fake, "-r", label="acc D fake")
        ax.plot(range(len(acc_D_real)), acc_D_real, "-b", label="acc D real")
        ax.set_xlabel("n iteration")
        ax.legend(loc="upper left")
        ax.set_title(title)
        out = os.path.join(path, title.replace(" ", "_") + ".png")
        fig.savefig(out)
        plt.close(fig)
    return out


def print_epoch_losses_summary(epoch: int, num_epochs: int,
                               logs: Dict[str, float]) -> None:
    """Console one-liner (reference `printer.print_epoch_losses_summary`)."""
    parts = " ".join(f"{k}: {float(v):.4f}" for k, v in logs.items())
    print(f"[{epoch}/{num_epochs}]\t{parts}", flush=True)


def print_tensor_stats(x, title: str) -> None:
    x = _as_numpy(x)
    print(f"{title}  shape {x.shape}  max {x.max():.4f}  min {x.min():.4f}  "
          f"mean {x.mean():.4f}  dtype {x.dtype}", flush=True)


def _grid_png(images, path: str, cols: int) -> str:
    """The grid as one uint8 PNG, without titles: cells of the largest
    image's size, gray images repeated to RGB when any image has color."""
    h = max(im.shape[0] for im in images)
    w = max(im.shape[1] for im in images)
    rgb = any(im.ndim == 3 for im in images)
    rows = -(-len(images) // cols)
    canvas = np.zeros((rows * h, cols * w) + ((3,) if rgb else ()),
                      np.float32)
    for i, im in enumerate(images):
        if rgb and im.ndim == 2:
            im = np.repeat(im[..., None], 3, axis=-1)
        r, c = divmod(i, cols)
        canvas[r * h:r * h + im.shape[0], c * w:c * w + im.shape[1]] = im
    return write_png(path, (canvas * 255.0).astype(np.uint8))


def save_image_grid(images, path: str, cols: int = 4,
                    titles=None) -> Optional[str]:
    """Sample grid (reference `plot_util.save_groups_images`,
    `plot_util.py:63-128`): rows of HDR input / fake / LDR images in
    [0, 1]."""
    images = [np.clip(np.squeeze(_as_numpy(im)), 0, 1) for im in images]
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    plt = _pyplot()
    if plt is None:
        return _grid_png(images, path, cols)
    rows = -(-len(images) // cols)
    with _MPL_LOCK:
        fig, axes = plt.subplots(rows, cols, figsize=(3 * cols, 3 * rows))
        axes = np.atleast_1d(axes).reshape(-1)
        for ax in axes:
            ax.axis("off")
        for i, im in enumerate(images):
            axes[i].imshow(im, cmap="gray" if im.ndim == 2 else None,
                           vmin=0, vmax=1)
            if titles and i < len(titles):
                axes[i].set_title(titles[i], fontsize=8)
        fig.savefig(path, bbox_inches="tight")
        plt.close(fig)
    return path
