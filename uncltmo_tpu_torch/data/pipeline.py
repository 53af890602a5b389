"""The training data pipeline, on the host.

Port of `uncltmo_tpu/data/pipeline.py`, itself the sampling of the
reference's `utils/ProcessedDatasetFolder.py` / `ProcessedDatasetFolderImg.py`:
random resize 256..512 and a random 256 crop, YUV luma, the lambda-log
mapping for HDR, /255 for LDR, two frames a sample, a 50/50 choice of the
static-image or the real-video pathway, SICE negatives.  A numpy producer
with a threaded prefetch, not a DataLoader.

The RNG is numpy's `default_rng` with the JAX package's one definition of a
batch: `SeedSequence([seed, stream, epoch, batch])` (`batch_rng`).  So batch
i of (epoch, stream) is bit-equal to the JAX pipeline's for
`SyntheticDataSource` and for npy files already at the crop size, whatever
the worker count.  The resize is `cv2.resize`'s INTER_LINEAR rule there;
here it is `F.interpolate`'s bilinear rule on a CPU tensor (half-pixel
centres, no antialiasing), equal to cv2's up to float rounding.

`device_prefetch` runs a `prepare` function on a background thread a few
items ahead of the consumer; the trainer's batch upload and the inference
runner's file loading both use it.
"""
from __future__ import annotations

import glob
import os
import queue
import threading
import warnings
from typing import Callable, Dict, Iterator, Optional

import numpy as np
import torch
import torch.nn.functional as F

from uncltmo_tpu_torch import params as P


def _resize(im: np.ndarray, w: int, h: int) -> np.ndarray:
    """(H, W, C) float32 -> (h, w, C), bilinear with half-pixel centres."""
    x = torch.from_numpy(np.ascontiguousarray(im)).permute(2, 0, 1)[None]
    out = F.interpolate(x, size=(h, w), mode="bilinear", align_corners=False,
                        antialias=False)
    return out[0].permute(1, 2, 0).numpy()


def _rgb_to_yuv_luma(im: np.ndarray) -> np.ndarray:
    """Y of cv2.COLOR_RGB2YUV, Rec.601 luma (`ProcessedDatasetFolder.py:
    81-82`)."""
    return (im[..., :3] @ np.asarray(P.REC601, im.dtype))[..., None]


def random_resize_crop(im: np.ndarray, rng: np.random.Generator,
                       size: int = 256) -> np.ndarray:
    """mode 0: resize to `size`; mode 1: resize to U(size, 2 size), then a
    random `size` crop (`ProcessedDatasetFolder.py:62-79`, `:178-197`)."""
    if im.shape[0] != size or im.shape[1] != size:
        mode = rng.integers(0, 2)
        resize_h = size if mode == 0 else int(rng.uniform(size, 2 * size))
        im = _resize(im, resize_h, resize_h)
        if im.shape[0] != size:
            yy = rng.integers(0, im.shape[0] - size)
            xx = rng.integers(0, im.shape[1] - size)
            im = im[yy:yy + size, xx:xx + size]
    return im


def normalize_ldr(im: np.ndarray, normalization: str, max_stretch: float = 1.0,
                  min_stretch: float = 0.0) -> np.ndarray:
    """The LDR input normalisations (`ProcessedDatasetFolder.py:15-23`),
    the published one being 'bugy_max_normalization' (/255)."""
    if normalization == "max_normalization":
        return im / im.max()
    if normalization == "bugy_max_normalization":
        return im / 255.0
    if normalization == "stretch":
        out = ((im - im.min()) / im.max()) * max_stretch - min_stretch
        return np.clip(out, 0, 1)
    return im


def hdr_log_input(gray: np.ndarray, brightness_factor: float) -> np.ndarray:
    """Min shift, then log10(x / max * f + 1) / max
    (`ProcessedDatasetFolder.py:147-149`)."""
    gray = gray - gray.min()
    a = np.log10((gray / gray.max()) * brightness_factor + 1.0)
    return (a / a.max()).astype(np.float32)


class LambdaTable:
    """{name: lambda} with the * 255 * factor_coeff scaling
    (`ProcessedDatasetFolder.py:26-35`).  A missing key raises, as the
    reference's `get_f` does (`utils/data_loader_util.py:212-222`), unless
    an explicit `default` is given; a dict path that does not exist raises
    at construction."""

    def __init__(self, path: Optional[str], factor_coeff: float,
                 default: Optional[float] = None):
        self.factor_coeff = factor_coeff
        self.default = default
        self.path = path
        self.table = {}
        if path and path != "none":
            if not os.path.exists(path):
                raise FileNotFoundError(f"lambda dict not found: {path!r}")
            self.table = np.load(path, allow_pickle=True)[()]

    def __call__(self, name: str) -> float:
        if name not in self.table:
            if self.default is not None:
                return float(self.default) * 255.0 * self.factor_coeff
            raise KeyError(
                f"no lambda found for {name!r} in {self.path!r} "
                "(reference get_f raises here too; pass default= to "
                "override explicitly)")
        return float(self.table[name]) * 255.0 * self.factor_coeff


# The reference replicates the SICE negative list to eight times its length
# (`ProcessedDatasetFolder.py:266-267`); that sets the epoch length only.
NEG_REPLICATION = 8


class TrainDataSource:
    """The five training pools of the reference's folder layout: static HDR
    npy, static positive LDR, HDR-video and sRGB-video scenes, SICE
    negatives.

    A pool glob that is given but matches no file raises at construction,
    naming the pool.  Without a negative pool the negatives are drawn from
    the positive pool, which leaves the contrastive losses without real
    negatives: that case warns.
    """

    def __init__(self, hdr_glob: str, ldr_glob: str, lambda_table: LambdaTable,
                 normalization: str = "bugy_max_normalization",
                 hdr_video_glob: Optional[str] = None,
                 srgb_video_glob: Optional[str] = None,
                 neg_ldr_glob: Optional[str] = None,
                 video_lambda_table: Optional[LambdaTable] = None,
                 size: int = 256, warn_missing_neg: bool = True):
        def _pool(pattern, what):
            if not pattern:
                return []
            files = sorted(glob.glob(pattern))
            if not files:
                raise FileNotFoundError(
                    f"{what} pool glob {pattern!r} matched no files "
                    "(pass None/'' to disable this pool explicitly)")
            return files

        self.size = size
        self.hdr_files = _pool(hdr_glob, "train-HDR")
        self.ldr_files = _pool(ldr_glob, "positive-LDR")
        self.hdr_video = _pool(hdr_video_glob, "train-HDR-video")
        self.srgb_video = _pool(srgb_video_glob, "train-sRGB-video")
        self.neg_ldr = _pool(neg_ldr_glob, "negative-LDR (SICE)")
        if not self.neg_ldr and self.ldr_files and warn_missing_neg:
            warnings.warn(
                "no negative-LDR pool configured: ldr_neg will be drawn "
                "from the POSITIVE pool, so the contrastive losses have no "
                "real negatives (reference uses SICE patches, "
                "ProcessedDatasetFolder.py:265-267). Pass neg_ldr_glob / "
                "--neg_ldr_root to fix.", stacklevel=2)
        if (self.hdr_video or self.srgb_video) \
                and video_lambda_table is None:
            raise ValueError(
                "video pools configured but no video_lambda_table; the "
                "reference reads f_train_hdrvideo_dict_path for every "
                "video draw (ProcessedDatasetFolder.py:264,301)")
        if not (self.hdr_files or self.hdr_video):
            raise ValueError(
                "no HDR training pool configured (hdr_glob and "
                "hdr_video_glob are both empty)")
        if not (self.ldr_files or self.srgb_video):
            raise ValueError(
                "no positive-LDR pool configured (ldr_glob and "
                "srgb_video_glob are both empty)")
        if not (self.neg_ldr or self.ldr_files):
            raise ValueError(
                "no negative-LDR pool available: neg_ldr_glob is empty and "
                "the static positive pool it falls back to is empty too")
        self.lam = lambda_table
        self.video_lam = video_lambda_table or lambda_table
        self.normalization = normalization

    def __len__(self):
        """The reference's epoch: the zip of three DataLoaders
        (`GanTrainer.py:172-174`), so the least of the static HDR list, the
        positive LDR list and the replicated negative list."""
        lengths = [len(self.hdr_files) or len(self.hdr_video)]
        if self.ldr_files or self.srgb_video:
            lengths.append(len(self.ldr_files) or len(self.srgb_video))
        if self.neg_ldr:
            lengths.append(NEG_REPLICATION * len(self.neg_ldr))
        return min(lengths)

    def _load_static(self, path: str, rng) -> np.ndarray:
        return random_resize_crop(
            np.load(path, allow_pickle=True).astype(np.float32), rng,
            size=self.size)

    def _video_rgb_frames(self, path: str, rng) -> list:
        """Frames t and t+1 of a scene, each cut to `size` rows and a
        `size`-wide column window at an x offset of its own (the reference
        draws the offset inside its frame loop, `ProcessedDatasetFolder.py:
        99-123`, so its pairs are not aligned); no resize."""
        s = self.size
        base = os.path.basename(path)
        frame_id = int(os.path.splitext(base)[0])
        nxt = path.replace(base, "%03d.npy" % (frame_id + 1))
        paths = [path, nxt if os.path.exists(nxt) else path]
        frames = []
        for p in paths:
            im = np.load(p, allow_pickle=True).astype(np.float32)
            xx = rng.integers(0, max(im.shape[1] - s, 1))
            frames.append(im[:s, xx:xx + s])
        return frames

    def _hdr_frames(self, path: str, rng, video: bool) -> np.ndarray:
        """Two lambda-log luma frames, (2, size, size, 1)."""
        frames = []
        if video:
            lam = self.video_lam(os.path.basename(os.path.dirname(path)))
            for im in self._video_rgb_frames(path, rng):
                frames.append(hdr_log_input(_rgb_to_yuv_luma(im), lam))
        else:
            name = os.path.splitext(os.path.basename(path))[0]
            lam = self.lam(name)
            for _ in range(2):
                im = self._load_static(path, rng)
                frames.append(hdr_log_input(_rgb_to_yuv_luma(im), lam))
        return np.stack(frames)

    def _ldr_frames(self, path: str, rng, video: bool = False) -> np.ndarray:
        """Two LDR luma frames: one image under two independent resize and
        crop draws (`ProcessedDatasetFolder.py:171-197`), or frames t and
        t+1 of a scene (`:94-140`)."""
        if video:
            ims = self._video_rgb_frames(path, rng)
        else:
            ims = [self._load_static(path, rng) for _ in range(2)]
        frames = [normalize_ldr(_rgb_to_yuv_luma(im), self.normalization)
                  for im in ims]
        return np.stack(frames).astype(np.float32)

    def sample(self, rng: np.random.Generator) -> Dict[str, np.ndarray]:
        """One training item.  The HDR and the positive-LDR streams flip
        their static-or-video coin independently (they are separate
        DataLoaders in the reference, `ProcessedDatasetFolder.py:290-301`);
        negatives are always static (`:286-289`).  A video pool without a
        static one takes the video branch without drawing the coin."""
        hdr_video = (bool(self.hdr_video)
                     and (not self.hdr_files or rng.uniform() >= 0.5))
        hdr_pool = self.hdr_video if hdr_video else self.hdr_files
        hdr = self._hdr_frames(hdr_pool[rng.integers(len(hdr_pool))], rng,
                               hdr_video)
        pos_video = (bool(self.srgb_video)
                     and (not self.ldr_files or rng.uniform() >= 0.5))
        pos_pool = self.srgb_video if pos_video else self.ldr_files
        ldr_pos = self._ldr_frames(pos_pool[rng.integers(len(pos_pool))],
                                   rng, pos_video)
        neg_pool = self.neg_ldr if self.neg_ldr else self.ldr_files
        ldr_neg = self._ldr_frames(neg_pool[rng.integers(len(neg_pool))], rng)
        return {"hdr": hdr, "ldr_pos": ldr_pos, "ldr_neg": ldr_neg}


class SyntheticDataSource:
    """Random data with the real pipeline's shapes and value ranges (tests,
    measurements, smoke training)."""

    def __init__(self, size: int = 256, n_items: int = 64):
        self.size = size
        self.n_items = n_items

    def __len__(self):
        return self.n_items

    def sample(self, rng: np.random.Generator) -> Dict[str, np.ndarray]:
        s = self.size
        hdr_rgb = (rng.random((s, s, 3)).astype(np.float32) ** 2) * 3000
        hdr = np.stack([hdr_log_input(_rgb_to_yuv_luma(hdr_rgb), 400.0)] * 2)
        ldr = rng.random((2, s, s, 1)).astype(np.float32)
        neg = np.clip(ldr * rng.uniform(0.1, 2.0), 0, 1).astype(np.float32)
        return {"hdr": hdr, "ldr_pos": ldr, "ldr_neg": neg}


class TrainPipeline:
    """Batches of a source, made by a pool of threads.

    Batch i of (epoch, stream) comes from its own RNG, seeded by
    (seed, stream, epoch, i), so the worker count never changes the stream.
    numpy releases the GIL in its heavy operations, so the threads overlap.
    """

    def __init__(self, source, batch_size: int, seed: int = 0,
                 prefetch: int = 2, workers: int = 0):
        self.source = source
        self.batch_size = batch_size
        self.seed = seed
        self.prefetch = prefetch
        if workers <= 0:
            workers = max(1, min(8, (os.cpu_count() or 2) - 1))
        self.workers = workers

    def steps_per_epoch(self) -> int:
        return max(len(self.source) // self.batch_size, 1)

    def batch_rng(self, epoch_idx: int, stream: int,
                  batch_idx: int) -> np.random.Generator:
        """The one RNG definition: a batch is (seed, stream, epoch, index),
        whoever produces it and whenever."""
        return np.random.default_rng(np.random.SeedSequence(
            [self.seed, stream, epoch_idx, batch_idx]))

    def _make_batch(self, rng) -> Dict[str, np.ndarray]:
        items = [self.source.sample(rng) for _ in range(self.batch_size)]
        return {k: np.stack([it[k] for it in items]) for k in items[0]}

    def epoch(self, epoch_idx: int, stream: int = 0,
              start: int = 0) -> Iterator[Dict[str, np.ndarray]]:
        """Batches `start` .. steps_per_epoch - 1 of one epoch.

        `stream` keeps apart phases that share epoch indices (the D
        pre-training and the main run).  `start` resumes mid-epoch without
        producing the batches before it.  A worker's exception re-raises
        here; leaving the generator early stops the pool.  Production runs
        at most `prefetch + workers` batches ahead of consumption.
        """
        n = self.steps_per_epoch()
        n_workers = min(self.workers, max(n - start, 1))
        lock = threading.Condition()
        results: Dict[int, object] = {}
        next_idx = [start]   # next batch index to claim (under lock)
        consumed = [start]   # first batch index not yet yielded
        stop = threading.Event()
        window = self.prefetch + n_workers

        def worker():
            while not stop.is_set():
                with lock:
                    while (next_idx[0] < n
                           and next_idx[0] - consumed[0] >= window
                           and not stop.is_set()):
                        lock.wait(0.1)
                    i = next_idx[0]
                    if i >= n or stop.is_set():
                        return
                    next_idx[0] = i + 1
                try:
                    item = self._make_batch(
                        self.batch_rng(epoch_idx, stream, i))
                except BaseException as e:   # noqa: BLE001 — re-raised below
                    item = e
                with lock:
                    results[i] = item
                    lock.notify_all()

        threads = [threading.Thread(target=worker, daemon=True)
                   for _ in range(n_workers)]
        for t in threads:
            t.start()
        try:
            for i in range(start, n):
                with lock:
                    while i not in results:
                        lock.wait(0.5)
                        if i not in results and not any(
                                t.is_alive() for t in threads):
                            raise RuntimeError(
                                "all pipeline workers exited without "
                                f"producing batch {i}")
                    item = results.pop(i)
                    consumed[0] = i + 1
                    lock.notify_all()
                if isinstance(item, BaseException):
                    raise item
                yield item
        finally:
            stop.set()
            with lock:
                lock.notify_all()


_DONE = object()


def device_prefetch(items, prepare: Callable, depth: int = 2):
    """Yield prepare(item) for each item, computed on a background thread
    that stays `depth` items ahead.  Exceptions re-raise in the consumer;
    leaving the generator early stops the thread."""
    q: queue.Queue = queue.Queue(maxsize=depth)
    stop = threading.Event()

    def put(item) -> bool:
        while not stop.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def worker():
        try:
            for item in items:
                if stop.is_set() or not put(prepare(item)):
                    return
            put(_DONE)
        except BaseException as e:      # noqa: BLE001 — re-raised below
            put(e)

    t = threading.Thread(target=worker, daemon=True)
    t.start()
    try:
        while True:
            item = q.get()
            if item is _DONE:
                return
            if isinstance(item, BaseException):
                raise item
            yield item
    finally:
        stop.set()
        t.join(timeout=10)
