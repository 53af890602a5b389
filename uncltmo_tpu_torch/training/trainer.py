"""Training orchestration: `GanTrainer`, for the image and the video
generator.

Port of `uncltmo_tpu/training/trainer.py` (reference `GanTrainer.py` /
`GanTrainerImg.py`): the D pre-training epochs, the three-stage loss
schedule, the per-epoch learning-rate decay, the 1/4-epoch summaries with a
checkpoint, curves and a sample grid, and a resume that continues a run
killed mid-epoch where it stopped.  Each iteration is one call of
`training.train_step.make_train_step`.

What the port decides for itself:

* Per-step randomness does not depend on history.  The step's drop path
  draws from a `torch.Generator`, which carries state; the trainer seeds a
  fresh one for every step from `SeedSequence([manual_seed + 1, stream,
  num_iter])` (stream 1 for D pre-training, 0 for the main run), so a run
  resumed at iteration N draws what the unbroken run drew.
* The batch is on the card before the step asks for it.  A prepare thread
  (`data.pipeline.device_prefetch`, depth 3) pins each array, copies it on
  a stream of its own with `non_blocking=True`, waits for that copy alone
  and hands over the device tensor; the step's `to_device` takes it as it
  is.
* The logs stay 0-dim device tensors on the training thread; the host
  worker reads them (one transfer per record) and writes the JSONL.
* Float32 training turns TF32 off for cuDNN and matmul.
* Whatever another thread reads is a copy taken on the training thread,
  because the state is updated in place: the checkpoint a host copy, the
  sample grid's weights a clone on the step's device.  The host worker
  loads that clone into a generator of the grid's own and runs its forward
  there, on the card as the steps do.
* The Tester (`training.tester`, attached by the training CLIs) runs on
  the training thread inside the summary, so nothing changes G while it
  reads the live weights; it copies them into its engine's own module.

Not ported yet, each refused by name: more than one card (ROADMAP Queue 1
item 7), bfloat16 training and batch norm (item 8), FID (item 9).
"""
from __future__ import annotations

import copy
import dataclasses
import glob
import os
import time
import warnings
from typing import Optional

import numpy as np
import torch

from uncltmo_tpu_torch import params as P
from uncltmo_tpu_torch.config import Options, get_model_params, weight_list
from uncltmo_tpu_torch.data.pipeline import (LambdaTable, SyntheticDataSource,
                                             TrainDataSource, TrainPipeline,
                                             device_prefetch)
from uncltmo_tpu_torch.inference.engine import disable_tf32
from uncltmo_tpu_torch.models.discriminator import make_discriminator
from uncltmo_tpu_torch.models.unet import (bottleneck_grid, make_generator,
                                           reference_normal_init_,
                                           seeded_init_)
from uncltmo_tpu_torch.training.state import TrainState, lr_schedule
from uncltmo_tpu_torch.training.train_step import (LossConfig,
                                                   make_train_step,
                                                   stage_for_epoch)
from uncltmo_tpu_torch.utils import checkpoint as ckpt
from uncltmo_tpu_torch.utils.logging import (AsyncHostWorker, MetricsLogger,
                                             plot_general_accuracy,
                                             plot_grad_flow,
                                             print_epoch_losses_summary,
                                             save_image_grid)


class GanTrainer:
    def __init__(self, opt: Options, video: bool = False, source=None,
                 tester=None, device="cuda"):
        self.opt = opt
        self.video = video
        self.tester = tester
        self.device = torch.device(device)
        self.epoch = 0
        self.num_iter = 0

        # the data-parallel request first, before any expensive init
        # (`trainer.py:49-66`)
        n_req = int(opt.data_parallel)
        if n_req > 1:
            raise NotImplementedError(
                f"data_parallel={n_req}: training on more than one card is "
                "not ported yet (ROADMAP Queue 1 item 7)")

        if opt.add_frame:
            # the reference's add_frame training path is inconsistent (the
            # dataset pads both crops while the generator crops its output)
            raise ValueError(
                "add_frame training is not supported (the reference path "
                "is unused/inconsistent; published configs use add_frame=0)")
        addition = int(opt.final_shape_addition)
        if addition % 16:
            raise ValueError(
                f"final_shape_addition={addition} breaks the U-Net's "
                "stride-16 grid; use a multiple of 16")
        # `input_size = params.input_size + opt.final_shape_addition`
        # (reference `main_train.py:25`)
        self.input_size = ((int(opt.train_input_size) or P.INPUT_SIZE)
                           + addition)
        gen_overrides, disc_overrides = {}, {}
        if self.input_size != P.INPUT_SIZE:
            gen_overrides["gcn_grid"] = bottleneck_grid(self.input_size,
                                                        opt.unet_depth)
            if opt.d_model == "simpleD":
                disc_overrides["input_size"] = self.input_size
        if opt.train_with_D and opt.d_model != "simpleD":
            # the contrastive losses need SimpleDiscriminator's (logit,
            # feature) pair; the reference crashes here (`GanTrainer.py:
            # 238-239`)
            raise ValueError(
                f"GAN training requires d_model='simpleD' (got "
                f"{opt.d_model!r}); other variants exist for "
                "checkpoint/CLI compatibility only")
        if opt.compute_dtype != "float32":
            raise NotImplementedError(
                f"compute_dtype={opt.compute_dtype!r}: the port trains in "
                "float32 only (ROADMAP Queue 1 item 8)")
        if opt.unet_norm == "batch_norm" or opt.d_norm == "batch_norm":
            raise NotImplementedError(
                "batch_norm training is not ported yet (ROADMAP Queue 1 "
                "item 8)")

        gen = make_generator(opt, **gen_overrides)
        disc = make_discriminator(opt, **disc_overrides)
        # xavier gain sqrt(2) (`model_save_util.py:41-47`), or the
        # reference's N(0, 0.02) under --use_xaviar 0 (`:26-38`)
        seeded_init_(gen, opt.manual_seed)
        seeded_init_(disc, opt.manual_seed + 1)
        if not int(opt.use_xaviar):
            reference_normal_init_(gen, opt.manual_seed + 2)
            reference_normal_init_(disc, opt.manual_seed + 3)
        self.cfg = LossConfig(
            loss_g_d_factor=opt.loss_g_d_factor,
            struct_loss_factor=opt.ssim_loss_factor,
            pyramid_weights=tuple(float(w) for w in
                                  weight_list(opt.pyramid_weight_list)),
            adv_weight=float(weight_list(opt.adv_weight_list)[0]),
            ssim_window_size=opt.ssim_window_size,
            video=video,
            train_with_D=bool(opt.train_with_D),
            cl_loss_type=str(opt.cl_loss_type))
        disable_tf32(self.device)           # float32 training
        # moves both modules to the device, then Adam over them there
        self.train_step = make_train_step(gen, disc, self.cfg,
                                          device=self.device)
        self.state = TrainState.create(gen, disc)
        # the sample grid's generator, on the step's device; touched on the
        # host worker only
        self._grid_gen = copy.deepcopy(gen).eval().requires_grad_(False)

        if source is None:
            if opt.data_root_npy and os.path.isdir(opt.data_root_npy):
                source = self._build_data_source()
            else:
                source = SyntheticDataSource(size=self.input_size)
        self.pipeline = TrainPipeline(source, opt.batch_size,
                                      seed=opt.manual_seed,
                                      workers=int(opt.data_workers))
        # the sample grids draw from held-out test dirs when given
        # (`Tester.py:126-148`), else from the training source
        self.test_source = self._build_test_source()

        self.logger = MetricsLogger(opt.output_dir)
        self._ckpt_saver = ckpt.AsyncSaver() if opt.async_checkpoint else None
        self._host_worker = AsyncHostWorker(max_pending=8)
        self._copy_stream = (torch.cuda.Stream(self.device)
                             if self.device.type == "cuda" else None)
        self._resume_iter = 0
        self._resumed = False
        self.last_epoch_timings: dict = {}
        if opt.debug_nans:
            from uncltmo_tpu_torch.utils.profiling import (
                enable_anomaly_detection)
            enable_anomaly_detection(True)

    # ------------------------------------------------------------------
    def _build_data_source(self) -> TrainDataSource:
        """The five training pools (`utils/ProcessedDatasetFolder.py:
        262-267`): static HDR, static positive LDR, HDR-video and
        sRGB-video scenes (video trainer only), SICE negatives.  A root left
        at its default that matches nothing is disabled with a warning; an
        explicit root that matches nothing raises in TrainDataSource."""
        opt = self.opt
        defaults = {f.name: f.default
                    for f in dataclasses.fields(type(opt))}

        def pool_glob(name: str, pattern: str) -> Optional[str]:
            root = getattr(opt, name)
            if not root or root == "none":
                return None
            g = os.path.join(root, pattern)
            if glob.glob(g):
                return g
            if root == defaults.get(name):
                warnings.warn(
                    f"--{name} left at its default {root!r} but no files "
                    f"match {g!r}; the pool is disabled for this run",
                    stacklevel=2)
                return None
            return g

        neg_glob = pool_glob("neg_ldr_root", "*.npy")
        hdr_video_glob = srgb_video_glob = video_lam = None
        if self.video:
            scene_pat = os.path.join("*", "*.npy")
            hdr_video_glob = pool_glob("hdr_video_root", scene_pat)
            srgb_video_glob = pool_glob("srgb_video_root", scene_pat)
            if hdr_video_glob or srgb_video_glob:
                video_lam = LambdaTable(opt.f_train_hdrvideo_dict_path,
                                        opt.factor_coeff)
        return TrainDataSource(
            hdr_glob=os.path.join(opt.data_root_npy, "*.npy"),
            ldr_glob=os.path.join(opt.data_root_ldr, "*.npy"),
            lambda_table=LambdaTable(opt.f_train_dict_path,
                                     opt.factor_coeff),
            normalization=opt.normalization,
            hdr_video_glob=hdr_video_glob,
            srgb_video_glob=srgb_video_glob,
            neg_ldr_glob=neg_glob,
            video_lambda_table=video_lam,
            size=self.input_size)

    def _build_test_source(self) -> Optional[TrainDataSource]:
        """Held-out source over --test_dataroot_npy / --test_dataroot_ldr
        (`data_loader_util.py:89-112`), or None when either has no .npy."""
        opt = self.opt
        hdr_glob = os.path.join(opt.test_dataroot_npy or "", "*.npy")
        ldr_glob = os.path.join(opt.test_dataroot_ldr or "", "*.npy")
        if not (glob.glob(hdr_glob) and glob.glob(ldr_glob)):
            return None
        return TrainDataSource(
            hdr_glob=hdr_glob, ldr_glob=ldr_glob,
            lambda_table=LambdaTable(opt.f_train_dict_path,
                                     opt.factor_coeff),
            normalization=opt.normalization,
            size=self.input_size)

    def _put(self, batch):
        """Host batch -> tensors on the step's device.  On the card: pinned,
        copied on the copy stream, and handed over once that copy is done
        (the pinned buffers may go then)."""
        host = {k: torch.from_numpy(np.ascontiguousarray(v))
                for k, v in batch.items()}
        if self._copy_stream is None:
            return host
        compute = torch.cuda.current_stream(self.device)
        with torch.cuda.stream(self._copy_stream):
            out = {k: v.pin_memory().to(self.device, non_blocking=True)
                   for k, v in host.items()}
            done = torch.cuda.Event()
            done.record(self._copy_stream)
        done.synchronize()
        for v in out.values():
            # allocated on the copy stream, used on the compute stream
            v.record_stream(compute)
        return out

    def _lrs(self, epoch: int):
        g = lr_schedule(self.opt.G_lr, epoch, self.opt.lr_decay_step)
        d = lr_schedule(self.opt.D_lr, epoch, self.opt.lr_decay_step)
        return g, d

    def train(self):
        """The run (`GanTrainer.py:142-166`): D pre-training epochs, then
        the main epochs with the learning-rate decay.  A resume skips the
        pre-training (its effect is in the restored D) and starts its epoch
        at the saved iteration.  The `finally` drains the checkpoint writer
        and the host worker, so a killed run still lands its last queued
        checkpoint."""
        if self.opt.checkpoint:
            self.load_checkpoint()
        try:
            if not self._resumed and self.opt.train_with_D:
                for p_epoch in range(self.opt.d_pretrain_epochs):
                    self.train_epoch(p_epoch, pretrain=True)
                self.num_iter = 0
            for epoch in range(self.epoch, self.opt.num_epochs):
                self.epoch = epoch
                self.train_epoch(epoch, start_iter=self._resume_iter)
                self._resume_iter = 0
        finally:
            if self._ckpt_saver is not None:
                self._ckpt_saver.wait()
            self._host_worker.wait()

    def _step_generator(self, pretrain: bool) -> torch.Generator:
        """A generator for this step alone, on the step's device, seeded by
        (manual_seed + 1, stream, num_iter)."""
        seed = np.random.SeedSequence(
            [self.opt.manual_seed + 1, 1 if pretrain else 0,
             self.num_iter]).generate_state(1, np.uint64)[0]
        return torch.Generator(device=self.device).manual_seed(int(seed))

    def train_epoch(self, epoch: int, pretrain: bool = False,
                    start_iter: int = 0):
        # the stage schedule and the decay are over main epochs; the
        # pre-training is its own phase at stage 0 and the initial rates
        stage = 0 if pretrain else stage_for_epoch(epoch)
        g_lr, d_lr = self._lrs(0 if pretrain else epoch)
        steps = self.pipeline.steps_per_epoch()
        # 1/4-epoch summaries; 1/8 for the video trainer's epochs 4..7
        # (`GanTrainer.py:194-199`)
        denom = 8 if (self.video and 4 <= epoch <= 7) else 4
        summary_every = max(steps // denom, 1)
        t0 = time.time()
        batches = self.pipeline.epoch(epoch, stream=1 if pretrain else 0,
                                      start=start_iter)
        # the weight channel of a batch derives from the num_iter it will
        # have, so the prepare thread's lookahead changes nothing
        base_iter = self.num_iter - start_iter

        def _prepare(idx_batch):
            it, batch = idx_batch
            batch = self._maybe_add_weight_channel(
                batch, pretrain, num_iter=base_iter + it)
            return it, self._put(batch)

        # seconds of the loop: `wait` blocked on the prepare queue, `dispatch`
        # in the step call, `log` / `summary` in the hooks on this thread
        timings = {"wait_s": 0.0, "dispatch_s": 0.0, "log_s": 0.0,
                   "summary_s": 0.0, "steps": 0}
        self.last_epoch_timings = timings
        prefetched = iter(device_prefetch(
            enumerate(batches, start=start_iter + 1), _prepare, depth=3))
        while True:
            t_mark = time.perf_counter()
            nxt = next(prefetched, None)
            if nxt is None:
                break
            it, dev_batch = nxt
            timings["wait_s"] += time.perf_counter() - t_mark
            self.num_iter += 1
            t_mark = time.perf_counter()
            self.state, logs = self.train_step(
                self.state, dev_batch, self._step_generator(pretrain), g_lr,
                d_lr, stage=stage, pretrain=pretrain)
            timings["dispatch_s"] += time.perf_counter() - t_mark
            timings["steps"] += 1
            if self.opt.verbose and not pretrain:
                print(f"iter {self.num_iter}  fake "
                      f"min {float(logs['fake/min']):.4f}  "
                      f"max {float(logs['fake/max']):.4f}  "
                      f"mean {float(logs['fake/mean']):.4f}", flush=True)
            if self.num_iter % self.opt.log_every == 0 or it == steps:
                t_mark = time.perf_counter()
                self._host_worker.submit(
                    self._log_async, logs, self.num_iter, epoch, pretrain,
                    (time.time() - t0) / (it - start_iter))
                timings["log_s"] += time.perf_counter() - t_mark
            if not pretrain and it % summary_every == 0:
                t_mark = time.perf_counter()
                self.print_epoch_summary(epoch, it, logs)
                timings["summary_s"] += time.perf_counter() - t_mark

    @staticmethod
    def _host_logs(logs) -> dict:
        """0-dim device tensors -> floats, in one transfer."""
        if not logs:
            return {}
        vals = torch.stack([v.float() for v in logs.values()]).tolist()
        return dict(zip(logs.keys(), vals))

    def _log_async(self, dev_logs, num_iter: int, epoch: int,
                   pretrain: bool, sec_per_step: float) -> None:
        """Host-worker body of the periodic log: the fetch, then the JSONL
        record.  The logger is touched on the host worker only."""
        host = self._host_logs(dev_logs)
        if pretrain:
            # pre-training shares step indices with the main run
            # (`GanTrainer.py:153-156`): keys of its own keep them apart
            host = {f"pretrain/{k}": v for k, v in host.items()}
        self.logger.log(num_iter, host, epoch=epoch,
                        phase="pretrain" if pretrain else "train",
                        sec_per_step=sec_per_step)

    def _maybe_add_weight_channel(self, batch, pretrain: bool,
                                  num_iter: Optional[int] = None,
                                  stream: int = 2):
        """Slider mode (manual_d_training): a constant weight channel after
        the HDR input, U(0, 1) per iteration unless d_weight_mul_mode is
        'single' (`GanTrainer.py:177-178, 293-299`), drawn from
        default_rng((manual_seed + stream, num_iter)); stream 2 for
        training, 3 for the sample grid."""
        if not self.opt.manual_d_training or pretrain:
            return batch
        if num_iter is None:
            num_iter = self.num_iter
        w = (1.0 if self.opt.d_weight_mul_mode == "single"
             else float(np.random.default_rng(
                 (self.opt.manual_seed + stream, num_iter)).random()))
        hdr = batch["hdr"]
        wc = np.full_like(hdr, w)
        return dict(batch, hdr=np.concatenate([hdr, wc], axis=-1))

    def _generator_state_dict(self, device: str = "cpu") -> dict:
        """A copy of the generator's weights, taken now, on `device`."""
        return {k: v.detach().to(device, copy=True)
                for k, v in self.state.gen.state_dict().items()}

    def print_epoch_summary(self, epoch: int, epoch_iter: int, logs):
        """The 1/4-epoch hook (`GanTrainer.py:520-544`): the Tester's eval
        when one is attached, a checkpoint, and on the host worker the
        console line, the curves, the grad-flow plot and the sample grid.
        The Tester reads G's live weights on the card, here on the training
        thread; the checkpoint reads a host copy taken here, the grid a
        device clone (queued on the step's stream before any later step)."""
        if self.tester is not None:
            test_metrics = self.tester.save_images_for_model(
                self.state.gen.state_dict(), self.opt.output_dir, epoch,
                epoch_iter)
            numeric = {f"test/{k}": float(v)
                       for k, v in test_metrics.items()
                       if isinstance(v, (int, float, np.floating))}
            if numeric:
                self._host_worker.submit(
                    self.logger.log, self.num_iter, numeric,
                    epoch=epoch, phase="test")
        models_dir = os.path.join(self.opt.output_dir, P.MODELS_SAVE_PATH)
        save_meta = {"num_iter": self.num_iter}
        if self._ckpt_saver is not None:
            self._ckpt_saver.save(models_dir, epoch, epoch_iter, self.state,
                                  extra_meta=save_meta)
        else:
            ckpt.save_train_state(models_dir, epoch, epoch_iter, self.state,
                                  extra_meta=save_meta)
        loss_dir = os.path.join(self.opt.output_dir, P.LOSS_PATH)
        grid_sd = self._generator_state_dict(self.device)
        grid_iter = self.num_iter

        def _render():
            # the FIFO worker has written every earlier log record by now
            hist = self.logger.snapshot()
            host_logs = self._host_logs(logs)
            print_epoch_losses_summary(
                epoch, self.opt.num_epochs,
                {k: v for k, v in host_logs.items()
                 if not k.startswith(("gradG/", "fake/"))})
            self.logger.plot(loss_dir, f"summary epoch_=_{epoch}",
                             history=hist)
            self._plot_diagnostics(loss_dir, epoch, host_logs, history=hist)
            self._save_sample_grid(epoch, epoch_iter, grid_sd, grid_iter)

        self._host_worker.submit(_render)

    def _plot_diagnostics(self, loss_dir: str, epoch: int, logs,
                          history=None):
        """Accuracy curves and grad-flow bars (reference
        `plot_util.plot_general_accuracy` / `plot_grad_flow`)."""
        hist = self.logger.history if history is None else history
        if hist.get("accDfake") and hist.get("accDreal"):
            plot_general_accuracy(
                [v for _, v in hist.get("accG", [])],
                [v for _, v in hist["accDfake"]],
                [v for _, v in hist["accDreal"]],
                f"accuracy epoch_=_{epoch}", loss_dir)
        grad_logs = {k.split("/", 1)[1]: float(v) for k, v in logs.items()
                     if k.startswith("gradG/")}
        if grad_logs:
            plot_grad_flow(grad_logs, loss_dir, f"epoch{epoch}")

    def _save_sample_grid(self, epoch: int, epoch_iter: int, gen_sd: dict,
                          num_iter: int):
        """Sample grid of (HDR input, fake, LDR positive) for two samples,
        like the reference's `Tester.save_test_images` (`Tester.py:
        126-148`), from the held-out dirs when configured.  Runs on the
        host worker: the grid's generator, loaded with `gen_sd`, on the
        step's device."""
        rng = np.random.default_rng(epoch)
        grid_source = self.test_source or self.pipeline.source
        items = [grid_source.sample(rng) for _ in range(2)]
        batch = {k: np.stack([it[k] for it in items]) for k in items[0]}
        if self.opt.manual_d_training:
            batch = self._maybe_add_weight_channel(batch, pretrain=False,
                                                   num_iter=num_iter,
                                                   stream=3)
        hdr = torch.from_numpy(batch["hdr"][:, 0]).permute(0, 3, 1, 2)
        self._grid_gen.load_state_dict(gen_sd)
        with torch.no_grad():
            fake, _ = self._grid_gen(hdr.to(self.device))
        fake = fake.cpu()
        images, titles = [], []
        for i in range(hdr.shape[0]):
            images += [hdr[i, 0].numpy(), fake[i, 0].numpy(),
                       batch["ldr_pos"][i, 0]]
            titles += ["hdr input", "fake", "ldr real"]
        out_dir = os.path.join(self.opt.output_dir, P.RESULTS_PATH,
                               f"images_epoch{epoch}_iter{epoch_iter}")
        save_image_grid(images, os.path.join(out_dir, "grid.png"), cols=3,
                        titles=titles)

    def run_final_assessment(self, input_images_path: str,
                             f_factor_path: str, scale: int = 4):
        """Post-training renders of a directory through `InferenceRunner`,
        from a copy of the generator (`GanTrainer.save_data_for_assessment`,
        `GanTrainer.py:546-580`).  FID is not ported yet."""
        from uncltmo_tpu_torch.inference.runner import InferenceRunner
        model_params = get_model_params(
            self.opt.result_dir_prefix or "model",
            os.path.join(self.opt.output_dir, "run_settings.npy"))
        out_dir = os.path.join(self.opt.output_dir,
                               f"final_{self.opt.final_epoch}",
                               "color_stretch")
        runner = InferenceRunner(model_params, net_path=None,
                                 state_dict=self._generator_state_dict(),
                                 device=self.device)
        outs = runner.run_on_path(input_images_path, out_dir, f_factor_path,
                                  scale=scale)
        if self.opt.fid_real_path and os.path.isdir(self.opt.fid_real_path):
            print("FID skipped: NotImplementedError: FID is not ported yet "
                  "(ROADMAP Queue 1 item 9)")
        return outs

    def load_checkpoint(self):
        """Restore the newest checkpoint with its mid-epoch bookkeeping:
        the run resumes at (epoch, epoch_iter) with the global num_iter, as
        the unbroken run would go on (the reference replays the whole
        epoch, `GanTrainer.py:485-494`).  A checkpoint without num_iter
        resumes at its epoch's start."""
        path = ckpt.latest_checkpoint(
            os.path.join(self.opt.output_dir, P.MODELS_SAVE_PATH))
        if path:
            self.state, meta = ckpt.load_train_state(path, self.state)
            self.epoch = int(meta.get("epoch", 0))
            self._resumed = True
            if "num_iter" in meta:
                self.num_iter = int(meta["num_iter"])
                self._resume_iter = int(meta.get("epoch_iter", 0))
                # saved at an epoch's last iteration: go on with the next
                if self._resume_iter >= self.pipeline.steps_per_epoch():
                    self.epoch += 1
                    self._resume_iter = 0
            print(f"restored checkpoint {path} (epoch {self.epoch}, "
                  f"iter {self._resume_iter}, num_iter {self.num_iter})")
