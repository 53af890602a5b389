"""One GAN training step.

Port of `uncltmo_tpu/training/train_step.py`: the D update (on the old G's
fake) followed by the G update against the *updated* D, the reference's
ordering (`GanTrainer.py:202-291`: optimizerD.step() precedes train_G).
The three-stage epoch schedule of loss mixes (`GanTrainer.py:301-332`,
epoch_step1 = 6 / epoch_step2 = 9) is the `stage` argument.

What the reference computed on the host mid-step -- the naturalness of
every patch for the pseudo-label loss and of every image for infoNCE2
(`GanTrainer.py:340-409`) -- runs on the tensors' device.

The step works in NCHW; batches arrive in the JAX package's layout.  In
float32 (the published configuration) it computes in float32 throughout.
With `compute_dtype=torch.bfloat16` the batch goes to the device as
bfloat16 (as the JAX trainer's `_put` does) and G's and D's forwards and
the loss terms run under `torch.autocast`: convolutions and matmuls in
bfloat16, the kernels K1 and K2 in bfloat16, the float32 islands of
`ops/precision.py` in float32.  Parameters, gradients and both Adam states
stay float32 and no loss scaling is needed.  (The JAX package keeps float32
activations and rounds only the matmul operands, `jax_default_matmul_
precision`; here the activations between ops are bfloat16 as well.)

A batch-norm generator's running statistics move as in the JAX step
(`uncltmo_tpu/training/train_step.py:155-165,195,216-237`): the D phase's
generator forward updates them, and the G phase's forward starts from that
update and updates them again, two momentum updates a step, with no
gradient through them.

Under a process group (`parallel/mesh.py`) each rank takes its rows of the
global batch, and the step is the one-process step on the global batch:
the drop path, batch norm, `batchMax` and the loss terms that couple the
batch see the global batch through differentiable collectives, the D and G
gradient lists are averaged over the ranks before each Adam update (by
hand: `torch.autograd.grad` bypasses DDP's hooks), so every rank applies
the same update, and the logs come out global and equal on every rank.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Callable, Dict, Tuple

import numpy as np
import torch

from uncltmo_tpu_torch.losses import adversarial as adv
from uncltmo_tpu_torch.losses.struct import struct_loss_pyramid
from uncltmo_tpu_torch.models.discriminator import SimpleDiscriminator
from uncltmo_tpu_torch.models.unet import UNetTMO, video_apply
from uncltmo_tpu_torch.ops.precision import float32_island
from uncltmo_tpu_torch.parallel.mesh import all_reduce_mean_, reduce_logs
from uncltmo_tpu_torch.training.state import TrainState, apply_updates


@dataclasses.dataclass(frozen=True)
class LossConfig:
    loss_g_d_factor: float = 0.1
    struct_loss_factor: float = 1.0
    pyramid_weights: Tuple[float, ...] = (0.2, 0.4, 0.6)
    adv_weight: float = 1.0
    ssim_window_size: int = 5
    video: bool = False              # video G: 5-D input + feature head
    train_with_D: bool = True
    # contrastive-loss flavor of the nce / infoNCE2 terms: every reference
    # call site hardcodes 'InfoNCE' (`GanTrainer.py:304-318`); 'LMCL'
    # (`GanTrainer.py:441-451`) is its implemented alternative
    cl_loss_type: str = "InfoNCE"


def _flatten_frames(x: torch.Tensor) -> torch.Tensor:
    """(B, T, C, H, W) -> (B*T, C, H, W)."""
    return x.reshape((-1,) + tuple(x.shape[2:]))


@float32_island
def generator_loss_terms(stage: int, cfg: LossConfig, fake, fea_fake,
                         d_fake_bp, d_real_pos_bp, d_fea_fake,
                         d_fea_real_pos, d_fea_real_neg, d_fea_input,
                         ldr_pos) -> torch.Tensor:
    """The stage-dependent adversarial / contrastive G loss
    (`GanTrainer.py:301-332`), in float32 (a float32 island,
    `ops/precision.py`)."""
    gd = cfg.loss_g_d_factor
    clt = cfg.cl_loss_type
    if stage == 0:
        err = gd * adv.contrastive_d_loss(d_fake_bp, d_real_pos_bp)
        err = err + gd * 0.5 * adv.nce(d_fea_fake, d_fea_real_pos,
                                       d_fea_input, k=1.0, c=1e-2,
                                       loss_type=clt)
        err = err + gd * 0.5 * (0.2 * adv.nce(d_fea_fake, d_fea_real_pos,
                                              d_fea_real_neg, k=1e3, c=2.0,
                                              loss_type=clt))
        err = err + gd * 1e-6 * adv.info_nce2(fea_fake, fake, k=1.0, c=1e-2,
                                              loss_type=clt)
        err = err + gd * 1e-6 * adv.mean_brightness_l1(fake, ldr_pos)
        err = err + gd * 1e-6 * adv.mean_contrast_l1(fake, ldr_pos)
        err = err + gd * 1e-6 * adv.pseudo_label_loss(fake)
    elif stage == 1:
        err = gd * 1e-6 * adv.contrastive_d_loss(d_fake_bp, d_real_pos_bp)
        err = err + gd * 0.5 * adv.nce(d_fea_fake, d_fea_real_pos,
                                       d_fea_input, k=1.0, c=1e-2,
                                       loss_type=clt)
        err = err + gd * 0.5 * (0.2 * adv.nce(d_fea_fake, d_fea_real_pos,
                                              d_fea_real_neg, k=1e3, c=2.0,
                                              loss_type=clt))
        err = err + gd * 0.1 * (5.0 * adv.info_nce2(fea_fake, fake, k=1.0,
                                                    c=1e-2, loss_type=clt))
        err = err + gd * 0.5 * (1e2 * adv.mean_brightness_l1(fake, ldr_pos))
        err = err + gd * 0.5 * (2.0 * adv.mean_contrast_l1(fake, ldr_pos))
        err = err + gd * 1e-6 * adv.pseudo_label_loss(fake)
    else:
        err = gd * 1e-6 * adv.contrastive_d_loss(d_fake_bp, d_real_pos_bp)
        err = err + gd * 0.5 * (1e2 * adv.mean_brightness_l1(fake, ldr_pos))
        err = err + gd * 0.5 * (1e2 * adv.pseudo_label_loss(fake))
        err = err + gd * 0.2 * (1e5 * adv.tv_loss(fake))
    return err


def _top_level(name: str, depth: int) -> str:
    """The JAX package's top-level module name of a generator parameter
    (`inc`, `down0..`, `last_down`, `gcn`, `up0..`, `outc`)."""
    parts = name.split(".")
    if parts[0] == "down_path":
        i = int(parts[1])
        return "last_down" if i == depth - 1 else f"down{i}"
    if parts[0] == "up_path":
        return f"up{parts[1]}"
    return parts[0]


def make_train_step(gen: UNetTMO, disc: SimpleDiscriminator, cfg: LossConfig,
                    device=None, compute_dtype: torch.dtype = torch.float32
                    ) -> Callable:
    """Build train_step(state, batch, generator, g_lr, d_lr, stage,
    pretrain) -> (state, logs) for a generator and a discriminator, which
    are moved to `device` here (the CUDA card when None).  `compute_dtype`
    float32 or bfloat16 (see the module docstring).

    batch (the image and video pipelines both deliver 2 frames per sample,
    `ProcessedDatasetFolder.py:57`), numpy arrays or tensors:
      hdr:     (B, 2, H, W, C)  lambda-log luminance (G input)
      ldr_pos: (B, 2, H, W, 1)  DIV2K luma / 255
      ldr_neg: (B, 2, H, W, 1)  SICE over/under-exposed luma / 255
    """
    device = torch.device("cuda" if device is None else device)
    gen.to(device)
    disc.to(device)
    g_params = list(gen.parameters())
    d_params = list(disc.parameters())
    g_tops = [_top_level(n, gen.depth) for n, _ in gen.named_parameters()]

    def to_device(x) -> torch.Tensor:
        """(B, T, H, W, C) -> (B, T, C, H, W) in the compute dtype on the
        device."""
        t = torch.as_tensor(np.asarray(x) if not isinstance(x, torch.Tensor)
                            else x, dtype=compute_dtype)
        return t.to(device).permute(0, 1, 4, 2, 3)

    def autocast():
        if compute_dtype == torch.float32:
            return contextlib.nullcontext()
        return torch.autocast(device.type, dtype=compute_dtype)

    def g_forward(hdr, generator, drop_masks):
        """A training forward of the generator: (fake (B*T, 1, H, W),
        features)."""
        if cfg.video:
            outs, feats = video_apply(gen, hdr, deterministic=False,
                                      generator=generator,
                                      drop_masks=drop_masks)
            return (_flatten_frames(outs),
                    _flatten_frames(feats)[:, :, None, None])
        return gen(_flatten_frames(hdr), deterministic=False,
                   generator=generator, drop_masks=drop_masks)

    def train_step(state: TrainState, batch: Dict, generator: torch.Generator,
                   g_lr: float, d_lr: float, stage: int = 0,
                   pretrain: bool = False, drop_masks=None):
        """One step; `state` is updated in place and returned with the logs
        (0-dim tensors on the device, so the step does not wait for it).
        `generator` feeds the drop path of the two generator forwards;
        `drop_masks`, an iterator of (B*,) keep masks in call order, takes
        its place when given (`models/gcn.py:drop_path`)."""
        if state.gen is not gen or state.disc is not disc:
            raise ValueError("train_step: the state holds other modules "
                             "than the step was built for")
        hdr = to_device(batch["hdr"])
        ldr_pos = _flatten_frames(to_device(batch["ldr_pos"]))
        ldr_neg = _flatten_frames(to_device(batch["ldr_neg"]))
        hdr_luma = _flatten_frames(hdr)[:, :1]
        logs = {}

        # ---- D update (`GanTrainer.py:202-261`)
        if cfg.train_with_D:
            with autocast():
                if pretrain:
                    fake_for_d = hdr_luma
                else:
                    # also moves batch norm's running statistics
                    with torch.no_grad():
                        fake_for_d, _ = g_forward(hdr, generator, drop_masks)
                d_weight = (cfg.adv_weight if stage == 0
                            else cfg.adv_weight * 1e-6)
                d_real_pre, _ = disc(ldr_pos)
                d_fake_pre, _ = disc(fake_for_d)
                err_d = d_weight * adv.contrastive_d_loss(d_real_pre,
                                                          d_fake_pre)
            grads = torch.autograd.grad(err_d, d_params)
            all_reduce_mean_(grads)
            for p, g in zip(d_params, grads):
                p.grad = g
            apply_updates(state.opt_D, d_lr)
            logs["errD"] = err_d.detach()
            # accuracy counters (reference `Tester.update_test_loss`:
            # logit > 0.5 = "real"), from the pre-update D forwards
            logs["accDreal"] = (d_real_pre > 0.5).float().mean()
            logs["accDfake"] = (d_fake_pre <= 0.5).float().mean()
            logs["accG"] = (d_fake_pre > 0.5).float().mean()

        state.step += 1
        if pretrain:
            return state, reduce_logs(logs)

        # ---- G update against the UPDATED D (`GanTrainer.py:263-291`)
        with autocast():
            fake, fea_fake = g_forward(hdr, generator, drop_masks)
            err_g = fake.new_zeros((), dtype=torch.float32)
            if cfg.train_with_D:
                d_fake_bp, d_fea_fake = disc(fake)
                with torch.no_grad():     # constants of the G loss
                    d_real_pos_bp, d_fea_real_pos = disc(ldr_pos)
                    _, d_fea_real_neg = disc(ldr_neg)
                    _, d_fea_input = disc(hdr_luma)
                err_g = generator_loss_terms(
                    stage, cfg, fake, fea_fake, d_fake_bp, d_real_pos_bp,
                    d_fea_fake, d_fea_real_pos, d_fea_real_neg, d_fea_input,
                    ldr_pos)
            err_struct = fake.new_zeros((), dtype=torch.float32)
            if cfg.struct_loss_factor:
                err_struct = cfg.struct_loss_factor * struct_loss_pyramid(
                    fake, hdr_luma, cfg.pyramid_weights, cfg.ssim_window_size)
        # gradients for G's parameters alone: D's `.grad`s keep the D
        # loss's, and nothing of the G loss reaches D's optimizer
        err = err_g + err_struct
        if err.requires_grad:
            grads = torch.autograd.grad(err, g_params)
        else:
            # no term to differentiate (train_with_D off and no structural
            # loss): the JAX step differentiates the constant and still
            # applies Adam to the zero gradients, so warm moments move G
            grads = [torch.zeros_like(p) for p in g_params]
        all_reduce_mean_(grads)
        for p, g in zip(g_params, grads):
            p.grad = g
        apply_updates(state.opt_G, g_lr)
        logs["errG_d"] = err_g.detach()
        logs["errG_struct"] = err_struct.detach()
        # G-progress statistics (the reference prints fake min/max/mean at
        # each train_G iteration, `printer.py:146-157`)
        fake = fake.detach()
        logs["fake/min"] = fake.min()
        logs["fake/max"] = fake.max()
        logs["fake/mean"] = fake.mean()
        # mean |grad| per top-level layer, the grad-flow diagnostic
        # (`plot_util.py:130-146`)
        sums, sizes = {}, {}
        for top, g in zip(g_tops, grads):
            sums[top] = sums.get(top, 0.0) + g.abs().sum()
            sizes[top] = sizes.get(top, 0) + g.numel()
        for top in sums:
            logs[f"gradG/{top}"] = sums[top] / sizes[top]
        return state, reduce_logs(logs)

    return train_step


def stage_for_epoch(epoch: int, step1: int = 6, step2: int = 9) -> int:
    """Loss-mix stage from the epoch index (`GanTrainer.py:113-114`,
    `:302-332`: stage boundaries at epoch_step1 = 6 and epoch_step2 = 9)."""
    if epoch <= step1:
        return 0
    if epoch <= step2:
        return 1
    return 2
