"""Adversarial and contrastive (InfoNCE) losses, NCHW.

Port of `uncltmo_tpu/losses/adversarial.py` (reference
`GanTrainer.py:221-451`), function for function.  The naturalness scores
that rank samples (`info_nce2`) and patches (`pseudo_label_loss`) are taken
without gradient, on the tensor's device; `argmax`/`argmin` return the first
index among equal scores, as `jnp.argmax` does.  `contrastive_d_loss` and
`generator_loss_terms` (`training/train_step.py`) are float32 islands
(`ops/precision.py`): under bfloat16 autocast the losses still take
float32 logits and features and compute in float32, as the JAX package
does; the relativistic loss compares logits that differ by far less than a
bfloat16 step of their size.

Under a process group (`parallel/mesh.py`) the terms that couple the batch
see the global batch: `contrastive_d_loss` sets the gathered real logits
against the gathered fake ones (the same value on every rank), and
`info_nce2` / `pseudo_label_loss` rank the gathered naturalness scores and
take the chosen sample or patch from whichever rank holds it.  The means
over samples (`nce`, `info_nce2`, `mean_*_l1`, `pseudo_label_loss`,
`tv_loss`) are then taken over the rank's own rows: each rank's value is its
share, and the mean over the ranks is the one-process loss, which is what
the step's gradient mean needs.
"""
from __future__ import annotations

import torch

from uncltmo_tpu_torch.metrics.tmqi import batched_naturalness
from uncltmo_tpu_torch.ops.precision import float32_island
from uncltmo_tpu_torch.ops.windows import contrast_map
from uncltmo_tpu_torch.parallel.mesh import all_gather_batch, gather_rows


@float32_island
def contrastive_d_loss(real_logits: torch.Tensor,
                       fake_logits: torch.Tensor) -> torch.Tensor:
    """Relativistic pairwise cross-entropy (`GanTrainer.py:221-231`): each
    real logit competes against every fake logit, and each negated fake
    logit against every negated real one;
    loss_half(t1, t2) = mean_i CE([t1_i, t2_0..t2_m], 0)."""
    r, f = all_gather_batch(real_logits.reshape(-1),
                            fake_logits.reshape(-1))

    def loss_half(t1, t2):
        logits = torch.cat([t1[:, None],
                            t2[None, :].expand(t1.shape[0], t2.shape[0])], 1)
        return torch.mean(torch.logsumexp(logits, dim=1) - t1)

    return loss_half(r, f) + loss_half(-f, -r)


def _similarity(a: torch.Tensor, b: torch.Tensor, k: float,
                c: float) -> torch.Tensor:
    """sum_ch (a*b) / (c + k|a-b|), then the spatial mean: (B, C, H, W)
    feature maps -> (B,) (`GanTrainer.py:421-430`)."""
    s = torch.sum(a * b * (1.0 / (c + k * torch.abs(a - b))), dim=1)
    return torch.mean(s, dim=(1, 2))


def lmcl_loss(pos: torch.Tensor, negs: torch.Tensor) -> torch.Tensor:
    """Large-margin cosine-style contrastive loss (`GanTrainer.py:441-451`):
    -log(exp(pos) / sum_j exp(neg_j)), mean over the batch; the positive is
    not in the denominator.  pos: (B,), negs: (B, K)."""
    return torch.mean(torch.logsumexp(negs, dim=1) - pos)


def nce(fea_anchor: torch.Tensor, fea_positive: torch.Tensor,
        fea_negative: torch.Tensor, k: float, c: float,
        loss_type: str = "InfoNCE") -> torch.Tensor:
    """Contrastive loss over one positive and one negative similarity
    (`GanTrainer.py:411-440`); `loss_type` is InfoNCE (published) or
    LMCL."""
    pos = _similarity(fea_anchor, fea_positive, k, c)
    neg = _similarity(fea_anchor, fea_negative, k, c)
    if loss_type == "LMCL":
        return lmcl_loss(pos, neg[:, None])
    if loss_type != "InfoNCE":
        raise ValueError(f"unknown cl_loss_type {loss_type!r} "
                         "(InfoNCE or LMCL)")
    logits = torch.stack([pos, neg], dim=1)
    return torch.mean(torch.logsumexp(logits, dim=1) - pos)


def info_nce2(fea_fake: torch.Tensor, fake: torch.Tensor, k: float,
              c: float, loss_type: str = "InfoNCE") -> torch.Tensor:
    """In-batch contrastive loss ranked by naturalness
    (`GanTrainer.py:385-409`): the features of the most natural fake are
    every sample's positive, those of the least natural its negative.
    fea_fake: (B, F, h, w); fake: (B, 1, H, W) in [0, 1]."""
    with torch.no_grad():
        scores = all_gather_batch(
            batched_naturalness(fake.detach()[:, 0] * 255.0))
        picks = torch.stack([torch.argmax(scores), torch.argmin(scores)])
    fea_pos, fea_neg = (f[None].expand_as(fea_fake)
                        for f in gather_rows(fea_fake, picks))
    return nce(fea_fake, fea_pos, fea_neg, k, c, loss_type)


def _spatial_mean(x: torch.Tensor) -> torch.Tensor:
    return torch.mean(x, dim=(2, 3))


def mean_brightness_l1(fake: torch.Tensor,
                       ldr_pos: torch.Tensor) -> torch.Tensor:
    """L1 between per-image mean luminances (`GanTrainer.py:308`)."""
    return torch.mean(torch.abs(_spatial_mean(fake) - _spatial_mean(ldr_pos)))


def mean_contrast_l1(fake: torch.Tensor,
                     ldr_pos: torch.Tensor) -> torch.Tensor:
    """L1 between per-image means of the local-contrast maps
    (`GanTrainer.py:309-312`)."""
    return torch.mean(torch.abs(_spatial_mean(contrast_map(fake))
                                - _spatial_mean(contrast_map(ldr_pos))))


def pseudo_label_loss(fake: torch.Tensor, split: int = 2) -> torch.Tensor:
    """Patch pseudo-label loss ranked by naturalness
    (`GanTrainer.py:340-369`): each fake is cut into split^2 patches, the
    most natural patch of the batch is the pseudo label, and every patch's
    mean brightness and mean contrast are pulled toward it.
    fake: (B, 1, H, H)."""
    b, _, h, _ = fake.shape
    ps = h // split
    patches = fake.reshape(b, split, ps, split, ps).permute(0, 1, 3, 2, 4)
    patches = patches.reshape(-1, 1, ps, ps)
    with torch.no_grad():
        best = torch.argmax(all_gather_batch(batched_naturalness(
            patches.detach()[:, 0] * 255.0)))[None]
    pseudo = gather_rows(patches, best)

    m = _spatial_mean(patches)                       # (P, 1)
    m_p = _spatial_mean(pseudo)                      # (1, 1)
    loss = torch.mean(torch.abs(m - m_p))
    cm = _spatial_mean(contrast_map(patches))
    cm_p = _spatial_mean(contrast_map(pseudo))
    return loss + torch.mean(torch.abs(cm - cm_p))


def tv_loss(x: torch.Tensor) -> torch.Tensor:
    """Total variation (`GanTrainer.py:669-682`), NCHW."""
    b, _, h, w = x.shape
    count_h = (h - 1) * w
    count_w = h * (w - 1)
    h_tv = torch.sum(torch.square(x[:, :, 1:] - x[:, :, :-1]))
    w_tv = torch.sum(torch.square(x[:, :, :, 1:] - x[:, :, :, :-1]))
    return 2.0 * (h_tv / count_h + w_tv / count_w) / b
