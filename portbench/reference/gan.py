"""Plain PyTorch reference of the published GAN training step, stage 0
(reference `GanTrainer.py:202-332`, `scripts/run_imageTMO_train.sh`):

1. D update on the old G's fake: relativistic pairwise cross-entropy of
   D(ldr_pos) against D(G(hdr)), Adam(beta1 0.5, beta2 0.999, eps 1e-8).
2. G update against the updated D: 0.1 x [the relativistic loss of
   D(fake) against D(ldr_pos); 0.5 x InfoNCE of D's feature of the fake
   against the real's (positive) and the input's (negative), k 1, c 1e-2;
   0.1 x InfoNCE against the real's and the over/under-exposed negative's,
   k 1e3, c 2; 1e-6 x the in-batch InfoNCE of G's last feature map ranked
   by TMQI naturalness; 1e-6 x mean brightness L1; 1e-6 x mean local
   contrast L1; 1e-6 x the patch pseudo-label loss ranked by naturalness]
   plus the structural loss pyramid (0.2, 0.4, 0.6) of window-
   standardised MSE against the input, then Adam.

`SimpleDiscriminator` (conv4s2 -> lrelu -> conv4s2 -> lrelu -> 1x1 conv
-> linear head; feature: the map's mean and the mean of its 11 x 11
Gaussian local variance), the generator's drop path (per-sample masks
x mask / 0.95 on the GCN's two residual branches, given by the caller)
and the losses are written out below.  Parameters are flat dicts in the
reference `.pth` layouts.
"""
from __future__ import annotations

import contextlib
import math

import numpy as np
import torch
import torch.nn.functional as F

from . import unet

BETAS = (0.5, 0.999)
ADAM_EPS = 1e-8
EPS2 = 1e-5
KEEP = 0.95


def disc_shapes(size: int = 256, dim: int = 16) -> dict:
    side = (size // 2 - 1) // 2 - 1
    return {"model.0.weight": (dim, 1, 4, 4), "model.0.bias": (dim,),
            "model.2.weight": (2 * dim, dim, 4, 4),
            "model.2.bias": (2 * dim,),
            "model.4.weight": (1, 2 * dim, 1, 1), "model.4.bias": (1,),
            "tail.1.weight": (1, side * side)}


@contextlib.contextmanager
def tf32_mode(on: bool):
    """TF32 for every product on the card, forward and backward."""
    flags = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = on
    torch.backends.cuda.matmul.allow_tf32 = on
    try:
        yield
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = flags


# ------------------------------------------------------------ windows
def _gauss11() -> np.ndarray:
    n = np.arange(11) - 5.0
    g = np.exp(-(n ** 2) / (2 * 1.5 ** 2))
    return g / g.sum()


def _sep(x, k1d):
    """Valid separable window mean of an NCHW tensor, every channel."""
    c = x.shape[1]
    k = torch.as_tensor(k1d, dtype=x.dtype, device=x.device)
    x = F.conv2d(x, k.reshape(1, 1, -1, 1).expand(c, 1, -1, 1), groups=c)
    return F.conv2d(x, k.reshape(1, 1, 1, -1).expand(c, 1, 1, -1), groups=c)


def contrast_map(x):
    """11 x 11 Gaussian (sigma 1.5) local variance, valid."""
    g = _gauss11()
    mu = _sep(x, g)
    return _sep(x * x, g) - mu * mu


def _mean_hw(x):
    return x.mean(dim=(2, 3))


# --------------------------------------------------------- naturalness
def naturalness(ldr):
    """TMQI's statistical naturalness of (N, H, W) images in [0, 255]:
    a Gaussian prior on the mean (115.94, 27.99) times a Beta(4.4, 10.1)
    prior on the mean std of 11 x 11 blocks / 64.29, each over its mode."""
    n, h, w = ldr.shape
    x = F.pad(ldr, (0, 11 - w % 11, 0, 11 - h % 11))
    hb, wb = x.shape[1] // 11, x.shape[2] // 11
    blocks = x.reshape(n, hb, 11, wb, 11).transpose(2, 3).reshape(
        n, hb * wb, 121)
    sig = blocks.std(dim=-1, correction=0).mean(-1) / 64.29
    a, b = 4.4, 10.1
    logb = math.lgamma(a) + math.lgamma(b) - math.lgamma(a + b)

    def beta(t):
        return torch.exp((a - 1) * torch.log(t) + (b - 1) * torch.log1p(-t)
                         - logb)
    mode = (a - 1) / (a + b - 2)
    c0 = math.exp((a - 1) * math.log(mode) + (b - 1) * math.log1p(-mode)
                  - logb)
    c = torch.where((sig < 0) | (sig > 1), torch.zeros_like(sig),
                    beta(sig.clamp(1e-6, 1 - 1e-6)))
    z = (ldr.mean(dim=(1, 2)) - 115.94) / 27.99
    return torch.exp(-0.5 * z * z) * c / c0


# -------------------------------------------------------------- losses
def relativistic(real, fake):
    r, f = real.reshape(-1), fake.reshape(-1)

    def half(t1, t2):
        logits = torch.cat([t1[:, None], t2[None, :].expand(len(t1),
                                                            len(t2))], 1)
        return (torch.logsumexp(logits, 1) - t1).mean()
    return half(r, f) + half(-f, -r)


def similarity(a, b, k, c):
    return (a * b / (c + k * (a - b).abs())).sum(1).mean(dim=(1, 2))


def info_nce(anchor, pos, neg, k, c):
    p, n = similarity(anchor, pos, k, c), similarity(anchor, neg, k, c)
    return (torch.logsumexp(torch.stack([p, n], 1), 1) - p).mean()


def info_nce_ranked(fea, fake, k, c):
    with torch.no_grad():
        nat = naturalness(fake[:, 0] * 255.0)
        best, worst = int(torch.argmax(nat)), int(torch.argmin(nat))
    return info_nce(fea, fea[best:best + 1].expand_as(fea),
                    fea[worst:worst + 1].expand_as(fea), k, c)


def pseudo_label(fake, split: int = 2):
    b, _, h, _ = fake.shape
    ps = h // split
    patches = fake.reshape(b, split, ps, split, ps).permute(
        0, 1, 3, 2, 4).reshape(-1, 1, ps, ps)
    with torch.no_grad():
        best = int(torch.argmax(naturalness(patches[:, 0] * 255.0)))
    pseudo = patches[best:best + 1]
    loss = (_mean_hw(patches) - _mean_hw(pseudo)).abs().mean()
    return loss + (_mean_hw(contrast_map(patches))
                   - _mean_hw(contrast_map(pseudo))).abs().mean()


def _bicubic_half(x):
    k = np.array([-0.09375, 0.59375, 0.59375, -0.09375])
    c = x.shape[1]
    kt = torch.as_tensor(k, dtype=x.dtype, device=x.device)
    ph = 2 if x.shape[2] % 2 == 0 else 0
    x = F.pad(x, (0, 0, 1, ph), mode="replicate")
    x = F.conv2d(x, kt.reshape(1, 1, 4, 1).expand(c, 1, 4, 1),
                 stride=(2, 1), groups=c)
    pw = 2 if x.shape[3] % 2 == 0 else 0
    x = F.pad(x, (1, pw, 0, 0), mode="replicate")
    return F.conv2d(x, kt.reshape(1, 1, 1, 4).expand(c, 1, 1, 4),
                    stride=(1, 2), groups=c)


def structural(fake, hdr, weights=(0.2, 0.4, 0.6), win: int = 5):
    """Pyramid of the MSE of 5 x 5 window-standardised images, expanded
    into box-filter responses; a bicubic halving between levels."""
    box = np.full(win, 1.0 / win)
    total = 0.0
    x, y = fake, hdr
    for i, w in enumerate(weights):
        mx, my = _sep(x, box), _sep(y, box)
        sxx, syy, sxy = _sep(x * x, box), _sep(y * y, box), _sep(x * y, box)
        zero = x.new_zeros(())
        a = 1.0 / (torch.sqrt(torch.maximum(sxx - mx * mx, zero) + EPS2)
                   + EPS2)
        b = 1.0 / (torch.sqrt(torch.maximum(syy - my * my, zero) + EPS2)
                   + EPS2)
        cc = a * mx - b * my
        mse = a * a * sxx + b * b * syy - 2 * a * b * sxy - cc * cc
        total = total + w * torch.maximum(mse, zero).mean()
        if i + 1 < len(weights):
            x, y = _bicubic_half(x), _bicubic_half(y)
    return total


# -------------------------------------------------------------- models
def discriminator(p, x, prec):
    y = F.leaky_relu(prec.conv2d(x, p["model.0.weight"], p["model.0.bias"],
                                 stride=2), 0.2)
    y = F.leaky_relu(prec.conv2d(y, p["model.2.weight"], p["model.2.bias"],
                                 stride=2), 0.2)
    fea = prec.conv2d(y, p["model.4.weight"], p["model.4.bias"])
    logit = fea.flatten(1) @ p["tail.1.weight"].t()
    feat = torch.cat([fea.mean(dim=(2, 3), keepdim=True),
                      contrast_map(fea).mean(dim=(2, 3), keepdim=True)], 1)
    return logit, feat


def adam_(params, grads, m, v, t: int, lr: float) -> None:
    b1, b2 = BETAS
    with torch.no_grad():
        for k, g in grads.items():
            m[k].mul_(b1).add_(g, alpha=1 - b1)
            v[k].mul_(b2).addcmul_(g, g, value=1 - b2)
            mh = m[k] / (1 - b1 ** t)
            vh = v[k] / (1 - b2 ** t)
            params[k].sub_(lr * mh / (vh.sqrt() + ADAM_EPS))


class Step:
    """The training state (both parameter dicts and Adam's moments) and the
    published stage-0 step over it."""

    def __init__(self, g_params: dict, d_params: dict,
                 prec: unet.Precision | None = None):
        self.g = {k: v.clone() for k, v in g_params.items()}
        self.d = {k: v.clone() for k, v in d_params.items()}
        self.prec = prec or unet.Precision()
        zeros = {k: torch.zeros_like(v) for k, v in self.g.items()}
        self.mg, self.vg = zeros, {k: z.clone() for k, z in zeros.items()}
        self.md = {k: torch.zeros_like(v) for k, v in self.d.items()}
        self.vd = {k: torch.zeros_like(v) for k, v in self.d.items()}
        self.t = 0
        self.trained = [k for k in self.g if not k.endswith("relative_pos")]

    def _gen(self, p, x, masks):
        return unet.generator_frame(p, x, None, self.prec, drop=masks)

    def __call__(self, batch: dict, masks, g_lr: float, d_lr: float) -> dict:
        """One step; `masks` the step's four (N,) keep masks in call order
        (D phase Grapher, FFN; G phase Grapher, FFN).  Returns the losses
        and, as `grads`, the G and D gradients Adam was given."""
        def frames(x):                        # (B, T, H, W, C) -> NCHW
            return x.permute(0, 1, 4, 2, 3).reshape(
                (-1, x.shape[-1]) + tuple(x.shape[2:4]))
        hdr, pos, neg = (frames(batch[k]) for k in ("hdr", "ldr_pos",
                                                     "ldr_neg"))
        luma = hdr[:, :1]
        self.t += 1
        with tf32_mode(self.prec.tf32):
            with torch.no_grad():
                old_fake, _ = self._gen(self.g, hdr, masks[0:2])
            d = {k: v.requires_grad_() for k, v in self.d.items()}
            real_l, _ = discriminator(d, pos, self.prec)
            fake_l, _ = discriminator(d, old_fake, self.prec)
            err_d = relativistic(real_l, fake_l)
            gd = dict(zip(d, torch.autograd.grad(err_d, list(d.values()))))
            for v in d.values():
                v.requires_grad_(False)
            adam_(self.d, gd, self.md, self.vd, self.t, d_lr)

            g = {k: (v.requires_grad_() if k in self.trained else v)
                 for k, v in self.g.items()}
            fake, up_x = self._gen(g, hdr, masks[2:4])
            d_fake, f_fake = discriminator(self.d, fake, self.prec)
            with torch.no_grad():
                d_real, f_real = discriminator(self.d, pos, self.prec)
                _, f_neg = discriminator(self.d, neg, self.prec)
                _, f_in = discriminator(self.d, luma, self.prec)
            k = 0.1
            err_g = k * relativistic(d_fake, d_real)
            err_g = err_g + k * 0.5 * info_nce(f_fake, f_real, f_in, 1.0,
                                               1e-2)
            err_g = err_g + k * 0.5 * (0.2 * info_nce(f_fake, f_real, f_neg,
                                                      1e3, 2.0))
            err_g = err_g + k * 1e-6 * info_nce_ranked(up_x, fake, 1.0, 1e-2)
            err_g = err_g + k * 1e-6 * (_mean_hw(fake)
                                        - _mean_hw(pos)).abs().mean()
            err_g = err_g + k * 1e-6 * (
                _mean_hw(contrast_map(fake))
                - _mean_hw(contrast_map(pos))).abs().mean()
            err_g = err_g + k * 1e-6 * pseudo_label(fake)
            err_s = structural(fake, luma)
            leaves = [g[n] for n in self.trained]
            gg = dict(zip(self.trained,
                          torch.autograd.grad(err_g + err_s, leaves)))
            for n in self.trained:
                g[n].requires_grad_(False)
            adam_(self.g, gg, self.mg, self.vg, self.t, g_lr)
        return {"errD": float(err_d.detach()), "errG_d": float(err_g.detach()),
                "errG_struct": float(err_s.detach()),
                "grads": {"G": gg, "D": gd}}
