"""The InceptionV3 feature trunk of the FID protocol (port of
`uncltmo_tpu/metrics/inception.py`).

The reference computes FID activations with pytorch-fid's InceptionV3 at
dims=768: the stem convs, Mixed_5b..5d (InceptionA), Mixed_6a (InceptionB)
and Mixed_6b..6e (InceptionC), the 17x17x768 map pooled adaptively to 8x8,
so each image gives 64 patch vectors (`fid/inception.py:86-117`,
`fid/fid_score.py:151-158`).  pytorch-fid's InceptionA/C pool with 3x3
stride-1 averages that do NOT count the zero padding (TensorFlow's rule,
`fid/inception.py:195-214`).  Inputs in [0, 1] are mapped to `2x - 1`
(`fid/inception.py:153`).

Batch norm (eps 1e-3, inference) is folded into each conv on the host in
float32, exactly as the JAX package folds it, so every BasicConv2d is one
biased `nn.Conv2d` (cuDNN on the card).  The weights come from a
torchvision-named InceptionV3 state dict (the pytorch-fid release
`pt_inception-2015-12-05-*.pth`, or any torchvision `inception_v3`), as
`.pth` or as a flat `.npz`; a missing file raises, and there is no
random-weight fallback.
"""
from __future__ import annotations

import os
from typing import Callable, Dict

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from uncltmo_tpu_torch.inference.engine import disable_tf32

BN_EPS = 1e-3


def _avg_pool_3x3_nopad_count(x: torch.Tensor) -> torch.Tensor:
    """3x3 stride-1 average pool, zero-padded, the padding left out of the
    divisor (the TF / FID rule, `fid/inception.py:203-206`)."""
    return F.avg_pool2d(x, 3, stride=1, padding=1, count_include_pad=False)


class _Branches(nn.Module):
    """The folded convs of one Mixed block, each followed by a relu."""

    def __init__(self, convs):
        super().__init__()
        for name, cin, cout, kernel, stride, pad in convs:
            setattr(self, name, nn.Conv2d(cin, cout, kernel, stride, pad))

    def c(self, name: str, x: torch.Tensor) -> torch.Tensor:
        return F.relu(getattr(self, name)(x))


class InceptionA(_Branches):
    """torchvision InceptionA with the FID pooling patch."""

    def __init__(self, cin: int, pool_features: int):
        super().__init__([
            ("branch1x1", cin, 64, 1, 1, 0),
            ("branch5x5_1", cin, 48, 1, 1, 0),
            ("branch5x5_2", 48, 64, 5, 1, 2),
            ("branch3x3dbl_1", cin, 64, 1, 1, 0),
            ("branch3x3dbl_2", 64, 96, 3, 1, 1),
            ("branch3x3dbl_3", 96, 96, 3, 1, 1),
            ("branch_pool", cin, pool_features, 1, 1, 0)])

    def forward(self, x):
        c = self.c
        b1 = c("branch1x1", x)
        b5 = c("branch5x5_2", c("branch5x5_1", x))
        b3 = c("branch3x3dbl_3", c("branch3x3dbl_2", c("branch3x3dbl_1", x)))
        bp = c("branch_pool", _avg_pool_3x3_nopad_count(x))
        return torch.cat([b1, b5, b3, bp], 1)


class InceptionB(_Branches):
    def __init__(self, cin: int):
        super().__init__([
            ("branch3x3", cin, 384, 3, 2, 0),
            ("branch3x3dbl_1", cin, 64, 1, 1, 0),
            ("branch3x3dbl_2", 64, 96, 3, 1, 1),
            ("branch3x3dbl_3", 96, 96, 3, 2, 0)])

    def forward(self, x):
        c = self.c
        b3 = c("branch3x3", x)
        bd = c("branch3x3dbl_3", c("branch3x3dbl_2", c("branch3x3dbl_1", x)))
        return torch.cat([b3, bd, F.max_pool2d(x, 3, stride=2)], 1)


class InceptionC(_Branches):
    """torchvision InceptionC with the FID pooling patch."""

    def __init__(self, cin: int, c7: int):
        super().__init__([
            ("branch1x1", cin, 192, 1, 1, 0),
            ("branch7x7_1", cin, c7, 1, 1, 0),
            ("branch7x7_2", c7, c7, (1, 7), 1, (0, 3)),
            ("branch7x7_3", c7, 192, (7, 1), 1, (3, 0)),
            ("branch7x7dbl_1", cin, c7, 1, 1, 0),
            ("branch7x7dbl_2", c7, c7, (7, 1), 1, (3, 0)),
            ("branch7x7dbl_3", c7, c7, (1, 7), 1, (0, 3)),
            ("branch7x7dbl_4", c7, c7, (7, 1), 1, (3, 0)),
            ("branch7x7dbl_5", c7, 192, (1, 7), 1, (0, 3)),
            ("branch_pool", cin, 192, 1, 1, 0)])

    def forward(self, x):
        c = self.c
        b1 = c("branch1x1", x)
        b7 = c("branch7x7_3", c("branch7x7_2", c("branch7x7_1", x)))
        bd = x
        for i in range(1, 6):
            bd = c(f"branch7x7dbl_{i}", bd)
        bp = c("branch_pool", _avg_pool_3x3_nopad_count(x))
        return torch.cat([b1, b7, bd, bp], 1)


class InceptionTrunk768(_Branches):
    """Stem through Mixed_6e: (N, 3, 299, 299) in [-1, 1] ->
    (N, 768, 17, 17), NCHW.  Parameter names are the torchvision module
    names with `.weight` / `.bias` of the folded conv."""

    def __init__(self):
        super().__init__([
            ("Conv2d_1a_3x3", 3, 32, 3, 2, 0),
            ("Conv2d_2a_3x3", 32, 32, 3, 1, 0),
            ("Conv2d_2b_3x3", 32, 64, 3, 1, 1),
            ("Conv2d_3b_1x1", 64, 80, 1, 1, 0),
            ("Conv2d_4a_3x3", 80, 192, 3, 1, 0)])
        self.Mixed_5b = InceptionA(192, 32)
        self.Mixed_5c = InceptionA(256, 64)
        self.Mixed_5d = InceptionA(288, 64)
        self.Mixed_6a = InceptionB(288)
        self.Mixed_6b = InceptionC(768, 128)
        self.Mixed_6c = InceptionC(768, 160)
        self.Mixed_6d = InceptionC(768, 160)
        self.Mixed_6e = InceptionC(768, 192)

    def forward(self, x):
        c = self.c
        x = c("Conv2d_2b_3x3", c("Conv2d_2a_3x3", c("Conv2d_1a_3x3", x)))
        x = F.max_pool2d(x, 3, stride=2)
        x = c("Conv2d_4a_3x3", c("Conv2d_3b_1x1", x))
        x = F.max_pool2d(x, 3, stride=2)
        for m in (self.Mixed_5b, self.Mixed_5c, self.Mixed_5d, self.Mixed_6a,
                  self.Mixed_6b, self.Mixed_6c, self.Mixed_6d, self.Mixed_6e):
            x = m(x)
        return x


def adaptive_avg_pool(x: torch.Tensor, out_size: int = 8) -> torch.Tensor:
    """NCHW -> (N, C, out, out): cell i averages rows floor(i H / out) ..
    ceil((i + 1) H / out) - 1, per axis (`fid_score.py:155-156`; the JAX
    package's two averaging matrices)."""
    return F.adaptive_avg_pool2d(x, out_size)


# ---------------------------------------------------------------------------
# Weight conversion: torchvision-named state dict -> folded conv weights.
# ---------------------------------------------------------------------------
_STEM = ("Conv2d_1a_3x3", "Conv2d_2a_3x3", "Conv2d_2b_3x3",
         "Conv2d_3b_1x1", "Conv2d_4a_3x3")
_MIXED = {
    "Mixed_5b": ("branch1x1", "branch5x5_1", "branch5x5_2", "branch3x3dbl_1",
                 "branch3x3dbl_2", "branch3x3dbl_3", "branch_pool"),
    "Mixed_6a": ("branch3x3", "branch3x3dbl_1", "branch3x3dbl_2",
                 "branch3x3dbl_3"),
    "Mixed_6b": ("branch1x1", "branch7x7_1", "branch7x7_2", "branch7x7_3",
                 "branch7x7dbl_1", "branch7x7dbl_2", "branch7x7dbl_3",
                 "branch7x7dbl_4", "branch7x7dbl_5", "branch_pool"),
}
_MIXED["Mixed_5c"] = _MIXED["Mixed_5d"] = _MIXED["Mixed_5b"]
_MIXED["Mixed_6c"] = _MIXED["Mixed_6d"] = _MIXED["Mixed_6e"] = \
    _MIXED["Mixed_6b"]


def _fold_basic_conv(sd: Dict, prefix: str) -> Dict[str, np.ndarray]:
    """BasicConv2d (conv without bias + BN eps 1e-3) -> a biased OIHW conv,
    folded in float32 numpy as the JAX package folds it."""
    def get(k):
        v = sd[f"{prefix}.{k}"]
        if isinstance(v, torch.Tensor):
            v = v.detach().cpu().numpy()
        return np.asarray(v, np.float32)

    w = get("conv.weight")
    gamma, beta = get("bn.weight"), get("bn.bias")
    mean, var = get("bn.running_mean"), get("bn.running_var")
    scale = gamma / np.sqrt(var + BN_EPS)
    return {"weight": w * scale[:, None, None, None],
            "bias": beta - mean * scale}


def convert_inception_state_dict(sd: Dict) -> Dict[str, torch.Tensor]:
    """torchvision / pytorch-fid InceptionV3 state dict -> the state dict of
    `InceptionTrunk768`.  Strict for the trunk: a missing key raises
    KeyError; keys past Mixed_6e (Mixed_7*, fc, AuxLogits) are ignored."""
    out = {}
    for name in _STEM:
        for k, v in _fold_basic_conv(sd, name).items():
            out[f"{name}.{k}"] = torch.from_numpy(v)
    for mixed, branches in _MIXED.items():
        for br in branches:
            for k, v in _fold_basic_conv(sd, f"{mixed}.{br}").items():
                out[f"{mixed}.{br}.{k}"] = torch.from_numpy(v)
    return out


def load_inception_params(weights_path: str) -> Dict[str, torch.Tensor]:
    """Load and convert an InceptionV3 state dict (`.pth`, or `.npz` of flat
    `dotted.name` -> array)."""
    if not weights_path or not os.path.exists(weights_path):
        raise FileNotFoundError(
            f"Inception weights not found: {weights_path!r}. FID requires "
            "the pytorch-fid InceptionV3 weights "
            "(pt_inception-2015-12-05-6726825d.pth, URL in the reference's "
            "fid/inception.py:13) or any torchvision inception_v3 state "
            "dict; there is no random-weight fallback.")
    if weights_path.endswith(".npz"):
        with np.load(weights_path) as f:
            sd = dict(f)
    else:
        sd = torch.load(weights_path, map_location="cpu", weights_only=True)
    return convert_inception_state_dict(sd)


def make_inception_extractor(weights_path: str, device="cuda") -> Callable:
    """Returns extractor(batch_nhwc_float01) -> (N, 8, 8, 768) numpy.

    The batch is (N, 299, 299, 3) in [0, 1] (the FID loader resizes); `2x -
    1`, the trunk and the 8x8 pool run on `device` (the card unless the
    caller asks for the CPU) in float32 with TF32 off, NCHW."""
    disable_tf32(device)
    model = InceptionTrunk768()
    model.load_state_dict(load_inception_params(weights_path), strict=True)
    model = model.to(device).eval()

    def extractor(batch_nhwc: np.ndarray) -> np.ndarray:
        x = torch.from_numpy(np.ascontiguousarray(batch_nhwc, np.float32))
        x = x.to(device).permute(0, 3, 1, 2)
        with torch.no_grad():
            feats = adaptive_avg_pool(model(2.0 * x - 1.0), 8)
        return feats.permute(0, 2, 3, 1).cpu().numpy()

    return extractor
