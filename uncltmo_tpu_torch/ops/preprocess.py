"""HDR preprocessing on (H, W, C) tensors: the lambda-log luma, the U-Net
grid pad and its crop, and the add_frame models' batch centre crop (port of
`uncltmo_tpu/ops/preprocess.py:16-98`)."""
from __future__ import annotations

import torch
import torch.nn.functional as F

from uncltmo_tpu_torch.ops.color import to_gray


def log_lambda_luma(gray: torch.Tensor, f_factor) -> torch.Tensor:
    """min-shift + log10(x/max * f + 1) / max ("min_log" TRC,
    reference `utils/model_save_util.py:214-216`)."""
    gray = gray - gray.min()
    a = torch.log10((gray / gray.max()) * f_factor + 1.0)
    return a / a.max()


def gamma_luma(gray: torch.Tensor, f_factor) -> torch.Tensor:
    """The "gamma" TRC (reference `utils/data_loader_util.py:203-208`)."""
    gamma = 1.0 / (1.0 + torch.log10(torch.as_tensor(
        f_factor, dtype=gray.dtype, device=gray.device)))
    return (gray / gray.max()) ** gamma


def hdr_to_network_input(rgb: torch.Tensor, f_factor,
                         data_trc: str = "min_log") -> torch.Tensor:
    """RGB HDR (H, W, 3) -> network luminance input (H, W, 1)
    (reference `utils/model_save_util.py:204-217`)."""
    rgb = rgb - torch.clamp(rgb.min(), max=0.0)
    gray = to_gray(rgb)
    if "min" in data_trc:
        gray = gray - gray.min()
    if "log" in data_trc:
        return log_lambda_luma(gray, f_factor)
    if "gamma" in data_trc:
        return gamma_luma(gray, f_factor)
    raise ValueError(f"unsupported data_trc: {data_trc}")


def padded_size(n: int) -> int:
    """16 * floor(n / 16) + 16 (reference `data_loader_util.py:145-146`)."""
    return int(16 * int(n / 16.0)) + 16


def pad_to_unet_grid(im: torch.Tensor, min_size: int = 256
                     ) -> tuple[torch.Tensor, int, int]:
    """Replicate-pad (H, W, C) so H, W = 16k + 16 and >= min_size.
    Returns (padded, diffY, diffX), split (d//2, d - d//2)."""
    h, w = im.shape[0], im.shape[1]
    th = max(padded_size(h), min_size)
    tw = max(padded_size(w), min_size)
    dy, dx = abs(h - th), abs(w - tw)
    chw = im.permute(2, 0, 1)[None]
    chw = F.pad(chw, (dx // 2, dx - dx // 2, dy // 2, dy - dy // 2),
                mode="replicate")
    return chw[0].permute(1, 2, 0), dy, dx


def crop_frame(im: torch.Tensor, diff_y: int, diff_x: int) -> torch.Tensor:
    """Remove the frame added by `pad_to_unet_grid` from (H, W, C)."""
    if diff_y == 0 and diff_x == 0:
        return im
    return im[diff_y // 2: im.shape[0] - (diff_y - diff_y // 2),
              diff_x // 2: im.shape[1] - (diff_x - diff_x // 2)]


def crop_center_batch(x: torch.Tensor, diff_y: int, diff_x: int
                      ) -> torch.Tensor:
    """Centre crop of an NCHW batch by (diff_y, diff_x): the reference's
    `crop_input_hdr_batch` (`utils/data_loader_util.py:165-172`) with its
    `int(round(d / 2))` start index, which for d % 4 == 3 is one row off
    the (d//2, d - d//2) replicate pad.  Kept as it is: the crop only runs
    on the add_frame model path, where the reference's behaviour is the
    specification."""
    if diff_y == 0 and diff_x == 0:
        return x
    h, w = x.shape[2], x.shape[3]
    th, tw = h - diff_y, w - diff_x
    i = int(round((h - th) / 2.0))
    j = int(round((w - tw) / 2.0))
    return x[:, :, i:i + th, j:j + tw]
