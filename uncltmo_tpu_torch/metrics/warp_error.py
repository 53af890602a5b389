"""Temporal-consistency warp error (port of
`uncltmo_tpu/metrics/warp_error.py`; reference `metrics/compute_wrap_error.py`,
`Tester.py:414-496`): estimate the inverse optical flow between two
consecutive tone-mapped frames, warp frame 1 onto frame 0, and report

  E1 = mean((warped - target)^2)                      (`Tester.py:389`)
  E2 = mean(|warped - target| / (1e-8 + warped + target))
                                                      (`compute_wrap_error.py:118`)

on a 32-px centre crop.

The branch follows where the frames are.  Frames on the card (CUDA
tensors, or numpy arrays with a CUDA `device`) take the pyramidal
Horn-Schunck flow of `metrics/flow.py` and a bilinear warp, in torch on
the card, whether cv2 imports or not: 'auto' resolves to 'hs_jax' there.
Frames on the host follow the JAX package's rule: where cv2 imports, its
estimators (DeepFlow with opencv-contrib, else DIS, else Farneback) and
`cv2.remap`; elsewhere the torch branch on the CPU.  A cv2 estimator named
explicitly runs on the host wherever the frames are.  cv2 is imported
inside the functions that use it.  The algo names are the JAX package's,
so a provenance record compares across the two packages: 'hs_jax' names
the Horn-Schunck estimator wherever it runs.
"""
from __future__ import annotations

import numpy as np
import torch

_ALGOS = ("auto", "DeepFlow", "DIS", "Farneback", "hs_jax")


def _cv2():
    """The cv2 module, or None where it does not import."""
    try:
        import cv2
    except ImportError:
        return None
    return cv2


def on_card(frame, device="cuda") -> bool:
    """Whether `frame` is evaluated on the card: a CUDA tensor, or a numpy
    array with a CUDA `device`."""
    if isinstance(frame, torch.Tensor):
        return frame.is_cuda
    return torch.device(device).type == "cuda"


def _to_uint8(img):
    """The reference's range rule and cast (`compute_wrap_error.py:54-60`),
    numpy or tensor: x 255 and clipped when the max is <= 1, then truncated
    (the [0, 255] branch is not clipped)."""
    if img.max() <= 1.0:
        img = (img * 255.0).clip(0, 255)
    if isinstance(img, torch.Tensor):
        return img.to(torch.uint8)
    return img.astype(np.uint8)


def resolve_flow_algo(algo: str = "auto", card: bool = False) -> str:
    """The estimator `estimate_inv_flow` runs for `algo`, on the card
    (`card`) or on this host.  'auto' resolves differently across cv2
    builds (DeepFlow needs opencv-contrib) and is 'hs_jax' on the card, so
    whatever records E1 / E2 records this beside them."""
    if algo not in _ALGOS:
        raise ValueError(f"unknown flow algo {algo!r}; choose from {_ALGOS}")
    cv2 = _cv2()
    if algo == "hs_jax" or cv2 is None or (card and algo == "auto"):
        return "hs_jax"
    if algo in ("auto", "DeepFlow") and hasattr(cv2, "optflow"):
        return "DeepFlow"
    if algo == "DeepFlow":
        raise RuntimeError(
            "DeepFlow requested but this cv2 build has no optflow "
            "(opencv-contrib) module; use 'DIS', 'Farneback', 'hs_jax', "
            "or 'auto'")
    if algo in ("auto", "DIS") and hasattr(cv2, "DISOpticalFlow_create"):
        return "DIS"
    if algo == "DIS":
        raise RuntimeError(
            "DIS requested but this cv2 build lacks DISOpticalFlow_create; "
            "use 'Farneback', 'hs_jax', or 'auto'")
    return "Farneback"


def estimate_inv_flow(img0, img1, algo: str = "auto", device="cuda"):
    """Flow f with img1(p + f(p)) ~= img0(p) between grayscale uint8 frames
    (numpy arrays, or tensors for 'hs_jax'), so remapping img1 by f gives
    img0: calc(prev=img0, next=img1) in cv2's convention.  A cv2 estimator
    returns a numpy (H, W, 2) array; 'hs_jax' a float32 tensor on `device`
    (a tensor frame's own device).  A requested estimator is never
    substituted: unknown or unavailable names raise."""
    resolved = resolve_flow_algo(algo, on_card(img0, device))
    if resolved == "hs_jax":
        from uncltmo_tpu_torch.metrics.flow import estimate_inv_flow_torch
        return estimate_inv_flow_torch(img0, img1, device=device)
    if img0.dtype != np.uint8 or img1.dtype != np.uint8:
        raise ValueError("cv2's flow estimators take uint8 frames")
    cv2 = _cv2()
    if resolved == "DeepFlow":
        return cv2.optflow.createOptFlow_DeepFlow().calc(img0, img1, None)
    if resolved == "DIS":
        est = cv2.DISOpticalFlow_create(cv2.DISOPTICAL_FLOW_PRESET_MEDIUM)
        return est.calc(img0, img1, None)
    return cv2.calcOpticalFlowFarneback(img0, img1, None,
                                        0.5, 3, 15, 3, 5, 1.2, 0)


def _warp_torch(img, flow: torch.Tensor) -> torch.Tensor:
    """img sampled at p + flow(p) in torch on the flow's device, clamped
    at the borders, rounded and clipped back to uint8, as the JAX
    package's map_coordinates branch."""
    from uncltmo_tpu_torch.metrics.flow import _sample
    if not isinstance(img, torch.Tensor):
        img = torch.from_numpy(np.ascontiguousarray(img))
    im = img.to(device=flow.device, dtype=torch.float32)
    chw = im.permute(2, 0, 1) if im.dim() == 3 else im[None]
    h, w = flow.shape[:2]
    yy = torch.arange(h, dtype=torch.float32, device=flow.device)[:, None]
    xx = torch.arange(w, dtype=torch.float32, device=flow.device)[None, :]
    out = _sample(chw, yy + flow[..., 1], xx + flow[..., 0])
    out = out.permute(1, 2, 0) if im.dim() == 3 else out[0]
    return torch.clamp(torch.round(out), 0, 255).to(torch.uint8)


def warp_with_flow(img, flow):
    """Bilinear remap of a uint8 (H, W[, C]) image by a dense flow (numpy
    or tensor).  A flow on the host is remapped by `cv2.remap` where cv2
    imports (numpy out); a flow on the card, or any flow without cv2, is
    sampled in torch on the flow's device (a uint8 tensor out)."""
    cv2 = _cv2()
    card = isinstance(flow, torch.Tensor) and flow.is_cuda
    if card or cv2 is None:
        return _warp_torch(img, torch.as_tensor(flow))
    if isinstance(flow, torch.Tensor):
        flow = flow.cpu().numpy()
    if isinstance(img, torch.Tensor):
        img = img.cpu().numpy()
    h, w = flow.shape[:2]
    fmap = flow.copy()
    fmap[:, :, 0] += np.arange(w)
    fmap[:, :, 1] += np.arange(h)[:, None]
    return cv2.remap(img, fmap, None, cv2.INTER_LINEAR)


def _check_crop(frame, crop: int) -> None:
    if crop > 0 and (frame.shape[0] <= 2 * crop
                     or frame.shape[1] <= 2 * crop):
        raise ValueError(
            f"frames {tuple(frame.shape[:2])} too small for the {crop}-px "
            "centre crop (the mean over an empty slice would be NaN)")


def _channel0(img):
    # the flow runs on channel 0, as the reference (`compute_wrap_error.py:
    # 62-63`)
    return img[..., 0] if img.ndim == 3 else img


def warp_error_torch(frame0, frame1, flow_source0=None, flow_source1=None,
                     crop: int = 32, device="cuda"):
    """(E1, E2) on the torch branch: the Horn-Schunck flow, the bilinear
    warp and the means, all on the frames' device when they are tensors,
    else on `device`.  The branch `compute_warp_error` takes on the card;
    callable on the CPU to hold the card against."""
    _check_crop(frame0, crop)
    if isinstance(frame0, torch.Tensor):
        device = frame0.device

    def prepare(img):
        if not isinstance(img, torch.Tensor):
            img = torch.from_numpy(np.ascontiguousarray(img))
        return img.to(device)

    f0, f1 = prepare(frame0), prepare(frame1)
    src0 = _to_uint8(prepare(flow_source0) if flow_source0 is not None
                     else f0)
    src1 = _to_uint8(prepare(flow_source1) if flow_source1 is not None
                     else f1)
    from uncltmo_tpu_torch.metrics.flow import estimate_inv_flow_torch
    flow = estimate_inv_flow_torch(_channel0(src0), _channel0(src1))
    warped = _warp_torch(_to_uint8(f1), flow)
    target = _to_uint8(f0)
    sl = slice(crop, -crop) if crop > 0 else slice(None)
    a = warped[sl, sl].to(torch.float32) / 255.0
    b = target[sl, sl].to(torch.float32) / 255.0
    e1, e2 = torch.stack([
        torch.mean((a - b) ** 2),
        torch.mean(torch.abs(a - b) / (1e-8 + a + b))]).tolist()
    return e1, e2


def compute_warp_error(frame0, frame1, flow_source0=None, flow_source1=None,
                       crop: int = 32, algo: str = "auto",
                       with_provenance: bool = False, device="cuda"):
    """(E1, E2) between consecutive tone-mapped frames.

    frame0 / frame1: (H, W, C) in [0, 1] or [0, 255], numpy or tensors.
    The flow may be estimated on another rendering of the scene, as the
    reference does with its L1L0 baseline renders (`Tester.py:378-390`):
    pass those as flow_source0/1; by default the frames themselves.  Frames
    on the card stay there (`warp_error_torch`) unless a cv2 estimator is
    named; frames on the host take cv2's estimators and `cv2.remap` where
    cv2 imports, as the JAX package does, else the torch branch on the CPU.

    `with_provenance=True` appends {'flow_algo': the resolved estimator,
    'flow_source': 'baseline' or 'self'}: warp errors compare only within
    one such pair.  The paper's protocol is DeepFlow on the L1L0 renders.
    """
    _check_crop(frame0, crop)
    card = on_card(frame0, device)
    resolved = resolve_flow_algo(algo, card)
    if _cv2() is None or (card and resolved == "hs_jax"):
        e1, e2 = warp_error_torch(frame0, frame1, flow_source0, flow_source1,
                                  crop, device=device if card else "cpu")
    else:
        def host(img):
            return (img.cpu().numpy() if isinstance(img, torch.Tensor)
                    else np.asarray(img))

        f0, f1 = host(frame0), host(frame1)
        src0 = _to_uint8(host(flow_source0) if flow_source0 is not None
                         else f0)
        src1 = _to_uint8(host(flow_source1) if flow_source1 is not None
                         else f1)
        flow = estimate_inv_flow(_channel0(src0), _channel0(src1), resolved,
                                 device="cpu")
        warped = warp_with_flow(_to_uint8(f1), flow)
        sl = slice(crop, -crop) if crop > 0 else slice(None)
        a = warped[sl, sl].astype(np.float32) / 255.0
        b = _to_uint8(f0)[sl, sl].astype(np.float32) / 255.0
        e1 = float(np.mean((a - b) ** 2))
        e2 = float(np.mean(np.abs(a - b) / (1e-8 + a + b)))
    if with_provenance:
        info = {"flow_algo": resolved,
                "flow_source": ("baseline" if flow_source0 is not None
                                else "self")}
        return e1, e2, info
    return e1, e2
