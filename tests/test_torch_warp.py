"""The port's Horn-Schunck flow and warp error against the JAX package
(CPU).

Tolerances: the flow within 0.02 px of JAX's on smooth translations at an
odd (67 x 93) and an even (64 x 64) size: the building blocks agree to
float32 rounding (the warp's normalised grid_sample coordinates to 6e-6 of
a level), and 720 Jacobi updates through bilinear warps amplify that to at
most 5.5e-3 px over eight draws (0.1 px where `np.roll` wraps a frame
around, which these inputs avoid); 0.2 px on uint8 frames, whose data
term is flat between levels (measured 0.097).  The warp error: cv2
branch on both sides E1 and E2 at 1e-6 relative for cv2's estimators (the
same cv2 calls and the same numpy means) and equal provenance; the
Horn-Schunck flow, and the branch without cv2 on both sides (`_HAS_CV2 =
False` on the JAX module, `cv2` hidden from the port), E1 and E2 at 2e-3
relative and the warped frames within 1 level (a flow 5e-3 px apart moves
a bilinear sample across a rounding step now and then).  Frames on the
card take the torch branch whether cv2 imports or not: equal to
`warp_error_torch` on the same frames.
"""
import sys

import cv2
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from uncltmo_tpu.metrics import flow_jax as jflow
from uncltmo_tpu.metrics import warp_error as jwarp
from uncltmo_tpu_torch.metrics import flow as tflow
from uncltmo_tpu_torch.metrics import warp_error as twarp

FLOW_TOL_PX = 0.02
# uint8 frames: the data term is piecewise flat between levels, and the
# Jacobi updates amplify rounding more (measured 0.097 px)
QUANTIZED_FLOW_TOL_PX = 0.2


def _smooth(rng, h, w):
    base = cv2.GaussianBlur(rng.random((h, w)).astype(np.float32), (0, 0),
                            1.5)
    return (base - base.min()) / (base.max() - base.min())


def _translated(base, dx, dy):
    """base moved by (dx, dy) px, edges replicated."""
    h, w = base.shape
    m = np.float32([[1, 0, dx], [0, 1, dy]])
    return cv2.warpAffine(base, m, (w, h), borderMode=cv2.BORDER_REPLICATE)


def _pair(seed=7, h=160, w=200, dx=6.0, dy=0.0):
    base = _smooth(np.random.default_rng(seed), h, w)
    f0 = np.stack([base] * 3, -1)
    f1 = np.stack([_translated(base, dx, dy)] * 3, -1)
    return f0, f1


@pytest.mark.parametrize("h,w,seed", [(67, 93, 0), (67, 93, 1), (64, 64, 2)])
def test_horn_schunck_flow_matches_jax(h, w, seed):
    base = _smooth(np.random.default_rng(seed), h, w)
    moved = _translated(base, 2.5, -1.0)
    ref = np.asarray(jflow.horn_schunck_flow(jnp.asarray(base),
                                             jnp.asarray(moved)))
    got = tflow.horn_schunck_flow(torch.from_numpy(base),
                                  torch.from_numpy(moved))
    assert got.shape == (h, w, 2) and got.dtype == torch.float32
    assert np.abs(got.numpy() - ref).max() <= FLOW_TOL_PX


def test_flow_building_blocks_match_jax_at_odd_sizes():
    import jax
    rng = np.random.default_rng(3)
    x = rng.random((67, 93), np.float32)
    np.testing.assert_allclose(tflow._avg_pool2(torch.from_numpy(x)).numpy(),
                               np.asarray(jflow._avg_pool2(jnp.asarray(x))),
                               rtol=1e-6)
    for got, ref in zip(tflow._grad(torch.from_numpy(x)),
                        jflow._grad(jnp.asarray(x))):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-6,
                                   atol=1e-7)
    u = (rng.standard_normal((67, 93)) * 5).astype(np.float32)
    v = (rng.standard_normal((67, 93)) * 5).astype(np.float32)
    np.testing.assert_allclose(
        tflow._warp(torch.from_numpy(x), torch.from_numpy(u),
                    torch.from_numpy(v)).numpy(),
        np.asarray(jflow._warp(jnp.asarray(x), jnp.asarray(u),
                               jnp.asarray(v))), atol=2e-5)
    for small, big in (((16, 23), (33, 46)), ((33, 46), (67, 93))):
        s = rng.random(small, np.float32)
        np.testing.assert_allclose(
            tflow._upsample(torch.from_numpy(s), big).numpy(),
            np.asarray(jax.image.resize(jnp.asarray(s), big, "linear")),
            atol=5e-6)


def test_horn_schunck_recovers_a_translation():
    """img1(p + f(p)) ~= img0(p): frame 1 moved by +6 px gives f ~ (+6, 0)
    in the interior, and the compensated warp error is a small part of
    the uncompensated one."""
    f0, f1 = _pair()
    flow = tflow.horn_schunck_flow(torch.from_numpy(f0[..., 0]),
                                   torch.from_numpy(f1[..., 0])).numpy()
    interior = flow[40:-40, 40:-40]
    assert abs(float(np.median(interior[..., 0])) - 6.0) < 1.0
    assert abs(float(np.median(interior[..., 1]))) < 1.0
    e1_noflow = float(np.mean((f1[32:-32, 32:-32] - f0[32:-32, 32:-32]) ** 2))
    e1, _ = twarp.compute_warp_error(f0, f1, algo="hs_jax", device="cpu")
    assert e1 < 0.3 * e1_noflow


@pytest.mark.parametrize("algo,rtol", [("auto", 1e-6), ("DIS", 1e-6),
                                       ("Farneback", 1e-6), ("hs_jax", 2e-3)])
def test_warp_error_cv2_branch_matches_jax(algo, rtol):
    f0, f1 = _pair(dx=4.5, dy=1.5)
    noisy = np.clip(f1 + np.random.default_rng(1).normal(
        0, 0.02, f1.shape), 0, 1).astype(np.float32)
    ref = jwarp.compute_warp_error(f0, noisy, algo=algo,
                                   with_provenance=True)
    got = twarp.compute_warp_error(f0, noisy, algo=algo,
                                   with_provenance=True, device="cpu")
    np.testing.assert_allclose(got[:2], ref[:2], rtol=rtol)
    assert got[2] == ref[2]
    assert twarp.resolve_flow_algo(algo) == jwarp.resolve_flow_algo(algo)
    # tensors go to the host on this branch; baseline renders as the flow
    # source are recorded as such
    src0 = (f0 * 255).astype(np.uint8)
    src1 = (f1 * 255).astype(np.uint8)
    ref = jwarp.compute_warp_error(f0, noisy, src0, src1, algo=algo,
                                   with_provenance=True)
    got = twarp.compute_warp_error(torch.from_numpy(f0),
                                   torch.from_numpy(noisy), src0, src1,
                                   algo=algo, with_provenance=True)
    np.testing.assert_allclose(got[:2], ref[:2], rtol=rtol)
    assert got[2] == ref[2] and got[2]["flow_source"] == "baseline"


def test_warp_error_without_cv2_matches_jax(monkeypatch):
    """Both packages' cv2-less branch: the Horn-Schunck flow and a
    bilinear warp, here on CPU tensors."""
    monkeypatch.setattr(jwarp, "_HAS_CV2", False)
    monkeypatch.setitem(sys.modules, "cv2", None)
    assert twarp.resolve_flow_algo("auto") == "hs_jax"
    for seed, (dx, dy) in ((7, (6.0, 0.0)), (8, (3.5, -2.0))):
        f0, f1 = _pair(seed, dx=dx, dy=dy)
        ref = jwarp.compute_warp_error(f0, f1, with_provenance=True)
        got = twarp.compute_warp_error(torch.from_numpy(f0),
                                       torch.from_numpy(f1),
                                       with_provenance=True)
        np.testing.assert_allclose(got[:2], ref[:2], rtol=2e-3)
        assert got[2] == ref[2] == {"flow_algo": "hs_jax",
                                    "flow_source": "self"}
        u8 = (f1 * 255).astype(np.uint8)
        flow = jwarp.estimate_inv_flow(u8[..., 0],
                                       (f0[..., 0] * 255).astype(np.uint8))
        w_ref = jwarp.warp_with_flow(u8, flow)
        w_got = twarp.warp_with_flow(torch.from_numpy(u8),
                                     torch.from_numpy(flow.copy()))
        assert w_got.dtype == torch.uint8
        assert np.abs(w_got.numpy().astype(int) - w_ref).max() <= 1
        t_flow = twarp.estimate_inv_flow(u8[..., 0],
                                         (f0[..., 0] * 255).astype(np.uint8),
                                         device="cpu")
        assert np.abs(t_flow.numpy() - flow).max() <= QUANTIZED_FLOW_TOL_PX


def test_unknown_algo_and_the_crop_guard_raise(monkeypatch):
    rng = np.random.default_rng(5)
    frame = rng.random((128, 160, 3)).astype(np.float32)
    with pytest.raises(ValueError, match="unknown flow algo"):
        twarp.compute_warp_error(frame, frame, algo="dis", device="cpu")
    if not hasattr(cv2, "optflow"):
        with pytest.raises(RuntimeError, match="DeepFlow"):
            twarp.compute_warp_error(frame, frame, algo="DeepFlow")
    small = rng.random((40, 50, 3)).astype(np.float32)
    e1, e2 = twarp.compute_warp_error(small, small, crop=0, algo="hs_jax",
                                      device="cpu")
    assert np.isfinite(e1) and np.isfinite(e2) and e1 < 1e-6
    with pytest.raises(ValueError, match="too small"):
        twarp.compute_warp_error(small, small, crop=32, algo="hs_jax",
                                 device="cpu")
    monkeypatch.setitem(sys.modules, "cv2", None)
    with pytest.raises(ValueError, match="too small"):
        twarp.compute_warp_error(torch.from_numpy(small),
                                 torch.from_numpy(small))


def test_frames_on_the_card_take_the_torch_branch(monkeypatch):
    """The branch follows the frames: on the card 'auto' is Horn-Schunck
    and the warp is torch's even where cv2 imports; a cv2 estimator named
    explicitly still runs on the host.  The card is stood in for here by
    `on_card` patched true on CPU tensors; the torch branch on the CPU,
    `warp_error_torch`, is what the card is held against."""
    assert twarp.on_card(np.zeros((4, 4)), "cuda")
    assert not twarp.on_card(np.zeros((4, 4)), "cpu")
    assert not twarp.on_card(torch.zeros(4, 4), "cuda")
    assert twarp.resolve_flow_algo("auto", card=True) == "hs_jax"
    assert twarp.resolve_flow_algo("DIS", card=True) == "DIS"
    assert twarp.resolve_flow_algo("auto") == jwarp.resolve_flow_algo("auto")
    f0, f1 = (torch.from_numpy(f) for f in _pair(9, dx=3.5, dy=-2.0))
    want = twarp.warp_error_torch(f0, f1)
    calls = []
    remap = cv2.remap
    monkeypatch.setattr(cv2, "remap",
                        lambda *a, **k: calls.append("remap") or remap(*a, **k))
    monkeypatch.setattr(twarp, "on_card", lambda frame, device="cuda": True)
    got = twarp.compute_warp_error(f0, f1, with_provenance=True)
    assert got == want + ({"flow_algo": "hs_jax", "flow_source": "self"},)
    assert calls == []
    dis = twarp.compute_warp_error(f0, f1, algo="DIS", with_provenance=True)
    assert dis[2]["flow_algo"] == "DIS" and calls == ["remap"]
    # the torch branch on the CPU is the one that runs without cv2
    monkeypatch.setitem(sys.modules, "cv2", None)
    assert twarp.compute_warp_error(f0, f1, device="cpu") == want
