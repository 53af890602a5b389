"""The up cell's phase 0 (`ops/kernels/up_cell.py`, `uncltmo_up_cell_folded`)
on the CPU: `Up`'s 2x2 stride-2 ConvTranspose2d, its bias and the pad or
crop to the skip, folded into the up cell's launch.

The plain version of the three-phase cell is `Up.forward`'s torch path
bit for bit (the upsample, `_pad_or_crop`, then the cell) at the four
published cells and at pads and crops of one and two on each axis in both
modes the kernel writes; the phase 0 packing is the 2x2 weight in the
producer's stage order, and a plain-PyTorch rebuild of phase 0 (flat tiles
of M positions, K-channel chunks, the stage read through `b_image_index`,
the epilogue's stores of `fold_store`) gives the upsampled plane; which
`Up` folds; and the backward formula against autograd of the plain cell.
The kernel itself runs only on a card (`tests/test_torch_up_cell_cuda.py`).
"""
import pytest
import torch
import torch.nn as nn
import torch.nn.functional as F

from uncltmo_tpu_torch import params
from uncltmo_tpu_torch.models import blocks
from uncltmo_tpu_torch.models.unet import UNetTMO
from uncltmo_tpu_torch.ops.kernels.packing import b_image_index
from uncltmo_tpu_torch.ops.kernels.up_cell import (
    FOLD_MODES, K, Upsample, default_up_plan, fold_plan, fused_up_cell,
    pad_or_crop, pad_or_crop_backward, pack_upsample_weights,
    up_fold_backward, up_fold_plain, upsample_plain)

# (C, C1, half-resolution side, skip side): the decoder's four cells at a
# 256^2 tile
PUBLISHED = [(256, 128, 12, 24), (128, 64, 28, 57), (64, 32, 61, 122),
             (32, 32, 126, 252)]


def _up(c, c1, mode="edge", seed=0):
    torch.manual_seed(seed)
    up = blocks.Up(c, c, c1, params.SQUARE_AND_SQUARE_ROOT,
                   padding_mode=mode)
    with torch.no_grad():
        for p in up.parameters():
            p.normal_(0, 0.2)
    return up


def _inputs(b, c, h0, w0, h, w, seed=1, dtype=torch.float32):
    g = torch.Generator().manual_seed(seed)
    return (torch.randn(b, c, h0, w0, generator=g, dtype=dtype),
            torch.relu(torch.randn(b, c, h, w, generator=g, dtype=dtype)))


def _fold(up, x, x2):
    cell = up.conv
    return fused_up_cell(x2, x, *cell._weights(),
                         upsample=Upsample(up.up.weight, up.up.bias,
                                           up.padding_mode))


@pytest.mark.parametrize("c,c1,h0,s", PUBLISHED,
                         ids=["up0", "up1", "up2", "up3"])
def test_plain_fold_is_ups_torch_path_at_the_published_cells(c, c1, h0, s):
    up = _up(c, c1)
    assert up.fused_cell and up.fold_upsample
    x, x2 = _inputs(2, c, h0, h0, s, s)
    with torch.no_grad():
        assert torch.equal(_fold(up, x, x2), up(x, x2))


# (dy, dx): the skip's plane against the upsampled one
MARGINS = [(1, 0), (0, 1), (-1, 0), (0, -1), (2, 2), (-2, -2), (1, -2),
           (-1, 2), (2, -1)]


@pytest.mark.parametrize("mode", ["replicate", "zeros"])
@pytest.mark.parametrize("dy,dx", MARGINS)
def test_plain_fold_pads_and_crops_as_up(mode, dy, dx):
    up = _up(32, 16, mode, seed=2)
    assert up.fold_upsample
    x, x2 = _inputs(2, 32, 5, 6, 10 + dy, 12 + dx, seed=3)
    with torch.no_grad():
        got = _fold(up, x, x2)
        ref = up(x, x2)
        u = up.up(x)
        assert torch.equal(pad_or_crop(u, x2.shape[2:], up.padding_mode),
                           blocks._pad_or_crop(u, dy, dx, up.padding_mode))
    assert got.shape == ref.shape == (2, 16, 14 + dy, 16 + dx)
    assert torch.equal(got, ref)


def test_which_ups_fold_the_upsample():
    """The 2x2 ConvT folds where the pad's mode is one the epilogue
    writes; `up_mode`'s zero insertion and `bilinear`'s 1x1 conv keep
    torch's upsample, and so does every other padding mode."""
    assert all(u.fused_cell and u.fold_upsample
               for u in UNetTMO().up_path)
    assert not any(u.fold_upsample for u in UNetTMO(up_mode=True).up_path)
    assert not any(u.fold_upsample for u in UNetTMO(bilinear=True).up_path)
    assert set(FOLD_MODES) == {"edge", "constant"}
    for mode, folds in (("edge", True), ("replicate", True), ("zeros", True),
                        ("constant", True), ("empty", True),
                        ("reflect", False), ("symmetric", False),
                        ("wrap", False), ("mean", False)):
        up = blocks.Up(32, 32, 8, params.SQUARE_AND_SQUARE_ROOT,
                       padding_mode=mode)
        assert up.fold_upsample is folds, mode
        assert isinstance(up.up, nn.ConvTranspose2d)


def emulate_fold(x, w_up, b_up, size, mode, plan):
    """Phase 0 of `up_cell_kernel` in plain PyTorch, in the kernel's order:
    item by item (image, tile of M flat positions of x, pass of N columns),
    each chunk of K channels staged with zeros past the plane, its stage
    read from `pack_upsample_weights`'s output at the producer's next
    offset (the TF32 planes added back), then the bias and each value
    stored as `fold_store` stores it: at (u + lo_y, v + lo_x) if inside the
    skip's plane, and over the pad beyond an edge (the value, or zeros)."""
    b, c, h0, w0 = x.shape
    ph = fold_plan(plan, c)
    m = ph.tw
    packed = pack_upsample_weights(w_up, 0, 0, plan).double()
    ho, wo = size
    lo_y, lo_x = (ho - 2 * h0) // 2, (wo - 2 * w0) // 2
    out = torch.full((b, c, ho, wo), float("nan"), dtype=torch.float64)
    plane = h0 * w0
    tiles = -(-plane // m)
    idx = b_image_index(K, ph.n, 4)
    stage = K * ph.n * 2
    flat = x.reshape(b, c, plane).double()
    for img in range(b):
        for tile in range(tiles):
            for pss in range(ph.coutp // ph.n):
                off = pss * ph.cinp * 2 * ph.n
                pos = tile * m + torch.arange(m)
                ok = pos < plane
                acc = torch.zeros((m, ph.n), dtype=torch.float64)
                for c0 in range(0, c, K):
                    staged = torch.zeros((K, m), dtype=torch.float64)
                    staged[:, ok] = flat[img, c0:c0 + K][:, pos[ok]]
                    wk = packed[off:off + stage // 2][idx] + packed[
                        off + stage // 2:off + stage][idx]
                    acc += staged.T @ wk
                    off += stage
                for p in pos[ok].tolist():
                    i0, j0 = divmod(p, w0)
                    for col in range(ph.n):
                        n = pss * ph.n + col
                        co, a, bb = n >> 2, (n >> 1) & 1, n & 1
                        u, v = 2 * i0 + a, 2 * j0 + bb
                        val = acc[p - tile * m, col] + b_up[co].double()
                        yc, xc = u + lo_y, v + lo_x
                        y0 = max(0 if u == 0 else yc, 0)
                        y1 = min(ho - 1 if u == 2 * h0 - 1 else yc, ho - 1)
                        x0 = max(0 if v == 0 else xc, 0)
                        x1 = min(wo - 1 if v == 2 * w0 - 1 else xc, wo - 1)
                        for yy in range(y0, y1 + 1):
                            for xx in range(x0, x1 + 1):
                                edge = mode == "edge" or (yy, xx) == (yc, xc)
                                out[img, co, yy, xx] = val if edge else 0.0
    return out


@pytest.mark.parametrize("mode", FOLD_MODES)
@pytest.mark.parametrize("c,c1,h0,w0,h,w", [
    (32, 32, 3, 5, 7, 10), (64, 32, 4, 3, 6, 8), (32, 64, 6, 2, 12, 5),
    (32, 128, 2, 2, 6, 3)], ids=["cfg32b-pad", "cfg32a-crop", "cfg64-mixed",
                                 "cfg128-pad2"])
def test_phase_zero_index_scheme_rebuilds_the_upsample(mode, c, c1, h0, w0,
                                                       h, w):
    """Every element of x1 written once, to the plain upsample's value."""
    g = torch.Generator().manual_seed(c + h)
    x = torch.randn(2, c, h0, w0, generator=g)
    w_up = torch.randn(c, c, 2, 2, generator=g) * 0.2
    b_up = torch.randn(c, generator=g) * 0.1
    plan = default_up_plan(4 * c, c1, c1)
    got = emulate_fold(x, w_up, b_up, (h, w), mode, plan)
    ref = upsample_plain(x, w_up, b_up, (h, w), mode)
    assert not got.isnan().any()
    torch.testing.assert_close(got.float(), ref, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("c,c1", [(256, 128), (128, 64), (64, 32), (32, 32)],
                         ids=["up0", "up1", "up2", "up3"])
def test_phase_zero_packing_round_trips_to_the_weight(c, c1):
    """Each stage of the packed weight, read back through `b_image_index`
    and its two TF32 planes added, is w_up[c0:c0 + K, co, a, b] at column
    4 co + 2 a + b, in the producer's order: pass, then chunk."""
    w_up = torch.randn(c, c, 2, 2, generator=torch.Generator().manual_seed(c))
    plan = default_up_plan(4 * c, c1, c1)
    ph = fold_plan(plan, c)
    assert (ph.cinp, ph.n, ph.coutp) == (c, plan.a.n, 4 * c)
    assert ph.tw == 64 * plan.nwg * plan.a.mw
    packed = pack_upsample_weights(w_up, c1, c1, plan)
    assert packed.numel() == 2 * 4 * c * c
    idx = b_image_index(K, ph.n, 4)
    bmat = w_up.reshape(c, 4 * c)          # [ci][4 co + 2 a + b]
    stage, off = K * ph.n * 2, 0
    for pss in range(4 * c // ph.n):
        for c0 in range(0, c, K):
            hi = packed[off:off + stage // 2][idx]
            lo = packed[off + stage // 2:off + stage][idx]
            want = bmat[c0:c0 + K, pss * ph.n:(pss + 1) * ph.n]
            assert (hi + lo - want).abs().max() <= 2 ** -21 * want.abs().max()
            assert (hi.view(torch.int32) & 0x1FFF).eq(0).all()
            off += stage
    assert off == packed.numel()


@pytest.mark.parametrize("mode", FOLD_MODES)
@pytest.mark.parametrize("dy,dx", [(1, 1), (-1, 2), (0, 0), (-2, -1)])
def test_fold_backward_formula_is_autograd_of_plain(mode, dy, dx):
    """`up_fold_backward` with the plain version's own x1, mid and y
    against autograd of `up_fold_plain`, in float64 but for the root,
    which K1's plain version takes in float32."""
    g = torch.Generator().manual_seed(7 + dy)
    c, c1, h0, w0 = 4, 8, 3, 4
    x = torch.randn(2, c, h0, w0, generator=g, dtype=torch.float64)
    x2 = torch.relu(torch.randn(2, c, 2 * h0 + dy, 2 * w0 + dx, generator=g,
                                dtype=torch.float64))
    ws = [torch.randn(c, c, 2, 2, generator=g, dtype=torch.float64) * 0.3,
          torch.randn(c, generator=g, dtype=torch.float64) * 0.1,
          torch.randn(4 * c, c1, 3, 3, generator=g, dtype=torch.float64) * 0.2,
          torch.randn(c1, generator=g, dtype=torch.float64) * 0.1,
          torch.randn(c1, c1, 3, 3, generator=g, dtype=torch.float64) * 0.2,
          torch.randn(c1, generator=g, dtype=torch.float64) * 0.1]
    leaves = [t.clone().requires_grad_() for t in (x2, x, *ws)]
    y = up_fold_plain(*leaves, mode)
    gy = torch.randn(y.shape, generator=g, dtype=torch.float64)
    ref = torch.autograd.grad(y, leaves, gy)
    w_up, b_up, w1, b1, w2, b2 = ws
    x1 = upsample_plain(x, w_up, b_up, x2.shape[2:], mode)
    from uncltmo_tpu_torch.ops.kernels.concat_skip import concat_skip_plain
    mid = F.relu(F.conv_transpose2d(concat_skip_plain(x2, x1), w1, b1))
    got = up_fold_backward(x2, x, w_up, x1, w1, w2, mid, y.detach(), gy,
                           mode)
    assert len(got) == 8
    for a, r in zip(got, ref):
        torch.testing.assert_close(a, r, rtol=1e-5, atol=1e-6)
    no_dx = up_fold_backward(x2, x, w_up, x1, w1, w2, mid, y.detach(), gy,
                             mode, need_dx2=False, need_dx=False)
    assert no_dx[0] is None and no_dx[1] is None
    torch.testing.assert_close(no_dx[2], ref[2], rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("mode", FOLD_MODES)
def test_pad_or_crop_backward_is_autograd(mode):
    g = torch.Generator().manual_seed(11)
    for hu, wu, h, w in ((6, 8, 9, 7), (5, 5, 3, 8), (4, 6, 4, 6)):
        u = torch.randn(2, 3, hu, wu, generator=g,
                        dtype=torch.float64).requires_grad_()
        out = pad_or_crop(u, (h, w), mode)
        go = torch.randn(out.shape, generator=g, dtype=torch.float64)
        (ref,) = torch.autograd.grad(out, u, go)
        torch.testing.assert_close(pad_or_crop_backward(go, (hu, wu), mode),
                                   ref)
