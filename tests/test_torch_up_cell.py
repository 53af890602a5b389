"""The decoder's up cell (`ops/kernels/up_cell.py`) on the CPU.

The plain version is today's `Up` cell bit for bit (K1's plain concat and
torch's ConvTs); a ConvTranspose2d(k=3) is the valid convolution over its
input zero-padded by 2 with the flipped, transposed kernel; the packed
weights are that kernel in the producer's stage order; and a plain-PyTorch
rebuild of one phase of the kernel (its items, tiles of one pitch, staged
input with the zero pad, Cin chunks, taps as shifts and the weights read
at the producer's stage offsets through `b_image_index`) gives the
convolution at every default plan.  The kernel itself runs only on a card
(`tests/test_torch_up_cell_cuda.py`).
"""
import pytest
import torch
import torch.nn.functional as F

from uncltmo_tpu_torch import params
from uncltmo_tpu_torch.models import blocks
from uncltmo_tpu_torch.models.unet import UNetTMO
from uncltmo_tpu_torch.ops.kernels.concat_skip import concat_skip_plain
from uncltmo_tpu_torch.ops.kernels.packing import b_image_index
from uncltmo_tpu_torch.ops.kernels.up_cell import (
    K, PhasePlan, _CFGS, channels_ok, convt_as_conv, default_up_plan,
    pack_phase, pack_up_cell_weights, packed_sizes, stage_channels,
    up_cell_backward, up_cell_plain)


def _cell(c, c1, h, w, seed=0, b=2):
    g = torch.Generator().manual_seed(seed)
    x2 = torch.relu(torch.randn(b, c, h, w, generator=g))
    x1 = torch.randn(b, c, h, w, generator=g)
    cin = 4 * c
    return (x2, x1, torch.randn(cin, c1, 3, 3, generator=g) * (2 / (9 * cin))
            ** 0.5, torch.randn(c1, generator=g) * 0.1,
            torch.randn(c1, c1, 3, 3, generator=g) * (2 / (9 * c1)) ** 0.5,
            torch.randn(c1, generator=g) * 0.1)


def test_plain_version_is_todays_up_cell_bit_for_bit():
    up = blocks.Up(32, 32, 8, params.SQUARE_AND_SQUARE_ROOT)
    assert up.fused_cell
    g = torch.Generator().manual_seed(1)
    x1 = torch.randn(2, 32, 5, 6, generator=g)
    x2 = torch.relu(torch.randn(2, 32, 11, 12, generator=g))
    with torch.no_grad():
        today = up(x1, x2)
        x1u = blocks._pad_or_crop(up.up(x1), 1, 0, up.padding_mode)
        cell = up.conv
        plain = up_cell_plain(x2, x1u, cell.conv.weight, cell.conv.bias,
                              cell.conv1.weight, cell.conv1.bias)
        via_k1 = cell(blocks.concat_skip(x2, x1u, up.con_operator))
    assert torch.equal(today, plain) and torch.equal(via_k1, plain)
    assert plain.shape == (2, 8, 15, 16)


def test_which_up_cells_fuse():
    """The published decoder fuses; other operators, norms and
    activations, and the DoubleConv decoder, keep today's layers."""
    net = UNetTMO()
    assert all(u.fused_cell for u in net.up_path)
    for kw in (dict(con_operator=params.ORIGINAL_UNET),
               dict(unet_norm="batch_norm"), dict(activation="leakyrelu"),
               dict(double_conv_transpose=False),
               dict(con_operator=params.SQUARE_AND_SQUARE_ROOT_MANUAL_D)):
        assert not any(u.fused_cell for u in UNetTMO(**kw).up_path), kw
    # skip channels of 160, 80, 40 and 20; of 128, 64, 32 and 16
    assert [u.fused_cell for u in UNetTMO(filters=20).up_path] == [
        True, False, False, False]
    assert [u.fused_cell for u in UNetTMO(filters=16).up_path] == [
        True, True, True, False]
    assert [c for c in range(1, 100) if channels_ok(c)] == [32, 64, 96]


def test_phase_one_consumes_x2s_chunks_for_three_blocks():
    plan = default_up_plan(4 * 64, 32, 32)
    assert stage_channels(plan.a, True) == [0, 128, 192, 32, 160, 224, 64,
                                            96]
    assert stage_channels(plan.b, False) == [0]


def test_state_dict_keys_are_the_published_ones():
    keys = set(UNetTMO().state_dict())
    for i in range(4):
        for conv in ("conv", "conv1"):
            for p in ("weight", "bias"):
                assert f"up_path.{i}.conv.{conv}.{p}" in keys
    assert not any("packed" in k for k in keys)


def test_convt_is_the_flipped_transposed_valid_conv():
    x2, x1, w1, b1, _, _ = _cell(5, 7, 9, 10)
    x = concat_skip_plain(x2, x1)
    got = F.conv2d(F.pad(x, (2, 2, 2, 2)), convt_as_conv(w1), b1)
    torch.testing.assert_close(got, F.conv_transpose2d(x, w1, b1),
                               rtol=1e-5, atol=1e-5)


def emulate_phase(srcs, w, bias, ph: PhasePlan, nwg: int, cat: bool):
    """One phase of `up_cell_kernel` in plain PyTorch, in the kernel's
    order: item by item (image, pass, tile), each source chunk staged as
    [channel][position] of pitch P = TW + 2 with the zero pad, each chunk
    of x2 serving the concat's blocks 0, 2 and 3 (x2, x2 * x2 and the root
    times the pad's 0/1 mask), x1's block 1, and every weight stage read
    from `pack_phase`'s output at the producer's next offset, the TF32
    planes added back.  Returns relu(conv(pad2(input)) + bias)."""
    x = srcs[0]
    b, cs, h, w_ = x.shape
    cout = w.shape[1]
    packed = pack_phase(w, ph, cat).double()
    m = 64 * nwg * ph.mw
    p = ph.tw + 2
    npos = m + 2 * p + 2
    ho, wo = h + 2, w_ + 2
    tiles_x = -(-wo // ph.tw)
    tiles = tiles_x * -(-ho // ph.th)
    out = torch.full((b, cout, ho, wo), float("nan"), dtype=torch.float64)
    pos = torch.arange(npos)
    q = torch.arange(m)
    width = cs if cat else ph.cinp
    chunks = [(s, c0) for s in range(len(srcs))
              for c0 in range(0, width, K)]
    idx = b_image_index(K, ph.n, 4)
    stage_elems = K * ph.n * 2
    for img in range(b):
        for pss in range(ph.coutp // ph.n):
            u = pss * 9 * ph.cinp * 2 * ph.n     # the producer's offset
            for tile in range(tiles):
                ty0, tx0 = (tile // tiles_x) * ph.th, (tile % tiles_x) * ph.tw
                gy, gx = ty0 + pos // p - 2, tx0 + pos % p - 2
                inside = (gy >= 0) & (gy < h) & (gx >= 0) & (gx < w_)
                ok = inside & (pos < (ph.th + 2) * p)
                acc = torch.zeros((m, ph.n), dtype=torch.float64)
                off = u
                for s, c0 in chunks:
                    staged = torch.zeros((K, npos), dtype=torch.float64)
                    real = min(K, cs - c0)
                    staged[:real, ok] = srcs[s][img][c0:c0 + real][
                        :, gy[ok], gx[ok]].double()
                    modes = (0, 1, 2) if cat and s == 0 else (0,)
                    for mode in modes:
                        v = staged.float()
                        if mode == 1:
                            v = v * v
                        elif mode == 2:
                            v = torch.sqrt(v + params.EPSILON) * inside
                        for t in range(9):
                            img_hi = packed[off:off + stage_elems // 2]
                            img_lo = packed[off + stage_elems // 2:
                                            off + stage_elems]
                            wk = img_hi[idx] + img_lo[idx]
                            sh = (t // 3) * p + t % 3
                            acc += v[:, sh:sh + m].double().T @ wk
                            off += stage_elems
                r, c = q // p, q % p
                keep = ((r < ph.th) & (c < ph.tw) & (ty0 + r < ho)
                        & (tx0 + c < wo))
                n = min(ph.n, cout - pss * ph.n)
                val = torch.relu(acc[keep, :n]
                                 + bias[pss * ph.n:pss * ph.n + n].double())
                out[img, pss * ph.n:pss * ph.n + n, ty0 + r[keep],
                    tx0 + c[keep]] = val.T
    return out


# (C, C1, C2, H, W): each default instantiation at a small plane, and a
# cell whose channels need padding and whose output has ragged tiles
EMULATED = [(32, 128, 128, 5, 7), (64, 64, 64, 6, 5), (64, 32, 32, 9, 4),
            (32, 32, 32, 3, 9), (32, 40, 24, 7, 3)]


@pytest.mark.parametrize("c,c1,c2,h,w", EMULATED,
                         ids=["cfg128", "cfg64", "cfg32a", "cfg32b",
                              "ragged"])
def test_kernel_index_scheme_rebuilds_the_cell(c, c1, c2, h, w):
    x2, x1, w1, b1, _, _ = _cell(c, c1, h, w, seed=3, b=1)
    g = torch.Generator().manual_seed(4)
    w2 = torch.randn(c1, c2, 3, 3, generator=g) * (2 / (9 * c1)) ** 0.5
    b2 = torch.randn(c2, generator=g) * 0.1
    plan = default_up_plan(4 * c, c1, c2)
    cat = concat_skip_plain(x2, x1)
    mid = emulate_phase([x2, x1], w1, b1, plan.a, plan.nwg, True)
    y = emulate_phase([mid.float()], w2, b2, plan.b, plan.nwg, False)
    ref_mid = F.relu(F.conv_transpose2d(cat, w1, b1))
    ref = F.relu(F.conv_transpose2d(ref_mid, w2, b2))
    torch.testing.assert_close(mid.float(), ref_mid, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(y.float(), ref, rtol=1e-5, atol=1e-5)
    assert (mid.numel(), y.numel()) == (ref_mid.numel(), ref.numel())


def test_default_plans_of_the_decoder():
    """The four published cells and the instantiation each takes; the
    packed sizes follow the padded channels."""
    for (cin, c1), name in (((1024, 128), "128"), ((512, 64), "64"),
                            ((256, 32), "32A"), ((128, 32), "32B")):
        plan = default_up_plan(cin, c1, c1)
        cfg = _CFGS[name]
        assert (plan.a.th, plan.a.tw, plan.a.mw, plan.a.n) == cfg[1:5]
        assert (plan.b.th, plan.b.tw, plan.b.mw, plan.b.n) == cfg[6:10]
        assert (plan.a.cinp, plan.b.cinp) == (cin, c1)
        # a tile's output rows fit its 64-row wgmma tiles
        for ph in plan:
            if isinstance(ph, PhasePlan):
                assert ph.th * (ph.tw + 2) <= 64 * plan.nwg * ph.mw
    plan = default_up_plan(128, 40, 24)
    assert (plan.a.cinp, plan.a.coutp, plan.b.cinp, plan.b.coutp) == (
        128, 64, 64, 64)
    pk = pack_up_cell_weights(torch.rand(128, 40, 3, 3), torch.rand(40),
                              torch.rand(40, 24, 3, 3), torch.rand(24), plan)
    assert (pk.w1.numel(), pk.w2.numel()) == packed_sizes(plan)


def test_backward_formula_is_autograd_of_plain():
    """`up_cell_backward` with the plain version's own mid and y (no relu
    flip possible) against autograd of the plain version, in float64 but
    for the root, which K1's plain version takes in float32."""
    args = [a.double() for a in _cell(4, 8, 6, 7, seed=5)]
    leaves = [a.clone().requires_grad_() for a in args]
    y = up_cell_plain(*leaves)
    gy = torch.randn(y.shape, dtype=torch.float64,
                     generator=torch.Generator().manual_seed(6))
    ref = torch.autograd.grad(y, leaves, gy)
    x2, x1, w1, b1, w2, b2 = args
    mid = F.relu(F.conv_transpose2d(concat_skip_plain(x2, x1), w1, b1))
    got = up_cell_backward(x2, x1, w1, w2, mid, y.detach(), gy)
    for a, r in zip(got, ref):
        torch.testing.assert_close(a, r, rtol=1e-5, atol=1e-6)
    no_dx = up_cell_backward(x2, x1, w1, w2, mid, y.detach(), gy,
                             need_dx=False)
    assert no_dx[0] is None and no_dx[1] is None
    torch.testing.assert_close(no_dx[2], ref[2], rtol=1e-5, atol=1e-6)
