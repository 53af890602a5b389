"""The index scheme of the tensor-core K2 kernel, and its weight packing.

    JAX_PLATFORMS=cpu python -m pytest tests/test_torch_double_conv_tiling.py -q

`csrc/double_conv3x3.cu` cannot run on the CPU, so its index arithmetic is
rebuilt here step by step in plain PyTorch (`tiled_model`): tiles with a
halo, staged as `[position][channel]` with one pitch, each tap a shift of
the flattened position, conv1 in chunks of the intermediate channels,
rounded to the input dtype, folded into conv2 accumulators, the wrapped
columns dropped at the store.  It reads the same packed weights as the
kernel.  Held against `double_conv3x3_plain`: float32 to rtol 1e-4 /
atol 1e-5 (sums in another order), bfloat16 to 2e-2 of the output scale
(one flipped rounding of the intermediate moves an output by a bf16 step).
"""
import pytest
import torch

from uncltmo_tpu_torch.models.blocks import DoubleConv
from uncltmo_tpu_torch.ops.kernels.double_conv import (
    MMA_K, _pack_taps, double_conv3x3_plain, pack_double_conv_weights,
    padded_channels, weights_key)


def _round_up(n, m):
    return -(-n // m) * m


def tile_geometry(th, tw):
    """Pitch and flattened extents of a TH x TW output tile, as the kernel
    reckons them: conv2 covers M2 positions, conv1 M1 (far enough for
    conv2's last shift), the input NPOS (far enough for conv1's)."""
    p = tw + 4
    m2 = _round_up(th * p, MMA_K)
    m1 = _round_up(m2 + 2 * p + 2, MMA_K)
    return p, m2, m1, m1 + 2 * p + 2


def tiled_model(x, w1, b1, w2, b2, th, tw):
    b, cin, h, w = x.shape
    c1, c2 = w1.shape[0], w2.shape[0]
    cinp, c1p, c2p = padded_channels(cin, c1, c2)
    chunk = 32 if c1 <= 32 else 64
    w1p, w2p = _pack_taps(w1, cinp, c1p), _pack_taps(w2, c1p, c2p)
    b1p = torch.zeros(c1p).index_copy_(0, torch.arange(c1), b1.float())
    p, m2, m1, npos = tile_geometry(th, tw)
    ho, wo = h - 4, w - 4
    y = torch.full((b, c2, ho, wo), float("nan"))
    q = torch.arange(m2)
    row, col = q // p, q % p
    for img in range(b):
        for ty0 in range(0, ho, th):
            for tx0 in range(0, wo, tw):
                # the input tile, zero beyond the image, the tile's rows and
                # the real channels
                in_s = torch.zeros(npos, cinp, dtype=x.dtype)
                rows, cols = min(th + 4, h - ty0), min(p, w - tx0)
                tile = x[img, :, ty0:ty0 + rows, tx0:tx0 + cols]
                grid = torch.zeros(cin, th + 4, p, dtype=x.dtype)
                grid[:, :rows, :cols] = tile
                in_s[:(th + 4) * p, :cin] = grid.reshape(cin, -1).T
                acc2 = torch.zeros(m2, c2p)
                for j in range(0, c1p, chunk):
                    cur = min(chunk, c1p - j)        # the last may be short
                    acc1 = torch.zeros(m1, cur)
                    for tap in range(9):
                        s = (tap // 3) * p + tap % 3
                        acc1 += (in_s[s:s + m1].float()
                                 @ w1p[tap, :, j:j + cur].float())
                    mid_s = torch.relu(acc1 + b1p[j:j + cur]).to(x.dtype)
                    for tap in range(9):
                        s = (tap // 3) * p + tap % 3
                        assert s + m2 <= m1
                        acc2 += (mid_s[s:s + m2].float()
                                 @ w2p[tap, j:j + cur].float())
                out = torch.relu(acc2[:, :c2] + b2.float()).to(x.dtype)
                keep = ((row < th) & (col < tw) & (ty0 + row < ho)
                        & (tx0 + col < wo))
                y[img, :, ty0 + row[keep], tx0 + col[keep]] = \
                    out[keep].float().T
    assert not torch.isnan(y).any()          # every output was stored
    return y.to(x.dtype)


def _inputs(seed, b, cin, c1, c2, h, w, dtype):
    g = torch.Generator().manual_seed(seed)

    def rnd(*shape, std=1.0):
        return (torch.randn(shape, generator=g) * std).to(dtype)

    return (torch.rand(b, cin, h, w, generator=g).to(dtype),
            rnd(c1, cin, 3, 3, std=(2 / (9 * cin)) ** 0.5), rnd(c1, std=0.1),
            rnd(c2, c1, 3, 3, std=(2 / (9 * c1)) ** 0.5), rnd(c2, std=0.1))


# (name, Cin, C1, C2, H, W, TH, TW): the four cells at a quarter of their
# width and size with their own tile shapes, then Cin = 1, ragged sizes and
# channel counts that need padding
CASES = [
    ("inc", 1, 8, 8, 40, 40, 12, 28),
    ("down0", 8, 16, 16, 34, 34, 8, 31),
    ("down1", 16, 32, 32, 23, 23, 10, 19),
    ("down2", 32, 64, 64, 16, 12, 12, 8),
    ("down1_f32_tile", 16, 32, 32, 23, 23, 8, 19),
    ("two_chunks", 4, 80, 8, 14, 13, 8, 8),
    ("ragged_37x40", 16, 24, 16, 37, 40, 12, 28),
    ("ragged_29x33", 8, 24, 8, 29, 33, 8, 8),
    ("smallest", 3, 5, 7, 5, 5, 8, 8),
]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("name,cin,c1,c2,h,w,th,tw", CASES,
                         ids=[c[0] for c in CASES])
def test_tiled_scheme_matches_plain(name, cin, c1, c2, h, w, th, tw, dtype):
    args = _inputs(3, 2, cin, c1, c2, h, w, dtype)
    out = tiled_model(*args, th, tw).float()
    ref = double_conv3x3_plain(*args).float()
    assert out.shape == ref.shape == (2, c2, h - 4, w - 4)
    if dtype == torch.float32:
        torch.testing.assert_close(out, ref, rtol=1e-4, atol=1e-5)
    else:
        assert (out - ref).abs().max() <= 2e-2 * ref.abs().max()


@pytest.mark.parametrize("th,tw", [(12, 28), (8, 31), (10, 19), (8, 19),
                                   (12, 8), (8, 8)])
def test_tile_geometry_keeps_every_shift_in_bounds(th, tw):
    p, m2, m1, npos = tile_geometry(th, tw)
    last = 2 * p + 2
    assert m2 % MMA_K == 0 and m1 % MMA_K == 0
    assert m2 >= th * p and m2 - 1 + last < m1 and m1 - 1 + last < npos
    # a stored output never reads a wrapped column or a row below the halo
    assert (tw - 1) + 2 <= p - 3 and (th - 1) + 2 < th + 2
    assert (th + 1) * p + (tw + 1) + last < (th + 4) * p


@pytest.mark.parametrize("cin,c1,c2,want", [
    (1, 32, 32, (16, 32, 32)), (32, 64, 64, (32, 64, 64)),
    (64, 128, 128, (64, 128, 128)), (128, 256, 256, (128, 256, 256)),
    (8, 24, 8, (16, 32, 32)), (3, 33, 65, (16, 64, 128)),
    (20, 80, 300, (32, 96, 512))])
def test_padded_channels(cin, c1, c2, want):
    assert padded_channels(cin, c1, c2) == want


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_pack_layout_and_zero_padding(dtype):
    x, w1, b1, w2, b2 = _inputs(4, 1, 8, 24, 8, 9, 9, dtype)
    pk = pack_double_conv_weights(w1, b1, w2, b2)
    assert pk.w1.shape == (9, 16, 32) and pk.w2.shape == (9, 32, 32)
    assert pk.w1.dtype == pk.w2.dtype == dtype
    assert pk.w1.is_contiguous() and pk.w2.is_contiguous()
    for ky in range(3):
        for kx in range(3):
            tap = 3 * ky + kx
            assert torch.equal(pk.w1[tap, :8, :24], w1[:, :, ky, kx].T)
            assert torch.equal(pk.w2[tap, :24, :8], w2[:, :, ky, kx].T)
    assert not pk.w1[:, 8:].any() and not pk.w1[:, :, 24:].any()
    assert not pk.w2[:, 24:].any() and not pk.w2[:, :, 8:].any()
    assert torch.equal(pk.b1, b1) and torch.equal(pk.b2, b2)


def test_packed_weights_carry_no_graph():
    cell = _cell()
    pk = cell.packed_weights()
    assert not any(t.requires_grad for t in pk)


def _cell():
    torch.manual_seed(0)
    return DoubleConv(4, 8)


def test_cache_packs_once_for_unchanged_weights():
    cell = _cell()
    first = cell.packed_weights()
    assert cell.packed_weights() is first
    assert torch.equal(first.w1[:, :4, :8],
                       cell.conv.weight.detach().permute(2, 3, 1, 0)
                       .reshape(9, 4, 8))


@pytest.mark.parametrize("change", ["version", "dtype", "data_ptr"])
def test_cache_repacks_when_a_parameter_changes(change):
    cell = _cell()
    first = cell.packed_weights()
    key = weights_key(*cell._weights())
    if change == "version":              # an optimiser's in-place update
        with torch.no_grad():
            cell.conv1.weight.add_(1.0)
    elif change == "dtype":              # the engine's cast of p.data
        for p in cell.parameters():
            p.data = p.data.to(torch.bfloat16)
    else:                                # a reload into new storage
        cell.conv.weight.data = cell.conv.weight.data.clone() * 2
    assert weights_key(*cell._weights()) != key
    second = cell.packed_weights()
    assert second is not first
    fresh = pack_double_conv_weights(*cell._weights())
    assert second.w1.dtype == cell.conv.weight.dtype
    assert torch.equal(second.w1, fresh.w1)
    assert torch.equal(second.w2, fresh.w2)
    assert cell.packed_weights() is second


def test_cpu_forward_needs_no_packing():
    cell = _cell()
    x = torch.rand(1, 4, 9, 9)
    out = cell(x)
    assert cell._packed is None
    assert torch.equal(out, double_conv3x3_plain(x, *cell._weights()))
