"""The decoder's up cell kernel (`ops/kernels/up_cell.py`) against its
plain PyTorch version, on a CUDA card.  Skipped without one (the kernel
has no CPU mode).  The file imports neither jax nor the JAX package:

    python -m pytest --noconftest tests/test_torch_up_cell_cuda.py -q

Tolerances: outputs rtol 1e-4 / atol 1e-4 (float32 sums of up to 9 * 4C
split-TF32 products in another order than cuDNN's; outputs of order 1),
as K2's.  The gradients come from the library with the relu masks of the
kernel's own `mid` and `y`, so a few entries within 1e-6 of zero fall on
the other side of a relu than in the plain version, and each adds or
removes a whole term: the Function end to end is held to 2e-3 in the L2
norm and 5e-2 of max-abs entry by entry, as K2's Function is.

The three-phase cell (phase 0: `Up`'s 2x2 ConvT, its bias and the pad or
crop to the skip) is held to the same tolerances against `up_fold_plain`,
and its x1 and y to `UP_FOLD_DIGESTS`.
"""
import hashlib

import numpy as np
import pytest
import torch

from uncltmo_tpu_torch.models import blocks
from uncltmo_tpu_torch.models.unet import UNetTMO, seeded_init_
from uncltmo_tpu_torch.ops.kernels.concat_skip import (
    concat_skip_plain, fused_concat_skip)
from uncltmo_tpu_torch.ops.kernels import up_cell as up_module
from uncltmo_tpu_torch.ops.kernels.up_cell import (
    Upsample, default_up_plan, fused_up_cell, up_cell_plain, up_cell_plan,
    up_fold_plain)

pytestmark = pytest.mark.cuda

# (C, C1, skip side): the decoder's four cells at a 256^2 tile
UP_CELLS = [(256, 128, 24), (128, 64, 57), (64, 32, 122), (32, 32, 252)]
UP_NAMES = ["up0", "up1", "up2", "up3"]
# (C, C1, H, W): the four B = 1 skips of a whole 1080p frame, and a ragged
# cell whose output channels need padding (odd H and W)
WHOLE_1080P = [(256, 128, 128, 234), (128, 64, 265, 477),
               (64, 32, 538, 962), (32, 32, 1084, 1932)]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernel has no CPU mode)")
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def cell_args(g, b, c, c1, h, w, c2=None, device="cuda"):
    """A post-relu skip, an upsampled branch and He-scaled ConvT weights."""
    c2 = c1 if c2 is None else c2
    cin = 4 * c

    def rnd(*shape, std=1.0):
        return torch.randn(shape, generator=g, device=device) * std
    x2 = torch.relu(rnd(b, c, h, w))
    return [x2, rnd(b, c, h, w), rnd(cin, c1, 3, 3, std=(2 / (9 * cin)) ** 0.5),
            rnd(c1, std=0.1), rnd(c1, c2, 3, 3, std=(2 / (9 * c1)) ** 0.5),
            rnd(c2, std=0.1)]


def check(args):
    n = fused_up_cell.launches
    out = fused_up_cell(*args)
    torch.cuda.synchronize()
    assert fused_up_cell.launches == n + 1
    ref = up_cell_plain(*args)
    assert out.shape == ref.shape
    torch.testing.assert_close(out, ref, rtol=1e-4, atol=1e-4)
    return out


def fold_args(g, b, c, c1, h0, w0, h, w, device="cuda"):
    """The three-phase cell's inputs: x2, the upsample's input x, and the
    weights as `cell_args`; then the upsample's weight and bias."""
    x2, _, *ws = cell_args(g, b, c, c1, h, w, device=device)
    x = torch.randn((b, c, h0, w0), generator=g, device=device)
    w_up = torch.randn((c, c, 2, 2), generator=g, device=device) * (
        1 / c) ** 0.5
    b_up = torch.randn((c,), generator=g, device=device) * 0.1
    return [x2, x, *ws], (w_up, b_up)


def check_fold(args, up, mode="edge"):
    n = (fused_up_cell.launches, fused_up_cell.upsample_folded)
    out = fused_up_cell(*args, upsample=Upsample(*up, mode))
    torch.cuda.synchronize()
    assert (fused_up_cell.launches, fused_up_cell.upsample_folded) == (
        n[0] + 1, n[1] + 1)
    x2, x, w1, b1, w2, b2 = args
    ref = up_fold_plain(x2, x, *up, w1, b1, w2, b2, mode)
    assert out.shape == ref.shape
    torch.testing.assert_close(out, ref, rtol=1e-4, atol=1e-4)
    return out


@pytest.mark.parametrize("b", [8, 60])
@pytest.mark.parametrize("c,c1,s", UP_CELLS, ids=UP_NAMES)
def test_folded_cell_matches_plain_at_the_decoders_cells(cuda_device, b, c,
                                                         c1, s):
    """The published tiles' upsamples: 12 -> 24, 28 -> 56 padded to 57,
    61 -> 122, 126 -> 252."""
    g = torch.Generator(device="cuda").manual_seed(b + c + 1)
    h0 = s // 2
    check_fold(*fold_args(g, b, c, c1, h0, h0, s, s))


# the whole 1080p frame's four cells (a pad of one on up1's axes) and
# ragged cells that crop and pad (C, C1, h0, w0, H, W, C2, mode)
FOLD_WHOLE = [(c, c1, h // 2, w // 2, h, w, c1, "edge")
              for c, c1, h, w in WHOLE_1080P] + [
    (32, 40, 19, 25, 37, 51, 24, "edge"),
    (32, 40, 19, 25, 37, 51, 24, "constant"),
    (64, 32, 30, 29, 62, 56, 32, "constant")]


@pytest.mark.parametrize("c,c1,h0,w0,h,w,c2,mode", FOLD_WHOLE,
                         ids=UP_NAMES + ["ragged_edge", "ragged_zeros",
                                         "pad2_crop2_zeros"])
def test_folded_cell_matches_plain_at_whole_image_shapes(
        cuda_device, c, c1, h0, w0, h, w, c2, mode):
    g = torch.Generator(device="cuda").manual_seed(h + w)
    args, up = fold_args(g, 1 if c1 == c2 else 3, c, c1, h0, w0, h, w)
    if c2 != c1:
        args[4], args[5] = args[4][:, :c2].contiguous(), args[5][:c2]
    check_fold(args, up, mode)


def test_folded_cell_saves_phase_zeros_x1(cuda_device):
    """The backward's x1 is phase 0's: the upsampled plane with up1's
    replicated row and column (56 -> 57)."""
    g = torch.Generator(device="cuda").manual_seed(14)
    args, up = fold_args(g, 4, 128, 64, 28, 28, 57, 57)
    up = [t.requires_grad_() for t in up]
    y = fused_up_cell(*args, upsample=Upsample(*up, "edge"))
    x1 = y.grad_fn.saved_tensors[3]
    with torch.no_grad():
        ref = blocks._pad_or_crop(torch.nn.functional.conv_transpose2d(
            args[1], *up, stride=2), 1, 1, "edge")
    assert torch.equal(x1[:, :, 56], x1[:, :, 55])
    assert torch.equal(x1[:, :, :, 56], x1[:, :, :, 55])
    torch.testing.assert_close(x1, ref, rtol=1e-5, atol=1e-5)


def test_folded_function_matches_autograd_of_plain(cuda_device):
    g = torch.Generator(device="cuda").manual_seed(15)
    args, up = fold_args(g, 8, 32, 32, 30, 29, 61, 58)
    leaves = [a.clone().requires_grad_() for a in [*args, *up]]
    n = (fused_up_cell.upsample_folded, fused_up_cell.backward_calls)
    y = fused_up_cell(*leaves[:6], upsample=Upsample(*leaves[6:], "edge"))
    gy = torch.randn(y.shape, generator=g, device="cuda")
    got = torch.autograd.grad(y, leaves, gy)
    assert (fused_up_cell.upsample_folded, fused_up_cell.backward_calls) == (
        n[0] + 1, n[1] + 1)
    ref_leaves = [a.clone().requires_grad_() for a in [*args, *up]]
    x2, x, w1, b1, w2, b2, w_up, b_up = ref_leaves
    ref = torch.autograd.grad(
        up_fold_plain(x2, x, w_up, b_up, w1, b1, w2, b2, "edge"),
        ref_leaves, gy)
    for a, r in zip(got, ref):
        assert a.shape == r.shape
        assert (a - r).norm() <= 2e-3 * r.norm()
        assert (a - r).abs().max() <= 5e-2 * r.abs().max()


@pytest.mark.parametrize("b", [8, 60, 120])
@pytest.mark.parametrize("c,c1,s", UP_CELLS, ids=UP_NAMES)
def test_up_cell_matches_plain_at_the_decoders_cells(cuda_device, b, c, c1,
                                                     s):
    g = torch.Generator(device="cuda").manual_seed(b + c)
    check(cell_args(g, b, c, c1, s, s))


@pytest.mark.parametrize("c,c1,h,w", WHOLE_1080P + [(32, 40, 37, 51)],
                         ids=UP_NAMES + ["ragged"])
def test_up_cell_matches_plain_at_whole_image_shapes(cuda_device, c, c1, h,
                                                     w):
    g = torch.Generator(device="cuda").manual_seed(h)
    ragged = c1 == 40
    check(cell_args(g, 3 if ragged else 1, c, c1, h, w,
                    c2=24 if ragged else None))


def test_up_cell_takes_up1s_replicate_padded_branch(cuda_device):
    """`up1` upsamples 28 -> 56 and pads the branch to the 57^2 skip by
    one replicated row and column, as `Up` does before the cell."""
    g = torch.Generator(device="cuda").manual_seed(7)
    args = cell_args(g, 8, 128, 64, 57, 57)
    small = torch.randn((8, 128, 56, 56), generator=g, device="cuda")
    args[1] = blocks._pad_or_crop(small, 1, 1, "edge")
    assert torch.equal(args[1][:, :, 56], args[1][:, :, 55])
    check(args)


def test_up_cell_saves_the_intermediate_without_its_pad(cuda_device):
    """The saved `mid` is relu(convT(cat) + b1) on (H+2) x (W+2): the
    2-pixel zero pad around it, where the second ConvT reads zeros, is
    never stored."""
    g = torch.Generator(device="cuda").manual_seed(8)
    x2, x1, w1, b1, w2, b2 = [a.requires_grad_(i > 1) for i, a in
                              enumerate(cell_args(g, 4, 64, 32, 30, 33))]
    y = fused_up_cell(x2, x1, w1, b1, w2, b2)
    mid = y.grad_fn.saved_tensors[4]
    ref = torch.relu(torch.nn.functional.conv_transpose2d(
        concat_skip_plain(x2, x1), w1, b1))
    assert mid.shape == ref.shape == (4, 32, 32, 35)
    torch.testing.assert_close(mid, ref, rtol=1e-4, atol=1e-4)
    # the first row and column are where the pad meets the plane
    torch.testing.assert_close(mid[:, :, 0], ref[:, :, 0], rtol=1e-4,
                               atol=1e-4)


def test_up_cell_function_matches_autograd_of_plain(cuda_device):
    g = torch.Generator(device="cuda").manual_seed(9)
    args = cell_args(g, 8, 32, 32, 61, 58)
    leaves = [a.clone().requires_grad_() for a in args]
    n = (fused_up_cell.launches, fused_up_cell.backward_calls,
         fused_concat_skip.launches, fused_concat_skip.backward_launches)
    y = fused_up_cell(*leaves)
    gy = torch.randn(y.shape, generator=g, device="cuda")
    got = torch.autograd.grad(y, leaves, gy)
    assert (fused_up_cell.launches, fused_up_cell.backward_calls,
            fused_concat_skip.launches,
            fused_concat_skip.backward_launches) == (
                n[0] + 1, n[1] + 1, n[2] + 1, n[3] + 1)
    ref_leaves = [a.clone().requires_grad_() for a in args]
    ref = torch.autograd.grad(up_cell_plain(*ref_leaves), ref_leaves, gy)
    for a, r in zip(got, ref):
        assert a.shape == r.shape
        assert (a - r).norm() <= 2e-3 * r.norm()
        assert (a - r).abs().max() <= 5e-2 * r.abs().max()


def test_generator_gradient_reaches_the_decoders_weights(cuda_device):
    """A published generator on the card: four up-cell launches a
    forward, none of K1's, and the gradient of a weight behind the kernel
    is that of the same generator on torch's layers."""
    net = seeded_init_(UNetTMO(), 11).cuda()
    ref_net = seeded_init_(UNetTMO(), 11).cuda()
    for u in ref_net.up_path:
        u.fused_cell = False
    x = torch.rand((2, 1, 128, 128), generator=torch.Generator(
        device="cuda").manual_seed(12), device="cuda")
    n = (fused_up_cell.launches, fused_up_cell.upsample_folded,
         fused_concat_skip.launches)
    out = net(x)[0]
    assert (fused_up_cell.launches - n[0],
            fused_up_cell.upsample_folded - n[1],
            fused_concat_skip.launches - n[2]) == (4, 4, 0)
    out.square().sum().backward()
    ref_net(x)[0].square().sum().backward()
    for name in ("up_path.3.conv.conv.weight", "up_path.3.up.weight"):
        got = dict(net.named_parameters())[name].grad
        ref = dict(ref_net.named_parameters())[name].grad
        assert got.abs().max() > 0, name
        assert (got - ref).norm() <= 2e-3 * ref.norm(), name


def test_up_cell_plan_matches_the_packings_mirror(cuda_device):
    for cin, c1, c2 in ((1024, 128, 128), (512, 64, 64), (256, 32, 32),
                        (128, 32, 32), (128, 40, 24), (256, 16, 8)):
        assert up_cell_plan(cin, c1, c2, cuda_device) == default_up_plan(
            cin, c1, c2)


def test_up_cell_refuses_what_it_does_not_take(cuda_device):
    g = torch.Generator(device="cuda").manual_seed(10)
    args = cell_args(g, 2, 32, 16, 9, 9)
    with pytest.raises(ValueError):            # bfloat16
        fused_up_cell(*[a.bfloat16() for a in args])
    with pytest.raises(ValueError):            # x1 of another shape
        fused_up_cell(args[0], args[1][:, :4], *args[2:])
    with pytest.raises(ValueError):            # weights of another Cin
        fused_up_cell(*args[:2], args[2][:64], *args[3:])
    with pytest.raises(ValueError):            # mixed devices
        fused_up_cell(*args[:5], args[5].cpu())
    with pytest.raises(ValueError):            # skip channels it cannot stage
        fused_up_cell(*cell_args(g, 2, 12, 16, 9, 9))
    fargs, up = fold_args(g, 2, 32, 16, 4, 4, 9, 9)
    with pytest.raises(ValueError):            # a pad mode it does not write
        fused_up_cell(*fargs, upsample=Upsample(*up, "reflect"))
    with pytest.raises(ValueError):            # an upsample of other channels
        fused_up_cell(*fargs, upsample=Upsample(up[0][:, :16], up[1][:16],
                                                "edge"))


def test_up_cell_launches_on_the_tensors_card(cuda_device):
    """With card 0 current, tensors on card 1 go through the kernel on
    card 1, as an engine over two devices runs them."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA cards")
    dev = torch.device("cuda", 1)
    g = torch.Generator(device="cpu").manual_seed(13)
    args = [a.to(dev) for a in cell_args(g, 4, 32, 32, 40, 41,
                                         device="cpu")]
    with torch.cuda.device(0):
        y = fused_up_cell(*args)
    torch.cuda.synchronize(dev)
    assert y.device == dev
    torch.testing.assert_close(y, up_cell_plain(*args), rtol=1e-4,
                               atol=1e-4)


# SHA-256 of the kernel's output bytes at the four cells, at a rank's
# batch and a 1080p frame's 60 tiles, for numpy-seeded inputs
# (`up_cell_output`): the plan's Cin chunk, N and D fix every output's
# rounding.  Print them with `PYTHONPATH=. python
# tests/test_torch_up_cell_cuda.py` on a card.
UP_DIGESTS = {
    "up0/8":
        "81133f7d9979e3656c9a0dc599ded580b5c7b45fbaa3fbe810ed5c119f1dfb7e",
    "up0/60":
        "a89fab4d6b15ba148e3710f9528f8ad3d873d34c228cffec2ae1bcb504c7800d",
    "up1/8":
        "f03f304ff2d0576cb098a1a29ee66a61f67ce3f826c76f87dd215063fbfa3d33",
    "up1/60":
        "29bd7e5bbff245286b8232318cdf6f235fa892988dd9cf7960cdc735887d9329",
    "up2/8":
        "f619cf0edb9f912726702edd1a545a5a428e65189ec6bcbe88de63674c7b0630",
    "up2/60":
        "f003f962e8d09555d94820139b3bdf9a3dd3f427c7a4ad865f05669625de67db",
    "up3/8":
        "30793aaee473d7859914d505b9341dad9c73d9d34af13900cc39e65a7c8b0ac1",
    "up3/60":
        "7f2e4c4259fe895f9ce1e4863c331b92143f07950447e9fb897275a9831210ea",
}


def up_cell_output(cell: str, b: int) -> torch.Tensor:
    c, c1, s = UP_CELLS[UP_NAMES.index(cell)]
    rng = np.random.default_rng(1000 * c + b)

    def arr(shape, std=None):
        a = (rng.random(shape, dtype=np.float32) if std is None else
             rng.standard_normal(shape, dtype=np.float32) * np.float32(std))
        return torch.from_numpy(a).to("cuda")
    cin = 4 * c
    return fused_up_cell(arr((b, c, s, s)), arr((b, c, s, s), 1.0),
                         arr((cin, c1, 3, 3), (2 / (9 * cin)) ** 0.5),
                         arr((c1,), 0.1),
                         arr((c1, c1, 3, 3), (2 / (9 * c1)) ** 0.5),
                         arr((c1,), 0.1))


def up_digest(out: torch.Tensor) -> str:
    raw = out.contiguous().view(torch.uint8).cpu().numpy()
    return hashlib.sha256(raw.tobytes()).hexdigest()


@pytest.mark.parametrize("b", [8, 60])
@pytest.mark.parametrize("cell", UP_NAMES)
def test_up_cell_outputs_keep_their_bits(cuda_device, cell, b):
    assert up_digest(up_cell_output(cell, b)) == UP_DIGESTS[f"{cell}/{b}"]


# SHA-256 of the three-phase cell's phase 0 output x1 and its y at the
# four cells (the published tiles' upsamples, up1's padded by an edge row
# and column), for numpy-seeded inputs (`up_fold_outputs`).  Print them
# with `PYTHONPATH=. python tests/test_torch_up_cell_cuda.py` on a card.
UP_FOLD_DIGESTS = {
    "up0/8": [
        "e77af20f3bebf0f3424e9fa94b8bb52c8989f1726aa91c54f466bb07a6280b79",
        "726914a2a6bfe9f6a84c91d9d499586e44401103f0a6b64e7eb3d0db95781195"],
    "up0/60": [
        "fb857ef2630b7f8536d80c879215ec8fa3797370c1fada33da63dfcde653557d",
        "a587d4e4ca1457bdd3be317658c0d16596f8c51b6368fa65b6febeb8a8f7a1c0"],
    "up1/8": [
        "81a23479438db741a277cb13fcd286079eb77081600fdb69fd46ebb251cd141a",
        "ea64abddf9bfac654bc3a8d3a26bf6408b88c894b3445c3df0b3f31c886ec1ca"],
    "up1/60": [
        "211be048d248671e0386a47fb674668ef66cd254102cedba058394ce2a1c06c1",
        "788159ec65c579eb8506d3474c8d8bcfdda27f14e4dd946dcb868edc0a9ec832"],
    "up2/8": [
        "a1821205d4ce3ad3486e150f0ff0211d9c0665c5cfc21583e16d707fe6278cb7",
        "09937626eaffe16e7863519490280e790d4e918a4443bf8cb6498e3cdf4bdace"],
    "up2/60": [
        "1e18aba474a9690f85366a70cbe7ae8ecffff2b41992a24b05fa759f53ef6b2c",
        "3cd9130aae2af87f6f0f0487dacc32bbc288c059573bda3481c590f800793427"],
    "up3/8": [
        "bb2720aae53f636d4f2d0f20588c5efe4fea85a3afbcb2618f32c26526890ebf",
        "b581734fbc81346e8ce97c98c25003ed93d5673a59c3b16857abd60c7d07121b"],
    "up3/60": [
        "84e08914f425290b481367318238b0a3680b521c82f6201ccb53385d795375bd",
        "00f849d2065bd5b207c07bc2d6f0c8093a43c3d5e143b80989dc8db9a3165e49"],
}


def up_fold_outputs(cell: str, b: int):
    """(x1, y) of one launch with phase 0 at `cell`, B = b."""
    c, c1, s = UP_CELLS[UP_NAMES.index(cell)]
    rng = np.random.default_rng(2000 * c + b)

    def arr(shape, std=None):
        a = (rng.random(shape, dtype=np.float32) if std is None else
             rng.standard_normal(shape, dtype=np.float32) * np.float32(std))
        return torch.from_numpy(a).to("cuda")
    cin = 4 * c
    x2, x = arr((b, c, s, s)), arr((b, c, s // 2, s // 2), 1.0)
    ws = (arr((cin, c1, 3, 3), (2 / (9 * cin)) ** 0.5), arr((c1,), 0.1),
          arr((c1, c1, 3, 3), (2 / (9 * c1)) ** 0.5), arr((c1,), 0.1))
    up = Upsample(arr((c, c, 2, 2), (1 / c) ** 0.5), arr((c,), 0.1), "edge")
    y, _, x1 = up_module._launch(x2, x, *ws, None, up)
    return x1, y


@pytest.mark.parametrize("b", [8, 60])
@pytest.mark.parametrize("cell", UP_NAMES)
def test_folded_cell_outputs_keep_their_bits(cuda_device, cell, b):
    x1, y = up_fold_outputs(cell, b)
    assert [up_digest(x1), up_digest(y)] == UP_FOLD_DIGESTS[f"{cell}/{b}"]


if __name__ == "__main__":
    # the tables of `UP_DIGESTS` and `UP_FOLD_DIGESTS`, from the kernel as
    # it is built here
    torch.backends.cudnn.allow_tf32 = False
    for cell in UP_NAMES:
        for b in (8, 60):
            print(f'    "{cell}/{b}":\n'
                  f'        "{up_digest(up_cell_output(cell, b))}",',
                  flush=True)
    for cell in UP_NAMES:
        for b in (8, 60):
            x1, y = up_fold_outputs(cell, b)
            print(f'    "{cell}/{b}": [\n'
                  f'        "{up_digest(x1)}",\n'
                  f'        "{up_digest(y)}"],', flush=True)
