"""The port's hand-written kernels against their plain PyTorch versions, on
a CUDA card.  Skipped without one (the kernels have no CPU mode).  The file
imports neither jax nor the JAX package, so it also runs where only the
port is installed:

    python -m pytest --noconftest tests/test_torch_kernels_cuda.py -q

Tolerances: K1 exact (copies, an exact bf16 product, a correctly rounded
sqrt); K2 rtol 1e-4 / atol 1e-4 in float32 (sums of up to 9*C1 terms in
another order than cuDNN's, on the tensor cores as split-TF32 products;
outputs are of order 1), 2e-2 of the output scale in bfloat16 (the
intermediate is rounded to bf16 in both, so one flipped rounding moves an
output by about a bf16 step).

The gradients: K1's backward kernel is the plain formula bit for bit in both
dtypes (every step rounds where the plain version rounds, and the launch
forbids fused multiply-adds).  K2's Function launches the kernel forward
and takes its gradients from the library (`double_conv3x3_backward`):
The kernel's output differs from cuDNN's in the last bits, so a few outputs
within 1e-6 of zero fall on the other side of the relu, and each adds or
removes a whole term of every gradient.  So the backward formula is held to
1e-4 of max-abs with the plain version's own output as its `y` (no flip
possible), and the Function end to end to 2e-3 in the L2 norm and 5e-2 of
max-abs entry by entry.
"""
import hashlib

import numpy as np
import pytest
import torch

from uncltmo_tpu_torch.ops.kernels.concat_skip import (
    concat_skip_backward_plain, concat_skip_plain, fused_concat_skip,
    fused_concat_skip_backward)
from uncltmo_tpu_torch.ops.kernels.double_conv import (
    default_plan, double_conv3x3_backward, double_conv3x3_plain,
    fused_double_conv3x3, kernel_plan)

pytestmark = pytest.mark.cuda

# (H, W, Cin, C1, C2): the tests/test_pallas.py shapes, the four U-Net cells
# (inc, down0, down1, down2), and two ragged shapes whose channel counts need
# padding (Cin = 1 with two chunks of C1; more than 256 output channels)
K2_SHAPES = [(37, 40, 16, 24, 16), (68, 32, 8, 8, 8), (61, 61, 64, 128, 128),
             (256, 256, 1, 32, 32), (126, 126, 32, 64, 64),
             (28, 28, 128, 256, 256), (29, 33, 1, 40, 24),
             (13, 14, 6, 96, 300)]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k1_kernel_matches_plain(cuda_device, dtype):
    g = torch.Generator(device="cpu").manual_seed(0)
    x2 = torch.rand(3, 16, 59, 40, generator=g).to(cuda_device, dtype)
    x1 = torch.randn(3, 16, 59, 40, generator=g).to(cuda_device, dtype)
    n = fused_concat_skip.launches
    out = fused_concat_skip(x2, x1)
    torch.cuda.synchronize()
    assert fused_concat_skip.launches == n + 1
    assert torch.equal(out, concat_skip_plain(x2, x1))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("h,w,cin,c1,c2", K2_SHAPES)
def test_k2_kernel_matches_plain(cuda_device, dtype, h, w, cin, c1, c2):
    g = torch.Generator(device="cpu").manual_seed(1)

    def rnd(*shape, std=1.0):
        return (torch.randn(shape, generator=g) * std).to(cuda_device, dtype)

    x = torch.rand(2, cin, h, w, generator=g).to(cuda_device, dtype)
    args = (x, rnd(c1, cin, 3, 3, std=(2 / (9 * cin)) ** 0.5), rnd(c1),
            rnd(c2, c1, 3, 3, std=(2 / (9 * c1)) ** 0.5), rnd(c2))
    n = fused_double_conv3x3.launches
    out = fused_double_conv3x3(*args)
    torch.cuda.synchronize()
    assert fused_double_conv3x3.launches == n + 1
    ref = double_conv3x3_plain(*args)
    if dtype == torch.float32:
        torch.testing.assert_close(out, ref, rtol=1e-4, atol=1e-4)
    else:
        err = (out.float() - ref.float()).abs().max().item()
        assert err <= 2e-2 * ref.float().abs().max().item()


# the U-Net's four cells (Cin, C1, C2, input side) at a 1080p frame's 60
# tiles and at a rank's training batch of 8
K2_CELLS = [(1, 32, 32, 256), (32, 64, 64, 126), (64, 128, 128, 61),
            (128, 256, 256, 28)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b", [8, 60])
@pytest.mark.parametrize("cin,c1,c2,s", K2_CELLS,
                         ids=["inc", "down0", "down1", "down2"])
def test_k2_cells_at_frame_and_rank_batches(cuda_device, dtype, b, cin, c1,
                                            c2, s):
    g = torch.Generator(device="cuda").manual_seed(8)

    def rnd(*shape, std=1.0):
        return (torch.randn(shape, generator=g, device="cuda")
                * std).to(dtype)

    x = torch.rand((b, cin, s, s), generator=g, device="cuda").to(dtype)
    args = (x, rnd(c1, cin, 3, 3, std=(2 / (9 * cin)) ** 0.5),
            rnd(c1, std=0.1), rnd(c2, c1, 3, 3, std=(2 / (9 * c1)) ** 0.5),
            rnd(c2, std=0.1))
    out = fused_double_conv3x3(*args)
    ref = double_conv3x3_plain(*args).float()
    err = (out.float() - ref).abs().max().item()
    tol = 1e-4 if dtype == torch.float32 else 2e-2
    assert err <= tol * ref.abs().max().item()


# SHA-256 of K2's output bytes at the four cells, at a rank's batch and at
# a 1080p frame's 60 tiles, for numpy-seeded inputs (`k2_cell_output`).
# Recorded from the kernel before its float32 schedule was rebuilt as
# persistent CTAs: the rebuild keeps every product, partial and float32
# join in its order, so every output keeps its bits.  Print them with
# `PYTHONPATH=. python tests/test_torch_kernels_cuda.py` on a card.
K2_DIGESTS = {
    "inc/8/float32":
        "9bfe46dcf3cc5ecc353b40d46ab545cc51de07a87b9c2964371242b2d439d3a4",
    "inc/8/bfloat16":
        "d34ae82a55945d4a9fb243dff60f4eba5dd3af6df4625b75fd18a7386b667645",
    "inc/60/float32":
        "4839a3ba634c2681933b6942cf0c850ca5a8669b4deb2512fa89c8586ba99d44",
    "inc/60/bfloat16":
        "1ac266e3ce2b875b8691b5a7e487465cdecacf28b7e207c0ce53ece27fdc8409",
    "down0/8/float32":
        "0a7bdc937d0fb3b0fda35430f6296172244b7889d4e7ad225ac667c2259780d0",
    "down0/8/bfloat16":
        "21d5ad8bae31c724737d24b6931061b5cded377d2cf8cbf93d19f1e62587fa82",
    "down0/60/float32":
        "35cb944e2b05effc81e5a16d7f04c251e70941e46b9f59a2340817bae89d8144",
    "down0/60/bfloat16":
        "eccfea2c60287f9a6a4d1b8a60c2cb839807a3ee89a59e0e0834e0817bc76e7a",
    "down1/8/float32":
        "cdcb1b2ab8935b74a44887cc0336656a49c27df2a481ab162e7bbe340b8e83fe",
    "down1/8/bfloat16":
        "fa4957c8aa7836b1a295cc46db05f27bab6a5adc4584e273fc1ac56cbd8e7308",
    "down1/60/float32":
        "f49f09110c542637987cd7a3b87bff8fe87a0b7d34353a3e5879271fd5d7acaf",
    "down1/60/bfloat16":
        "1e6c9ca4d23fe66ebfbc8d1830e4eec9656e6540b5f13fe3870ccae1105d43c8",
    "down2/8/float32":
        "23c1394704f584354fe4bacefd77cd42b5e99a5e9ae2722df32eb270e62a1065",
    "down2/8/bfloat16":
        "beb6e4301b4555355a9e102cf39a6d0cb786d64369ed953115fcea613391113e",
    "down2/60/float32":
        "5493872412c90c3b04378b4a60ef9d364fb318501b037a3960f2e6a2944be53e",
    "down2/60/bfloat16":
        "8ee2825d0afa625915a3c2cff497c614b83fb95515c04a69408e550178b4645e",
}


def k2_cell_output(cell: str, b: int, dtype: torch.dtype) -> torch.Tensor:
    """K2's output at `cell` for inputs drawn with numpy from a seed of
    the cell and the batch (uniform input, He-scaled weights)."""
    cin, c1, c2, s = K2_CELLS[["inc", "down0", "down1", "down2"].index(cell)]
    rng = np.random.default_rng(1000 * cin + b)

    def arr(shape, std=None):
        a = (rng.random(shape, dtype=np.float32) if std is None else
             rng.standard_normal(shape, dtype=np.float32) * np.float32(std))
        return torch.from_numpy(a).to("cuda").to(dtype)

    args = (arr((b, cin, s, s)), arr((c1, cin, 3, 3), (2 / (9 * cin)) ** 0.5),
            arr((c1,), 0.1), arr((c2, c1, 3, 3), (2 / (9 * c1)) ** 0.5),
            arr((c2,), 0.1))
    return fused_double_conv3x3(*args)


def k2_digest(out: torch.Tensor) -> str:
    raw = out.contiguous().view(torch.uint8).cpu().numpy()
    return hashlib.sha256(raw.tobytes()).hexdigest()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["float32", "bfloat16"])
@pytest.mark.parametrize("b", [8, 60])
@pytest.mark.parametrize("cell", ["inc", "down0", "down1", "down2"])
def test_k2_outputs_keep_their_bits(cuda_device, cell, b, dtype):
    name = f"{cell}/{b}/{str(dtype).split('.')[-1]}"
    assert k2_digest(k2_cell_output(cell, b, dtype)) == K2_DIGESTS[name]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("cin,c1,c2", [(1, 32, 32), (32, 64, 64),
                                       (64, 128, 128), (128, 256, 256),
                                       (3, 5, 7), (144, 40, 72),
                                       (6, 96, 300)])
def test_k2_plan_matches_the_packings_mirror(cuda_device, dtype, cin, c1,
                                             c2):
    """The built library's plan is the one the CPU packing assumes, and
    `down2` runs as a cluster."""
    plan = kernel_plan(cin, c1, c2, dtype, cuda_device)
    assert plan == default_plan(cin, c1, c2, dtype)
    if (cin, c1, c2) == (128, 256, 256):
        assert plan.cl >= 2


# a batch of 120 tiles (two 1080p scenes in one video frame step) and one
# plane of a whole 1080p frame (B = 1, ragged right and bottom edges)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(120, 64, 122, 122), (1, 64, 538, 962)],
                         ids=["b120_tile", "b1_plane"])
def test_k1_kernel_at_video_and_whole_image_shapes(cuda_device, dtype, shape):
    g = torch.Generator(device="cuda").manual_seed(2)
    x2 = torch.rand(shape, generator=g, device="cuda").to(dtype)
    x1 = torch.randn(shape, generator=g, device="cuda").to(dtype)
    assert torch.equal(fused_concat_skip(x2, x1), concat_skip_plain(x2, x1))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,cin,c1,c2,h,w",
                         [(120, 64, 128, 128, 61, 61),
                          (1, 32, 64, 64, 542, 966)],
                         ids=["b120_tile", "b1_plane"])
def test_k2_kernel_at_video_and_whole_image_shapes(cuda_device, dtype, b, cin,
                                                   c1, c2, h, w):
    g = torch.Generator(device="cuda").manual_seed(3)

    def rnd(*shape, std=1.0):
        return (torch.randn(shape, generator=g, device="cuda")
                * std).to(dtype)

    x = torch.rand((b, cin, h, w), generator=g, device="cuda").to(dtype)
    args = (x, rnd(c1, cin, 3, 3, std=(2 / (9 * cin)) ** 0.5), rnd(c1),
            rnd(c2, c1, 3, 3, std=(2 / (9 * c1)) ** 0.5), rnd(c2))
    out = fused_double_conv3x3(*args)
    ref = double_conv3x3_plain(*args)
    assert out.shape == ref.shape == (b, c2, h - 4, w - 4)
    if dtype == torch.float32:
        torch.testing.assert_close(out, ref, rtol=1e-4, atol=1e-4)
    else:
        err = (out.float() - ref.float()).abs().max().item()
        assert err <= 2e-2 * ref.float().abs().max().item()


def test_kernels_refuse_what_they_do_not_take(cuda_device):
    x = torch.rand(1, 4, 4, 9, device=cuda_device)
    w1, b1 = torch.rand(6, 4, 3, 3, device=cuda_device), torch.rand(
        6, device=cuda_device)
    w2, b2 = torch.rand(5, 6, 3, 3, device=cuda_device), torch.rand(
        5, device=cuda_device)
    with pytest.raises(ValueError):            # H < 5
        fused_double_conv3x3(x, w1, b1, w2, b2)
    with pytest.raises(ValueError):            # mixed dtypes
        fused_double_conv3x3(torch.rand(1, 4, 9, 9, device=cuda_device),
                             w1.double(), b1, w2, b2)
    with pytest.raises(ValueError):            # shape mismatch
        fused_concat_skip(x, x[:, :2])


def test_kernels_launch_on_the_tensors_card(cuda_device):
    """With card 0 current, tensors on card 1 (made there just before, on
    its own stream) go through K1, its backward and K2 on card 1, as an
    engine over two devices runs them."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA cards")
    dev = torch.device("cuda", 1)
    g = torch.Generator(device="cpu").manual_seed(4)
    x2 = torch.rand(8, 32, 126, 126, generator=g).to(dev) * 2.0
    x1 = torch.randn(8, 32, 126, 126, generator=g).to(dev) - 0.5
    gout = torch.randn(8, 128, 126, 126, generator=g).to(dev)
    w1, b1 = torch.randn(64, 32, 3, 3, generator=g).to(dev) * 0.08, \
        torch.randn(64, generator=g).to(dev)
    w2, b2 = torch.randn(64, 64, 3, 3, generator=g).to(dev) * 0.06, \
        torch.randn(64, generator=g).to(dev)
    with torch.cuda.device(0):
        out = fused_concat_skip(x2, x1)
        dx2, dx1 = fused_concat_skip_backward(x2, gout)
        y = fused_double_conv3x3(x2, w1, b1, w2, b2)
    torch.cuda.synchronize(dev)
    assert out.device == dx2.device == y.device == dev
    assert torch.equal(out, concat_skip_plain(x2, x1))
    ref_dx2, ref_dx1 = concat_skip_backward_plain(x2, gout)
    assert torch.equal(dx2, ref_dx2) and torch.equal(dx1, ref_dx1)
    torch.testing.assert_close(y, double_conv3x3_plain(x2, w1, b1, w2, b2),
                               rtol=1e-4, atol=1e-4)


def _post_relu(shape, g, dtype):
    """A skip as the encoder makes it: non-negative, many exact zeros."""
    x = torch.randn(shape, generator=g, device="cuda")
    return torch.relu(x).to(dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(3, 16, 59, 40), (16, 64, 122, 122),
                                   (1, 5, 7, 3)],
                         ids=["ragged", "train_b16", "tiny"])
def test_k1_backward_kernel_matches_plain(cuda_device, dtype, shape):
    g = torch.Generator(device="cuda").manual_seed(4)
    x2 = _post_relu(shape, g, dtype)
    b, c, h, w = shape
    gout = torch.randn((b, 4 * c, h, w), generator=g, device="cuda").to(dtype)
    n = fused_concat_skip.backward_launches
    dx2, dx1 = fused_concat_skip_backward(x2, gout)
    torch.cuda.synchronize()
    assert fused_concat_skip.backward_launches == n + 1
    ref2, ref1 = concat_skip_backward_plain(x2, gout)
    assert torch.equal(dx2, ref2) and torch.equal(dx1, ref1)
    # a gradient that arrives non-contiguous
    strided = gout.transpose(2, 3).contiguous().transpose(2, 3)
    assert not strided.is_contiguous()
    dx2, _ = fused_concat_skip_backward(x2, strided)
    assert torch.equal(dx2, ref2)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k1_function_differentiates_through_the_kernels(cuda_device, dtype):
    g = torch.Generator(device="cuda").manual_seed(5)
    x2 = _post_relu((2, 8, 30, 31), g, dtype).requires_grad_()
    x1 = torch.randn((2, 8, 30, 31), generator=g,
                     device="cuda").to(dtype).requires_grad_()
    gout = torch.randn((2, 32, 30, 31), generator=g, device="cuda").to(dtype)
    n = (fused_concat_skip.launches, fused_concat_skip.backward_launches)
    out = fused_concat_skip(x2, x1)
    assert out.grad_fn is not None
    out.backward(gout)
    assert (fused_concat_skip.launches,
            fused_concat_skip.backward_launches) == (n[0] + 1, n[1] + 1)
    ref2, ref1 = concat_skip_backward_plain(x2.detach(), gout)
    assert torch.equal(x2.grad, ref2) and torch.equal(x1.grad, ref1)
    with pytest.raises(ValueError):            # gradient of another shape
        fused_concat_skip_backward(x2.detach(), gout[:, :8])


@pytest.mark.parametrize("b,cin,c1,c2,h,w",
                         [(16, 1, 32, 32, 256, 256),
                          (16, 32, 64, 64, 126, 126),
                          (16, 64, 128, 128, 61, 61),
                          (16, 128, 256, 256, 28, 28), (2, 3, 5, 7, 9, 11)],
                         ids=["inc", "down0", "down1", "down2", "ragged"])
def test_k2_function_matches_autograd_of_plain(cuda_device, b, cin, c1, c2,
                                               h, w):
    g = torch.Generator(device="cuda").manual_seed(6)

    def rnd(*shape, std=1.0):
        return torch.randn(shape, generator=g, device="cuda") * std

    args = [torch.rand((b, cin, h, w), generator=g, device="cuda"),
            rnd(c1, cin, 3, 3, std=(2 / (9 * cin)) ** 0.5), rnd(c1, std=0.1),
            rnd(c2, c1, 3, 3, std=(2 / (9 * c1)) ** 0.5), rnd(c2, std=0.1)]
    need_dx = cin > 1                      # `inc` reads the batch itself
    leaves = [a.clone().requires_grad_(i > 0 or need_dx)
              for i, a in enumerate(args)]
    n = (fused_double_conv3x3.launches, fused_double_conv3x3.backward_calls)
    y = fused_double_conv3x3(*leaves)
    gy = torch.randn(y.shape, generator=g, device="cuda")
    wanted = [t for t in leaves if t.requires_grad]
    got = torch.autograd.grad(y, wanted, gy)
    assert (fused_double_conv3x3.launches,
            fused_double_conv3x3.backward_calls) == (n[0] + 1, n[1] + 1)
    ref_leaves = [a.clone().requires_grad_(i > 0 or need_dx)
                  for i, a in enumerate(args)]
    ref_y = double_conv3x3_plain(*ref_leaves)
    ref = torch.autograd.grad(ref_y, [t for t in ref_leaves
                                      if t.requires_grad], gy)
    torch.testing.assert_close(y, ref_y, rtol=1e-4, atol=1e-4)
    formula = double_conv3x3_backward(*args, ref_y.detach(), gy,
                                      need_dx=need_dx)
    for a, f, r in zip(got, [t for t in formula if t is not None], ref):
        assert a.shape == r.shape
        assert (f - r).abs().max() <= 1e-4 * r.abs().max()
        assert (a - r).norm() <= 2e-3 * r.norm()
        assert (a - r).abs().max() <= 5e-2 * r.abs().max()


if __name__ == "__main__":
    # the table of `K2_DIGESTS`, from the kernel as it is built here
    torch.backends.cudnn.allow_tf32 = False
    for cell in ("inc", "down0", "down1", "down2"):
        for b in (8, 60):
            for dtype in (torch.float32, torch.bfloat16):
                out = k2_cell_output(cell, b, dtype)
                print(f'    "{cell}/{b}/{str(dtype).split(".")[-1]}":\n'
                      f'        "{k2_digest(out)}",', flush=True)
                del out
