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
"""
import pytest
import torch

from uncltmo_tpu_torch.ops.kernels.concat_skip import (concat_skip_plain,
                                                       fused_concat_skip)
from uncltmo_tpu_torch.ops.kernels.double_conv import (double_conv3x3_plain,
                                                       fused_double_conv3x3)

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
