"""The port's K1/K2 against the JAX package's Pallas kernels.

On the CPU the wrappers run their plain PyTorch versions, held here against
the Pallas kernels in interpret mode (as `tests/test_pallas.py` runs them).
The kernels themselves run only on the card:
`tests/test_torch_kernels_cuda.py` holds them against the plain versions.
Tolerances: K1 1e-6 (elementwise), K2 rtol 1e-4 / atol 1e-5 (float32 sums in
another order), as `tests/test_pallas.py`.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from uncltmo_tpu.ops.pallas_kernels import (fused_concat_skip as jax_k1,
                                            fused_double_conv3x3 as jax_k2)
from uncltmo_tpu_torch.ops.kernels.concat_skip import (concat_skip_plain,
                                                       fused_concat_skip)
from uncltmo_tpu_torch.ops.kernels.double_conv import (double_conv3x3_plain,
                                                       fused_double_conv3x3)

K2_SHAPES = [(37, 40, 16, 24, 16), (68, 32, 8, 8, 8)]


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x)).permute(0, 3, 1, 2)


def _k2_inputs(seed, h, w, cin, c1, c2):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((2, h, w, cin)).astype(np.float32)
    k1 = (rng.standard_normal((3, 3, cin, c1)) * 0.1).astype(np.float32)
    b1 = (rng.standard_normal(c1) * 0.1).astype(np.float32)
    k2 = (rng.standard_normal((3, 3, c1, c2)) * 0.1).astype(np.float32)
    b2 = (rng.standard_normal(c2) * 0.1).astype(np.float32)
    return x, k1, b1, k2, b2


def _oihw(k):
    return torch.from_numpy(np.ascontiguousarray(k.transpose(3, 2, 0, 1)))


def test_k1_plain_matches_pallas():
    rng = np.random.default_rng(0)
    x2 = np.abs(rng.standard_normal((2, 59, 40, 16))).astype(np.float32)
    x1 = rng.standard_normal((2, 59, 40, 16)).astype(np.float32)
    ref = np.asarray(jax_k1(jnp.asarray(x2), jnp.asarray(x1), True))
    out = fused_concat_skip(_nchw(x2), _nchw(x1))
    np.testing.assert_allclose(out.permute(0, 2, 3, 1).numpy(), ref,
                               rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("h,w,cin,c1,c2", K2_SHAPES)
def test_k2_plain_matches_pallas(h, w, cin, c1, c2):
    x, k1, b1, k2, b2 = _k2_inputs(1, h, w, cin, c1, c2)
    ref = np.asarray(jax_k2(*map(jnp.asarray, (x, k1, b1, k2, b2)),
                            interpret=True))
    out = fused_double_conv3x3(_nchw(x), _oihw(k1), torch.from_numpy(b1),
                               _oihw(k2), torch.from_numpy(b2))
    np.testing.assert_allclose(out.permute(0, 2, 3, 1).numpy(), ref,
                               rtol=1e-4, atol=1e-5)


def test_cpu_tensors_take_the_plain_versions():
    """On the CPU the wrappers are their plain versions and count no
    kernel launch."""
    k1_before = fused_concat_skip.launches
    k2_before = fused_double_conv3x3.launches
    x = torch.rand(1, 4, 9, 9)
    assert torch.equal(fused_concat_skip(x, x), concat_skip_plain(x, x))
    w1, b1 = torch.rand(6, 4, 3, 3), torch.rand(6)
    w2, b2 = torch.rand(5, 6, 3, 3), torch.rand(5)
    assert torch.equal(fused_double_conv3x3(x, w1, b1, w2, b2),
                       double_conv3x3_plain(x, w1, b1, w2, b2))
    assert fused_concat_skip.launches == k1_before
    assert fused_double_conv3x3.launches == k2_before
