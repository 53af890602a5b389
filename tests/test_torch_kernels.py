"""The port's K1/K2 against the JAX package's Pallas kernels.

On the CPU the wrappers run their plain PyTorch versions, held here against
the Pallas kernels in interpret mode (as `tests/test_pallas.py` runs them).
The kernels themselves run only on the card:
`tests/test_torch_kernels_cuda.py` holds them against the plain versions.
Tolerances: K1 1e-6 (elementwise), K2 rtol 1e-4 / atol 1e-5 (float32 sums in
another order), as `tests/test_pallas.py`.

The gradients: on the card both wrappers are `torch.autograd.Function`s.
Their backward formulas are plain functions (`concat_skip_backward_plain`,
`double_conv3x3_backward`) that run here on CPU tensors, against autograd of
the plain forwards and, for K1, against `jax.vjp` of the Pallas kernel in
interpret mode.  Tolerances there: float32 1e-5 of the gradient's max-abs
(the same terms, `g / (2 rt)` against `g * (0.5 / rt)`); bfloat16 one bf16
step (2^-7) against the JAX VJP, whose rounding order the port copies, and
3e-2 against autograd, which rounds at other places.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from uncltmo_tpu.ops.pallas_kernels import (fused_concat_skip as jax_k1,
                                            fused_double_conv3x3 as jax_k2)
from uncltmo_tpu_torch.ops.kernels.concat_skip import (
    concat_skip_backward_plain, concat_skip_plain, fused_concat_skip,
    fused_concat_skip_backward)
from uncltmo_tpu_torch.ops.kernels.double_conv import (
    double_conv3x3_backward, double_conv3x3_plain, fused_double_conv3x3)

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


def _k1_grad_inputs(dtype):
    """x2 like a post-relu skip (a third of it exactly zero, where
    0.5 / rt = 5000), x1 and the concat's gradient g."""
    rng = np.random.default_rng(2)
    x2 = np.maximum(rng.standard_normal((2, 19, 23, 8)), 0.0) \
        * (rng.random((2, 19, 23, 8)) > 0.3)
    x1 = rng.standard_normal((2, 19, 23, 8))
    g = rng.standard_normal((2, 19, 23, 32))
    return [_nchw(a.astype(np.float32)).contiguous().to(dtype)
            for a in (x2, x1, g)]


def _max_rel(got, ref):
    ref = ref.float()
    return ((got.float() - ref).abs().max() / ref.abs().max()).item()


@pytest.mark.parametrize("dtype,vs_autograd,vs_jax",
                         [(torch.float32, 1e-5, 1e-6),
                          (torch.bfloat16, 3e-2, 2 ** -7)],
                         ids=["float32", "bfloat16"])
def test_k1_backward_plain_matches_autograd_and_jax_vjp(dtype, vs_autograd,
                                                        vs_jax):
    x2, x1, g = _k1_grad_inputs(dtype)
    assert (x2 == 0).float().mean() > 0.3
    dx2, dx1 = concat_skip_backward_plain(x2, g)
    assert torch.equal(dx1, g[:, 8:16])
    # autograd of the plain forward
    a2, a1 = x2.clone().requires_grad_(), x1.clone().requires_grad_()
    concat_skip_plain(a2, a1).backward(g)
    assert torch.equal(a1.grad, dx1)
    assert _max_rel(dx2, a2.grad) <= vs_autograd
    # the JAX package's hand-derived VJP around the Pallas kernel
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16

    def nhwc(t):
        return jnp.asarray(t.float().permute(0, 2, 3, 1).numpy()).astype(jdt)

    _, vjp = jax.vjp(lambda a, b: jax_k1(a, b, True), nhwc(x2), nhwc(x1))
    j2, j1 = vjp(nhwc(g))
    j2 = _nchw(np.asarray(j2.astype(jnp.float32)))
    assert _max_rel(dx2, j2) <= vs_jax
    np.testing.assert_array_equal(
        np.asarray(j1.astype(jnp.float32)),
        dx1.float().permute(0, 2, 3, 1).numpy())


def test_k1_wrappers_differentiate_on_the_cpu():
    """CPU tensors go through the plain forward under autograd; the
    backward wrapper is the plain formula; neither counts a launch."""
    x2, x1, g = _k1_grad_inputs(torch.float32)
    before = (fused_concat_skip.launches, fused_concat_skip.backward_launches)
    a2, a1 = x2.clone().requires_grad_(), x1.clone().requires_grad_()
    out = fused_concat_skip(a2, a1)
    assert out.grad_fn is not None
    out.backward(g)
    dx2, dx1 = fused_concat_skip_backward(x2, g.transpose(2, 3).contiguous()
                                          .transpose(2, 3))   # non-contiguous
    assert _max_rel(dx2, a2.grad) <= 1e-5 and torch.equal(dx1, a1.grad)
    assert before == (fused_concat_skip.launches,
                      fused_concat_skip.backward_launches)


@pytest.mark.parametrize("h,w,cin,c1,c2", K2_SHAPES + [(12, 11, 1, 8, 8)])
def test_k2_backward_matches_autograd_of_plain(h, w, cin, c1, c2):
    x, k1, b1, k2, b2 = _k2_inputs(3, h, w, cin, c1, c2)
    args = [_nchw(x).contiguous(), _oihw(k1), torch.from_numpy(b1),
            _oihw(k2), torch.from_numpy(b2)]
    leaves = [a.clone().requires_grad_() for a in args]
    y = double_conv3x3_plain(*leaves)
    gy = torch.from_numpy(np.random.default_rng(4).standard_normal(
        tuple(y.shape)).astype(np.float32))
    ref = torch.autograd.grad(y, leaves, gy)
    got = double_conv3x3_backward(*args, y.detach(), gy)
    for name, a, b in zip(("dx", "dw1", "db1", "dw2", "db2"), got, ref):
        assert a.shape == b.shape, name
        assert _max_rel(a, b) <= 1e-5, name
    no_dx = double_conv3x3_backward(*args, y.detach(), gy, need_dx=False)
    assert no_dx[0] is None and torch.equal(no_dx[1], got[1])
    # the wrapper on CPU tensors: the plain forward under autograd
    before = fused_double_conv3x3.backward_calls
    leaves = [a.clone().requires_grad_() for a in args]
    via = torch.autograd.grad(fused_double_conv3x3(*leaves), leaves, gy)
    for a, b in zip(via, ref):
        assert torch.equal(a, b)
    assert fused_double_conv3x3.backward_calls == before
