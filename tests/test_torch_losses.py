"""The port's discriminator, losses and naturalness score against the JAX
package (CPU).

Inputs are numpy arrays from fixed seeds, handed to both sides (NHWC for
JAX, NCHW for the port).  Tolerances: values 1e-5 relative, gradients 1e-4
of their max-abs (float32 sums in another order); the golden pack at 5e-5
as `tests/test_golden.py`.  The discrete choices inside `info_nce2` and
`pseudo_label_loss` (the most and least natural sample) get inputs whose
scores are far apart, and one case where all scores are equal, for the
first-index tie rule.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from uncltmo_tpu.losses import adversarial as jadv
from uncltmo_tpu.losses import struct as jstruct
from uncltmo_tpu.metrics import tmqi as jtmqi
from uncltmo_tpu.models.discriminator import (
    SimpleDiscriminator as JaxSimpleD)
from uncltmo_tpu.ops import resize as jresize
from uncltmo_tpu.ops import windows as jwin
from uncltmo_tpu.training import train_step as jstep
from uncltmo_tpu.utils.export_torch import export_discriminator
from uncltmo_tpu_torch import config as tconfig
from uncltmo_tpu_torch.losses import adversarial as adv
from uncltmo_tpu_torch.losses import struct as tstruct
from uncltmo_tpu_torch.metrics import tmqi as ttmqi
from uncltmo_tpu_torch.models.discriminator import (SimpleDiscriminator,
                                                    make_discriminator)
from uncltmo_tpu_torch.ops import resize as tresize
from uncltmo_tpu_torch.ops import windows as twin
from uncltmo_tpu_torch.training import train_step as tstep
from uncltmo_tpu_torch.utils.convert import (
    discriminator_state_dict_from_flax, load_state)

GOLDEN = os.path.join(os.path.dirname(__file__), "golden", "golden.npz")
FLOAT_TOL = 5e-5
VALUE_RTOL = 1e-5
GRAD_TOL = 1e-4          # of the gradient's max-abs


def _nchw(x, grad=False):
    t = torch.from_numpy(np.ascontiguousarray(x)).permute(0, 3, 1, 2)
    t = t.contiguous()
    return t.requires_grad_() if grad else t


def _nhwc(t):
    return t.detach().permute(0, 2, 3, 1).numpy()


def _assert_grad_close(got, ref, what=""):
    ref = np.asarray(ref)
    scale = max(float(np.abs(ref).max()), 1e-30)
    assert float(np.abs(got - ref).max()) <= GRAD_TOL * scale, (
        what, float(np.abs(got - ref).max()), scale)


# ---------------------------------------------------------------- ops
@pytest.mark.parametrize("h,w", [(22, 33), (56, 56), (30, 41)])
def test_block_std_mean_matches_jax(h, w):
    x = np.random.default_rng(0).random((3, h, w), np.float32) * 255.0
    ref = np.asarray(jax.vmap(jwin.block_std_mean)(jnp.asarray(x)))
    got = twin.block_std_mean(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, ref, rtol=VALUE_RTOL)
    one = twin.block_std_mean(torch.from_numpy(x[0])).numpy()
    np.testing.assert_allclose(one, ref[0], rtol=VALUE_RTOL)


@pytest.mark.parametrize("kernel,size", [("box5", 112), ("box5", 28),
                                         ("gauss11", 26), ("gauss11", 112)])
def test_window_mean_matches_jax_at_the_loss_sizes(kernel, size):
    x = np.random.default_rng(1).random((2, size, size, 3), np.float32)
    np.testing.assert_array_equal(twin.box_kernel_1d(5), jwin.box_kernel_1d(5))
    np.testing.assert_array_equal(twin.fspecial_gauss_1d(),
                                  jwin.fspecial_gauss_1d())
    k = (twin.box_kernel_1d(5) if kernel == "box5"
         else twin.fspecial_gauss_1d(11, 1.5))
    ref = np.asarray(jwin.window_mean(jnp.asarray(x), k))
    got = _nhwc(twin.window_mean(_nchw(x), k))
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("h,w", [(112, 112), (56, 56), (57, 40), (13, 9)])
def test_bicubic_half_matches_jax_and_interpolate(h, w):
    x = np.random.default_rng(2).random((2, h, w, 2), np.float32)
    ref = np.asarray(jresize.bicubic_half(jnp.asarray(x)))
    got = tresize.bicubic_half(_nchw(x))
    np.testing.assert_allclose(_nhwc(got), ref, rtol=1e-5, atol=1e-6)
    lib = F.interpolate(_nchw(x), scale_factor=0.5, mode="bicubic",
                        align_corners=False)
    np.testing.assert_allclose(got.numpy(), lib.numpy(), rtol=1e-5, atol=1e-6)


def _natural_images(rng, means, size=44, amp=0.3):
    """(len(means), size, size) images in [0, 1] whose naturalness scores
    are far apart (the score is a bell over the mean brightness)."""
    return np.stack([rng.random((size, size), np.float32) * amp + m
                     for m in means]).astype(np.float32)


def test_batched_naturalness_matches_jax():
    rng = np.random.default_rng(3)
    imgs = _natural_images(rng, [0.1, 0.3, 0.45, 0.6]) * 255.0
    # outside the beta density's support: block std far above 64.29
    checker = (np.indices((44, 44)).sum(0) % 2).astype(np.float32) * 255.0
    x = np.concatenate([imgs, checker[None]])
    ref = np.asarray(jtmqi.batched_naturalness(jnp.asarray(x)))
    got = ttmqi.batched_naturalness(torch.from_numpy(x)).numpy()
    assert ref[-1] == 0.0 and got[-1] == 0.0
    assert len(set(np.argsort(ref).tolist())) == 5
    np.testing.assert_allclose(got, ref, rtol=VALUE_RTOL, atol=1e-12)
    one = ttmqi.statistical_naturalness(torch.from_numpy(x[2])).numpy()
    np.testing.assert_allclose(one, ref[2], rtol=VALUE_RTOL)


# ------------------------------------------------------- adversarial
def _loss_cases():
    """name -> (jax fn, port fn, NHWC inputs, index of the differentiated
    input)."""
    rng = np.random.default_rng(4)
    b, s = 4, 44
    means = [0.15, 0.45, 0.62, 0.8]
    fake = _natural_images(rng, means, s)[..., None]
    ldr = rng.random((b, s, s, 1), np.float32)
    fea = [rng.random((b, 12, 12, 6), np.float32) for _ in range(3)]
    d_fea = [rng.standard_normal((b, 1, 1, 2)).astype(np.float32)
             for _ in range(3)]
    logits = [rng.standard_normal((b, 1)).astype(np.float32)
              for _ in range(2)]
    # patches with their own brightness, so the best patch is clear-cut
    patchy = np.zeros((2, s, s, 1), np.float32)
    pm = [0.1, 0.3, 0.45, 0.6, 0.7, 0.8, 0.9, 0.2]
    for i in range(2):
        for j in range(4):
            ys, xs = (j // 2) * 22, (j % 2) * 22
            patchy[i, ys:ys + 22, xs:xs + 22, 0] = (
                rng.random((22, 22), np.float32) * 0.3 + pm[4 * i + j] * 0.7)
    return {
        "contrastive_d_loss": (jadv.contrastive_d_loss,
                               adv.contrastive_d_loss, logits, 1),
        "similarity": (lambda a, b: jnp.sum(jadv._similarity(a, b, 1.0, 1e-2)),
                       lambda a, b: adv._similarity(a, b, 1.0, 1e-2).sum(),
                       fea[:2], 0),
        "lmcl_loss": (jadv.lmcl_loss, adv.lmcl_loss,
                      [logits[0][:, 0], rng.standard_normal(
                          (b, 3)).astype(np.float32)], 1),
        "nce_InfoNCE": (lambda a, p, n: jadv.nce(a, p, n, 1.0, 1e-2),
                        lambda a, p, n: adv.nce(a, p, n, 1.0, 1e-2), fea, 0),
        "nce_InfoNCE_k1e3": (lambda a, p, n: jadv.nce(a, p, n, 1e3, 2.0),
                             lambda a, p, n: adv.nce(a, p, n, 1e3, 2.0),
                             d_fea, 0),
        "nce_LMCL": (lambda a, p, n: jadv.nce(a, p, n, 1.0, 1e-2, "LMCL"),
                     lambda a, p, n: adv.nce(a, p, n, 1.0, 1e-2, "LMCL"),
                     fea, 0),
        "info_nce2": (lambda f, x: jadv.info_nce2(f, x, 1.0, 1e-2),
                      lambda f, x: adv.info_nce2(f, x, 1.0, 1e-2),
                      [fea[0], fake], 0),
        "info_nce2_LMCL": (lambda f, x: jadv.info_nce2(f, x, 1.0, 1e-2,
                                                       "LMCL"),
                           lambda f, x: adv.info_nce2(f, x, 1.0, 1e-2,
                                                      "LMCL"),
                           [fea[0], fake], 0),
        "mean_brightness_l1": (jadv.mean_brightness_l1,
                               adv.mean_brightness_l1, [fake, ldr], 0),
        "mean_contrast_l1": (jadv.mean_contrast_l1, adv.mean_contrast_l1,
                             [fake, ldr], 0),
        "pseudo_label_loss": (jadv.pseudo_label_loss, adv.pseudo_label_loss,
                              [patchy], 0),
        "tv_loss": (jadv.tv_loss, adv.tv_loss, [fake], 0),
    }


def _to_port(a, grad=False):
    if a.ndim == 4:
        return _nchw(a, grad)
    t = torch.from_numpy(a.copy())
    return t.requires_grad_() if grad else t


def _grad_to_jax_layout(t, like):
    g = t.grad
    return _nhwc(g) if like.ndim == 4 else g.numpy()


@pytest.mark.parametrize("name", sorted(_loss_cases()))
def test_adversarial_loss_matches_jax(name):
    jfn, tfn, inputs, diff = _loss_cases()[name]
    ref, ref_grad = jax.value_and_grad(jfn, argnums=diff)(
        *map(jnp.asarray, inputs))
    args = [_to_port(a, grad=(i == diff)) for i, a in enumerate(inputs)]
    out = tfn(*args)
    out.backward()
    np.testing.assert_allclose(out.item(), float(ref), rtol=VALUE_RTOL)
    _assert_grad_close(_grad_to_jax_layout(args[diff], inputs[diff]),
                       ref_grad, name)


def test_nce_refuses_an_unknown_loss_type():
    x = torch.rand(2, 3, 4, 4)
    with pytest.raises(ValueError, match="cl_loss_type"):
        adv.nce(x, x, x, 1.0, 1e-2, "other")


def test_ranked_losses_pick_the_first_index_on_ties():
    """Two samples tie for the best (or the worst) naturalness score: both
    sides take the first of them, which shows in the value because the
    tied samples' features differ."""
    rng = np.random.default_rng(5)
    good, bad = _natural_images(rng, [0.45, 0.8])[..., None]
    fea = rng.random((3, 10, 10, 4), np.float32)

    def with_choice(i_pos, i_neg):
        pos = np.repeat(fea[i_pos:i_pos + 1], 3, axis=0)
        neg = np.repeat(fea[i_neg:i_neg + 1], 3, axis=0)
        return adv.nce(_nchw(fea), _nchw(pos), _nchw(neg), 1.0, 1e-2).item()

    for fake, first, second in (
            (np.stack([good, good, bad]), (0, 2), (1, 2)),   # argmax ties
            (np.stack([good, bad, bad]), (0, 1), (0, 2))):   # argmin ties
        ref = float(jadv.info_nce2(jnp.asarray(fea), jnp.asarray(fake), 1.0,
                                   1e-2))
        got = adv.info_nce2(_nchw(fea), _nchw(fake), 1.0, 1e-2).item()
        assert got == pytest.approx(ref, rel=VALUE_RTOL)
        assert got == pytest.approx(with_choice(*first), rel=1e-6)
        assert abs(with_choice(*second) - ref) > 1e-3 * abs(ref)
    # four equal patches in every image: whichever of the tied four is the
    # pseudo label, the value is the same and equals the JAX package's
    tile = rng.random((22, 22), np.float32) * 0.5 + 0.2
    img = np.tile(tile, (2, 2))[None, :, :, None]
    imgs = np.concatenate([img, img * 0.5])
    ref = float(jadv.pseudo_label_loss(jnp.asarray(imgs)))
    got = adv.pseudo_label_loss(_nchw(imgs)).item()
    assert got == pytest.approx(ref, rel=VALUE_RTOL)


# ------------------------------------------------------------- struct
@pytest.mark.parametrize("level", ["single", "pyramid"])
def test_struct_loss_matches_jax(level):
    rng = np.random.default_rng(6)
    fake = rng.random((2, 64, 64, 1), np.float32)
    hdr = rng.random((2, 64, 64, 1), np.float32)
    hdr[0, :12, :12] = 0.0          # a flat region: the variance clamp's tie
    w = (0.2, 0.4, 0.6)
    if level == "single":
        jfn, tfn = jstruct.struct_loss_single, tstruct.struct_loss_single
    else:
        jfn = lambda a, b: jstruct.struct_loss_pyramid(a, b, w)    # noqa
        tfn = lambda a, b: tstruct.struct_loss_pyramid(a, b, w)    # noqa
    ref, ref_grad = jax.value_and_grad(jfn)(jnp.asarray(fake),
                                            jnp.asarray(hdr))
    x = _nchw(fake, grad=True)
    out = tfn(x, _nchw(hdr))
    out.backward()
    np.testing.assert_allclose(out.item(), float(ref), rtol=VALUE_RTOL)
    _assert_grad_close(_nhwc(x.grad), ref_grad, level)


def test_struct_loss_works_in_float32_whatever_the_input():
    rng = np.random.default_rng(7)
    fake = torch.from_numpy(rng.random((1, 1, 32, 32), np.float32))
    hdr = torch.from_numpy(rng.random((1, 1, 32, 32), np.float32))
    out = tstruct.struct_loss_single(fake.bfloat16(), hdr.bfloat16())
    assert out.dtype == torch.float32
    ref = tstruct.struct_loss_single(fake.bfloat16().float(),
                                     hdr.bfloat16().float())
    assert out.item() == ref.item()
    same = tstruct.struct_loss_single(fake, fake)
    assert 0.0 <= same.item() < 1e-6          # clamped, never negative


# ------------------------------------------------------ discriminator
def _jax_disc(size, **kw):
    disc = JaxSimpleD(input_size=size, **kw)
    v = jax.jit(disc.init)(jax.random.PRNGKey(0),
                           jnp.zeros((1, size, size, 1)))
    return disc, v


def test_discriminator_matches_golden():
    golden = np.load(GOLDEN)
    _, v = _jax_disc(128)
    params = jax.tree_util.tree_map(np.asarray, v["params"])
    port = load_state(SimpleDiscriminator(input_size=128),
                      discriminator_state_dict_from_flax(params))
    x = np.random.default_rng(3).random((2, 128, 128, 1), np.float32)
    with torch.no_grad():
        logits, fea = port(_nchw(x))
    assert tuple(logits.shape) == (2, 1) and tuple(fea.shape) == (2, 2, 1, 1)
    np.testing.assert_allclose(logits.numpy(), golden["discriminator/logits"],
                               rtol=FLOAT_TOL, atol=FLOAT_TOL)
    np.testing.assert_allclose(_nhwc(fea), golden["discriminator/fea"],
                               rtol=FLOAT_TOL, atol=FLOAT_TOL)


@pytest.mark.parametrize("kw", [
    {}, {"simpleD_maxpool": True}, {"padding": 1},
    {"last_activation": "sigmoid", "dim": 8}],
    ids=["published", "maxpool", "padding1", "sigmoid_dim8"])
def test_discriminator_options_match_jax(kw):
    size = 64
    disc, v = _jax_disc(size, **kw)
    params = jax.tree_util.tree_map(np.asarray, v["params"])
    sd = discriminator_state_dict_from_flax(params)
    ref_sd = export_discriminator(params)
    assert list(sd) == list(ref_sd)
    for k in sd:
        np.testing.assert_array_equal(sd[k], ref_sd[k], err_msg=k)
    port = SimpleDiscriminator(input_size=size, **kw)
    assert sorted(port.state_dict()) == sorted(sd)
    load_state(port, sd)                                # strict=True
    x = np.random.default_rng(8).random((3, size, size, 1), np.float32)
    ref_logit, ref_fea = disc.apply(v, jnp.asarray(x))
    xt = _nchw(x, grad=True)
    logit, fea = port(xt)
    np.testing.assert_allclose(logit.detach().numpy(), np.asarray(ref_logit),
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(_nhwc(fea), np.asarray(ref_fea), rtol=1e-4,
                               atol=1e-6)
    # the gradient of both outputs with respect to the image
    gref = jax.grad(lambda a: sum(jnp.sum(o) for o in disc.apply(v, a)))(
        jnp.asarray(x))
    (logit.sum() + fea.sum()).backward()
    _assert_grad_close(_nhwc(xt.grad), gref, str(kw))


def test_make_discriminator_builds_simpleD_and_names_the_rest():
    opt = tconfig.Options(d_down_dim=8, simpleD_maxpool=1)
    disc = make_discriminator(opt, input_size=64)
    assert sorted(disc.state_dict()) == ["model.0.bias", "model.0.weight",
                                        "model.2.bias", "model.2.weight",
                                        "tail.1.weight"]
    assert disc.tail[1].in_features == 16
    assert isinstance(make_discriminator(), SimpleDiscriminator)
    # the other variants are built (tests/test_torch_discriminators.py
    # holds them against JAX); an unknown name is refused by name
    for name in ("dcgan", "original", "patchD", "multiLayerD_simpleD"):
        assert not isinstance(make_discriminator(
            tconfig.Options(d_model=name)), SimpleDiscriminator)
    with pytest.raises(ValueError, match="nonsense"):
        make_discriminator(tconfig.Options(d_model="nonsense"))


def test_options_and_loss_config_mirror_the_jax_package():
    """Every field of the port's `Options` has the JAX package's default,
    and `LossConfig` has the same fields and defaults."""
    import dataclasses
    from uncltmo_tpu.config import Options as JaxOptions
    ref = {f.name: f.default for f in dataclasses.fields(JaxOptions)}
    mine = {f.name: f.default for f in dataclasses.fields(tconfig.Options)}
    for name in ("d_model", "d_down_dim", "d_norm", "d_last_activation",
                 "simpleD_maxpool", "d_padding"):
        assert name in mine, name
    assert {n: ref[n] for n in mine} == mine
    assert ([(f.name, f.default) for f in dataclasses.fields(tstep.LossConfig)]
            == [(f.name, f.default)
                for f in dataclasses.fields(jstep.LossConfig)])


# ---------------------------------------------------- the stage table
def _stage_inputs(seed=7, b=2, s=64, f=32):
    rng = np.random.default_rng(seed)
    fake = rng.random((b, s, s, 1), np.float32)
    fea_fake = rng.random((b, s, s, f), np.float32)
    d_fake_bp = rng.random((b, 1), np.float32)
    d_real_pos_bp = rng.random((b, 1), np.float32)
    d_fea = [rng.random((b, 1, 1, 2), np.float32) for _ in range(4)]
    ldr_pos = rng.random((b, s, s, 1), np.float32)
    return [fake, fea_fake, d_fake_bp, d_real_pos_bp, *d_fea, ldr_pos]


def test_generator_loss_terms_match_golden():
    golden = np.load(GOLDEN)
    args = [_to_port(a) for a in _stage_inputs()]
    vals = [[tstep.generator_loss_terms(
        stage, tstep.LossConfig(cl_loss_type=clt), *args).item()
        for stage in (0, 1, 2)] for clt in ("InfoNCE", "LMCL")]
    np.testing.assert_allclose(np.asarray(vals), golden["losses/stage_err"],
                               rtol=FLOAT_TOL, atol=FLOAT_TOL)


@pytest.mark.parametrize("stage", [0, 1, 2])
def test_generator_loss_terms_and_gradient_match_jax(stage):
    """The sum, and its gradient with respect to `fake`, whose small
    weights (1e-6) would hide a wrong term in the sum alone."""
    rng = np.random.default_rng(9)
    inputs = _stage_inputs(seed=10, b=4, s=44, f=6)
    inputs[0] = _natural_images(rng, [0.15, 0.45, 0.62, 0.8], 44)[..., None]
    ref, ref_grad = jax.value_and_grad(
        lambda fake, *rest: jstep.generator_loss_terms(
            stage, jstep.LossConfig(), fake, *rest))(
        *map(jnp.asarray, inputs))
    args = [_to_port(a, grad=(i == 0)) for i, a in enumerate(inputs)]
    out = tstep.generator_loss_terms(stage, tstep.LossConfig(), *args)
    out.backward()
    np.testing.assert_allclose(out.item(), float(ref), rtol=VALUE_RTOL)
    _assert_grad_close(_nhwc(args[0].grad), ref_grad, f"stage {stage}")
