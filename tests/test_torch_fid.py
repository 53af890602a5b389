"""FID of the port (`uncltmo_tpu_torch/metrics/{fid,inception}.py`,
`ops/resize.py:pil_bicubic_resize_u8`) against PIL and the JAX package.

The published Inception weights are not in the repository, so both
packages read one seeded torchvision-named state dict written to
`tmp_path` (BN statistics drawn away from (0, 1), as
`tests/test_metrics.py` draws them, so the folding is exercised); it is
built in numpy, which spares JAX's 16 s `init`.  Held: PIL's resample bit for bit; `load_fid_image` bit for bit;
the trunk and the 8x8 pool within 1e-4 of the activations' max-abs (at
171 px, where Mixed_6e is 9x9 and the 9 -> 8 pool's cells overlap); the
FID within 1e-4 relative in both protocols (float32 sums in another order
move the activations by ~1e-6, the float64 statistics carry that);
the refusals without weights; and the trainer's FID tail.
"""
import os
import types

import numpy as np
import pytest
import torch
from PIL import Image

from uncltmo_tpu.metrics import fid as jfid
from uncltmo_tpu.metrics import inception as jinc
from uncltmo_tpu_torch.metrics import fid as tfid
from uncltmo_tpu_torch.metrics import inception as tinc
from uncltmo_tpu_torch.ops.resize import pil_bicubic_resize_u8
from uncltmo_tpu_torch.utils.io import write_png

TRUNK_TOL = 1e-4              # of the activations' max-abs
FID_RTOL = 1e-4


def seeded_inception_state_dict(seed: int) -> dict:
    """A torchvision-named InceptionV3 state dict through Mixed_6e, in
    numpy: He-scaled conv weights, BN statistics away from (0, 1)."""
    rng = np.random.default_rng(seed)
    sd = {}
    for k, v in tinc.InceptionTrunk768().state_dict().items():
        if not k.endswith(".weight"):
            continue
        p, (o, i, kh, kw) = k[:-len(".weight")], v.shape
        sd[p + ".conv.weight"] = (rng.standard_normal((o, i, kh, kw))
                                  * np.sqrt(2.0 / (i * kh * kw)))
        sd[p + ".bn.weight"] = rng.normal(1.0, 0.05, o)
        sd[p + ".bn.bias"] = rng.normal(0.0, 0.05, o)
        sd[p + ".bn.running_mean"] = rng.normal(0.0, 0.05, o)
        sd[p + ".bn.running_var"] = rng.uniform(0.5, 1.5, o)
    return {k: v.astype(np.float32) for k, v in sd.items()}


@pytest.fixture(scope="module")
def weights(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("inception") / "inception.npz")
    np.savez(path, **seeded_inception_state_dict(0))
    return path


def _u8_image(rng, shape, alpha=False):
    """A smooth image with texture, uint8 (H, W, C) or (H, W)."""
    h, w = shape[:2]
    yy, xx = np.mgrid[0:h, 0:w] / max(h, w)
    f = rng.uniform(2.0, 9.0, 3)
    base = 128 + 90 * np.sin(f[0] * xx + f[1] * yy) * np.cos(f[2] * yy)
    im = base[..., None] + rng.normal(0, 20, shape if len(shape) == 3
                                      else shape + (1,))
    im = np.clip(im, 0, 255).astype(np.uint8)
    if alpha:
        im[..., 3] = rng.choice([0, 1, 64, 200, 255], (h, w))
    return im if len(shape) == 3 else im[..., 0]


@pytest.mark.parametrize("mode,channels", [("RGB", 3), ("L", 0),
                                           ("RGBA", 4)])
@pytest.mark.parametrize("size", [(160, 203), (402, 517), (299, 299)],
                         ids=["up", "down", "same"])
def test_pil_bicubic_resize_is_bit_equal_to_pil(mode, channels, size):
    rng = np.random.default_rng(channels)
    shape = size + ((channels,) if channels else ())
    im = _u8_image(rng, shape, alpha=channels == 4)
    for out in ((299, 299), (97, 311)):
        ref = np.asarray(Image.fromarray(im, mode).resize(out,
                                                          Image.BICUBIC))
        np.testing.assert_array_equal(pil_bicubic_resize_u8(im, *out), ref)


def test_load_fid_image_is_bit_equal_to_jax(tmp_path):
    """PNGs that PIL writes (filtered rows: the port decodes them through
    imageio) and that the port writes, RGB, gray and RGBA with a varying
    alpha, in the three value pipelines; and the modes PIL converts
    (gray + alpha, a palette, 16-bit gray and RGB written by cv2) in the
    real-side pipeline."""
    import cv2
    rng = np.random.default_rng(1)
    files = []
    for name, shape, mode in (("rgb", (180, 240, 3), "RGB"),
                              ("gray", (330, 310), "L"),
                              ("rgba", (260, 200, 4), "RGBA")):
        p = str(tmp_path / f"{name}.png")
        Image.fromarray(_u8_image(rng, shape, alpha=mode == "RGBA"),
                        mode).save(p)
        files.append(p)
    files.append(write_png(str(tmp_path / "own.png"),
                           _u8_image(rng, (301, 333, 3))))
    Image.fromarray(_u8_image(rng, (90, 120, 2)), "LA").save(
        tmp_path / "la.png")
    Image.fromarray(_u8_image(rng, (90, 120, 3))).convert("P").save(
        tmp_path / "p.png")
    cv2.imwrite(str(tmp_path / "g16.png"),
                (rng.random((90, 120)) * 600).astype(np.uint16))
    cv2.imwrite(str(tmp_path / "c16.png"),
                (rng.random((90, 120, 3)) * 65535).astype(np.uint16))
    for name in ("la", "p", "g16", "c16"):
        p = str(tmp_path / f"{name}.png")
        np.testing.assert_array_equal(tfid.load_fid_image(p, False),
                                      jfid.load_fid_image(p, False),
                                      err_msg=name)
    for p in files:
        for fake, small in ((False, False), (True, False), (False, True),
                            (True, True)):
            got = tfid.load_fid_image(p, fake, small)
            ref = jfid.load_fid_image(p, fake, small)
            assert got.dtype == np.float32 and got.shape == (299, 299, 3)
            np.testing.assert_array_equal(got, ref, err_msg=str(
                (p, fake, small)))


def test_trunk_and_pool_match_jax(weights):
    """2 x 171 x 171: Mixed_6e is 9 x 9, so the adaptive pool's cells
    overlap (rows 0-1, 1-2, ...)."""
    x = np.random.default_rng(2).random((2, 171, 171, 3)).astype(np.float32)
    ref = jinc.make_inception_extractor(weights)(x)
    got = tinc.make_inception_extractor(weights, device="cpu")(x)
    assert got.shape == ref.shape == (2, 8, 8, 768)
    scale = float(np.abs(ref).max())
    assert scale > 0.1
    err = float(np.abs(got - ref).max())
    assert err <= TRUNK_TOL * scale, (err, scale)


def test_pth_and_npz_weights_fold_alike(weights, tmp_path):
    """The same state dict as `.pth` (torch tensors) and as `.npz` folds to
    the same conv weights, equal to the JAX package's folding (HWIO)."""
    sd = dict(np.load(weights))
    pth = str(tmp_path / "w.pth")
    torch.save({k: torch.from_numpy(v) for k, v in sd.items()}, pth)
    a = tinc.load_inception_params(weights)
    b = tinc.load_inception_params(pth)
    assert a.keys() == b.keys()
    for k in a:
        assert torch.equal(a[k], b[k]), k
    jp = jinc.load_inception_params(weights)
    np.testing.assert_array_equal(
        a["Mixed_6e.branch7x7dbl_2.weight"].numpy().transpose(2, 3, 1, 0),
        jp["Mixed_6e"]["branch7x7dbl_2"]["kernel"])
    np.testing.assert_array_equal(a["Conv2d_1a_3x3.bias"].numpy(),
                                  jp["Conv2d_1a_3x3"]["bias"])


def _fid_dirs(root, seed):
    rng = np.random.default_rng(seed)
    real, fake = root / "real", root / "fake"
    real.mkdir()
    fake.mkdir()
    for i in range(3):
        Image.fromarray(_u8_image(rng, (299, 299, 3))).save(real / f"{i}.png")
        write_png(str(fake / f"{i}.png"),
                  (_u8_image(rng, (320, 300, 3)) * 0.7).astype(np.uint8))
    return str(real), str(fake)


@pytest.mark.parametrize("small_dset", [False, True],
                         ids=["main", "small_dset"])
def test_fid_matches_jax(tmp_path, weights, small_dset):
    real, fake = _fid_dirs(tmp_path, 3)
    ref = jfid.calculate_fid_given_paths([real, fake], weights_path=weights,
                                         small_dset=small_dset)
    got = tfid.calculate_fid_given_paths([real, fake], weights_path=weights,
                                         small_dset=small_dset, device="cpu")
    assert np.isfinite(got) and got > 0
    assert abs(got - ref) <= FID_RTOL * abs(ref), (got, ref)


def test_fid_refuses_without_weights(tmp_path):
    with pytest.raises(RuntimeError, match="weights"):
        tfid.calculate_fid_given_paths(["a", "b"], device="cpu")
    with pytest.raises(FileNotFoundError, match="no random-weight"):
        tinc.load_inception_params(str(tmp_path / "missing.pth"))
    with pytest.raises(FileNotFoundError, match="Inception weights"):
        tinc.make_inception_extractor("", device="cpu")
    sd = seeded_inception_state_dict(1)
    del sd["Mixed_6e.branch_pool.bn.running_var"]
    with pytest.raises(KeyError, match="Mixed_6e.branch_pool"):
        tinc.convert_inception_state_dict(sd)
    (tmp_path / "empty").mkdir()
    with pytest.raises(ValueError, match="no png/jpg/jpeg"):
        tfid.path_statistics(str(tmp_path / "empty"), lambda b: b, False)


def _assess(trainer_cls, runner_module, monkeypatch, opt, renders, device):
    """`run_final_assessment` of `trainer_cls` on a stand-in trainer whose
    runner copies `renders` into the output directory (the renders are not
    what is compared here: the FID tail is)."""
    class Runner:
        def __init__(self, *a, **k):
            pass

        def run_on_path(self, inp, out_dir, lam, scale=4):
            os.makedirs(out_dir, exist_ok=True)
            for f in sorted(os.listdir(renders)):
                with open(os.path.join(renders, f), "rb") as src, open(
                        os.path.join(out_dir, f), "wb") as dst:
                    dst.write(src.read())
            return sorted(os.listdir(out_dir))

    monkeypatch.setattr(runner_module, "InferenceRunner", Runner)
    fake_self = types.SimpleNamespace(
        opt=opt, device=device, _generator_state_dict=lambda: {},
        _generator_variables=lambda: {})
    return trainer_cls.run_final_assessment(fake_self, "unused", "unused")


def test_trainer_fid_tail_writes_the_jax_dict(tmp_path, weights, monkeypatch,
                                              capsys):
    """The renders' FID against `fid_real_path`, merged by model name into
    `fid_res_path` (relative to the output directory, `.npy` appended)
    beside an entry already there, as the JAX trainer writes it; without
    weights both print the same `FID skipped` line."""
    import dataclasses
    from uncltmo_tpu import config as jconfig
    from uncltmo_tpu.inference import runner as jrunner
    from uncltmo_tpu.training.trainer import GanTrainer as JTrainer
    from uncltmo_tpu_torch import config as tconfig
    from uncltmo_tpu_torch.inference import runner as trunner
    from uncltmo_tpu_torch.training.trainer import GanTrainer as TTrainer
    real, renders = _fid_dirs(tmp_path, 4)
    dicts, lines = {}, {}
    for tag, cls, mod, cfg in (("jax", JTrainer, jrunner, jconfig),
                               ("port", TTrainer, trunner, tconfig)):
        out = tmp_path / tag
        out.mkdir()
        np.save(out / "fid_results.npy", {"earlier_model": 12.5})
        for w in ("none", weights):
            opt = cfg.Options(output_dir=str(out), fid_real_path=real,
                              inception_weights=w, result_dir_prefix="m9")
            cfg.save_run_settings(opt, str(out))
            capsys.readouterr()
            outs = _assess(cls, mod, monkeypatch, opt, renders, "cpu")
            lines.setdefault(tag, []).append(capsys.readouterr().out)
        assert len(outs) == 3
        dicts[tag] = np.load(out / "fid_results.npy", allow_pickle=True)[()]
        assert dataclasses.asdict(opt)["fid_res_path"] == "fid_results"
    assert dicts["port"].keys() == dicts["jax"].keys() == {"earlier_model",
                                                           "m9"}
    assert dicts["port"]["earlier_model"] == 12.5
    ref, got = dicts["jax"]["m9"], dicts["port"]["m9"]
    assert isinstance(got, float) and abs(got - ref) <= FID_RTOL * abs(ref)
    assert lines["port"][0] == lines["jax"][0]
    assert lines["port"][0].startswith("FID skipped: RuntimeError: FID needs")
    assert "FID skipped" not in lines["port"][1]
