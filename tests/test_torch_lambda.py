"""The port's lambda estimation and `prepare_lambdas` CLI against the JAX
package (CPU): the cross-entropy over a grid of lambdas, the grid-and-zoom
fit, `calc_lambda` over a directory, the area resize of oversized frames
against cv2, and the CLI's four modes against the JAX CLI's files.

Tolerances: the golden lambda at 5e-5 relative (`tests/test_golden.py`'s
rule); the cross-entropy vector at 1e-5 relative on all but 2% of a
512-lambda grid, and within 1e-3 everywhere.  The bin edges are float32
thresholds (10^(e M) - 1) / lambda whose `pow` and `log10` round an ulp
apart in XLA and in torch now and then; where a luminance sits between the
two, a count moves by one and that entry differs by up to a few 1e-4 (5
entries of 512 on seed 0, the rest within 1e-6).  Fitted lambdas and dicts
at 5e-5 relative; the area resize at 1e-6 of the range (float32 sums in
another order than cv2's).
"""
import importlib.util
import os
import sys

import cv2
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from uncltmo_tpu.ops import lambda_est as jlam
from uncltmo_tpu_torch.cli import prepare_lambdas as tcli
from uncltmo_tpu_torch.ops import lambda_est as tlam
from uncltmo_tpu_torch.ops.preprocess import area_resize_np, reshape_image_np
from uncltmo_tpu_torch.utils.io import write_png, write_radiance_hdr

GOLDEN = os.path.join(os.path.dirname(__file__), "golden", "golden.npz")
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _jax_cli():
    spec = importlib.util.spec_from_file_location(
        "uncltmo_cli_prepare_lambdas_oracle",
        os.path.join(ROOT, "cli", "prepare_lambdas.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _hdr(rng, h, w):
    """Linear RGB over ~4 decades with texture."""
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    logl = 2.0 * np.sin(xx / w * rng.uniform(2, 5)) + 1.5 * np.cos(
        yy / h * rng.uniform(2, 5))
    rgb = (10.0 ** logl)[..., None] * rng.uniform(0.4, 1.0, 3)
    rgb = rgb * (1.0 + 0.1 * rng.random((h, w, 3)))
    return rgb.astype(np.float32)


def _hist(tmp_path, rng):
    t = np.float32(rng.random(20) + 0.2)
    path = str(tmp_path / "hist.npy")
    np.save(path, {"mean_vals": t / t.sum() * 20,
                   "all_bins": np.linspace(0, 1, 21)})
    return path, np.asarray(t / t.sum() * 20, np.float32)


def test_fit_lambda_matches_golden():
    golden = np.load(GOLDEN)
    rng = np.random.default_rng(6)
    rng.random((1, 64, 64, 1), np.float32)        # the contrast_map input
    gray = rng.random((120, 160), np.float32) ** 3 * 50.0
    targets = np.float32(rng.random(20))
    lam = tlam.fit_lambda(gray, targets / targets.sum(), device="cpu")
    np.testing.assert_allclose(lam, golden["ops/lambda"][0], rtol=5e-5)


@pytest.mark.parametrize("seed", [0, 1])
def test_cross_entropy_over_a_grid_matches_jax(seed):
    rng = np.random.default_rng(seed)
    gray = (rng.random((96, 128), np.float32) ** 3 * 80.0).reshape(-1)
    gs = np.sort(gray) / np.sort(gray)[-1]
    lams = np.power(10.0, np.linspace(0, 9, 512)).astype(np.float32)
    t = np.float32(rng.random(20))
    t = t / t.sum()
    ref = np.asarray(jlam._ce_for_lambdas(jnp.asarray(gs), jnp.asarray(lams),
                                          jnp.asarray(t), 20))
    got = tlam._ce_for_lambdas(torch.from_numpy(gs), torch.from_numpy(lams),
                               torch.from_numpy(t), 20).numpy()
    rel = np.abs(got - ref) / np.abs(ref)
    assert (rel > 1e-5).mean() <= 0.02
    assert rel.max() <= 1e-3
    # the host objective is the JAX package's, bit for bit
    for lam in (3.0, 250.0, 4e5):
        assert tlam.cross_entropy_np(lam, gray, t, 20) == \
            jlam.cross_entropy_np(lam, gray, t, 20)


def test_fit_lambda_takes_a_tensor_and_matches_jax():
    rng = np.random.default_rng(3)
    gray = _hdr(rng, 90, 110)[..., 1]
    t = np.float32(rng.random(20) + 0.1)
    ref = jlam.fit_lambda(gray, t)
    np.testing.assert_allclose(tlam.fit_lambda(torch.from_numpy(gray), t,
                                               device="cpu"), ref, rtol=5e-5)


def test_calc_lambda_on_a_directory_gives_the_jax_dict(tmp_path):
    """.hdr and .npy inputs, a stray README, and a lambda dict inside the
    input directory that must not be read as an image."""
    rng = np.random.default_rng(4)
    d = tmp_path / "in"
    d.mkdir()
    write_radiance_hdr(str(d / "a.hdr"), _hdr(rng, 70, 90))
    np.save(d / "b.npy", _hdr(rng, 64, 80))
    np.save(d / "c.npy", _hdr(rng, 50, 66) - 0.5)      # negative values
    (d / "README.txt").write_text("not an image")
    inner = str(d / "known.npy")
    np.save(inner, {"b": 123.0})
    hist, _ = _hist(tmp_path, rng)
    outs = {}
    for name, fn, kw in (("jax", jlam.calc_lambda, {}),
                         ("port", tlam.calc_lambda, {"device": "cpu"})):
        out_dir = tmp_path / name
        out_dir.mkdir()
        path = fn(inner, (".hdr", ".npy"), str(d), hist, str(out_dir), **kw)
        assert path == str(out_dir / "input_images_lambdas.npy")
        outs[name] = np.load(path, allow_pickle=True)[()]
    assert set(outs["port"]) == set(outs["jax"]) == {"a", "b", "c"}
    for k in outs["jax"]:
        np.testing.assert_allclose(outs["port"][k], outs["jax"][k],
                                   rtol=5e-5)
    # a dict that covers the directory is returned as it is
    full = str(tmp_path / "full.npy")
    np.save(full, {"a": 1.0, "b": 2.0, "c": 3.0, "known": 4.0})
    assert tlam.calc_lambda(full, (".hdr", ".npy"), str(d), hist,
                            str(tmp_path), device="cpu") == full


def test_verify_lambda_dict_follows_the_extension_rule(tmp_path):
    d = tmp_path / "in"
    d.mkdir()
    np.save(d / "im0.npy", np.ones((8, 8, 3), np.float32))
    (d / "README.txt").write_text("stray")
    dict_path = str(tmp_path / "lams.npy")
    np.save(dict_path, {"im0": 123.0})
    for ext in ((".npy",), None):
        assert tlam.verify_lambda_dict(dict_path, str(d), ext) == \
            jlam.verify_lambda_dict(dict_path, str(d), ext)
    assert tlam.verify_lambda_dict(dict_path, str(d), (".npy",))
    assert not tlam.verify_lambda_dict(dict_path, str(d))
    inner = str(d / "inner_lams.npy")
    np.save(inner, {"im0": 123.0})
    assert tlam.verify_lambda_dict(inner, str(d), (".npy",))
    os.unlink(inner)
    np.save(d / "im1.npy", np.ones((8, 8, 3), np.float32))
    assert not tlam.verify_lambda_dict(dict_path, str(d), (".npy",))
    assert not tlam.verify_lambda_dict("none", str(d), (".npy",))


@pytest.mark.parametrize("h,w,oh,ow", [(100, 130, 33, 43), (61, 47, 20, 15),
                                       (90, 90, 30, 30), (37, 41, 12, 13)])
def test_area_resize_matches_cv2(h, w, oh, ow):
    rng = np.random.default_rng(h + w)
    for shape in ((h, w), (h, w, 3)):
        x = rng.random(shape, np.float32) * 100.0
        ref = cv2.resize(x, (ow, oh), interpolation=cv2.INTER_AREA)
        got = area_resize_np(x, oh, ow)
        assert got.shape == ref.shape and got.dtype == np.float32
        np.testing.assert_allclose(got, ref, rtol=0, atol=1e-6 * 100.0)


def test_the_size_policy_at_2001_by_2003():
    """A short side above 2000 is cut to a third (w // 3 of 2003 is 667, a
    non-integer scale); 3000 and below 2000 are left alone."""
    from uncltmo_tpu.ops.preprocess import reshape_image_np as jreshape
    rng = np.random.default_rng(11)
    x = rng.random((2001, 2003), np.float32)
    got = reshape_image_np(x)
    ref = jreshape(x, train_reshape=False)
    assert got.shape == ref.shape == (667, 667)
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-6)
    small = rng.random((1999, 2500), np.float32)
    assert reshape_image_np(small) is small


def _write_ldr_dir(path, rng):
    """Four 8-bit PNGs the port's reader takes (gray and RGB), one that a
    library writes (with row filters), and a stray text file."""
    import imageio.v2 as imageio
    os.makedirs(path)
    for i in range(2):
        write_png(os.path.join(path, f"rgb{i}.png"),
                  (rng.random((30, 40, 3)) * 255).astype(np.uint8))
        write_png(os.path.join(path, f"gray{i}.png"),
                  (rng.random((30, 40)) ** 2 * 255).astype(np.uint8))
    yy = np.mgrid[0:30, 0:40][0].astype(np.uint8) * 8
    imageio.imwrite(os.path.join(path, "z_filtered.png"),
                    np.stack([yy, yy, yy], -1))
    with open(os.path.join(path, "notes.txt"), "w") as f:
        f.write("not an image")


def test_prepare_lambdas_modes_write_the_jax_clis_files(tmp_path, capsys):
    rng = np.random.default_rng(12)
    jcli = _jax_cli()
    ldr = str(tmp_path / "ldr")
    _write_ldr_dir(ldr, rng)
    hdr = tmp_path / "hdr"
    hdr.mkdir()
    write_radiance_hdr(str(hdr / "im0.hdr"), _hdr(rng, 60, 80))
    np.save(hdr / "im1.npy", _hdr(rng, 48, 64))
    scenes = tmp_path / "scenes"
    for s in ("s0", "s1"):
        (scenes / s).mkdir(parents=True)
        for i in range(2):
            np.save(scenes / s / f"{i:03d}.npy", _hdr(rng, 40, 52))
    (scenes / "empty").mkdir()
    (scenes / "list.txt").write_text("stray")
    out = {}
    for name, cli, extra in (("jax", jcli, []),
                             ("port", tcli, ["--device", "cpu"])):
        o = tmp_path / name
        o.mkdir()
        hist = str(o / "hist.npy")
        cli.main(["--mode", "mean_hist", "--input_dir", ldr, "--output",
                  hist])
        for mode, src in (("lambdas", hdr), ("scene_lambdas", scenes)):
            cli.main(["--mode", mode, "--input_dir", str(src), "--output",
                      str(o / f"{mode}.npy"), "--mean_hist_path", hist]
                     + extra)
        out[name] = {k: np.load(o / f"{k}.npy", allow_pickle=True)[()]
                     for k in ("hist", "lambdas", "scene_lambdas")}
    np.testing.assert_allclose(out["port"]["hist"]["mean_vals"],
                               out["jax"]["hist"]["mean_vals"], rtol=1e-6)
    np.testing.assert_array_equal(out["port"]["hist"]["all_bins"],
                                  out["jax"]["hist"]["all_bins"])
    for mode in ("lambdas", "scene_lambdas"):
        assert set(out["port"][mode]) == set(out["jax"][mode])
        for k, v in out["jax"][mode].items():
            np.testing.assert_allclose(out["port"][mode][k], v, rtol=5e-5)
    assert set(out["port"]["scene_lambdas"]) == {"s0", "s1"}
    capsys.readouterr()
    tcli.main(["--mode", "show", "--npy", str(tmp_path / "port" /
                                              "lambdas.npy")])
    shown = capsys.readouterr().out
    jcli.main(["--mode", "show", "--npy", str(tmp_path / "port" /
                                              "lambdas.npy")])
    assert shown == capsys.readouterr().out and "(2 entries)" in shown


def test_mean_hist_refuses_by_name_without_a_reader(tmp_path, monkeypatch):
    """A file the port's PNG reader does not take needs imageio or cv2, as
    the JAX reader does; without both, the refusal says so.  An empty
    directory is refused before a NaN histogram is saved."""
    d = tmp_path / "ldr"
    d.mkdir()
    cv2.imwrite(str(d / "a.jpg"), np.full((8, 8, 3), 90, np.uint8))
    for name in ("imageio", "imageio.v2", "cv2"):
        monkeypatch.setitem(sys.modules, name, None)
    with pytest.raises(NotImplementedError,
                       match="need imageio or cv2, as the JAX reader does"):
        tcli.main(["--mode", "mean_hist", "--input_dir", str(d),
                   "--output", str(tmp_path / "h.npy")])
    (tmp_path / "none").mkdir()
    with pytest.raises(SystemExit):
        tcli.main(["--mode", "mean_hist", "--input_dir",
                   str(tmp_path / "none"), "--output",
                   str(tmp_path / "h.npy")])


def test_image_cli_fits_missing_lambdas_with_calc_lambda(tmp_path):
    """`--calc_lambda 1`: the lambda of the image the dict lacks is fitted
    into {lambda_output_path}/input_images_lambdas.npy, as the JAX CLI
    fits it, and both images are tone-mapped."""
    from uncltmo_tpu_torch.cli.test_imageTMO import main
    from uncltmo_tpu_torch.models.unet import UNetTMO, seeded_init_
    rng = np.random.default_rng(13)
    model_dir = tmp_path / "model"
    model_dir.mkdir()
    gen = seeded_init_(UNetTMO(filters=8), 0)
    torch.save({"modelG_state_dict": gen.state_dict()},
               str(model_dir / "trained_weights.pth"))
    np.save(model_dir / "run_settings.npy", {"filters": 8})
    in_dir = tmp_path / "in"
    in_dir.mkdir()
    np.save(in_dir / "a.npy", _hdr(rng, 64, 72))
    write_radiance_hdr(str(in_dir / "b.hdr"), _hdr(rng, 60, 70))
    lam = str(tmp_path / "lams.npy")
    np.save(lam, {"a": 200.0})
    hist, _ = _hist(tmp_path, rng)
    (tmp_path / "fitted").mkdir()
    main(["--model_path", str(model_dir), "--input_images_path",
          str(in_dir), "--output_path", str(tmp_path / "out"),
          "--f_factor_path", lam, "--scale", "1", "--calc_lambda", "1",
          "--mean_hist_path", hist, "--lambda_output_path",
          str(tmp_path / "fitted"), "--device", "cpu"])
    assert sorted(os.listdir(tmp_path / "out")) == ["a_UnCLTMO.png",
                                                    "b_UnCLTMO.png"]
    fitted = np.load(tmp_path / "fitted" / "input_images_lambdas.npy",
                     allow_pickle=True)[()]
    (tmp_path / "jax").mkdir()
    ref = np.load(jlam.calc_lambda(lam, (".hdr", ".npy"), str(in_dir), hist,
                                   str(tmp_path / "jax")),
                  allow_pickle=True)[()]
    assert set(fitted) == set(ref) == {"a", "b"}
    np.testing.assert_allclose(fitted["b"], ref["b"], rtol=5e-5)
