"""The port's offline metric CLIs (`uncltmo_tpu_torch/cli/compute_metrics.py`
and `png2video.py`) against the JAX package's (`cli/`, loaded by file path
as `tests/test_cli.py` loads them), on `--device cpu`.

Each `compute_metrics` subcommand writes its JSON; the port's is held
against the JAX CLI's key for key: TMQI and BTMQI within 5e-5 (the golden
tolerance; the port's TMQI runs in float64 where JAX's runs float32, and
agrees to that on textured images), the warp error equal where both take
cv2's estimator and within 2e-3 with the Horn-Schunck flow in torch
(`tests/test_torch_warp.py`), FID within 1e-4 relative
(`tests/test_torch_fid.py`).  The HDR image that does not match its
render's size is resized on the device, held here against the JAX CLI's
`cv2.resize`.  png2video's AVI decodes to the JAX CLI's frames.
"""
import importlib.util
import json
import os
import sys

import cv2
import numpy as np
import pytest

from test_torch_fid import seeded_inception_state_dict
from uncltmo_tpu_torch.cli import compute_metrics as tcm
from uncltmo_tpu_torch.cli import png2video as tpv
from uncltmo_tpu_torch.utils.io import write_png, write_radiance_hdr

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = 5e-5


def _jax_cli(name):
    spec = importlib.util.spec_from_file_location(
        f"uncltmo_cli_{name}_for_port", os.path.join(ROOT, "cli",
                                                     name + ".py"))
    mod = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = mod
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def jcm():
    return _jax_cli("compute_metrics")


def _close(got, ref, rtol, path="") -> None:
    """JSON values equal in structure, numbers within `rtol` (relative,
    with `rtol` absolute below 1)."""
    if isinstance(ref, dict):
        assert sorted(got) == sorted(ref), path
        for k in ref:
            _close(got[k], ref[k], rtol, f"{path}/{k}")
    elif isinstance(ref, list):
        assert len(got) == len(ref), path
        for i, (a, b) in enumerate(zip(got, ref)):
            _close(a, b, rtol, f"{path}[{i}]")
    elif isinstance(ref, float):
        assert abs(got - ref) <= rtol * max(abs(ref), 1.0), (path, got, ref)
    else:
        assert got == ref, path


def _run_both(jcm, tmp_path, args, port_extra=("--device", "cpu")):
    out = {}
    for tag, main in (("jax", jcm.main), ("port", tcm.main)):
        path = str(tmp_path / f"{tag}.json")
        main(args + ["--output", path]
             + (list(port_extra) if tag == "port" else []))
        with open(path) as f:
            out[tag] = json.load(f)
    return out["port"], out["jax"]


def _hdr(rng, h, w):
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    f = rng.uniform(4.0, 12.0, 3)
    logl = (1.5 * np.sin(f[0] * xx / w + f[1] * yy / h)
            + np.cos(f[2] * yy / h))
    rgb = 10.0 ** logl[..., None] * rng.uniform(0.4, 1.0, 3)
    rgb *= 1.0 + 0.1 * rng.standard_normal((h, w, 3))
    return np.clip(rgb, 1e-3, None).astype(np.float32)


def _render(rng, hdr, size=None):
    """A textured tone-mapped rendering of `hdr`, uint8, at `size`."""
    ldr = np.log1p(hdr) / np.log1p(hdr.max()) * 230.0
    ldr = np.clip(ldr + rng.normal(0, 6, hdr.shape), 0, 255).astype(np.uint8)
    if size is not None:
        ldr = cv2.resize(ldr, (size[1], size[0]))
    return ldr


def test_hdr_resize_on_the_device_matches_cv2():
    rng = np.random.default_rng(0)
    hdr = _hdr(rng, 96, 128)
    for h, w in ((72, 100), (120, 150), (96, 64)):
        ref = cv2.resize(hdr, (w, h))
        got = tcm._hdr_at(hdr, np.zeros((h, w, 3)), "cpu").numpy()
        np.testing.assert_allclose(got, ref, rtol=1e-5,
                                   atol=1e-5 * hdr.max())
    same = tcm._hdr_at(hdr, np.zeros((96, 128, 3)), "cpu")
    np.testing.assert_array_equal(same.numpy(), hdr)


def test_tmqi_pair_and_directory(jcm, tmp_path, capsys):
    """The single pair with a render smaller than its HDR, then a directory
    of .hdr / .npy inputs with their `_UnCLTMO` renders, plain and TMQIr,
    capped by --max_frames.  (Sizes whose pyramid levels are never smaller
    than the 11 px window in one axis only, which both packages refuse.)"""
    rng = np.random.default_rng(1)
    hdr_dir, ldr_dir = tmp_path / "hdr", tmp_path / "ldr"
    hdr_dir.mkdir()
    ldr_dir.mkdir()
    for i, ext in enumerate((".hdr", ".npy", ".hdr")):
        hdr = _hdr(rng, 96, 128)
        if ext == ".hdr":
            write_radiance_hdr(str(hdr_dir / f"{i}{ext}"), hdr)
        else:
            np.save(hdr_dir / f"{i}{ext}", hdr)
        write_png(str(ldr_dir / f"{i}_UnCLTMO.png"), _render(rng, hdr))
    (hdr_dir / "notes.txt").write_text("not a frame")
    hdr = _hdr(rng, 96, 128)
    np.save(tmp_path / "pair.npy", hdr)
    write_png(str(tmp_path / "pair.png"), _render(rng, hdr, (88, 112)))
    got, ref = _run_both(jcm, tmp_path, [
        "tmqi", "--hdr_file", str(tmp_path / "pair.npy"), "--ldr_file",
        str(tmp_path / "pair.png")])
    _close(got, ref, TOL)
    assert 0.0 < got["Q"] <= 1.0
    for extra in ([], ["--revised", "1"], ["--max_frames", "2"]):
        got, ref = _run_both(jcm, tmp_path, [
            "tmqi", "--hdr_dir", str(hdr_dir), "--ldr_dir", str(ldr_dir)]
            + extra)
        _close(got, ref, TOL)
        assert len(got["per_image"]) == (2 if extra[:1] == ["--max_frames"]
                                         else 3)
    capsys.readouterr()


def test_tmqi_per_scene(jcm, tmp_path):
    rng = np.random.default_rng(2)
    for scene in ("s0", "s1"):
        (tmp_path / "h" / scene).mkdir(parents=True)
        (tmp_path / "l" / scene).mkdir(parents=True)
        for i in range(3):
            hdr = _hdr(rng, 64, 72)
            np.save(tmp_path / "h" / scene / f"{i:03d}.npy", hdr)
            write_png(str(tmp_path / "l" / scene / f"{i:03d}_UnCLTMO.png"),
                      _render(rng, hdr))
    got, ref = _run_both(jcm, tmp_path, [
        "tmqi", "--hdr_dir", str(tmp_path / "h"), "--ldr_dir",
        str(tmp_path / "l"), "--per_scene", "1", "--max_frames", "2"])
    _close(got, ref, TOL)
    assert sorted(got["per_scene"]) == ["s0", "s1"]
    assert all(len(v) == 2 for v in got["per_scene"].values())


def _frames(d, rng, n=3, h=112, w=128, shift=2):
    d.mkdir()
    base = _render(rng, _hdr(rng, h, w + shift * n))
    for i in range(n):
        cv2.imwrite(str(d / f"{i:03d}.png"),
                    base[:, i * shift:i * shift + w])


@pytest.mark.parametrize("algo,rtol", [("auto", 1e-6), ("hs_jax", 2e-3)])
def test_warp(jcm, tmp_path, algo, rtol):
    """Frames decoded on the host and scored on --device cpu: 'auto' takes
    cv2's estimator in both packages; 'hs_jax' the Horn-Schunck flow, in
    torch in the port.  With --baseline_dir the flow comes from the
    baseline renders (`_L1L0TM` names)."""
    rng = np.random.default_rng(3)
    _frames(tmp_path / "f", rng)
    (tmp_path / "b").mkdir()
    for name in sorted(os.listdir(tmp_path / "f")):
        im = cv2.imread(str(tmp_path / "f" / name))
        cv2.imwrite(str(tmp_path / "b" / name.replace(".png", "_L1L0TM.png")),
                    cv2.GaussianBlur(im, (5, 5), 1.0))
    for extra in ([], ["--baseline_dir", str(tmp_path / "b")]):
        got, ref = _run_both(jcm, tmp_path, [
            "warp", "--frames_dir", str(tmp_path / "f"), "--algo", algo]
            + extra)
        _close(got, ref, rtol)
        assert got["flow_source"] == ("baseline" if extra else "self")


def test_fid(jcm, tmp_path):
    rng = np.random.default_rng(4)
    weights = str(tmp_path / "w.npz")
    np.savez(weights, **seeded_inception_state_dict(2))
    for d in ("real", "fake"):
        (tmp_path / d).mkdir()
        for i in range(3):
            write_png(str(tmp_path / d / f"{i}.png"),
                      _render(rng, _hdr(rng, 150, 170)))
    got, ref = _run_both(jcm, tmp_path, [
        "fid", "--real_dir", str(tmp_path / "real"), "--fake_dir",
        str(tmp_path / "fake"), "--inception_weights", weights,
        "--small_dset", "1"])
    _close(got, ref, 1e-4)
    assert got["fid"] > 0


def test_btmqi(jcm, tmp_path):
    """The surrogate over a directory with the reference demo's
    pre-adjustment, and the SVR on a savemat model with the |Spearman|
    against a MOS table."""
    import scipy.io as sio
    rng = np.random.default_rng(5)
    (tmp_path / "ldr").mkdir()
    mos = {}
    for i in range(4):
        name = f"{i}_UnCLTMO.png"
        write_png(str(tmp_path / "ldr" / name),
                  _render(rng, _hdr(rng, 96, 112)))
        mos[name] = float(i)
    (tmp_path / "mos.json").write_text(json.dumps(mos))
    sio.savemat(str(tmp_path / "model.mat"), {"model": {
        "Parameters": np.array([[4.0], [2.0], [3.0], [1.0 / 11.0], [0.0]]),
        "SVs": rng.normal(4.0, 2.0, (6, 11)),
        "sv_coef": rng.normal(0.0, 1.0, (6, 1)),
        "rho": np.array([[-6.2008]])}})
    base = ["btmqi", "--ldr_dir", str(tmp_path / "ldr")]
    for extra in (["--demo_adjust", "1"],
                  ["--model_mat", str(tmp_path / "model.mat"), "--mos",
                   str(tmp_path / "mos.json")]):
        got, ref = _run_both(jcm, tmp_path, base + extra)
        _close(got, ref, TOL)
    assert 0.0 <= got["spearman_abs"] <= 1.0 and len(got["scores"]) == 4


def test_png2video_frames_equal_the_jax_cli(tmp_path, capsys):
    rng = np.random.default_rng(6)
    _frames(tmp_path / "f", rng, n=4, h=60, w=80, shift=3)
    decoded = {}
    for tag, main in (("jax", _jax_cli("png2video").main), ("port", tpv.main)):
        out = str(tmp_path / f"{tag}.avi")
        main(["--input_dir", str(tmp_path / "f"), "--output", out,
              "--width", "96", "--height", "64"])
        cap = cv2.VideoCapture(out)
        frames = []
        while True:
            ok, fr = cap.read()
            if not ok:
                break
            frames.append(fr)
        cap.release()
        decoded[tag] = np.stack(frames)
    assert decoded["port"].shape == (4, 64, 96, 3)
    np.testing.assert_array_equal(decoded["port"], decoded["jax"])
    (tmp_path / "empty").mkdir()
    with pytest.raises(SystemExit, match="no PNG frames"):
        tpv.main(["--input_dir", str(tmp_path / "empty")])
    capsys.readouterr()


def test_cli_help_names_every_subcommand_and_device(capsys):
    for sub in ("tmqi", "warp", "fid", "btmqi"):
        with pytest.raises(SystemExit) as e:
            tcm.main([sub, "--help"])
        assert e.value.code == 0
        assert "--device" in capsys.readouterr().out, sub
    with pytest.raises(SystemExit):
        tcm.main(["fid", "--real_dir", "a", "--fake_dir", "b"])
    with pytest.raises(SystemExit):
        tcm.main(["tmqi", "--hdr_file", "x.npy", "--device", "cpu"])
    capsys.readouterr()
