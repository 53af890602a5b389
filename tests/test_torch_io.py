"""The port's host I/O (numpy + stdlib only) against cv2, and the rules the
port package keeps: no jax and nothing of `uncltmo_tpu`, checked by AST."""
import ast
import os
import subprocess
import sys

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from uncltmo_tpu_torch.utils.io import (read_hdr_image, read_png,
                                        save_uint8_png, write_png,
                                        write_radiance_hdr)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(ROOT, "uncltmo_tpu_torch")


def _hdr_image(seed, h, w):
    rng = np.random.default_rng(seed)
    im = (rng.random((h, w, 3), np.float32) ** 3) * 300.0
    im[0, :5] = 0.0                       # zero pixels (exponent 0)
    im[1, :3] = rng.random(3) * 1e-3      # tiny values
    return im


def test_hdr_reader_matches_cv2_on_rle_file(tmp_path):
    """cv2 writes new-style RLE scanlines; both readers decode the same
    float32 values."""
    cv2 = pytest.importorskip("cv2")
    im = _hdr_image(0, 37, 70)
    path = str(tmp_path / "a.hdr")
    assert cv2.imwrite(path, cv2.cvtColor(im, cv2.COLOR_RGB2BGR))
    ref = cv2.cvtColor(cv2.imread(path, cv2.IMREAD_ANYDEPTH
                                  | cv2.IMREAD_COLOR), cv2.COLOR_BGR2RGB)
    got = read_hdr_image(path)
    assert got.dtype == np.float32 and got.shape == (37, 70, 3)
    np.testing.assert_array_equal(got, ref)


def test_hdr_writer_flat_file_reads_back(tmp_path):
    """The port's flat writer: cv2 and the port's reader agree on the file,
    and RGBE keeps ~2^-8 relative precision of the brightest channel."""
    cv2 = pytest.importorskip("cv2")
    im = _hdr_image(1, 20, 33)
    path = write_radiance_hdr(str(tmp_path / "b.hdr"), im)
    got = read_hdr_image(path)
    ref = cv2.cvtColor(cv2.imread(path, cv2.IMREAD_ANYDEPTH
                                  | cv2.IMREAD_COLOR), cv2.COLOR_BGR2RGB)
    np.testing.assert_array_equal(got, ref)
    peak = im.max(axis=-1, keepdims=True)
    assert np.all(np.abs(got - im) <= peak * 2.0 ** -7 + 1e-30)


def test_npy_input(tmp_path):
    im = _hdr_image(2, 5, 6)
    np.save(tmp_path / "c.npy", im)
    np.testing.assert_array_equal(read_hdr_image(str(tmp_path / "c.npy")), im)


@pytest.mark.parametrize("shape", [(17, 23, 3), (9, 12)])
def test_png_writer_round_trip(tmp_path, shape):
    im = np.random.default_rng(3).integers(0, 256, shape, dtype=np.uint8)
    path = write_png(str(tmp_path / "d.png"), im)
    np.testing.assert_array_equal(read_png(path), im)
    cv2 = pytest.importorskip("cv2")
    dec = cv2.imread(path, cv2.IMREAD_UNCHANGED)
    if im.ndim == 3:
        dec = cv2.cvtColor(dec, cv2.COLOR_BGR2RGB)
    np.testing.assert_array_equal(dec, im)


def test_save_uint8_png_truncates_like_the_jax_saver(tmp_path):
    im = np.array([[[0.0, 0.5, 1.2], [-0.1, 0.999, 0.004]],
                   [[0.3, 0.7, 0.2], [1.0, 0.0, 0.5]]], np.float32)
    path = save_uint8_png(im, str(tmp_path / "o"), "x")
    np.testing.assert_array_equal(
        read_png(path), (np.clip(im, 0, 1) * 255).astype(np.uint8))


def test_bilinear_downscale_matches_cv2():
    """The runner's /scale resize (F.interpolate bilinear, half-pixel
    centres, no antialias) against cv2.resize INTER_LINEAR."""
    cv2 = pytest.importorskip("cv2")
    im = _hdr_image(4, 64, 96)
    for scale in (2, 4):
        ref = cv2.resize(im, (96 // scale, 64 // scale),
                         interpolation=cv2.INTER_LINEAR)
        got = F.interpolate(torch.from_numpy(im).permute(2, 0, 1)[None],
                            size=(64 // scale, 96 // scale), mode="bilinear",
                            align_corners=False, antialias=False)
        np.testing.assert_allclose(got[0].permute(1, 2, 0).numpy(), ref,
                                   rtol=1e-5, atol=1e-4)


def test_directory_listing_follows_the_jax_rule(tmp_path):
    """Which files of a directory are HDR input: the JAX package's tuple,
    matched with its case.  `.exr` and `.dng` are listed by both (the port
    decodes `.exr` and refuses `.dng` by name); `.HDR` and other files are
    listed by neither."""
    from uncltmo_tpu.utils import io as jio
    from uncltmo_tpu_torch.utils import io as tio
    assert tio.HDR_EXTENSIONS == jio.HDR_EXTENSIONS
    for n in ("b.hdr", "a.npy", "c.exr", "d.HDR", "e.Npy", "f.dng", "g.png",
              "README"):
        (tmp_path / n).write_bytes(b"")
    ref = [n for n in sorted(os.listdir(tmp_path))
           if os.path.splitext(n)[1] in jio.HDR_EXTENSIONS]
    assert tio.list_hdr_names(str(tmp_path)) == ref == [
        "a.npy", "b.hdr", "c.exr", "f.dng"]


def _runner_and_lambdas(tmp_path):
    from uncltmo_tpu_torch.config import get_model_params
    from uncltmo_tpu_torch.inference.runner import InferenceRunner
    from uncltmo_tpu_torch.models.unet import UNetTMO
    torch.manual_seed(0)
    runner = InferenceRunner(dict(get_model_params("m"), filters=8), None,
                             state_dict=UNetTMO(filters=8).state_dict(),
                             device="cpu")
    np.save(tmp_path / "lams.npy", {"x": 100.0, "y": 100.0})
    return runner, str(tmp_path / "lams.npy")


def test_runner_refuses_exr_by_name_and_skips_upper_case(tmp_path):
    """An `.exr` file in a compression the port does not decode (PIZ) is an
    error that names the compression and the ROADMAP, not a silently
    shorter output, in a directory and in a scene; `x.HDR` is skipped, as
    the JAX runner skips it."""
    from test_torch_exr import write_undecoded_exr
    runner, lam = _runner_and_lambdas(tmp_path)
    im = _hdr_image(5, 40, 50)
    planes = {c: im[..., i].astype(np.float16) for i, c in enumerate("RGB")}
    up = tmp_path / "upper"
    up.mkdir()
    write_radiance_hdr(str(up / "x.HDR"), im)
    assert runner.run_on_path(str(up), str(tmp_path / "o"), lam,
                              scale=1) == []
    exr = tmp_path / "exr"
    exr.mkdir()
    write_undecoded_exr(str(exr / "y.exr"), planes, "PIZ")
    with pytest.raises(NotImplementedError,
                       match="PIZ compression.*ROADMAP Queue 3"):
        runner.run_on_path(str(exr), str(tmp_path / "o"), lam, scale=1)
    scenes = tmp_path / "scenes"
    (scenes / "y").mkdir(parents=True)
    write_undecoded_exr(str(scenes / "y" / "000.exr"), planes, "PIZ")
    (scenes / "y" / "001.HDR").write_bytes(b"")
    with pytest.raises(NotImplementedError,
                       match="PIZ compression.*ROADMAP Queue 3"):
        runner.run_on_video_path(str(scenes), str(tmp_path / "o"), lam)


def test_runner_reads_exr_and_refuses_dng(tmp_path):
    """A directory with a ZIP `.exr` file is read (the port's OpenEXR
    reader, `tests/test_torch_exr.py`); one with a `.dng` file, or a scene
    with one, is an error that names the ROADMAP."""
    from test_torch_exr import write_exr
    runner, lam = _runner_and_lambdas(tmp_path)
    im = _hdr_image(5, 40, 50)
    exr = tmp_path / "exr"
    exr.mkdir()
    write_exr(str(exr / "y.exr"),
              {c: im[..., i] for i, c in enumerate("RGB")}, "ZIP")
    outs = runner.run_on_path(str(exr), str(tmp_path / "o"), lam, scale=1)
    assert [os.path.basename(p) for p in outs] == ["y_UnCLTMO.png"]
    assert read_png(outs[0]).shape == (40, 50, 3)
    dng = tmp_path / "dng"
    dng.mkdir()
    (dng / "y.dng").write_bytes(b"")
    with pytest.raises(NotImplementedError, match="ROADMAP Queue 3"):
        runner.run_on_path(str(dng), str(tmp_path / "o"), lam, scale=1)
    scenes = tmp_path / "scenes"
    (scenes / "y").mkdir(parents=True)
    (scenes / "y" / "000.dng").write_bytes(b"")
    with pytest.raises(NotImplementedError, match="ROADMAP Queue 3"):
        runner.run_on_video_path(str(scenes), str(tmp_path / "o"), lam)


def _unfiltered_png(path, im):
    """uint8 (H, W, 2) or (H, W, 4) as an unfiltered gray + alpha or RGBA
    PNG, the layout the port's own decoder reads."""
    import struct
    import zlib
    h, w, ch = im.shape
    rows = np.zeros((h, 1 + w * ch), np.uint8)
    rows[:, 1:] = im.reshape(h, w * ch)

    def chunk(kind, data):
        return (struct.pack(">I", len(data)) + kind + data
                + struct.pack(">I", zlib.crc32(kind + data)))
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n")
        f.write(chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8,
                                           {2: 4, 4: 6}[ch], 0, 0, 0)))
        f.write(chunk(b"IDAT", zlib.compress(rows.tobytes())))
        f.write(chunk(b"IEND", b""))
    return path


def test_read_ldr_image_drops_alpha_of_gray_and_colour_pngs(tmp_path):
    """Gray + alpha and RGBA PNGs, unfiltered (the port's own decoder) and
    written by PIL (filtered rows: a library decodes them), against the JAX
    package's `read_ldr_image` on the same files: the same samples, alpha
    dropped.  Gray + alpha comes back as the (H, W) gray plane, as a gray
    file does; the JAX reader's imageio keeps it as (H, W, 2), whose first
    plane is compared."""
    from PIL import Image
    from uncltmo_tpu.utils import io as jio
    from uncltmo_tpu_torch.utils import io as tio
    rng = np.random.default_rng(6)
    for ch, mode in ((2, "LA"), (4, "RGBA")):
        im = rng.integers(0, 256, (5, 7, ch), dtype=np.uint8)
        own = _unfiltered_png(str(tmp_path / f"own{ch}.png"), im)
        assert tio.read_png(own).shape == im.shape
        lib = str(tmp_path / f"lib{ch}.png")
        Image.fromarray(im, mode).save(lib)
        for path in (own, lib):
            got = tio.read_ldr_image(path)
            ref = jio.read_ldr_image(path)
            if ref.ndim == 3 and ref.shape[-1] == 2:
                ref = ref[..., 0]
            assert got.dtype == np.float32
            assert got.shape == ((5, 7) if ch == 2 else (5, 7, 3))
            np.testing.assert_array_equal(got, ref, err_msg=path)


def _port_sources():
    for d, _, files in os.walk(PORT):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)
    yield os.path.join(ROOT, "chip_smoke.py")


@pytest.mark.parametrize("path", sorted(_port_sources()),
                         ids=lambda p: os.path.relpath(p, ROOT))
def test_port_imports_no_jax_and_nothing_of_uncltmo_tpu(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    banned = {"jax", "jaxlib", "flax", "uncltmo_tpu"}
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""] if node.level == 0 else []
        elif (isinstance(node, ast.Call)
              and getattr(node.func, "id", getattr(node.func, "attr", ""))
              in ("import_module", "__import__") and node.args
              and isinstance(node.args[0], ast.Constant)):
            names = [str(node.args[0].value)]
        else:
            continue
        for name in names:
            assert name.split(".")[0] not in banned, (path, node.lineno, name)


def test_cli_help_and_msgpack_refusal(tmp_path):
    env = dict(os.environ, PYTHONPATH=ROOT)
    out = subprocess.run(
        [sys.executable, "-m", "uncltmo_tpu_torch.cli.test_imageTMO",
         "--help"], capture_output=True, text=True, env=env, cwd=ROOT,
        timeout=120)
    assert out.returncode == 0 and "--device" in out.stdout
    out = subprocess.run(
        [sys.executable, "-m", "uncltmo_tpu_torch.cli.test_videoTMO",
         "--help"], capture_output=True, text=True, env=env, cwd=ROOT,
        timeout=120)
    assert out.returncode == 0 and "--scene_batch" in out.stdout
    assert "--device" in out.stdout
    from uncltmo_tpu_torch.cli.test_imageTMO import find_net_path
    (tmp_path / "w.msgpack").write_bytes(b"")
    with pytest.raises(SystemExit, match="export_checkpoint"):
        find_net_path(str(tmp_path))
