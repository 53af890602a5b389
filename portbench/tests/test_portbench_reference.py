"""The plain reference against the port on the CPU at a small size: one
256 x 256 tile, a 2-frame scene with the carry, the tile plan, the whole
tiled pipeline to uint8, and the host I/O.  The port's CPU path runs the
kernels' plain versions; these tests hold the reference, which decides
`correct` on the card, to the port's semantics."""
from __future__ import annotations

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from portbench import inputs, serving, weights
from portbench.reference import hdrio, pipeline, unet


@pytest.fixture(scope="module")
def state():
    return weights.generator_state(2 ** 33 + 5, "cpu")


@pytest.fixture(scope="module")
def port_model(state):
    from uncltmo_tpu_torch.models.unet import UNetTMO
    from uncltmo_tpu_torch.utils.convert import load_state
    return load_state(UNetTMO(), state).eval()


def test_state_fits_the_port_strictly(state, port_model):
    assert set(state) == set(port_model.state_dict())
    for k, v in port_model.state_dict().items():
        assert tuple(v.shape) == tuple(state[k].shape), k


def test_one_tile(state, port_model):
    x = torch.rand((2, 1, 256, 256), generator=torch.Generator()
                   .manual_seed(1))
    with torch.no_grad():
        want, _ = port_model(x)
        got, _ = unet.generator_frame(state, x)
    assert got.shape == want.shape == (2, 1, 256, 256)
    assert float((got - want).abs().max()) < 1e-5
    assert float(want.std()) > 0.01          # not a saturated output


def test_scene_with_the_carry(state, port_model):
    from uncltmo_tpu_torch.models.unet import video_apply
    x = torch.rand((1, 2, 1, 256, 256), generator=torch.Generator()
                   .manual_seed(2))
    with torch.no_grad():
        want, _ = video_apply(port_model, x, with_features=False)
        got = unet.generator_scene(state, x)
        alone, _ = unet.generator_frame(state, x[:, 1])
    assert float((got - want).abs().max()) < 1e-5
    # the carry changes frame 1
    assert float((got[:, 1] - alone).abs().max()) > 1e-3


@pytest.mark.parametrize("length", [256, 260, 300, 720, 1088, 1936])
def test_tile_plan(length):
    from uncltmo_tpu_torch.inference.tiling import axis_plan
    o, w = pipeline.axis_weights(length)
    p = axis_plan(length)
    assert np.array_equal(o, p.origins)
    assert np.allclose(w, p.weights, atol=1e-6)
    canvas = np.zeros(length)
    for s, row in zip(o, w):
        canvas[s:s + 256] += row
    assert np.allclose(canvas, 1.0, atol=1e-6)


@pytest.mark.parametrize("video", [False, True])
def test_tiled_pipeline_to_uint8(state, video):
    from uncltmo_tpu_torch.inference.runner import (InferenceRunner,
                                                    postprocess_device,
                                                    preprocess_device)
    from uncltmo_tpu_torch.ops.preprocess import pad_to_unet_grid
    g = torch.Generator().manual_seed(3)
    frames = inputs.hdr_scenes(g, 1, 2, 260, 300, 4, 0.02)[0]
    f = 4321.0
    runner = InferenceRunner({"factor_coeff": 0.1}, None, video=video,
                             state_dict=state, device="cpu")
    loaded = []
    for frame in frames:
        rgb, gray = preprocess_device(frame, f)
        rgb_p, dy, dx = pad_to_unet_grid(rgb)
        gray_p, _, _ = pad_to_unet_grid(gray)
        loaded.append((rgb_p, gray_p))
    if video:
        fakes = runner.engine.run_video(torch.stack([g for _, g in loaded]))
        got = [serving.to_u8(postprocess_device(r, fk, dy, dx))
               for (r, _), fk in zip(loaded, fakes)]
        want = pipeline.tonemap_scene(state, frames, f)
    else:
        got = [serving.to_u8(runner._tonemap_loaded(r, g, dy, dx))
               for r, g in loaded]
        want = [pipeline.tonemap_image(state, fr, f) for fr in frames]
    for a, b in zip(got, want):
        assert a.shape == b.shape == (260, 300, 3)
        assert serving.differing_pct(a, b) < 0.05


def test_rgbe_decode_and_downscale(tmp_path):
    from uncltmo_tpu_torch.utils.io import read_radiance_hdr
    g = torch.Generator().manual_seed(4)
    x = inputs.hdr_frames(g, 1, 37, 333)[0]
    path = inputs.write_rle_hdr(str(tmp_path / "a.hdr"), x)
    mine = hdrio.decode_radiance(open(path, "rb").read())
    assert np.array_equal(mine, read_radiance_hdr(path))
    assert np.abs(mine - x.numpy()).max() <= x.max().item() / 128
    t = torch.from_numpy(mine)
    small = hdrio.downscale(t, 4)
    ref = F.interpolate(t.permute(2, 0, 1)[None], size=(9, 83),
                        mode="bilinear", align_corners=False)[0]
    assert torch.allclose(small, ref.permute(1, 2, 0), rtol=1e-5, atol=0)


def test_png_read_back(tmp_path):
    from uncltmo_tpu_torch.utils.io import save_uint8_png
    im = np.random.default_rng(5).random((13, 17, 3))
    path = save_uint8_png(im, str(tmp_path), "x")
    got = hdrio.decode_png(open(path, "rb").read())
    assert np.array_equal(got, (np.clip(im, 0, 1) * 255).astype(np.uint8))


def test_png_row_filters():
    """Rows filtered Sub, Up, Average and Paeth decode as numpy
    reconstructs them."""
    import struct
    import zlib
    rng = np.random.default_rng(6)
    h, w = 5, 4
    img = rng.integers(0, 256, (h, w * 3)).astype(np.int32)
    rows, prev = [], np.zeros(w * 3, np.int32)
    for y in range(h):
        f = y % 5
        raw = []
        for i in range(w * 3):
            a = img[y, i - 3] if i >= 3 else 0
            b = prev[i]
            c = prev[i - 3] if i >= 3 else 0
            pa, pb, pc = abs(b - c), abs(a - c), abs(a + b - 2 * c)
            pred = [0, a, b, (a + b) // 2,
                    a if pa <= pb and pa <= pc else (b if pb <= pc
                                                     else c)][f]
            raw.append((img[y, i] - pred) & 255)
        rows.append(bytes([f] + raw))
        prev = img[y]

    def chunk(kind, data):
        return (struct.pack(">I", len(data)) + kind + data
                + struct.pack(">I", zlib.crc32(kind + data)))
    png = (b"\x89PNG\r\n\x1a\n"
           + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
           + chunk(b"IDAT", zlib.compress(b"".join(rows)))
           + chunk(b"IEND", b""))
    got = hdrio.decode_png(png)
    assert np.array_equal(got.reshape(h, -1), img.astype(np.uint8))


@pytest.mark.parametrize("seed", [2 ** 31 + 3, 9])
def test_stage0_training_step(seed):
    """Three published stage-0 steps at batch 1 (two frames of 112 x 112):
    the port's `make_train_step` against the reference `gan.Step` from the
    same weights, batches and drop-path masks, by the training check's own
    numbers."""
    from portbench import harness
    from portbench.drivers import gan_step
    from portbench.reference import gan
    cell = harness.resolve("train_image_b8", traced=False)
    traffic = dict(cell.traffic, batch=1, size=112, ring=3)
    drv = gan_step.Driver(cell.config, traffic, seed, "cpu")
    drv.setup()
    want = gan_step._reference_steps(drv, unet.Precision(False), 3)
    gaps = gan_step.compare(drv.got, want, drv.g0, drv.d0)
    assert gaps["loss_gap"] < 1e-4
    assert gaps["grad_gap"] < 1e-4
    assert gaps["change_gap"] < 0.05
    # every leaf the reference moves, the port moved
    for m, p0 in (("G", drv.g0), ("D", drv.d0)):
        for k, v in want["after"][m].items():
            if float((v - p0[k]).abs().max()) > 0:
                assert float((drv.got["after"][m][k] - p0[k]).abs().max()) > 0
    assert set(want["grads"]["D"]) == set(gan.disc_shapes(112))
