"""The port's `Tester` against the JAX package's (CPU), and its wiring into
`GanTrainer`.

The generator's parameters are made in JAX (`UNetTMO(filters=8).init`) and
carried across with `state_dict_from_flax`; eval files are synthetic
`.npy` / `.hdr` images of 280 x 360 (scenes of 96 x 120) written into
`tmp_path`.  Tolerances: TMQI within 1e-4 (the renders agree to float32
rounding, and TMQI to 5e-5 on equal inputs, `tests/test_torch_tmqi.py`;
measured 3e-7 here); PNGs within 1 level (a rounding can cross a
truncation step); the video Tester's E1 / E2 within 1e-3 relative: DIS
flow on uint8 renders that differ by a level here and there moves a few
warped pixels (measured 1.1e-5 and 1.3e-5); the fitted lambda dict at
5e-5 relative
(`tests/test_torch_lambda.py`).  Result directories are compared by their
`epoch{E}_iter{I}_` prefix and the metrics parsed from the name.
"""
import os
import re

import imageio.v2 as imageio
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from uncltmo_tpu.config import Options as JaxOptions
from uncltmo_tpu.models.unet import UNetTMO as JaxUNet
from uncltmo_tpu.training.tester import Tester as JaxTester
from uncltmo_tpu_torch.config import (Options, create_output_dirs,
                                      save_run_settings)
from uncltmo_tpu_torch.data.pipeline import SyntheticDataSource
from uncltmo_tpu_torch.models.unet import UNetTMO
from uncltmo_tpu_torch.training.tester import Tester
from uncltmo_tpu_torch.training.trainer import GanTrainer
from uncltmo_tpu_torch.utils.convert import load_state, state_dict_from_flax
from uncltmo_tpu_torch.utils.io import write_radiance_hdr

FILTERS = 8
TMQI_TOL = 1e-4
WARP_RTOL = 1e-3


@pytest.fixture(scope="module")
def generator():
    """(flax module, its params, the port's module with the same weights)."""
    model = JaxUNet(filters=FILTERS)
    variables = jax.jit(model.init)(jax.random.PRNGKey(0),
                                    jnp.zeros((1, 256, 256, 1)))
    params = variables["params"]
    sd = state_dict_from_flax(jax.tree_util.tree_map(np.asarray, params))
    return model, params, load_state(UNetTMO(filters=FILTERS), sd).eval()


def _scene_image(rng, h, w):
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    logl = (1.5 * np.sin(xx / w * rng.uniform(2, 6))
            + 1.2 * np.cos(yy / h * rng.uniform(2, 6)))
    rgb = (10.0 ** logl)[..., None] * rng.uniform(0.4, 1.0, 3)
    rgb = rgb * (1.0 + 0.08 * rng.standard_normal((h, w, 3)))
    return np.clip(rgb, 1e-3, None).astype(np.float32)


def _eval_set(tmp_path, rng, n=2, shape=(280, 360)):
    eval_dir = tmp_path / "orig_hdr"
    eval_dir.mkdir()
    names = []
    for i in range(n):
        im = _scene_image(rng, *shape)
        if i % 2:
            write_radiance_hdr(str(eval_dir / f"im{i}.hdr"), im)
        else:
            np.save(eval_dir / f"im{i}.npy", im)
        names.append(f"im{i}")
    (eval_dir / "README.txt").write_text("not an image")
    return eval_dir, names


def _scenes(tmp_path, rng, shape=(96, 120)):
    root = tmp_path / "scenes"
    for s in ("scene_a", "scene_b"):
        (root / s).mkdir(parents=True)
        base = _scene_image(rng, *shape)
        for i in range(3):
            np.save(root / s / f"{i:03d}.npy",
                    np.roll(base, 2 * i, axis=1) * (1.0 + 0.05 * i))
    (root / "stray").mkdir()                 # no frames: skipped
    (root / "list.txt").write_text("stray")
    return root


def _options(cls, eval_dir, lam_path, **kw):
    return cls(test_dataroot_original_hdr=str(eval_dir),
               f_factor_path=str(lam_path), factor_coeff=0.1, **kw)


def _result_dir(out_dir):
    dirs = os.listdir(os.path.join(out_dir, "model_results"))
    assert len(dirs) == 1
    return dirs[0], os.path.join(out_dir, "model_results", dirs[0],
                                 "color_stretch")


def _png_diff(dir_a, dir_b):
    names = sorted(os.listdir(dir_a))
    assert names == sorted(os.listdir(dir_b)) and names
    return max(int(np.abs(imageio.imread(os.path.join(dir_a, n)).astype(int)
                          - imageio.imread(os.path.join(dir_b, n))).max())
               for n in names)


def test_image_tester_matches_jax(tmp_path, generator):
    model, params, port_model = generator
    rng = np.random.default_rng(0)
    eval_dir, names = _eval_set(tmp_path, rng)
    lam = tmp_path / "lams.npy"
    np.save(lam, {n: 300.0 + 200 * i for i, n in enumerate(names)})
    jt = JaxTester(_options(JaxOptions, eval_dir, lam), model)
    tt = Tester(_options(Options, eval_dir, lam), port_model, device="cpu")
    assert [it["im_name"] for it in tt.original_hdr] == names
    ref = jt.save_images_for_model(params, str(tmp_path / "jax"), 1, 3)
    got = tt.save_images_for_model(port_model.state_dict(),
                                   str(tmp_path / "port"), 1, 3)
    assert set(got) == set(ref) == {"tmqi"}
    assert abs(got["tmqi"] - ref["tmqi"]) <= TMQI_TOL
    assert 0.0 < got["tmqi"] <= 1.0
    name_j, dir_j = _result_dir(tmp_path / "jax")
    name_t, dir_t = _result_dir(tmp_path / "port")
    assert name_t.startswith("epoch1_iter3_tmqi")
    assert name_j.startswith("epoch1_iter3_tmqi")
    assert float(name_t[len("epoch1_iter3_tmqi"):]) == got["tmqi"]
    assert _png_diff(dir_j, dir_t) <= 1
    assert sorted(os.listdir(dir_t)) == [f"{n}_color_stretch.png"
                                         for n in names]


def test_video_tester_matches_jax(tmp_path, generator):
    """Scene root of two 3-frame scenes plus a stray directory, and one
    eval image rendered through the recurrence with its frame replicated
    4x.  The flow here is cv2's DIS on both sides."""
    model, params, port_model = generator
    rng = np.random.default_rng(1)
    eval_dir, names = _eval_set(tmp_path, rng, n=1)
    root = _scenes(tmp_path, rng)
    lam = tmp_path / "lams.npy"
    np.save(lam, {names[0]: 400.0, "scene_a": 250.0, "scene_b": 600.0})
    jt = JaxTester(_options(JaxOptions, eval_dir, lam), model, video=True,
                   test_video_path=str(root))
    tt = Tester(_options(Options, eval_dir, lam), port_model, video=True,
                test_video_path=str(root), device="cpu")
    ref = jt.save_images_for_model(params, str(tmp_path / "jax"), 0, 5)
    got = tt.save_images_for_model(port_model.state_dict(),
                                   str(tmp_path / "port"), 0, 5)
    assert set(got) == set(ref)
    assert got["flow_algo"] == ref["flow_algo"]
    assert got["flow_source"] == ref["flow_source"] == "self"
    assert abs(got["tmqi"] - ref["tmqi"]) <= TMQI_TOL
    for k in ("warp_e1", "warp_e2"):
        np.testing.assert_allclose(got[k], ref[k], rtol=WARP_RTOL)
    name_j, dir_j = _result_dir(tmp_path / "jax")
    name_t, dir_t = _result_dir(tmp_path / "port")
    m = re.fullmatch(r"epoch0_iter5_m1st(.+)_m2nd(.+)_m3rd(.+)", name_t)
    assert m and name_j.startswith("epoch0_iter5_m1st")
    assert [float(v) for v in m.groups()] == [got["tmqi"], got["warp_e1"],
                                              got["warp_e2"]]
    assert _png_diff(dir_j, dir_t) <= 1


def test_a_missing_lambda_raises_key_error(tmp_path, generator):
    """No dict and no mean histogram: a loud KeyError, as the reference's
    `get_f` (`data_loader_util.py:212-222`)."""
    eval_dir, _ = _eval_set(tmp_path, np.random.default_rng(2), n=1,
                            shape=(64, 80))
    opt = Options(test_dataroot_original_hdr=str(eval_dir),
                  f_factor_path="none", mean_hist_path="none")
    with pytest.raises(KeyError, match="no lambda"):
        Tester(opt, generator[2], device="cpu")


def test_missing_lambdas_are_fitted_into_the_jax_dict(tmp_path, generator):
    """One eval image has a lambda, one has not: the Tester fits the
    missing one into {lambdas_path}/input_images_lambdas.npy, keeping the
    known one, as the JAX Tester does."""
    rng = np.random.default_rng(3)
    eval_dir, names = _eval_set(tmp_path, rng, shape=(90, 110))
    lam = tmp_path / "lams.npy"
    np.save(lam, {names[0]: 321.0})
    hist = tmp_path / "hist.npy"
    t = np.float32(rng.random(20) + 0.2)
    np.save(hist, {"mean_vals": t / t.sum() * 20,
                   "all_bins": np.linspace(0, 1, 21)})
    dicts = {}
    for side, cls in (("jax", None), ("port", Tester)):
        kw = dict(mean_hist_path=str(hist),
                  lambdas_path=str(tmp_path / side))
        if cls is None:
            JaxTester(_options(JaxOptions, eval_dir, lam, **kw),
                      generator[0])
        else:
            tt = cls(_options(Options, eval_dir, lam, **kw), generator[2],
                     device="cpu")
        dicts[side] = np.load(tmp_path / side / "input_images_lambdas.npy",
                              allow_pickle=True)[()]
    assert set(dicts["port"]) == set(dicts["jax"]) == set(names)
    assert dicts["port"][names[0]] == 321.0
    np.testing.assert_allclose(dicts["port"][names[1]],
                               dicts["jax"][names[1]], rtol=5e-5)
    assert tt._lambda_for(names[1]) == pytest.approx(
        dicts["port"][names[1]] * 255.0 * 0.1)


def test_baseline_flow_pair(tmp_path, generator):
    """The warp error's flow source: the L1L0 baseline renders when the
    configured directory has them (`Tester.py:378-385`), else (None,
    None)."""
    import cv2
    rng = np.random.default_rng(4)
    base = tmp_path / "l1l0"
    (base / "scene_a").mkdir(parents=True)
    f0 = (rng.random((64, 80, 3)) * 255).astype(np.uint8)
    f1 = (rng.random((64, 80, 3)) * 255).astype(np.uint8)
    cv2.imwrite(str(base / "scene_a" / "frame0_L1L0TM.png"), f0)
    cv2.imwrite(str(base / "scene_a" / "frame1_L1L0TM.png"), f1)
    opt = Options(test_dataroot_original_hdr="none", f_factor_path="none",
                  baseline_flow_dir=str(base))
    tester = Tester(opt, generator[2], video=True, device="cpu")
    s0, s1 = tester._baseline_flow_pair("scene_a", ["frame0.npy",
                                                    "frame1.npy"])
    np.testing.assert_array_equal(s0, f0)
    np.testing.assert_array_equal(s1, f1)
    assert tester._baseline_flow_pair("scene_b", ["a.npy", "b.npy"]) == \
        (None, None)
    off = Tester(Options(test_dataroot_original_hdr="none",
                         f_factor_path="none"), generator[2], video=True,
                 device="cpu")
    assert off._baseline_flow_pair("scene_a", ["f0.npy", "f1.npy"]) == \
        (None, None)


def _trainer_opt(out, **kw):
    opt = Options(batch_size=2, num_epochs=1, d_pretrain_epochs=0,
                  log_every=1, train_input_size=112, filters=FILTERS,
                  d_down_dim=8, result_dir_prefix=str(out),
                  output_dir=str(out), data_workers=1, **kw)
    create_output_dirs(opt.output_dir)
    save_run_settings(opt, opt.output_dir)
    return opt


def test_a_bf16_tester_leaves_the_float32_trainer_alone(tmp_path):
    """The Tester's engine runs a bfloat16 copy; the trainer's float32
    parameters stay bit for bit what they were, and its module is not
    moved or switched to eval()."""
    rng = np.random.default_rng(5)
    eval_dir, names = _eval_set(tmp_path, rng, n=1, shape=(64, 80))
    lam = tmp_path / "lams.npy"
    np.save(lam, {names[0]: 300.0})
    opt = _trainer_opt(tmp_path / "run", test_dataroot_original_hdr=str(
        eval_dir), f_factor_path=str(lam))
    trainer = GanTrainer(opt, device="cpu", source=SyntheticDataSource(
        size=112, n_items=2))
    gen = trainer.state.gen
    before = {k: v.detach().clone() for k, v in gen.state_dict().items()}
    was_training = gen.training
    tester = Tester(opt, gen, dtype=torch.bfloat16, device="cpu")
    metrics = tester.save_images_for_model(gen.state_dict(),
                                           str(tmp_path / "out"), 0, 1)
    # an untrained G's render anti-correlates with its input: negative
    # s_l, and TMQI's S = prod s_l^w_l is NaN, in the JAX package as well
    assert set(metrics) == {"tmqi"}
    assert next(tester.engine.model.parameters()).dtype == torch.bfloat16
    assert gen.training == was_training
    for k, v in gen.state_dict().items():
        assert v.dtype == before[k].dtype and torch.equal(v, before[k]), k


def test_gan_trainer_with_a_tester_logs_test_records(tmp_path):
    """Each 1/4-epoch summary runs the Tester on the training thread with
    G's live weights and logs `test/tmqi`; the renders land in
    model_results/."""
    import json
    rng = np.random.default_rng(6)
    eval_dir, names = _eval_set(tmp_path, rng, n=1, shape=(64, 80))
    lam = tmp_path / "lams.npy"
    np.save(lam, {names[0]: 300.0})
    opt = _trainer_opt(tmp_path / "run", test_dataroot_original_hdr=str(
        eval_dir), f_factor_path=str(lam))
    trainer = GanTrainer(opt, device="cpu", source=SyntheticDataSource(
        size=112, n_items=4))
    trainer.tester = Tester(opt, trainer.state.gen, device="cpu")
    trainer.train()
    recs = [json.loads(line) for line in open(
        os.path.join(opt.output_dir, "train_metrics.jsonl"))]
    tests = [r for r in recs if r["phase"] == "test"]
    assert len(tests) == 2 and all("test/tmqi" in r for r in tests)
    dirs = sorted(os.listdir(os.path.join(opt.output_dir, "model_results")))
    assert [d.split("_tmqi")[0] for d in dirs] == ["epoch0_iter1",
                                                  "epoch0_iter2"]
