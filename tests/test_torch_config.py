"""The port's option set (`uncltmo_tpu_torch/config.py`) against the JAX
package's: fields and defaults, the CLI parse, the seed rule, the
`run_settings.npy` snapshot in both directions, and the training CLIs'
`--device` flag on top."""
import dataclasses
import glob
import os
import re

import numpy as np
import pytest

from uncltmo_tpu import config as jconfig
from uncltmo_tpu_torch import config as tconfig

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# fields that only modules not ported yet read, with their ROADMAP item
NOT_YET_CONSUMED = {
    "d_nlayers": "item 8 (the other discriminators)",
    "num_D": "item 8",
    "d_fully_connected": "item 8",
    "fid_res_path": "item 9 (FID)",
    "inception_weights": "item 9",
}


def test_options_fields_and_defaults_equal_jax_field_by_field():
    tf, jf = dataclasses.fields(tconfig.Options), dataclasses.fields(
        jconfig.Options)
    assert [f.name for f in tf] == [f.name for f in jf]
    for a, b in zip(tf, jf):
        assert a.type == b.type and a.default == b.default, a.name
    assert tconfig.WRITE_ONLY_COMPAT == jconfig.WRITE_ONLY_COMPAT
    assert dataclasses.asdict(tconfig.Options()) == dataclasses.asdict(
        jconfig.Options())


def test_every_option_is_read_by_the_port_or_named_as_not_yet():
    """As `tests/test_config.py` holds for the JAX package: each field is
    read by the port, or write-only in the reference too, or read only by a
    module that is not ported yet (then it names its ROADMAP item)."""
    src = "\n".join(open(f).read() for f in glob.glob(
        os.path.join(ROOT, "uncltmo_tpu_torch", "**", "*.py"), recursive=True)
        if not f.endswith("config.py"))
    in_get_opt = ("change_random_seed", "manual_d_training",
                  "result_dir_prefix", "manual_seed", "output_dir")
    for f in dataclasses.fields(tconfig.Options):
        used = bool(re.search(rf"\b{re.escape(f.name)}\b", src)
                    or f.name in in_get_opt)
        listed = (f.name in tconfig.WRITE_ONLY_COMPAT
                  or f.name in NOT_YET_CONSUMED)
        assert used != listed, f.name


ARGVS = [
    [],
    ["--batch_size", "8", "--num_epochs", "21", "--lr_decay_step", "50",
     "--G_lr", "1e-5", "--D_lr", "1.5e-5", "--loss_g_d_factor", "0.1",
     "--pyramid_weight_list", "0.2,0.4,0.6", "--change_random_seed", "0"],
    ["--change_random_seed", "17", "--manual_d_training", "1",
     "--d_weight_mul_mode", "single", "--train_input_size", "112"],
    ["--unet_depth", "3", "--filters", "16", "--data_workers", "2",
     "--neg_ldr_root", "none", "--verbose", "1", "--factor_coeff", "0.25"],
]


@pytest.mark.parametrize("argv", ARGVS, ids=range(len(ARGVS)))
def test_parse_and_get_opt_agree_with_jax(argv, tmp_path):
    assert dataclasses.asdict(tconfig.parse_arguments(argv)) == \
        dataclasses.asdict(jconfig.parse_arguments(argv))
    t = tconfig.get_opt(argv + ["--result_dir_prefix", str(tmp_path / "t")])
    j = jconfig.get_opt(argv + ["--result_dir_prefix", str(tmp_path / "j")])
    td, jd = dataclasses.asdict(t), dataclasses.asdict(j)
    for d in (td, jd):
        d.pop("output_dir"), d.pop("result_dir_prefix")
    assert td == jd
    assert t.output_dir == str(tmp_path / "t")
    for sub in ("models", "loss_plot", "result_images", "model_results",
                "accuracy", "best_model"):
        assert os.path.isdir(os.path.join(t.output_dir, sub))
    assert os.path.exists(os.path.join(t.output_dir, "run_settings.json"))


def test_seed_rule_and_input_dim(tmp_path):
    def opt(*argv):
        return tconfig.get_opt(list(argv) + ["--result_dir_prefix",
                                             str(tmp_path)])
    assert opt("--change_random_seed", "0").manual_seed == 999
    assert opt("--change_random_seed", "42").manual_seed == 42
    assert 1 <= opt("--change_random_seed", "1").manual_seed <= 10000
    assert opt("--manual_d_training", "1").input_dim == 2
    assert opt().input_dim == 1


def test_run_settings_cross_both_ways(tmp_path):
    argv = ["--filters", "16", "--factor_coeff", "0.3", "--add_frame", "0",
            "--manual_d_training", "1", "--data_trc", "min_log"]
    t = tconfig.get_opt(argv + ["--result_dir_prefix", str(tmp_path / "t")])
    j = jconfig.get_opt(argv + ["--result_dir_prefix", str(tmp_path / "j")])
    for written in (t.output_dir, j.output_dir):
        path = os.path.join(written, "run_settings.npy")
        tp = tconfig.get_model_params("m", path)
        jp = jconfig.get_model_params("m", path)
        assert tp == jp and tp["filters"] == 16 and tp["input_dim"] == 2
        snap = np.load(path, allow_pickle=True)[()]
        assert dataclasses.asdict(tconfig.Options(**snap)) == \
            dataclasses.asdict(jconfig.Options(**snap))
        assert dataclasses.asdict(tconfig.options_from_model_params(tp)) == \
            dataclasses.asdict(jconfig.options_from_model_params(jp))
    assert tconfig.get_model_params("m") == jconfig.get_model_params("m")


def test_weight_list_matches_jax():
    for s in ("0.2,0.4,0.6", "1,1,0", "0.1"):
        got, ref = tconfig.weight_list(s), jconfig.weight_list(s)
        assert got.dtype == ref.dtype == np.float32
        np.testing.assert_array_equal(got, ref)


def test_training_cli_parse_adds_device(tmp_path):
    from uncltmo_tpu_torch.cli.main_train import parse
    opt, device = parse(["--device", "cpu", "--batch_size", "4",
                         "--result_dir_prefix", str(tmp_path)])
    assert device == "cpu" and opt.batch_size == 4
    assert os.path.exists(os.path.join(str(tmp_path), "run_settings.npy"))
    snap = np.load(os.path.join(str(tmp_path), "run_settings.npy"),
                   allow_pickle=True)[()]
    assert "device" not in snap
    assert parse(["--result_dir_prefix", str(tmp_path)])[1] == "cuda"
