"""Configuration: every training and inference option, under the
reference's flag names (`config.py:11-105`) and with the JAX package's
defaults (port of `uncltmo_tpu/config.py`); an argparse CLI with the same
flags, so the published launch scripts keep working; the `run_settings.npy`
snapshot (a pickled dict of all options, reference `config.py:122`) that
the inference CLIs re-hydrate (`utils/model_save_util.py:620-652`).  numpy
only: a snapshot written by either package loads in the other."""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import random
from typing import List, Optional

import numpy as np

_MODEL_PARAM_KEYS = (
    "add_frame", "last_layer", "stretch_g", "con_operator",
    "g_doubleConvTranspose", "factor_coeff", "use_new_f", "data_trc",
    "d_weight_mul_mode", "manual_d_training", "use_contrast_ratio_f",
    "final_shape_addition", "bilinear", "padding", "up_mode",
    "convtranspose_kernel",
)


@dataclasses.dataclass
class Options:
    # ====== GENERAL ======
    checkpoint: int = 0
    change_random_seed: int = 10
    # ====== TRAINING ======
    batch_size: int = 2
    num_epochs: int = 1
    G_lr: float = 2e-4
    D_lr: float = 2e-4
    lr_decay_step: float = 1.0
    d_pretrain_epochs: int = 5
    use_xaviar: int = 1
    # ====== SLIDER MODE ======
    manual_d_training: int = 0
    d_weight_mul_mode: str = "double"
    strong_details_D_weights: str = "1,1,1"
    basic_details_D_weights: str = "0.1,0.1,0.1"
    # ====== ARCHITECTURE ======
    model: str = "unet"
    filters: int = 32
    unet_depth: int = 4
    con_operator: str = "square_and_square_root"
    unet_norm: str = "none"
    g_activation: str = "relu"
    d_down_dim: int = 16
    d_nlayers: int = 3
    d_norm: str = "none"
    last_layer: str = "sigmoid"
    d_model: str = "simpleD"
    num_D: int = 3
    d_last_activation: str = "none"
    stretch_g: str = "none"
    g_doubleConvTranspose: int = 1
    d_fully_connected: int = 0
    simpleD_maxpool: int = 0
    bilinear: int = 0
    padding: str = "replicate"
    d_padding: int = 0
    convtranspose_kernel: int = 2
    final_shape_addition: int = 0
    up_mode: int = 0
    input_dim: int = 1
    output_dim: int = 1
    # ====== LOSS ======
    train_with_D: int = 1
    loss_g_d_factor: float = 1.0
    adv_weight_list: str = "1,1,1"
    struct_method: str = "gamma_struct"
    ssim_loss_factor: float = 1.0
    ssim_window_size: int = 5
    pyramid_weight_list: str = "1,1,1"
    # ====== DATASET ======
    data_root_npy: str = "data/hdr_data_with_f"
    data_root_ldr: str = "data/ldr_data"
    test_dataroot_npy: str = "data/hdr_data_with_f"
    test_dataroot_original_hdr: str = "data/temp_data"
    test_dataroot_ldr: str = "data/ldr_data"
    input_images_mean: float = 0.0
    use_factorise_data: int = 1
    factor_coeff: float = 0.1
    gamma_log: int = 10
    f_factor_path: str = "none"
    use_new_f: int = 0
    use_contrast_ratio_f: int = 0
    use_hist_fit: int = 1
    f_train_dict_path: str = "none"
    mean_hist_path: str = "none"
    lambdas_path: str = "data/lambdas/"
    bins: int = 20
    data_trc: str = "min_log"
    max_stretch: float = 1.0
    min_stretch: float = 0.0
    add_frame: int = 0
    normalization: str = "bugy_max_normalization"
    # Video / negative-contrastive training pools.  The reference HARDCODES
    # these globs inside the dataset (`utils/ProcessedDatasetFolder.py:
    # 262-267`); here they are flags with the reference's paths as
    # defaults.  "none" disables a pool explicitly.  Scene layout:
    # {root}/{scene}/{frame:03d}.npy for the video roots, flat *.npy for
    # the SICE negatives.
    hdr_video_root: str = "../../data/tone_mapping/train_HDRvideo"
    srgb_video_root: str = "../../data/tone_mapping/train_sRGBvideo"
    neg_ldr_root: str = "../../data/tone_mapping/SICE_patches512_npy"
    f_train_hdrvideo_dict_path: str = \
        "data/input_images_lambdas_trainHDRvideo.npy"
    # ====== SAVE RESULTS ======
    epoch_to_save: int = 2
    result_dir_prefix: str = ""
    # Directory of the L1L0-baseline tone-mapped renders used as the flow
    # source for the video warp-error protocol (the reference hardcodes
    # '../output_testvideoall_L1L0', `Tester.py:378-390`).  "none" -> flow
    # is estimated on the model's own renders (documented fallback; NOT
    # protocol-comparable to the paper numbers).
    baseline_flow_dir: str = "none"
    final_epoch: int = 1
    fid_real_path: str = "none"
    fid_res_path: str = "fid_results"
    # InceptionV3 weights for FID (pytorch-fid pt_inception release or a
    # torchvision inception_v3 state dict; reference downloads them at
    # `fid/inception.py:13`).  "none" -> post-training FID is skipped
    # loudly; FID never runs on random weights.
    inception_weights: str = "none"
    # ====== EXTRAS of the JAX package (not in the reference CLI) ======
    cl_loss_type: str = "InfoNCE"      # contrastive flavor for nce/infoNCE2:
                                       # InfoNCE (published; the reference
                                       # hardcodes it at every call site,
                                       # `GanTrainer.py:304-318`) or LMCL
                                       # (`GanTrainer.py:441-451`)
    compute_dtype: str = "float32"     # "bfloat16" for fastest training
                                       # (autocast; params stay float32)
    data_parallel: int = 0             # cards for batch sharding: the
                                       # training CLIs start one process
                                       # a card; 0 = every visible card
                                       # when the batch divides, else 1
                                       # (a GanTrainer built alone: its
                                       # process group's size, else 1)
    log_every: int = 50
    data_workers: int = 0              # batch-production threads (0 = auto:
                                       # min(8, cpus-1)); determinism is
                                       # per-batch-seeded, so the count
                                       # never changes the data stream
    train_input_size: int = 0          # 0 = params.INPUT_SIZE (256, the
                                       # published config); smaller values
                                       # (multiples of 16, >= 96) give fast
                                       # smoke runs and CPU tests
    debug_nans: int = 0                # autograd anomaly detection (the
                                       # reference's detect_anomaly)
    verbose: int = 0                   # per-iteration G-progress tensor
                                       # stats (reference printer.py:146-157
                                       # via GanTrainer.py:271,275); forces
                                       # a device sync per step
    async_checkpoint: int = 1          # 1/4-epoch saves: the host copy on
                                       # the training thread, serialize +
                                       # write on a worker thread; 0 =
                                       # synchronous, reference-style stall
    # -- filled by get_opt()
    manual_seed: int = 999
    output_dir: str = "."


# ----------------------------------------------------------------------
# Flags the reference parses and snapshots but never functionally
# consumes — their only "uses" in the reference are commented out,
# stored-but-never-read, or print-only.  They are kept so the published
# launch scripts and run_settings snapshots stay compatible; changing
# them changes nothing.  The same list as the JAX package's.
# ----------------------------------------------------------------------
WRITE_ONLY_COMPAT = {
    "epoch_to_save": "only use is commented out (`GanTrainer.py:532`)",
    "gamma_log": "dir-name composition is commented out (`config.py:"
                 "258-263`); the cluster-hardcoded lambda-path table "
                 "(`model_save_util.py:655-682`) is superseded by the "
                 "explicit --f_factor_path/--f_train_dict_path flags",
    "use_factorise_data": "print-only (`printer.py:218`); passed to a "
                          "legacy transform (`tranforms.py:236`) not on "
                          "any live path — its functional twin "
                          "factor_coeff IS consumed",
    "use_new_f": "only picks entries in the superseded lambda-path table "
                 "(`model_save_util.py:655-682`) and a commented-out "
                 "dir-name suffix (`config.py:227-228`)",
    "use_contrast_ratio_f": "stored by Tester/dataset but never read "
                            "(`Tester.py:35`, `ProcessedDatasetFolder.py:"
                            "258` — no further use)",
    "use_hist_fit": "same superseded lambda-path selection "
                    "(`config.py:231`, `model_save_util.py:655-682`)",
    "strong_details_D_weights": "stored (`GanTrainer.py:108`) and never "
                                "read again; the live slider weights are "
                                "--adv_weight_list",
    "basic_details_D_weights": "stored (`GanTrainer.py:109`) and never "
                               "read again",
    "struct_method": "stored on StructLoss (`struct_loss.py:21`) and "
                     "never read; there is exactly one struct-loss "
                     "formula in the reference",
    "input_images_mean": "threaded to plot_util.save_groups_images "
                         "(`Tester.py:148`) whose `image_mean` parameter "
                         "is unused (`plot_util.py:104-128`)",
}


def build_parser() -> argparse.ArgumentParser:
    """One flag per option, under its field name, with its default."""
    parser = argparse.ArgumentParser(description="Parser for gan network")
    for f in dataclasses.fields(Options):
        if f.name in ("manual_seed", "output_dir"):
            continue
        parser.add_argument(f"--{f.name}", type=type(f.default),
                            default=f.default)
    return parser


def parse_arguments(argv: Optional[List[str]] = None) -> Options:
    return Options(**vars(build_parser().parse_args(argv)))


def weight_list(s: str) -> np.ndarray:
    return np.asarray([float(v) for v in s.split(",")], dtype=np.float32)


def get_opt(argv: Optional[List[str]] = None,
            opt: Optional[Options] = None) -> Options:
    """Parse args (or take `opt`, parsed already), seed RNGs, create output
    dirs, snapshot run settings (reference `config.py:108-134`)."""
    if opt is None:
        opt = parse_arguments(argv)
    if opt.change_random_seed > 1:
        opt.manual_seed = opt.change_random_seed
    elif opt.change_random_seed == 1:
        opt.manual_seed = random.randint(1, 10000)
    else:
        opt.manual_seed = 999
    np.random.seed(opt.manual_seed)
    if opt.manual_d_training:
        opt.input_dim = 2
    opt.output_dir = opt.result_dir_prefix if opt.result_dir_prefix else "."
    create_output_dirs(opt.output_dir)
    save_run_settings(opt, opt.output_dir)
    return opt


def create_output_dirs(output_dir: str) -> None:
    os.makedirs(output_dir, exist_ok=True)
    for sub in ("models", "loss_plot", "result_images", "model_results",
                "accuracy", "best_model"):
        os.makedirs(os.path.join(output_dir, sub), exist_ok=True)


def save_run_settings(opt: Options, output_dir: str) -> None:
    d = dataclasses.asdict(opt)
    np.save(os.path.join(output_dir, "run_settings.npy"), d)
    with open(os.path.join(output_dir, "run_settings.json"), "w") as f:
        json.dump(d, f, indent=2, default=str)


def get_model_params(model_name: str, train_settings_path: str = "none"
                     ) -> dict:
    model_params = {
        "model_name": model_name, "model": "unet", "filters": 32, "depth": 4,
        "factorised_data": True, "input_loader": None, "gamma_log": 10,
        "unet_norm": "none", "input_dim": 1, "clip": False,
        # defaults if no settings file (published values)
        "add_frame": 0, "last_layer": "sigmoid", "stretch_g": "none",
        "con_operator": "square_and_square_root", "g_doubleConvTranspose": 1,
        "factor_coeff": 0.1, "use_new_f": 0, "data_trc": "min_log",
        "d_weight_mul_mode": "none", "manual_d_training": 0,
        "use_contrast_ratio_f": 0, "final_shape_addition": 0, "bilinear": 0,
        "padding": "replicate", "up_mode": 0, "convtranspose_kernel": 2,
    }
    if os.path.exists(train_settings_path):
        train_settings = np.load(train_settings_path, allow_pickle=True)[()]
        for key in _MODEL_PARAM_KEYS:
            if key in train_settings:
                model_params[key] = train_settings[key]
        for key in ("filters", "unet_depth", "unet_norm", "input_dim"):
            if key in train_settings:
                model_params["depth" if key == "unet_depth" else key] = \
                    train_settings[key]
        # the JAX package serves every checkpoint with relu; the settings
        # of a leaky run name its activation, and the port serves it so
        # (relu runs read exactly as in the JAX package)
        if train_settings.get("g_activation", "relu") != "relu":
            model_params["g_activation"] = train_settings["g_activation"]
    if model_params.get("manual_d_training"):
        model_params["input_dim"] = 2
    return model_params


def options_from_model_params(mp: dict) -> Options:
    """The generator options of inference model params (for
    `models.unet.make_generator`)."""
    return Options(
        input_dim=int(mp.get("input_dim", 1)), output_dim=1,
        last_layer=str(mp.get("last_layer", "sigmoid")),
        unet_depth=int(mp.get("depth", 4)),
        con_operator=str(mp.get("con_operator", "square_and_square_root")),
        filters=int(mp.get("filters", 32)),
        unet_norm=str(mp.get("unet_norm", "none")),
        g_activation=str(mp.get("g_activation", "relu")),
        g_doubleConvTranspose=int(mp.get("g_doubleConvTranspose", 1)),
        up_mode=int(mp.get("up_mode", 0)),
        bilinear=int(mp.get("bilinear", 0)),
        padding=str(mp.get("padding", "replicate")),
        stretch_g=str(mp.get("stretch_g", "none")),
        factor_coeff=float(mp.get("factor_coeff", 0.1)),
        data_trc=str(mp.get("data_trc", "min_log")),
        add_frame=int(mp.get("add_frame", 0)),
        final_shape_addition=int(mp.get("final_shape_addition", 0)),
        convtranspose_kernel=int(mp.get("convtranspose_kernel", 2)),
    )
