"""Model settings: `run_settings.npy` re-hydration for inference
(reference `utils/model_save_util.py:620-652`) and the options that build
the generator and the discriminator, under the reference's flag names and
with the JAX package's defaults (`uncltmo_tpu/config.py:22-73`).  numpy
only."""
from __future__ import annotations

import dataclasses
import os

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
    """The subset of the training options that `make_generator` and
    `make_discriminator` read."""
    input_dim: int = 1
    output_dim: int = 1
    last_layer: str = "sigmoid"
    unet_depth: int = 4
    con_operator: str = "square_and_square_root"
    filters: int = 32
    unet_norm: str = "none"
    g_activation: str = "relu"
    g_doubleConvTranspose: int = 1
    up_mode: int = 0
    bilinear: int = 0
    padding: str = "replicate"
    stretch_g: str = "none"
    add_frame: int = 0
    convtranspose_kernel: int = 2
    # discriminator
    d_model: str = "simpleD"
    d_down_dim: int = 16
    d_norm: str = "none"
    d_last_activation: str = "none"
    simpleD_maxpool: int = 0
    d_padding: int = 0


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
        g_activation="relu",
        g_doubleConvTranspose=int(mp.get("g_doubleConvTranspose", 1)),
        up_mode=int(mp.get("up_mode", 0)),
        bilinear=int(mp.get("bilinear", 0)),
        padding=str(mp.get("padding", "replicate")),
        stretch_g=str(mp.get("stretch_g", "none")),
        add_frame=int(mp.get("add_frame", 0)),
        convtranspose_kernel=int(mp.get("convtranspose_kernel", 2)),
    )
