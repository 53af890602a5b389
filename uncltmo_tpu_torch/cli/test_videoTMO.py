"""Video tone-mapping CLI of the PyTorch port, flag-compatible with
`cli/test_videoTMO.py` (reference `activate_trained_model/test_videoTMO.py`)
plus `--device`:

    python -m uncltmo_tpu_torch.cli.test_videoTMO --model_path M \\
        --input_images_path IN --output_path OUT --f_factor_path L.npy

IN holds one directory of HDR frames per scene; the lambda is looked up by
the scene's name; the generator's temporal recurrence runs per spatial
tile.  Writes OUT/{scene}/{frame}_UnCLTMO.png.  Loads run_settings.npy from
--model_path and a reference `.pth` generator checkpoint (a `.msgpack` of
the JAX package is converted first with `python cli/export_checkpoint.py
--checkpoint X.msgpack --output X.pth`).
"""
from __future__ import annotations

import argparse
import os
import time

import torch

from uncltmo_tpu_torch import params
from uncltmo_tpu_torch.cli.test_imageTMO import find_net_path
from uncltmo_tpu_torch.config import get_model_params

DEFAULTS = {
    "model_path": "model_weights_videoTMO",
    "model_name": "videoTMO",
    "input_images_path": "input_images",
    "f_factor_path": "lambda_data/input_images_lambdas_HDRSdataset.npy",
    "output_path": "output",
    "mean_hist_path": "lambda_data/ldr_avg_hist_900_images_20_bins.npy",
    "lambda_output_path": "lambda_data",
    "bins": 20,
}


def get_args(argv=None):
    parser = argparse.ArgumentParser(description="Parser for gan network")
    for key, val in DEFAULTS.items():
        parser.add_argument(f"--{key}", type=type(val), default=val)
    parser.add_argument("--net_name", type=str, default="")
    parser.add_argument("--overlap", type=int, default=params.TILE_OVERLAP)
    parser.add_argument("--dtype", type=str, default="float32",
                        choices=["float32", "bfloat16"])
    parser.add_argument("--scene_batch", type=int, default=1,
                        help="batch this many same-shape scenes per frame "
                             "step (serving throughput mode; 1 = one scene "
                             "at a time, as the reference)")
    parser.add_argument("--device", type=str, default="cuda",
                        help="torch device (default cuda)")
    return parser.parse_args(argv)


def run_trained_model(args):
    from uncltmo_tpu_torch.inference.runner import InferenceRunner

    start = time.time()
    net_path = find_net_path(
        args.model_path, args.net_name,
        candidates=("net_epoch10_iter124.pth", "trained_weights.pth"))
    model_params = get_model_params(
        args.model_name, os.path.join(args.model_path, "run_settings.npy"))
    os.makedirs(args.output_path, exist_ok=True)
    dtype = torch.bfloat16 if args.dtype == "bfloat16" else torch.float32
    runner = InferenceRunner(model_params, net_path, video=True,
                             overlap=args.overlap, dtype=dtype,
                             device=args.device)
    runner.run_on_video_path(args.input_images_path, args.output_path,
                             args.f_factor_path,
                             scene_batch=args.scene_batch)
    print("tone mapping took [%.2f] seconds" % (time.time() - start))


def main(argv=None):
    run_trained_model(get_args(argv))


if __name__ == "__main__":
    main()
