"""Image tone-mapping CLI of the PyTorch port, flag-compatible with
`cli/test_imageTMO.py` (reference `activate_trained_model/test_imageTMO.py`)
plus `--device`:

    python -m uncltmo_tpu_torch.cli.test_imageTMO --model_path M \\
        --input_images_path IN --output_path OUT --f_factor_path L.npy

Loads run_settings.npy from --model_path and a reference `.pth` generator
checkpoint, and writes {name}_UnCLTMO.png per input `.hdr`/`.npy` file.  A
`.msgpack` checkpoint of the JAX package is converted first with
`python cli/export_checkpoint.py --checkpoint X.msgpack --output X.pth`.
"""
from __future__ import annotations

import argparse
import os
import time

import torch

from uncltmo_tpu_torch import params
from uncltmo_tpu_torch.config import get_model_params

DEFAULTS = {
    "model_path": "model_weights_imageTMO",
    "model_name": "imageTMO",
    "input_images_path": "input_images",
    "f_factor_path": "lambda_data/input_images_lambdas_HDRSdataset.npy",
    "output_path": "output",
    "mean_hist_path": "lambda_data/ldr_avg_hist_900_images_20_bins.npy",
    "lambda_output_path": "lambda_data",
    "bins": 20,
}


def get_args(argv=None):
    parser = argparse.ArgumentParser(description="Parser for gan network")
    for key in ("model_name", "input_images_path", "output_path",
                "model_path", "f_factor_path", "mean_hist_path",
                "lambda_output_path"):
        parser.add_argument(f"--{key}", type=str, default=DEFAULTS[key])
    parser.add_argument("--bins", type=str, default=DEFAULTS["bins"])
    parser.add_argument("--net_name", type=str, default="",
                        help="checkpoint file inside model_path "
                             "(default: auto-detect)")
    parser.add_argument("--scale", type=int, default=4,
                        help="host downscale before tone mapping "
                             "(4 = quarter-res eval protocol)")
    parser.add_argument("--overlap", type=int, default=params.TILE_OVERLAP)
    parser.add_argument("--dtype", type=str, default="float32",
                        choices=["float32", "bfloat16"])
    parser.add_argument("--calc_lambda", type=int, default=0,
                        help="estimate missing lambdas before running "
                             "(not ported yet)")
    parser.add_argument("--whole_image", type=int, default=0,
                        help="non-tiled whole-image forward with bicubic "
                             "pad removal (the reference's "
                             "run_model_on_single_image protocol)")
    parser.add_argument("--device", type=str, default="cuda",
                        help="torch device (default cuda)")
    return parser.parse_args(argv)


def find_net_path(model_path: str, net_name: str = "",
                  candidates=("net_epoch5_iter62.pth", "trained_weights.pth")
                  ) -> str:
    """The `.pth` checkpoint to load: `net_name`, else the first of
    `candidates` that exists, else the first `.pth` of the directory;
    `.msgpack` is refused with the conversion command."""
    path = os.path.join(model_path, net_name) if net_name else None
    if path is None:
        for cand in candidates:
            if os.path.exists(os.path.join(model_path, cand)):
                path = os.path.join(model_path, cand)
                break
    if path is None:
        found = sorted(f for f in os.listdir(model_path)
                       if f.endswith((".pth", ".msgpack")))
        pth = [f for f in found if f.endswith(".pth")]
        if not found:
            raise FileNotFoundError(f"no checkpoint found in {model_path}")
        path = os.path.join(model_path, (pth or found)[0])
    if path.endswith(".msgpack"):
        raise SystemExit(
            f"{path} is a JAX-package .msgpack checkpoint; convert it with "
            f"`python cli/export_checkpoint.py --checkpoint {path} --output "
            f"{os.path.splitext(path)[0]}.pth` and pass the .pth")
    return path


def run_trained_model(args):
    from uncltmo_tpu_torch.inference.runner import InferenceRunner

    if args.calc_lambda:
        raise NotImplementedError("--calc_lambda: lambda estimation is not "
                                  "ported yet (ROADMAP Queue 1 item 5)")
    start = time.time()
    net_path = find_net_path(args.model_path, args.net_name)
    model_params = get_model_params(
        args.model_name, os.path.join(args.model_path, "run_settings.npy"))
    os.makedirs(args.output_path, exist_ok=True)
    dtype = torch.bfloat16 if args.dtype == "bfloat16" else torch.float32
    runner = InferenceRunner(model_params, net_path, overlap=args.overlap,
                             dtype=dtype, whole_image=bool(args.whole_image),
                             device=args.device)
    runner.run_on_path(args.input_images_path, args.output_path,
                       args.f_factor_path, scale=args.scale)
    print("tone mapping took [%.2f] seconds" % (time.time() - start))


def main(argv=None):
    run_trained_model(get_args(argv))


if __name__ == "__main__":
    main()
