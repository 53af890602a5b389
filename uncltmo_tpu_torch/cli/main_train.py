"""Video-TMO training CLI of the PyTorch port, flag-compatible with
`cli/main_train.py` (reference `main_train.py`) plus `--device`:

    python -m uncltmo_tpu_torch.cli.main_train --data_root_npy HDR \\
        --data_root_ldr LDR --f_train_dict_path L.npy \\
        --result_dir_prefix OUT [--device cpu]

Every flag of `config.Options` is accepted.  `get_opt` seeds, creates the
output directories and writes `run_settings.npy`; checkpoints land in
{result_dir_prefix}/models as `net_epoch{E}_iter{I}.pth`, which the
serving CLIs read.  The Tester is not ported yet (ROADMAP Queue 1 item 6):
a `--test_dataroot_original_hdr` that is a directory is refused.
"""
from __future__ import annotations

import os

from uncltmo_tpu_torch import config


def parse(argv=None):
    """(options, device): the flags of `config.Options` plus `--device`
    (default cuda), then `config.get_opt`'s seeding and snapshot."""
    parser = config.build_parser()
    parser.add_argument("--device", type=str, default="cuda",
                        help="torch device (default cuda)")
    args = vars(parser.parse_args(argv))
    device = args.pop("device")
    return config.get_opt(opt=config.Options(**args)), device


def main(argv=None, video: bool = True):
    from uncltmo_tpu_torch.training.trainer import GanTrainer
    opt, device = parse(argv)
    if os.path.isdir(opt.test_dataroot_original_hdr):
        raise NotImplementedError(
            f"--test_dataroot_original_hdr {opt.test_dataroot_original_hdr!r}"
            " is a directory, but the Tester that would evaluate it is not "
            "ported yet (ROADMAP Queue 1 item 6); pass a path that is not a "
            "directory to train without it")
    GanTrainer(opt, video=video, device=device).train()


if __name__ == "__main__":
    main()
