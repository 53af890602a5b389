"""Video-TMO training CLI of the PyTorch port, flag-compatible with
`cli/main_train.py` (reference `main_train.py`) plus `--device`:

    python -m uncltmo_tpu_torch.cli.main_train --data_root_npy HDR \\
        --data_root_ldr LDR --f_train_dict_path L.npy \\
        --result_dir_prefix OUT [--device cpu]

Every flag of `config.Options` is accepted.  `get_opt` seeds, creates the
output directories and writes `run_settings.npy`; checkpoints land in
{result_dir_prefix}/models as `net_epoch{E}_iter{I}.pth`, which the
serving CLIs read.  When `--test_dataroot_original_hdr` is a directory, a
`Tester` evaluates the generator on it every 1/4 epoch (for the video
generator also on the scene directories under $UNCLTMO_TEST_HDRVIDEO) and
writes {result_dir_prefix}/model_results/epoch*_iter*_<metrics>/.
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
    trainer = GanTrainer(opt, video=video, device=device)
    if os.path.isdir(opt.test_dataroot_original_hdr):
        from uncltmo_tpu_torch.training.tester import Tester
        trainer.tester = Tester(
            opt, trainer.state.gen, video=video,
            test_video_path=(os.environ.get("UNCLTMO_TEST_HDRVIDEO", "")
                             if video else None),
            device=device)
    trainer.train()


if __name__ == "__main__":
    main()
