"""Video-TMO training CLI of the PyTorch port, flag-compatible with
`cli/main_train.py` (reference `main_train.py`) plus `--device`:

    python -m uncltmo_tpu_torch.cli.main_train --data_root_npy HDR \\
        --data_root_ldr LDR --f_train_dict_path L.npy \\
        --result_dir_prefix OUT [--device cpu] [--data_parallel N]

Every flag of `config.Options` is accepted.  `get_opt` seeds, creates the
output directories and writes `run_settings.npy`; checkpoints land in
{result_dir_prefix}/models as `net_epoch{E}_iter{I}.pth`, which the
serving CLIs read.  When `--test_dataroot_original_hdr` is a directory, a
`Tester` evaluates the generator on it every 1/4 epoch (for the video
generator also on the scene directories under $UNCLTMO_TEST_HDRVIDEO) and
writes {result_dir_prefix}/model_results/epoch*_iter*_<metrics>/.

`--data_parallel N` (N > 1; 0, the default, takes every visible card when
the batch divides over them) starts N processes in one `torch.distributed`
group from this command: one card each over NCCL, or gloo ranks on the
CPU with `--device cpu`.  Under torchrun
(`torchrun --nproc_per_node N -m uncltmo_tpu_torch.cli.main_train ...`)
each process joins the group its environment names instead.
"""
from __future__ import annotations

import os

import numpy as np
import torch.distributed as dist

from uncltmo_tpu_torch import config
from uncltmo_tpu_torch.parallel import mesh


def _flags(argv=None):
    """(options, device): the flags of `config.Options` plus `--device`
    (default cuda), as given."""
    parser = config.build_parser()
    parser.add_argument("--device", type=str, default="cuda",
                        help="torch device (default cuda)")
    args = vars(parser.parse_args(argv))
    device = args.pop("device")
    return config.Options(**args), device


def parse(argv=None):
    """`_flags`, then `config.get_opt`'s seeding and snapshot."""
    opt, device = _flags(argv)
    return config.get_opt(opt=opt), device


def train(device, opt, video: bool) -> None:
    """One process's run: the only one, or a rank of the group on
    `device`.  Rank 0 alone evaluates with the Tester."""
    from uncltmo_tpu_torch.training.trainer import GanTrainer
    np.random.seed(opt.manual_seed)          # as `get_opt` does
    trainer = GanTrainer(opt, video=video, device=device)
    if trainer.rank == 0 and os.path.isdir(opt.test_dataroot_original_hdr):
        from uncltmo_tpu_torch.training.tester import Tester
        trainer.tester = Tester(
            opt, trainer.state.gen, video=video,
            test_video_path=(os.environ.get("UNCLTMO_TEST_HDRVIDEO", "")
                             if video else None),
            device=trainer.device)
    trainer.train()


def main(argv=None, video: bool = True):
    opt, device = _flags(argv)
    if mesh.launched_by_torchrun():
        dev = mesh.initialize_distributed(device=device)
        try:
            # one seed and one snapshot for the group, from rank 0
            opt = mesh.broadcast_object(
                config.get_opt(opt=opt) if dist.get_rank() == 0 else None)
            train(dev, opt, video)
        finally:
            dist.destroy_process_group()
        return
    opt = config.get_opt(opt=opt)
    n = mesh.resolve_data_parallel(opt.data_parallel, opt.batch_size, device)
    if n > 1:
        mesh.launch(train, n, device, opt, video)
    else:
        train(device, opt, video)


if __name__ == "__main__":
    main()
