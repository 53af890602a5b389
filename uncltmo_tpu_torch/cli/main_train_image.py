"""Image-TMO training CLI of the PyTorch port, flag-compatible with
`cli/main_train_image.py` (reference `main_train_image.py`) plus
`--device`:

    python -m uncltmo_tpu_torch.cli.main_train_image --data_root_npy HDR \\
        --data_root_ldr LDR --f_train_dict_path L.npy \\
        --result_dir_prefix OUT [--device cpu]

The same flags and outputs as `cli.main_train`, with the image generator.
"""
from __future__ import annotations

from uncltmo_tpu_torch.cli import main_train


def main(argv=None):
    main_train.main(argv, video=False)


if __name__ == "__main__":
    main()
