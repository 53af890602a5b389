"""Constants of the tone-mapping paths (reference `utils/params.py`)."""

# The published training crop; its GCN bottleneck grid is that of a 256
# tile (see models/unet.py for the size flow).
INPUT_SIZE = 256
GCN_GRID = 12

EPSILON = 1e-08   # reference `utils/params.py:48`
EPSILON2 = 1e-05  # reference `utils/params.py:49`

# Adam's first-moment decay of both optimizers (reference
# `utils/params.py:61`).
BETA1 = 0.5

# The skip-connection concat operators (reference `utils/params.py:78-83`);
# the published one is `square_and_square_root`.
ORIGINAL_UNET = "original_unet"
SQUARE = "square"
SQUARE_ROOT = "square_root"
SQUARE_AND_SQUARE_ROOT = "square_and_square_root"
GAMMA = "gamma"
SQUARE_AND_SQUARE_ROOT_MANUAL_D = "square_and_square_root_manual_d"

# Rec.601 luma weights (reference `utils/hdr_image_util.py:72-82`).
REC601 = (0.299, 0.587, 0.114)
# Rec.709 luma weights, TMQI's RGB -> Y (reference `TMQI.py:46-49`).
REC709 = (0.2126, 0.7152, 0.0722)

# Tiled-inference defaults, quarter-res protocol (reference
# `utils/model_save_util.py:303-304`).
TILE = 256
TILE_OVERLAP = 64
TILE_OVERLAP_FULL_RES = 192

# Video recurrence: the share of channels carried from the previous frame at
# each of the eight carry positions (reference `Unet.py:229-272`).
RECURRENT_CH_RATIO = 1 / 32

# Output sub-directories of a training run (reference `utils/params.py:
# 26-31`).
MODELS_SAVE_PATH = "models"
LOSS_PATH = "loss_plot"
RESULTS_PATH = "result_images"
