"""Constants of the tone-mapping paths (reference `utils/params.py`)."""

# GCN bottleneck grid of a 256 tile (see models/unet.py for the size flow).
GCN_GRID = 12

EPSILON = 1e-08   # reference `utils/params.py:48`

# The published skip-connection concat operator (reference
# `utils/params.py:78-83`); the other five are not ported yet.
SQUARE_AND_SQUARE_ROOT = "square_and_square_root"

# Rec.601 luma weights (reference `utils/hdr_image_util.py:72-82`).
REC601 = (0.299, 0.587, 0.114)

# Tiled-inference defaults, quarter-res protocol (reference
# `utils/model_save_util.py:303-304`).
TILE = 256
TILE_OVERLAP = 64
TILE_OVERLAP_FULL_RES = 192

# Video recurrence: the share of channels carried from the previous frame at
# each of the eight carry positions (reference `Unet.py:229-272`).
RECURRENT_CH_RATIO = 1 / 32
