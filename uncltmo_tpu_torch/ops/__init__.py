"""Pre/post-processing ops and the hand-written kernels."""
