"""Generator modules (NCHW)."""
