"""Training losses of the port (NCHW)."""
