"""Benchmark of the PyTorch / CUDA port `uncltmo_tpu_torch` (see `run.py`)."""
