"""prepost_ms_per_frame: device time a frame of the operations launched
inside the benchmark's `preprocess` and `postprocess` spans in the traced
stretch."""
from portbench.metrics_common import device_ms_per_item


def read(run):
    return device_ms_per_item(run, ("preprocess", "postprocess"))
