"""engine_ms_per_frame: device time a frame of the operations launched
inside the benchmark's `engine` span in the traced stretch."""
from portbench.metrics_common import device_ms_per_item


def read(run):
    return device_ms_per_item(run, ("engine",))
