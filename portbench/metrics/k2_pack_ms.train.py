"""k2_pack_ms.train: device time a training step of the operations
launched inside the program's `uncltmo.k2.pack` span (K2's weight packing
after each update of the encoder's weights) in the traced stretch."""
from portbench.metrics_common import device_ms_per_item


def read(run):
    return device_ms_per_item(run, ("uncltmo.k2.pack",))
