"""train_g_update_ms: device time a training step of the operations
launched inside the program's `uncltmo.train.g_update` span (G's forward,
D on the fake and on the loss's constants, the loss terms, G's backward
and Adam step) in the traced stretch."""
from portbench.metrics_common import device_ms_per_item


def read(run):
    return device_ms_per_item(run, ("uncltmo.train.g_update",))
