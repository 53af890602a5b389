"""train_d_update_ms: device time a training step of the operations
launched inside the program's `uncltmo.train.d_update` span (the no-grad
G forward, D's forwards, loss, backward and Adam step) in the traced
stretch."""
from portbench.metrics_common import device_ms_per_item


def read(run):
    return device_ms_per_item(run, ("uncltmo.train.d_update",))
