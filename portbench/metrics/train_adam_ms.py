"""train_adam_ms: device time a training step of the operations launched
inside the program's `uncltmo.train.d_adam` and `uncltmo.train.g_adam`
spans (both Adam steps) in the traced stretch."""
from portbench.metrics_common import device_ms_per_item


def read(run):
    return device_ms_per_item(run, ("uncltmo.train.d_adam",
                                    "uncltmo.train.g_adam"))
