"""train_device_ms: the device's busy time (the union of its operations'
intervals) a training step, over the traced stretch."""


def read(run):
    if run.trace is None or not run.trace.ops or not run.traced_items:
        return None
    return 1e3 * run.trace.busy_s / run.traced_items
