"""gcn_ms_per_frame: device time a frame of the operations launched inside
the program's `uncltmo.gen.gcn` span (the generator's graph bottleneck) in
the traced stretch."""
from portbench.metrics_common import device_ms_per_item


def read(run):
    return device_ms_per_item(run, ("uncltmo.gen.gcn",))
