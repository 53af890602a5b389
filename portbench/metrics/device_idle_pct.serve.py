"""device_idle_pct.serve: share of the traced stretch in which no
operation ran on the device (the union of their intervals), %."""
from portbench.metrics_common import idle_pct


def read(run):
    return idle_pct(run)
