"""frame_p95_ms: the 95th percentile, over every frame of the window, of
one frame's time from its HDR frame on the card to its uint8 frame on
the host, host clock."""
from portbench.measure import percentile


def read(run):
    return 1e3 * percentile(run.window.latencies_s, 95.0)
