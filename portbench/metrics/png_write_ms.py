"""png_write_ms: host time of one `save_uint8_png` call as the runner
makes it (the benchmark's span in the traced stretch), mean over files."""
from portbench.metrics_common import mean_host_ms


def read(run):
    return mean_host_ms(run, "png_write")
