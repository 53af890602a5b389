"""mfu.serve: the generator's operations on every tile the window
delivered (FlopCounterMode over the reference at one tile) over the
window's time, as a share of the float32 peak, %."""
from portbench import roofline


def read(run):
    if not run.window.tiles:
        return None
    flops = roofline.generator_flops_per_tile(run.cell.config["tile"])
    return 100.0 * run.window.tiles * flops / run.window.seconds / (
        roofline.PEAK_FLOPS_F32)
