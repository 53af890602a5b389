"""mfu.train: the operations of one published step (FlopCounterMode over
the reference's step) times the steps of the window, over the window's
time, as a share of the float32 peak, %."""
from portbench import roofline


def read(run):
    flops = run.driver.step_flops()
    return 100.0 * flops * run.window.items / run.window.seconds / (
        roofline.PEAK_FLOPS_F32)
