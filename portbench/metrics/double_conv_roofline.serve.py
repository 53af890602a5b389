"""double_conv_roofline.serve: the least time of the encoder's DoubleConv
cells (`inc`, `down_path.0..2`; their operations and bytes counted from
the shapes each call saw) as a share of the device time of every operation
launched inside them, in the traced stretch, %."""
from portbench import roofline


def read(run):
    if run.trace is None or not run.spans.calls.get("double_conv"):
        return None
    flops = nbytes = 0.0
    for b, cin, c1, c2, h, w in run.spans.calls["double_conv"]:
        f, n = roofline.double_conv_work(b, cin, c1, c2, h, w)
        flops += f
        nbytes += n
    return roofline.roofline_pct(flops, nbytes,
                                 run.trace.device_s("double_conv"))
