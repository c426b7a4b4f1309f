"""ops.layer_norm (K6): its least time over its launches' device time, %."""
from portbench.harness.readers import roofline


def read(run):
    return roofline(run, "layer_norm")
