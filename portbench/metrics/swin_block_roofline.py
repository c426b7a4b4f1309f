"""ops.fused_swin_block (K5): its least time over its launches' device time, %."""
from portbench.harness.readers import roofline


def read(run):
    return roofline(run, "swin_block")
