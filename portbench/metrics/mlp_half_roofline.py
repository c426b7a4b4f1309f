"""ops.fused_mlp_half: its least time over its launches' device time, %."""
from portbench.harness.readers import roofline


def read(run):
    return roofline(run, "mlp_half")
