"""ops.fused_qkv_attention (K1) in the training forward: its least time over its launches' device time, %."""
from portbench.harness.readers import roofline


def read(run):
    return roofline(run, "qkv_attention")
