"""Training FLOPs (three times the forward's) a second over the bf16 peak, %."""
from portbench.harness.readers import mfu


def read(run):
    return mfu(run, 3)
