"""Model FLOPs (twice the forward's multiply-adds an image) a second over the bf16 peak, %."""
from portbench.harness.readers import mfu


def read(run):
    return mfu(run, 1)
