"""The device's idle share of the traced training window (each rank's own; rank 0 read), %."""
from portbench.harness.readers import idle_share


def read(run):
    return idle_share(run)
