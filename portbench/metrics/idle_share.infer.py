"""The device's idle share of the traced inference window, %."""
from portbench.harness.readers import idle_share


def read(run):
    return idle_share(run)
