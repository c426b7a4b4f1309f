"""Device ms a step launched inside the train step's forward span (casts, forward, loss)."""
from portbench.harness.spans import device_ms


def read(run):
    return device_ms(run, "eqxvision.train.forward")
