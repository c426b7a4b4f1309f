"""Device ms a step launched inside the train step's backward span (the autograd thread's launches too)."""
from portbench.harness.spans import device_ms


def read(run):
    return device_ms(run, "eqxvision.train.backward")
