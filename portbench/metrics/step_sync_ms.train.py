"""Device ms a step launched inside the train step's collectives span (all-reduce, flatten, loss mean)."""
from portbench.harness.spans import device_ms


def read(run):
    return device_ms(run, "eqxvision.train.sync")
