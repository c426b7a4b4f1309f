"""Device ms a step launched inside the train step's augmentation span."""
from portbench.harness.spans import device_ms


def read(run):
    return device_ms(run, "eqxvision.train.augment")
