"""Device ms a step inside the benchmark's span around the augmentation it hands the step."""
from portbench.harness.readers import device_ms_under


def read(run):
    return device_ms_under(run, ["portbench.augment"])
