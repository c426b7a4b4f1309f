"""Device ms a batch launched inside the eval step's preprocessing span (resize, crop, normalise)."""
from portbench.harness.spans import device_ms


def read(run):
    return device_ms(run, "eqxvision.eval.preprocess")
