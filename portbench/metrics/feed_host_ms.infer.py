"""Host ms a batch inside the port's feed span (pinning and the copy's issue, data.device_prefetch)."""
from portbench.harness.spans import host_ms


def read(run):
    return host_ms(run, "eqxvision.feed")
