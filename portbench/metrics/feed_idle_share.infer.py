"""% of the traced window the device idles while the host is inside the port's feed span."""
from portbench.harness.spans import idle_share


def read(run):
    return idle_share(run, "eqxvision.feed")
