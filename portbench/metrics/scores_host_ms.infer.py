"""Host ms a batch inside the eval step's scores span (preprocessing and the forward's issue)."""
from portbench.harness.spans import host_ms


def read(run):
    return host_ms(run, "eqxvision.eval.scores")
