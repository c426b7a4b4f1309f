"""Device ms a step of the NCCL kernels (the gradients' all-reduce) on rank 0."""
from portbench.harness.readers import ms_per_step


def read(run):
    return ms_per_step(run, run.trace.device_ns(kernel_contains="nccl"))
