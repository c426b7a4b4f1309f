"""Device ms a step under the kernels' backward nodes, which recompute through the plain versions."""
from portbench.harness.readers import BACKWARD_NODE, KERNEL_BACKWARDS, device_ms_under


def read(run):
    return device_ms_under(run, [BACKWARD_NODE + n for n in KERNEL_BACKWARDS])
