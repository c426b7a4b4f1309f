"""Shared arithmetic of the per-layer readers (``metrics/<name>.py``).

Each reader gets the traced run: ``run.trace`` (``trace.Trace``),
``run.cell``, ``run.chips`` (the cards the run uses), ``run.steps`` (the
steps or batches started in the traced window), ``run.images`` (the
images they carried, over every rank), ``run.macs_per_image`` and
``run.shapes`` (``trace.shapes_probe``'s: the input shapes of each kernel
op's launches in one iteration of the window's loop, just before it). A
reader returns None where the trace holds nothing for it.
"""
from __future__ import annotations

from typing import Optional, Sequence

from .roofline import KERNELS, PRODUCT_FLOPS, launch_bound_s

# The program's kernels' backward nodes: each recomputes through the
# kernel's plain version (``ops.attention.recompute_grads``).
KERNEL_BACKWARDS = ("_FusedQkvAttentionBackward", "_WindowQkvAttentionBackward", "_FusedSwinBlockBackward",
                    "_LayerNormBackward", "_AttentionBackward", "_FusedMlpHalfBackward", "_FusedAttentionHalfBackward",
                    "_FusedWindowAttentionHalfBackward")
BACKWARD_NODE = "autograd::engine::evaluate_function: "


def roofline(run, kernel: str) -> Optional[float]:
    """% of its roofline: the least time of the kernel's launches in the
    traced window over the device time of everything its entry launched.
    A cell runs one shape, so each iteration of its loop makes the same
    launches: the window's launches take the least time of the program's
    own launches in the probed iteration, each from its input shapes."""
    op = KERNELS[kernel][2]
    probed = run.shapes.get(op)
    launched = run.trace.count_ops(op)
    ns = run.trace.device_ns(under=[op])
    if not probed or launched == 0 or ns == 0:
        return None
    bound = launched * sum(launch_bound_s(kernel, shapes) for shapes in probed) / len(probed)
    return 100.0 * bound / (ns / 1e9)


def mfu(run, passes: int) -> Optional[float]:
    """% of the bf16 peak of every card the run uses: ``passes`` x 2 x the
    forward's multiply-adds an image (3 passes a training step: forward,
    and the backward's two products a forward product), over the traced
    window."""
    if not run.images:
        return None
    window_s = run.trace.window_ns / 1e9
    return 100.0 * passes * 2 * run.macs_per_image * run.images / window_s / (PRODUCT_FLOPS * run.chips)


def idle_share(run) -> Optional[float]:
    """% of the traced window in which nothing ran on the device."""
    if not run.trace.device:
        return None
    return 100.0 * (1.0 - run.trace.busy_ns / run.trace.window_ns)


def ms_per_step(run, ns: int) -> Optional[float]:
    if not run.steps or ns == 0:
        return None
    return ns / 1e6 / run.steps


def device_ms_under(run, names: Sequence[str]) -> Optional[float]:
    return ms_per_step(run, run.trace.device_ns(under=list(names)))
