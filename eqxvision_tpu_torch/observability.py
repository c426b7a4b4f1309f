"""Tracing, trace spans and a NaN guard (eqxvision_tpu/observability.py).

- ``trace(logdir)``: ``torch.profiler`` over the block (CPU, and CUDA where
  there is a card), its trace written under ``logdir`` for TensorBoard or
  Perfetto;
- ``annotate(name)``: a named span in that trace (``record_function``);
- ``checked_call(model, x)``: ``model(x)`` with a check after every module,
  which raises on the first module whose output holds NaN or inf, naming
  its qualified name (the location that checkify gives the JAX package).
"""
from __future__ import annotations

import contextlib
from typing import Any

import torch
from torch import nn


@contextlib.contextmanager
def trace(logdir: str):
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=activities,
                                on_trace_ready=torch.profiler.tensorboard_trace_handler(str(logdir))):
        yield logdir


def annotate(name: str):
    return torch.profiler.record_function(name)


def _tensors(out):
    if isinstance(out, torch.Tensor):
        yield out
    elif isinstance(out, (tuple, list)):
        for o in out:
            yield from _tensors(o)
    elif isinstance(out, dict):
        for o in out.values():
            yield from _tensors(o)


def checked_call(model: nn.Module, x: torch.Tensor) -> Any:
    """Run ``model(x)``; raise ``FloatingPointError`` naming the first module
    (in the order their forwards finish, so the innermost) whose output
    holds a NaN or an infinity. Each check syncs with the device: a
    debugging call, not a serving one."""
    names = {m: name for name, m in model.named_modules()}

    def check(module, inputs, output):
        for t in _tensors(output):
            if t.is_floating_point() and not bool(torch.isfinite(t).all()):
                name = names[module] or "<the model itself>"
                raise FloatingPointError(f"non-finite value (NaN or inf) in the output of {name} "
                                         f"({type(module).__name__})")

    handles = [m.register_forward_hook(check) for m in names]
    try:
        return model(x)
    finally:
        for h in handles:
            h.remove()
