"""Tracing, trace spans and a NaN guard (eqxvision_tpu/observability.py).

- ``trace(logdir)``: ``torch.profiler`` over the block (CPU, and CUDA where
  there is a card), its trace written under ``logdir`` for TensorBoard or
  Perfetto;
- ``annotate(name)``: a named span in that trace. While a profiler records
  (``trace``, or any ``torch.profiler.profile``), it is a
  ``record_function``: a host event of the profiler, on the clock of the
  card's activities, which the profiler links to the kernels launched
  inside it. Otherwise it is one shared no-op context, so that a span
  costs one call when nothing records;
- ``checked_call(model, x)``: ``model(x)`` with a check after every module,
  which raises on the first module whose output holds NaN or inf, naming
  its qualified name (the location that checkify gives the JAX package).

``SPANS`` names the spans the port opens at its layer boundaries, each
opened and closed inside one call:

- ``eqxvision.feed``: ``data.device_prefetch``'s work on one batch
  (``np.ascontiguousarray``, ``pin_memory()`` and the ``non_blocking`` copy
  issued on the side stream; off the card the tensors made in place);
- ``eqxvision.eval.scores``: ``cli.eval_imagenet.make_step``'s
  ``scores``, the whole call: preprocessing and the forward (TTA included);
- ``eqxvision.eval.preprocess``: inside it, ``imagenet_eval_pipeline``
  (or the TTA crops and normalisation);
- ``eqxvision.train.augment``: ``make_train_step``'s ``augment_fn``;
- ``eqxvision.train.forward``: the bf16 casts of the masters, the forward
  (remat's checkpoint included) and the loss;
- ``eqxvision.train.backward``: ``zero_grad`` and ``loss.backward()``;
- ``eqxvision.train.sync``: the step's collectives, the gradients'
  all-reduce and the loss's mean over the data group (only on a mesh with
  more than one data rank);
- ``eqxvision.train.optimizer``: ``optimizer.step()``.

An operator traces a run of the eval CLI with
``with observability.trace(logdir): cli.eval_imagenet.main([...])``.
"""
from __future__ import annotations

import contextlib
from typing import Any

import torch
from torch import nn

SPANS = (
    "eqxvision.feed",
    "eqxvision.eval.scores",
    "eqxvision.eval.preprocess",
    "eqxvision.train.augment",
    "eqxvision.train.forward",
    "eqxvision.train.backward",
    "eqxvision.train.sync",
    "eqxvision.train.optimizer",
)

_NO_SPAN = contextlib.nullcontext()


@contextlib.contextmanager
def trace(logdir: str):
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=activities,
                                on_trace_ready=torch.profiler.tensorboard_trace_handler(str(logdir))):
        yield logdir


def annotate(name: str):
    """A span named ``name`` while a profiler records, else a no-op."""
    if torch._C._autograd._profiler_enabled():
        return torch.profiler.record_function(name)
    return _NO_SPAN


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
