"""Weight-baked inference programs for serving, on ``torch.export``
(eqxvision_tpu/export.py).

- ``export_inference`` traces ``model(x)`` at one static serving shape
  ``(batch, size, size, channels)`` into a ``torch.export.ExportedProgram``
  that holds the weights (the artifact is the checkpoint). An optional
  ``preprocess_fn`` is traced in front of the model, so that a uint8
  placeholder reaches the first layer normalised, not as raw bytes. A
  segmentation model's program returns its last output, the main map.
- ``save_exported`` / ``load_exported``: the byte round trip
  (``torch.export.save`` / ``load``). ``program.module()(x)`` runs it.

The kernels stay in the program: while ``torch.export`` traces, each kernel
wrapper goes through its ``torch.library`` op (``eqxvision::...``, see
``ops.attention.export_op``), which the loaded program calls again: the
hand-written kernel on a CUDA tensor, the plain version on a CPU one.
Importing the package (this module imports it) registers the ops, so a
program loads wherever the port is importable.

Where the JAX function takes ``platforms=`` (lowering for another backend)
and ``mesh=`` (a batch sharded over chips), this one raises: torch lowers
for the device the model sits on, and the port's multi-card path is ROADMAP
A.11b.
"""
from __future__ import annotations

import copy
from typing import Any, Callable, Optional, Sequence

import torch
from torch import nn


class _Inference(nn.Module):
    def __init__(self, model: nn.Module, dtype: Optional[torch.dtype], preprocess_fn: Optional[Callable]):
        super().__init__()
        self.model, self.dtype, self.preprocess_fn = model, dtype, preprocess_fn

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.preprocess_fn is not None:
            x = self.preprocess_fn(x)
        if self.dtype is not None and x.is_floating_point():
            x = x.to(self.dtype)
        out = self.model(x)
        return out[-1] if isinstance(out, tuple) else out  # segmentation: (aux, out)


def export_inference(
    model: nn.Module,
    batch: int,
    size: int,
    *,
    channels: int = 3,
    dtype: Optional[torch.dtype] = torch.bfloat16,
    input_dtype: Optional[torch.dtype] = None,
    preprocess_fn: Optional[Callable[[torch.Tensor], torch.Tensor]] = None,
    platforms: Optional[Sequence[str]] = None,
    mesh: Any = None,
) -> torch.export.ExportedProgram:
    """Export one inference configuration of ``model`` (left as it is).

    ``dtype`` is the type the weights and a floating input are cast to
    (bf16 by default; None keeps the model's own). ``input_dtype`` is the
    placeholder's type (default ``dtype``, else f32); pass ``torch.uint8``
    with a ``preprocess_fn`` (e.g. ``ops.imagenet_eval_pipeline``) for a
    program that starts at decoded bytes. The program runs on the device
    the model sits on; eval mode is forced."""
    if mesh is not None:
        raise NotImplementedError("export over several cards (mesh=) waits for the port's multi-card path, "
                                  "ROADMAP A.11b")
    if platforms is not None:
        raise ValueError("torch.export lowers for the device the model sits on; move the model there instead "
                         "of naming platforms")
    device = next(model.parameters()).device
    inner = copy.deepcopy(model).eval()
    if dtype is not None:
        inner = inner.to(dtype)
    example = torch.zeros((batch, size, size, channels), dtype=input_dtype or dtype or torch.float32, device=device)
    with torch.no_grad():
        return torch.export.export(_Inference(inner, dtype, preprocess_fn), (example,))


def save_exported(exported: torch.export.ExportedProgram, path: str) -> None:
    """Write the program, weights included, to ``path``."""
    torch.export.save(exported, path)


def load_exported(path: str) -> torch.export.ExportedProgram:
    """Load a program; ``.module()(x)`` runs it."""
    return torch.export.load(path)
