"""Exponential moving average of a model's weights (eqxvision_tpu/parallel/ema.py).

The shadow is a dict of f32 copies of the model's floating parameters and
buffers (BatchNorm's running statistics among them), keyed by
``state_dict()`` names; integer buffers (``num_batches_tracked``, index
tables) are not averaged.

    ema = ema_init(model)
    loss = step(model, optimizer, x, y, generator)
    ema_update(ema, model, decay=0.9999, step=step_no)
    eval_model = ema_params(ema, model)

``ema_update`` with ``step`` ramps the decay in as ``decay * (1 + step) /
(10 + step)`` (timm's ModelEmaV2 warmup), so that early training is not
frozen by a decay near 1.
"""
from __future__ import annotations

import copy
from typing import Dict, Iterator, Optional, Tuple

import torch
from torch import nn


def _averaged(model: nn.Module) -> Iterator[Tuple[str, torch.Tensor]]:
    for name, t in model.state_dict(keep_vars=True).items():
        if t.is_floating_point():
            yield name, t


def ema_init(model: nn.Module) -> Dict[str, torch.Tensor]:
    """f32 copies of the floating parameters and buffers."""
    return {name: t.detach().float().clone() for name, t in _averaged(model)}


@torch.no_grad()
def ema_update(
    ema: Dict[str, torch.Tensor], model: nn.Module, decay: float = 0.9999, step: Optional[int] = None
) -> Dict[str, torch.Tensor]:
    """One step in place, ``ema = d * ema + (1 - d) * value`` in f32, with
    ``d = decay``, or ``decay * (1 + step) / (10 + step)`` where ``step`` is
    given; returns ``ema``."""
    d = float(decay)
    if step is not None:
        d = d * (1.0 + step) / (10.0 + step)
    for name, t in _averaged(model):
        e = ema[name]
        e.copy_(e * d + t.float() * (1.0 - d))
    return ema


def ema_params(ema: Dict[str, torch.Tensor], model: nn.Module) -> nn.Module:
    """A copy of ``model`` carrying the averages, each cast to its tensor's
    type; everything else is the model's."""
    out = copy.deepcopy(model)
    with torch.no_grad():
        for name, t in _averaged(out):
            t.copy_(ema[name])
    return out
