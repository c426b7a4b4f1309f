"""The port's counterpart of the JAX package's entry point
(``__graft_entry__.entry``): a forward step on ResNet-50 and its arguments.

``forward, (model, x) = entry()``; ``forward(model, x)`` gives the logits.
The model is resnet50 in eval mode, random weights from seed 0, and x is
zeros of shape (8, 224, 224, 3) in f32, both on the card unless ``device``
names another; without a card, ``device="cuda"`` raises. The multichip dry
run of the JAX entry (a sharded training step) waits for the port's
training path.
"""
from __future__ import annotations

from typing import Callable, Tuple, Union

import torch
from torch import nn

from .models.classification.resnet import resnet50


def forward(model: nn.Module, x: torch.Tensor) -> torch.Tensor:
    with torch.inference_mode():
        return model(x)


def entry(device: Union[str, torch.device] = "cuda") -> Tuple[Callable, Tuple[nn.Module, torch.Tensor]]:
    model = resnet50(generator=torch.Generator().manual_seed(0), device=device).eval()
    x = torch.zeros(8, 224, 224, 3, device=device)
    return forward, (model, x)
