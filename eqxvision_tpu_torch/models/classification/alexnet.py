"""AlexNet, NHWC batched (eqxvision_tpu/models/classification/alexnet.py).

torchvision's module tree and state-dict names: ``features.0``, ``.3``,
``.6``, ``.8``, ``.10`` the convolutions, ``classifier.1``, ``.4``, ``.6``
the Linears. The adaptive pool to 6 x 6 and the CHW-ordered flatten give
the classifier torchvision's input, so a torchvision checkpoint's logits
are reproduced whole. No kernel of the port runs here.
"""
from __future__ import annotations

from typing import Any, Optional, Union

import torch
from torch import nn

from ...nn import AdaptiveAvgPool2d, Conv2d, Dropout, Linear, MaxPool2d, flatten_chw
from .._common import debatch, default_generator, ensure_nhwc, maybe_load_state_dict, resolve_device


class AlexNet(nn.Module):
    def __init__(
        self, num_classes: int = 1000, dropout: float = 0.5, *, generator: Optional[torch.Generator] = None,
        device: Union[str, torch.device] = "cuda",
    ):
        super().__init__()
        kw = dict(generator=default_generator(generator), device=resolve_device(device))
        self.features = nn.Sequential(
            Conv2d(3, 64, 11, stride=4, padding=2, **kw),
            nn.ReLU(),
            MaxPool2d(3, 2),
            Conv2d(64, 192, 5, padding=2, **kw),
            nn.ReLU(),
            MaxPool2d(3, 2),
            Conv2d(192, 384, 3, padding=1, **kw),
            nn.ReLU(),
            Conv2d(384, 256, 3, padding=1, **kw),
            nn.ReLU(),
            Conv2d(256, 256, 3, padding=1, **kw),
            nn.ReLU(),
            MaxPool2d(3, 2),
        )
        self.avgpool = AdaptiveAvgPool2d((6, 6))
        self.classifier = nn.Sequential(
            Dropout(dropout),
            Linear(256 * 6 * 6, 4096, **kw),
            nn.ReLU(),
            Dropout(dropout),
            Linear(4096, 4096, **kw),
            nn.ReLU(),
            Linear(4096, num_classes, **kw),
        )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x, single = ensure_nhwc(x)
        x = flatten_chw(self.avgpool(self.features(x)))
        return debatch(self.classifier(x), single)


def alexnet(torch_weights: Optional[str] = None, **kwargs: Any) -> AlexNet:
    return maybe_load_state_dict(AlexNet(**kwargs), torch_weights)
