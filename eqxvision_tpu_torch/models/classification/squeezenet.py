"""SqueezeNet 1.0 and 1.1, NHWC batched
(eqxvision_tpu/models/classification/squeezenet.py).

torchvision's module tree and state-dict names: ``features`` a
``nn.Sequential`` of the stem conv, ReLU, ceil-mode max pools and ``_Fire``
modules (``squeeze``, ``expand1x1``, ``expand3x3``, the two expand branches
concatenated on the channel axis, the last one in NHWC); ``classifier``
Dropout, a 1x1 conv, ReLU and a global average pool, then the flatten.
Every conv has the JAX layer's default init, the final one too. No kernel
of the port runs here.
"""
from __future__ import annotations

from typing import Any, Optional, Union

import torch
import torch.nn.functional as F
from torch import nn

from ...nn import AdaptiveAvgPool2d, Conv2d, Dropout, MaxPool2d, flatten_chw
from .._common import debatch, default_generator, ensure_nhwc, maybe_load_state_dict, resolve_device


class _Fire(nn.Module):
    def __init__(self, inplanes, squeeze_planes, expand1x1_planes, expand3x3_planes, *, generator, device=None):
        super().__init__()
        kw = dict(generator=generator, device=device)
        self.squeeze = Conv2d(inplanes, squeeze_planes, 1, **kw)
        self.expand1x1 = Conv2d(squeeze_planes, expand1x1_planes, 1, **kw)
        self.expand3x3 = Conv2d(squeeze_planes, expand3x3_planes, 3, padding=1, **kw)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = F.relu(self.squeeze(x))
        return torch.cat([F.relu(self.expand1x1(x)), F.relu(self.expand3x3(x))], dim=-1)


def _pool():
    return MaxPool2d(3, 2, use_ceil=True)


class SqueezeNet(nn.Module):
    def __init__(
        self, version: str = "1_0", num_classes: int = 1000, dropout: float = 0.5, *,
        generator: Optional[torch.Generator] = None, device: Union[str, torch.device] = "cuda",
    ):
        super().__init__()
        kw = dict(generator=default_generator(generator), device=resolve_device(device))
        if version == "1_0":
            self.features = nn.Sequential(
                Conv2d(3, 96, 7, stride=2, **kw), nn.ReLU(), _pool(),
                _Fire(96, 16, 64, 64, **kw), _Fire(128, 16, 64, 64, **kw), _Fire(128, 32, 128, 128, **kw), _pool(),
                _Fire(256, 32, 128, 128, **kw), _Fire(256, 48, 192, 192, **kw), _Fire(384, 48, 192, 192, **kw),
                _Fire(384, 64, 256, 256, **kw), _pool(),
                _Fire(512, 64, 256, 256, **kw),
            )
        elif version == "1_1":
            self.features = nn.Sequential(
                Conv2d(3, 64, 3, stride=2, **kw), nn.ReLU(), _pool(),
                _Fire(64, 16, 64, 64, **kw), _Fire(128, 16, 64, 64, **kw), _pool(),
                _Fire(128, 32, 128, 128, **kw), _Fire(256, 32, 128, 128, **kw), _pool(),
                _Fire(256, 48, 192, 192, **kw), _Fire(384, 48, 192, 192, **kw), _Fire(384, 64, 256, 256, **kw),
                _Fire(512, 64, 256, 256, **kw),
            )
        else:
            raise ValueError(f"Unsupported SqueezeNet version {version}: 1_0 or 1_1 expected")
        self.classifier = nn.Sequential(
            Dropout(dropout), Conv2d(512, num_classes, 1, **kw), nn.ReLU(), AdaptiveAvgPool2d((1, 1)),
        )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x, single = ensure_nhwc(x)
        x = self.classifier(self.features(x))
        return debatch(flatten_chw(x), single)


def squeezenet1_0(torch_weights: Optional[str] = None, **kwargs: Any) -> SqueezeNet:
    return maybe_load_state_dict(SqueezeNet("1_0", **kwargs), torch_weights)


def squeezenet1_1(torch_weights: Optional[str] = None, **kwargs: Any) -> SqueezeNet:
    return maybe_load_state_dict(SqueezeNet("1_1", **kwargs), torch_weights)
