"""GoogLeNet (Inception v1), NHWC batched
(eqxvision_tpu/models/classification/googlenet.py).

torchvision's module tree and state-dict names, with the quirks its
checkpoints depend on: ``BasicConv2d`` is conv (no bias), BatchNorm at eps
1e-3 and ReLU (fields ``conv`` and ``bn``); the "5x5" branch of an
inception block uses a 3x3 conv; every max pool is ceil mode; ``aux1`` and
``aux2`` sit between ``inception5b`` and ``fc``. ``InceptionAux`` pools to
4 x 4 and flattens in CHW order before ``fc1``, as torchvision's weights
expect. ``transform_input`` re-normalises ImageNet-normalised input to the
0.5/0.5 scheme on the channel (last) axis. In training mode with
``aux_logits`` the forward returns ``(logits, aux2, aux1)``; in eval mode
the logits. No kernel of the port runs here.
"""
from __future__ import annotations

from typing import Any, Optional, Union

import torch
import torch.nn.functional as F
from torch import nn

from ...nn import BatchNorm, Conv2d, Dropout, Linear, MaxPool2d, adaptive_avg_pool2d, flatten_chw
from .._common import debatch, default_generator, ensure_nhwc, maybe_load_state_dict, resolve_device


class BasicConv2d(nn.Module):
    def __init__(self, in_channels, out_channels, *, generator, device=None, **conv_kwargs):
        super().__init__()
        self.conv = Conv2d(in_channels, out_channels, use_bias=False, generator=generator, device=device,
                           **conv_kwargs)
        self.bn = BatchNorm(out_channels, eps=1e-3, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.relu(self.bn(self.conv(x)))


class _Inception(nn.Module):
    def __init__(self, in_channels, ch1x1, ch3x3red, ch3x3, ch5x5red, ch5x5, pool_proj, *, generator, device=None):
        super().__init__()
        kw = dict(generator=generator, device=device)
        self.branch1 = BasicConv2d(in_channels, ch1x1, kernel_size=1, **kw)
        self.branch2 = nn.Sequential(
            BasicConv2d(in_channels, ch3x3red, kernel_size=1, **kw),
            BasicConv2d(ch3x3red, ch3x3, kernel_size=3, padding=1, **kw),
        )
        # torchvision's "5x5" branch is a 3x3 conv (its checkpoints have that shape)
        self.branch3 = nn.Sequential(
            BasicConv2d(in_channels, ch5x5red, kernel_size=1, **kw),
            BasicConv2d(ch5x5red, ch5x5, kernel_size=3, padding=1, **kw),
        )
        self.branch4 = nn.Sequential(
            MaxPool2d(3, 1, 1, use_ceil=True),
            BasicConv2d(in_channels, pool_proj, kernel_size=1, **kw),
        )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.cat([self.branch1(x), self.branch2(x), self.branch3(x), self.branch4(x)], dim=-1)


class InceptionAux(nn.Module):
    def __init__(self, in_channels, num_classes, dropout: float = 0.7, *, generator, device=None):
        super().__init__()
        kw = dict(generator=generator, device=device)
        self.conv = BasicConv2d(in_channels, 128, kernel_size=1, **kw)
        self.fc1 = Linear(2048, 1024, **kw)
        self.fc2 = Linear(1024, num_classes, **kw)
        self.dropout = Dropout(dropout)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = flatten_chw(self.conv(adaptive_avg_pool2d(x, (4, 4))))
        return self.fc2(self.dropout(F.relu(self.fc1(x))))


class GoogLeNet(nn.Module):
    def __init__(
        self,
        num_classes: int = 1000,
        aux_logits: bool = True,
        transform_input: bool = False,
        dropout: float = 0.2,
        dropout_aux: float = 0.7,
        *,
        generator: Optional[torch.Generator] = None,
        device: Union[str, torch.device] = "cuda",
    ):
        super().__init__()
        kw = dict(generator=default_generator(generator), device=resolve_device(device))
        self.aux_logits = bool(aux_logits)
        self.transform_input = bool(transform_input)
        self.conv1 = BasicConv2d(3, 64, kernel_size=7, stride=2, padding=3, **kw)
        self.maxpool1 = MaxPool2d(3, 2, use_ceil=True)
        self.conv2 = BasicConv2d(64, 64, kernel_size=1, **kw)
        self.conv3 = BasicConv2d(64, 192, kernel_size=3, padding=1, **kw)
        self.maxpool2 = MaxPool2d(3, 2, use_ceil=True)
        self.inception3a = _Inception(192, 64, 96, 128, 16, 32, 32, **kw)
        self.inception3b = _Inception(256, 128, 128, 192, 32, 96, 64, **kw)
        self.maxpool3 = MaxPool2d(3, 2, use_ceil=True)
        self.inception4a = _Inception(480, 192, 96, 208, 16, 48, 64, **kw)
        self.inception4b = _Inception(512, 160, 112, 224, 24, 64, 64, **kw)
        self.inception4c = _Inception(512, 128, 128, 256, 24, 64, 64, **kw)
        self.inception4d = _Inception(512, 112, 144, 288, 32, 64, 64, **kw)
        self.inception4e = _Inception(528, 256, 160, 320, 32, 128, 128, **kw)
        self.maxpool4 = MaxPool2d(2, 2, use_ceil=True)
        self.inception5a = _Inception(832, 256, 160, 320, 32, 128, 128, **kw)
        self.inception5b = _Inception(832, 384, 192, 384, 48, 128, 128, **kw)
        if aux_logits:
            self.aux1 = InceptionAux(512, num_classes, dropout_aux, **kw)
            self.aux2 = InceptionAux(528, num_classes, dropout_aux, **kw)
        else:
            self.aux1 = self.aux2 = None
        self.dropout = Dropout(dropout)
        self.fc = Linear(1024, num_classes, **kw)

    @staticmethod
    def _transform_input(x: torch.Tensor) -> torch.Tensor:
        ch0 = x[..., 0] * (0.229 / 0.5) + (0.485 - 0.5) / 0.5
        ch1 = x[..., 1] * (0.224 / 0.5) + (0.456 - 0.5) / 0.5
        ch2 = x[..., 2] * (0.225 / 0.5) + (0.406 - 0.5) / 0.5
        return torch.stack([ch0, ch1, ch2], dim=-1)

    def forward(self, x: torch.Tensor):
        x, single = ensure_nhwc(x)
        if self.transform_input:
            x = self._transform_input(x)
        with_aux = self.training and self.aux1 is not None
        x = self.maxpool1(self.conv1(x))
        x = self.maxpool2(self.conv3(self.conv2(x)))
        x = self.maxpool3(self.inception3b(self.inception3a(x)))
        x = self.inception4a(x)
        aux1 = self.aux1(x) if with_aux else None
        x = self.inception4d(self.inception4c(self.inception4b(x)))
        aux2 = self.aux2(x) if with_aux else None
        x = self.maxpool4(self.inception4e(x))
        x = self.inception5b(self.inception5a(x))
        logits = self.fc(self.dropout(flatten_chw(adaptive_avg_pool2d(x, (1, 1)))))
        if not self.training or not self.aux_logits:
            return debatch(logits, single)
        return debatch((logits, aux2, aux1), single)


def googlenet(torch_weights: Optional[str] = None, **kwargs: Any) -> GoogLeNet:
    """With ``torch_weights`` (torchvision's checkpoint holds the aux heads
    and was trained with the input transform), ``aux_logits`` and
    ``transform_input`` default to True."""
    if torch_weights is not None:
        kwargs.setdefault("aux_logits", True)
        kwargs.setdefault("transform_input", True)
    return maybe_load_state_dict(GoogLeNet(**kwargs), torch_weights)
