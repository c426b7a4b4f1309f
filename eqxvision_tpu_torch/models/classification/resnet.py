"""ResNet / ResNeXt / Wide-ResNet, NHWC batched
(eqxvision_tpu/models/classification/resnet.py).

torchvision's module tree and state-dict names: ``conv1``, ``bn1``,
``layer1`` ... ``layer4`` of blocks, ``fc``; a block's ``conv1``/``bn1``
... and its ``downsample`` as an ``nn.Sequential`` (``downsample.0`` the
1x1 conv, ``downsample.1`` its BatchNorm). v1.5: a bottleneck strides on
its 3x3 conv. ``groups`` and ``width_per_group`` give ResNeXt and
Wide-ResNet, ``replace_stride_with_dilation`` the dilated trunks that
segmentation uses, ``norm_layer`` (called as ``norm_layer(channels,
device=...)``; ``nn.BatchNorm`` by default) another norm. The convolutions are cuDNN on the channels-last view,
the BatchNorms ``F.batch_norm`` at inference (``nn.BatchNorm``), and no
kernel of the port runs here; ``ops.fold_batchnorm`` folds the BatchNorms
into the convolutions on request.
"""
from __future__ import annotations

from typing import Any, Callable, List, Optional, Type, Union

import torch
import torch.nn.functional as F
from torch import nn

from ...nn import AdaptiveAvgPool2d, BatchNorm, Conv2d, Linear, MaxPool2d, flatten_chw
from .._common import debatch, default_generator, ensure_nhwc, maybe_load_state_dict, resolve_device


def _conv3x3(cin, cout, stride=1, groups=1, dilation=1, **kw):
    return Conv2d(cin, cout, 3, stride=stride, padding=dilation, groups=groups, dilation=dilation, use_bias=False, **kw)


def _conv1x1(cin, cout, stride=1, **kw):
    return Conv2d(cin, cout, 1, stride=stride, use_bias=False, **kw)


class BasicBlock(nn.Module):
    expansion = 1

    def __init__(self, inplanes, planes, stride=1, downsample=None, groups=1, base_width=64, dilation=1,
                 norm_layer: Callable[..., nn.Module] = BatchNorm, *, generator, device=None):
        super().__init__()
        if groups != 1 or base_width != 64:
            raise ValueError("BasicBlock only supports groups=1 and base_width=64")
        if dilation > 1:
            raise NotImplementedError("Dilation > 1 not supported in BasicBlock")
        kw = dict(generator=generator, device=device)
        self.conv1 = _conv3x3(inplanes, planes, stride, **kw)
        self.bn1 = norm_layer(planes, device=device)
        self.conv2 = _conv3x3(planes, planes, **kw)
        self.bn2 = norm_layer(planes, device=device)
        self.downsample = downsample

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = F.relu(self.bn1(self.conv1(x)))
        out = self.bn2(self.conv2(out))
        identity = x if self.downsample is None else self.downsample(x)
        return F.relu(out + identity)


class Bottleneck(nn.Module):
    expansion = 4

    def __init__(self, inplanes, planes, stride=1, downsample=None, groups=1, base_width=64, dilation=1,
                 norm_layer: Callable[..., nn.Module] = BatchNorm, *, generator, device=None):
        super().__init__()
        width = int(planes * (base_width / 64.0)) * groups
        kw = dict(generator=generator, device=device)
        self.conv1 = _conv1x1(inplanes, width, **kw)
        self.bn1 = norm_layer(width, device=device)
        self.conv2 = _conv3x3(width, width, stride, groups, dilation, **kw)
        self.bn2 = norm_layer(width, device=device)
        self.conv3 = _conv1x1(width, planes * self.expansion, **kw)
        self.bn3 = norm_layer(planes * self.expansion, device=device)
        self.downsample = downsample

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = F.relu(self.bn1(self.conv1(x)))
        out = F.relu(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(out))
        identity = x if self.downsample is None else self.downsample(x)
        return F.relu(out + identity)


class ResNet(nn.Module):
    def __init__(
        self,
        block: Union[Type[BasicBlock], Type[Bottleneck]],
        layers: List[int],
        num_classes: int = 1000,
        groups: int = 1,
        width_per_group: int = 64,
        replace_stride_with_dilation: Optional[List[bool]] = None,
        norm_layer: Callable[..., nn.Module] = BatchNorm,
        *,
        generator: Optional[torch.Generator] = None,
        device: Union[str, torch.device] = "cuda",
    ):
        super().__init__()
        generator = default_generator(generator)
        device = resolve_device(device)
        if replace_stride_with_dilation is None:
            replace_stride_with_dilation = [False, False, False]
        if len(replace_stride_with_dilation) != 3:
            raise ValueError("replace_stride_with_dilation should have 3 elements")
        self._kw = dict(generator=generator, device=device)
        self._inplanes, self._dilation = 64, 1
        self._groups, self._base_width, self._norm_layer = groups, width_per_group, norm_layer
        self.conv1 = Conv2d(3, 64, 7, stride=2, padding=3, use_bias=False, **self._kw)
        self.bn1 = norm_layer(64, device=device)
        self.maxpool = MaxPool2d(3, 2, 1)
        self.layer1 = self._make_layer(block, 64, layers[0])
        self.layer2 = self._make_layer(block, 128, layers[1], 2, replace_stride_with_dilation[0])
        self.layer3 = self._make_layer(block, 256, layers[2], 2, replace_stride_with_dilation[1])
        self.layer4 = self._make_layer(block, 512, layers[3], 2, replace_stride_with_dilation[2])
        self.avgpool = AdaptiveAvgPool2d((1, 1))
        self.fc = Linear(512 * block.expansion, num_classes, **self._kw)
        del self._kw, self._inplanes, self._dilation, self._groups, self._base_width, self._norm_layer  # build only

    def _make_layer(self, block, planes, blocks, stride=1, dilate=False) -> nn.Sequential:
        previous_dilation = self._dilation
        if dilate:
            self._dilation *= stride
            stride = 1
        device = self._kw["device"]
        downsample = None
        if stride != 1 or self._inplanes != planes * block.expansion:
            downsample = nn.Sequential(
                _conv1x1(self._inplanes, planes * block.expansion, stride, **self._kw),
                self._norm_layer(planes * block.expansion, device=device),
            )
        layers = [block(self._inplanes, planes, stride, downsample, self._groups, self._base_width,
                        previous_dilation, self._norm_layer, **self._kw)]
        self._inplanes = planes * block.expansion
        for _ in range(1, blocks):
            layers.append(block(self._inplanes, planes, groups=self._groups, base_width=self._base_width,
                                dilation=self._dilation, norm_layer=self._norm_layer, **self._kw))
        return nn.Sequential(*layers)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x, single = ensure_nhwc(x)
        x = self.maxpool(F.relu(self.bn1(self.conv1(x))))
        x = self.layer4(self.layer3(self.layer2(self.layer1(x))))
        x = flatten_chw(self.avgpool(x))
        return debatch(self.fc(x), single)


def _resnet(block, layers, torch_weights, **kwargs) -> ResNet:
    return maybe_load_state_dict(ResNet(block, layers, **kwargs), torch_weights)


def resnet18(torch_weights: Optional[str] = None, **kwargs: Any) -> ResNet:
    return _resnet(BasicBlock, [2, 2, 2, 2], torch_weights, **kwargs)


def resnet34(torch_weights: Optional[str] = None, **kwargs: Any) -> ResNet:
    return _resnet(BasicBlock, [3, 4, 6, 3], torch_weights, **kwargs)


def resnet50(torch_weights: Optional[str] = None, **kwargs: Any) -> ResNet:
    return _resnet(Bottleneck, [3, 4, 6, 3], torch_weights, **kwargs)


def resnet101(torch_weights: Optional[str] = None, **kwargs: Any) -> ResNet:
    return _resnet(Bottleneck, [3, 4, 23, 3], torch_weights, **kwargs)


def resnet152(torch_weights: Optional[str] = None, **kwargs: Any) -> ResNet:
    return _resnet(Bottleneck, [3, 8, 36, 3], torch_weights, **kwargs)


def resnext50_32x4d(torch_weights: Optional[str] = None, **kwargs: Any) -> ResNet:
    kwargs.setdefault("groups", 32)
    kwargs.setdefault("width_per_group", 4)
    return _resnet(Bottleneck, [3, 4, 6, 3], torch_weights, **kwargs)


def resnext101_32x8d(torch_weights: Optional[str] = None, **kwargs: Any) -> ResNet:
    kwargs.setdefault("groups", 32)
    kwargs.setdefault("width_per_group", 8)
    return _resnet(Bottleneck, [3, 4, 23, 3], torch_weights, **kwargs)


def wide_resnet50_2(torch_weights: Optional[str] = None, **kwargs: Any) -> ResNet:
    kwargs.setdefault("width_per_group", 128)
    return _resnet(Bottleneck, [3, 4, 6, 3], torch_weights, **kwargs)


def wide_resnet101_2(torch_weights: Optional[str] = None, **kwargs: Any) -> ResNet:
    kwargs.setdefault("width_per_group", 128)
    return _resnet(Bottleneck, [3, 4, 23, 3], torch_weights, **kwargs)
