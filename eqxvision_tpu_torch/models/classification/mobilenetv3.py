"""MobileNetV3 Large and Small, NHWC batched
(eqxvision_tpu/models/classification/mobilenetv3.py).

Inverted residuals with squeeze-excitation (hard-sigmoid gate, squeeze
width ``_make_divisible(expanded // 4, 8)``), hard-swish activations,
BatchNorm with eps 1e-3 and momentum 0.01 by default, and the
``width_mult``, ``reduced_tail`` and ``dilated`` variants that LR-ASPP's
backbone uses (a dilated block takes stride 1). torchvision's names:
``features.i.block.j`` and ``classifier`` (linear, hard-swish, dropout,
linear). cuDNN convolutions on the channels-last view; no kernel of the
port runs here.
"""
from __future__ import annotations

import functools
from typing import Any, Callable, List, Optional, Union

import torch
from torch import nn

from ... import nn as N
from ...layers import ConvNormActivation, SqueezeExcitation
from ...utils import _make_divisible
from .._common import debatch, default_generator, ensure_nhwc, maybe_load_state_dict, resolve_device


class _InvertedResidualConfig:
    def __init__(self, input_channels, kernel, expanded_channels, out_channels, use_se, activation, stride, dilation,
                 width_mult):
        self.input_channels = self.adjust_channels(input_channels, width_mult)
        self.kernel = kernel
        self.expanded_channels = self.adjust_channels(expanded_channels, width_mult)
        self.out_channels = self.adjust_channels(out_channels, width_mult)
        self.use_se = use_se
        self.use_hs = activation == "HS"
        self.stride = stride
        self.dilation = dilation

    @staticmethod
    def adjust_channels(channels: int, width_mult: float) -> int:
        return _make_divisible(channels * width_mult, 8)


class _InvertedResidual(nn.Module):
    def __init__(self, cnf: _InvertedResidualConfig, norm_layer: Callable[..., nn.Module], *, generator, device=None):
        super().__init__()
        if cnf.stride not in (1, 2):
            raise ValueError("illegal stride value")
        self.use_res_connect = cnf.stride == 1 and cnf.input_channels == cnf.out_channels
        self.out_channels = cnf.out_channels
        kw = dict(generator=generator, device=device)
        act = N.hard_swish if cnf.use_hs else N.relu
        layers = []
        if cnf.expanded_channels != cnf.input_channels:
            layers.append(ConvNormActivation(cnf.input_channels, cnf.expanded_channels, kernel_size=1,
                                             norm_layer=norm_layer, activation_layer=act, **kw))
        layers.append(ConvNormActivation(
            cnf.expanded_channels, cnf.expanded_channels, kernel_size=cnf.kernel,
            stride=1 if cnf.dilation > 1 else cnf.stride, dilation=cnf.dilation, groups=cnf.expanded_channels,
            norm_layer=norm_layer, activation_layer=act, **kw))
        if cnf.use_se:
            squeeze_channels = _make_divisible(cnf.expanded_channels // 4, 8)
            layers.append(SqueezeExcitation(cnf.expanded_channels, squeeze_channels, scale_activation=N.hard_sigmoid,
                                            **kw))
        layers.append(ConvNormActivation(cnf.expanded_channels, cnf.out_channels, kernel_size=1,
                                         norm_layer=norm_layer, activation_layer=None, **kw))
        self.block = nn.Sequential(*layers)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = self.block(x)
        return out + x if self.use_res_connect else out


class MobileNetV3(nn.Module):
    def __init__(
        self,
        inverted_residual_setting: List[_InvertedResidualConfig],
        last_channel: int,
        num_classes: int = 1000,
        norm_layer: Optional[Callable[..., nn.Module]] = None,
        dropout: float = 0.2,
        *,
        generator: Optional[torch.Generator] = None,
        device: Union[str, torch.device] = "cuda",
    ):
        super().__init__()
        kw = dict(generator=default_generator(generator), device=resolve_device(device))
        if norm_layer is None:
            norm_layer = functools.partial(N.BatchNorm, eps=1e-3, momentum=0.01)
        layers = [ConvNormActivation(3, inverted_residual_setting[0].input_channels, kernel_size=3, stride=2,
                                     norm_layer=norm_layer, activation_layer=N.hard_swish, **kw)]
        layers += [_InvertedResidual(cnf, norm_layer, **kw) for cnf in inverted_residual_setting]
        lastconv_input = inverted_residual_setting[-1].out_channels
        lastconv_output = 6 * lastconv_input
        layers.append(ConvNormActivation(lastconv_input, lastconv_output, kernel_size=1, norm_layer=norm_layer,
                                         activation_layer=N.hard_swish, **kw))
        self.features = nn.Sequential(*layers)
        self.classifier = nn.Sequential(
            N.Linear(lastconv_output, last_channel, **kw),
            N.Lambda(N.hard_swish),
            N.Dropout(dropout),
            N.Linear(last_channel, num_classes, **kw),
        )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x, single = ensure_nhwc(x)
        x = self.features(x).mean((1, 2))
        return debatch(self.classifier(x), single)


def _mobilenet_v3_conf(arch: str, width_mult: float = 1.0, reduced_tail: bool = False, dilated: bool = False):
    """The architecture tables: (inverted residual settings, last channel)."""
    reduce_divider = 2 if reduced_tail else 1
    dilation = 2 if dilated else 1
    bneck_conf = functools.partial(_InvertedResidualConfig, width_mult=width_mult)
    if arch == "mobilenet_v3_large":
        setting = [
            bneck_conf(16, 3, 16, 16, False, "RE", 1, 1),
            bneck_conf(16, 3, 64, 24, False, "RE", 2, 1),
            bneck_conf(24, 3, 72, 24, False, "RE", 1, 1),
            bneck_conf(24, 5, 72, 40, True, "RE", 2, 1),
            bneck_conf(40, 5, 120, 40, True, "RE", 1, 1),
            bneck_conf(40, 5, 120, 40, True, "RE", 1, 1),
            bneck_conf(40, 3, 240, 80, False, "HS", 2, 1),
            bneck_conf(80, 3, 200, 80, False, "HS", 1, 1),
            bneck_conf(80, 3, 184, 80, False, "HS", 1, 1),
            bneck_conf(80, 3, 184, 80, False, "HS", 1, 1),
            bneck_conf(80, 3, 480, 112, True, "HS", 1, 1),
            bneck_conf(112, 3, 672, 112, True, "HS", 1, 1),
            bneck_conf(112, 5, 672, 160 // reduce_divider, True, "HS", 2, dilation),
            bneck_conf(160 // reduce_divider, 5, 960 // reduce_divider, 160 // reduce_divider, True, "HS", 1, dilation),
            bneck_conf(160 // reduce_divider, 5, 960 // reduce_divider, 160 // reduce_divider, True, "HS", 1, dilation),
        ]
        last_channel = _InvertedResidualConfig.adjust_channels(1280 // reduce_divider, width_mult)
    elif arch == "mobilenet_v3_small":
        setting = [
            bneck_conf(16, 3, 16, 16, True, "RE", 2, 1),
            bneck_conf(16, 3, 72, 24, False, "RE", 2, 1),
            bneck_conf(24, 3, 88, 24, False, "RE", 1, 1),
            bneck_conf(24, 5, 96, 40, True, "HS", 2, 1),
            bneck_conf(40, 5, 240, 40, True, "HS", 1, 1),
            bneck_conf(40, 5, 240, 40, True, "HS", 1, 1),
            bneck_conf(40, 5, 120, 48, True, "HS", 1, 1),
            bneck_conf(48, 5, 144, 48, True, "HS", 1, 1),
            bneck_conf(48, 5, 288, 96 // reduce_divider, True, "HS", 2, dilation),
            bneck_conf(96 // reduce_divider, 5, 576 // reduce_divider, 96 // reduce_divider, True, "HS", 1, dilation),
            bneck_conf(96 // reduce_divider, 5, 576 // reduce_divider, 96 // reduce_divider, True, "HS", 1, dilation),
        ]
        last_channel = _InvertedResidualConfig.adjust_channels(1024 // reduce_divider, width_mult)
    else:
        raise ValueError(f"Unsupported model type {arch}")
    return setting, last_channel


def _mobilenet_v3(arch, torch_weights, width_mult=1.0, reduced_tail=False, dilated=False, **kwargs) -> MobileNetV3:
    setting, last_channel = _mobilenet_v3_conf(arch, width_mult, reduced_tail, dilated)
    return maybe_load_state_dict(MobileNetV3(setting, last_channel, **kwargs), torch_weights)


def mobilenet_v3_large(torch_weights: Optional[str] = None, **kwargs: Any) -> MobileNetV3:
    return _mobilenet_v3("mobilenet_v3_large", torch_weights, **kwargs)


def mobilenet_v3_small(torch_weights: Optional[str] = None, **kwargs: Any) -> MobileNetV3:
    return _mobilenet_v3("mobilenet_v3_small", torch_weights, **kwargs)
