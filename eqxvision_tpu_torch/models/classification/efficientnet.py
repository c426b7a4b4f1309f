"""EfficientNet B0-B7 and V2 S/M/L, NHWC batched
(eqxvision_tpu/models/classification/efficientnet.py).

MBConv (expand, depthwise, squeeze-excitation with squeeze width
``max(1, input_channels // 4)``, project) and FusedMBConv blocks, the width
and depth scaling of the architecture tables, each variant's dropout and
BatchNorm (eps 1e-3 and momentum 0.01 for B5-B7, eps 1e-3 for V2), and
stochastic depth growing linearly with the block's index, ``p * block_id /
total_blocks``, one draw per sample (``DropPath``'s global mode, as the
JAX model and torchvision's training). torchvision's names:
``features.i.j.block.k``, ``classifier`` (dropout, linear). cuDNN
convolutions on the channels-last view; no kernel of the port runs here.
"""
from __future__ import annotations

import copy
import functools
import math
from dataclasses import dataclass
from typing import Any, Callable, Optional, Sequence, Union

import torch
from torch import nn

from ... import nn as N
from ...layers import ConvNormActivation, DropPath, SqueezeExcitation
from ...utils import _make_divisible
from .._common import debatch, default_generator, ensure_nhwc, maybe_load_state_dict, resolve_device


@dataclass
class _MBConvConfig:
    expand_ratio: float
    kernel: int
    stride: int
    input_channels: int
    out_channels: int
    num_layers: int
    block: str  # "mbconv" | "fused"

    @staticmethod
    def adjust_channels(channels: int, width_mult: float, min_value: Optional[int] = None) -> int:
        return _make_divisible(channels * width_mult, 8, min_value)


def _mbconf(expand_ratio, kernel, stride, input_channels, out_channels, num_layers, width_mult=1.0, depth_mult=1.0):
    return _MBConvConfig(expand_ratio, kernel, stride, _MBConvConfig.adjust_channels(input_channels, width_mult),
                         _MBConvConfig.adjust_channels(out_channels, width_mult),
                         int(math.ceil(num_layers * depth_mult)), "mbconv")


def _fusedconf(expand_ratio, kernel, stride, input_channels, out_channels, num_layers):
    return _MBConvConfig(expand_ratio, kernel, stride, input_channels, out_channels, num_layers, "fused")


class _MBConv(nn.Module):
    def __init__(self, cnf: _MBConvConfig, stochastic_depth_prob: float, norm_layer: Callable[..., nn.Module], *,
                 generator, device=None):
        super().__init__()
        if not 1 <= cnf.stride <= 2:
            raise ValueError("illegal stride value")
        self.use_res_connect = cnf.stride == 1 and cnf.input_channels == cnf.out_channels
        self.out_channels = cnf.out_channels
        kw = dict(generator=generator, device=device)
        expanded = _MBConvConfig.adjust_channels(cnf.input_channels, cnf.expand_ratio)
        layers = []
        if expanded != cnf.input_channels:
            layers.append(ConvNormActivation(cnf.input_channels, expanded, kernel_size=1, norm_layer=norm_layer,
                                             activation_layer=N.silu, **kw))
        layers += [
            ConvNormActivation(expanded, expanded, kernel_size=cnf.kernel, stride=cnf.stride, groups=expanded,
                               norm_layer=norm_layer, activation_layer=N.silu, **kw),
            SqueezeExcitation(expanded, max(1, cnf.input_channels // 4), activation=N.silu, **kw),
            ConvNormActivation(expanded, cnf.out_channels, kernel_size=1, norm_layer=norm_layer,
                               activation_layer=None, **kw),
        ]
        self.block = nn.Sequential(*layers)
        self.stochastic_depth = DropPath(stochastic_depth_prob)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = self.block(x)
        return self.stochastic_depth(out) + x if self.use_res_connect else out


class _FusedMBConv(nn.Module):
    def __init__(self, cnf: _MBConvConfig, stochastic_depth_prob: float, norm_layer: Callable[..., nn.Module], *,
                 generator, device=None):
        super().__init__()
        if not 1 <= cnf.stride <= 2:
            raise ValueError("illegal stride value")
        self.use_res_connect = cnf.stride == 1 and cnf.input_channels == cnf.out_channels
        self.out_channels = cnf.out_channels
        kw = dict(norm_layer=norm_layer, generator=generator, device=device)
        expanded = _MBConvConfig.adjust_channels(cnf.input_channels, cnf.expand_ratio)
        if expanded != cnf.input_channels:
            layers = [
                ConvNormActivation(cnf.input_channels, expanded, kernel_size=cnf.kernel, stride=cnf.stride,
                                   activation_layer=N.silu, **kw),
                ConvNormActivation(expanded, cnf.out_channels, kernel_size=1, activation_layer=None, **kw),
            ]
        else:
            layers = [ConvNormActivation(cnf.input_channels, cnf.out_channels, kernel_size=cnf.kernel,
                                         stride=cnf.stride, activation_layer=N.silu, **kw)]
        self.block = nn.Sequential(*layers)
        self.stochastic_depth = DropPath(stochastic_depth_prob)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = self.block(x)
        return self.stochastic_depth(out) + x if self.use_res_connect else out


class EfficientNet(nn.Module):
    def __init__(
        self,
        inverted_residual_setting: Sequence[_MBConvConfig],
        dropout: float,
        stochastic_depth_prob: float = 0.2,
        num_classes: int = 1000,
        norm_layer: Optional[Callable[..., nn.Module]] = None,
        last_channel: Optional[int] = None,
        *,
        generator: Optional[torch.Generator] = None,
        device: Union[str, torch.device] = "cuda",
    ):
        super().__init__()
        kw = dict(generator=default_generator(generator), device=resolve_device(device))
        if norm_layer is None:
            norm_layer = N.BatchNorm
        total_stage_blocks = sum(cnf.num_layers for cnf in inverted_residual_setting)
        layers = [ConvNormActivation(3, inverted_residual_setting[0].input_channels, kernel_size=3, stride=2,
                                     norm_layer=norm_layer, activation_layer=N.silu, **kw)]
        stage_block_id = 0
        for cnf in inverted_residual_setting:
            stage = []
            for i in range(cnf.num_layers):
                block_cnf = copy.copy(cnf)
                if i > 0:
                    block_cnf.input_channels = block_cnf.out_channels
                    block_cnf.stride = 1
                sd_prob = stochastic_depth_prob * float(stage_block_id) / total_stage_blocks
                block = _FusedMBConv if block_cnf.block == "fused" else _MBConv
                stage.append(block(block_cnf, sd_prob, norm_layer, **kw))
                stage_block_id += 1
            layers.append(nn.Sequential(*stage))
        lastconv_input = inverted_residual_setting[-1].out_channels
        lastconv_output = last_channel if last_channel is not None else 4 * lastconv_input
        layers.append(ConvNormActivation(lastconv_input, lastconv_output, kernel_size=1, norm_layer=norm_layer,
                                         activation_layer=N.silu, **kw))
        self.features = nn.Sequential(*layers)
        self.classifier = nn.Sequential(N.Dropout(dropout), N.Linear(lastconv_output, num_classes, **kw))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x, single = ensure_nhwc(x)
        x = self.features(x).mean((1, 2))
        return debatch(self.classifier(x), single)


def _efficientnet_conf(arch: str):
    """The architecture tables: (block settings, last channel or None)."""
    if arch.startswith("efficientnet_b"):
        width_mult, depth_mult = {
            "efficientnet_b0": (1.0, 1.0),
            "efficientnet_b1": (1.0, 1.1),
            "efficientnet_b2": (1.1, 1.2),
            "efficientnet_b3": (1.2, 1.4),
            "efficientnet_b4": (1.4, 1.8),
            "efficientnet_b5": (1.6, 2.2),
            "efficientnet_b6": (1.8, 2.6),
            "efficientnet_b7": (2.0, 3.1),
        }[arch]
        bneck = functools.partial(_mbconf, width_mult=width_mult, depth_mult=depth_mult)
        setting = [
            bneck(1, 3, 1, 32, 16, 1),
            bneck(6, 3, 2, 16, 24, 2),
            bneck(6, 5, 2, 24, 40, 2),
            bneck(6, 3, 2, 40, 80, 3),
            bneck(6, 5, 1, 80, 112, 3),
            bneck(6, 5, 2, 112, 192, 4),
            bneck(6, 3, 1, 192, 320, 1),
        ]
        return setting, None
    if arch == "efficientnet_v2_s":
        setting = [
            _fusedconf(1, 3, 1, 24, 24, 2),
            _fusedconf(4, 3, 2, 24, 48, 4),
            _fusedconf(4, 3, 2, 48, 64, 4),
            _mbconf(4, 3, 2, 64, 128, 6),
            _mbconf(6, 3, 1, 128, 160, 9),
            _mbconf(6, 3, 2, 160, 256, 15),
        ]
    elif arch == "efficientnet_v2_m":
        setting = [
            _fusedconf(1, 3, 1, 24, 24, 3),
            _fusedconf(4, 3, 2, 24, 48, 5),
            _fusedconf(4, 3, 2, 48, 80, 5),
            _mbconf(4, 3, 2, 80, 160, 7),
            _mbconf(6, 3, 1, 160, 176, 14),
            _mbconf(6, 3, 2, 176, 304, 18),
            _mbconf(6, 3, 1, 304, 512, 5),
        ]
    elif arch == "efficientnet_v2_l":
        setting = [
            _fusedconf(1, 3, 1, 32, 32, 4),
            _fusedconf(4, 3, 2, 32, 64, 7),
            _fusedconf(4, 3, 2, 64, 96, 7),
            _mbconf(4, 3, 2, 96, 192, 10),
            _mbconf(6, 3, 1, 192, 224, 19),
            _mbconf(6, 3, 2, 224, 384, 25),
            _mbconf(6, 3, 1, 384, 640, 7),
        ]
    else:
        raise ValueError(f"Unsupported model type {arch}")
    return setting, 1280


_DROPOUT = {
    "efficientnet_b0": 0.2, "efficientnet_b1": 0.2, "efficientnet_b2": 0.3,
    "efficientnet_b3": 0.3, "efficientnet_b4": 0.4, "efficientnet_b5": 0.4,
    "efficientnet_b6": 0.5, "efficientnet_b7": 0.5,
    "efficientnet_v2_s": 0.2, "efficientnet_v2_m": 0.3, "efficientnet_v2_l": 0.4,
}


def _efficientnet(arch: str, torch_weights: Optional[str], **kwargs) -> EfficientNet:
    setting, last_channel = _efficientnet_conf(arch)
    kwargs.setdefault("dropout", _DROPOUT[arch])
    kwargs.setdefault("last_channel", last_channel)
    if arch in ("efficientnet_b5", "efficientnet_b6", "efficientnet_b7"):
        kwargs.setdefault("norm_layer", functools.partial(N.BatchNorm, eps=1e-3, momentum=0.01))
    elif arch.startswith("efficientnet_v2"):
        kwargs.setdefault("norm_layer", functools.partial(N.BatchNorm, eps=1e-3))
    return maybe_load_state_dict(EfficientNet(setting, **kwargs), torch_weights)


def _make_factory(arch: str):
    def factory(torch_weights: Optional[str] = None, **kwargs: Any) -> EfficientNet:
        return _efficientnet(arch, torch_weights, **kwargs)

    factory.__name__ = factory.__qualname__ = arch
    factory.__doc__ = f"{arch}: the architecture table, dropout and BatchNorm of that variant."
    return factory


efficientnet_b0 = _make_factory("efficientnet_b0")
efficientnet_b1 = _make_factory("efficientnet_b1")
efficientnet_b2 = _make_factory("efficientnet_b2")
efficientnet_b3 = _make_factory("efficientnet_b3")
efficientnet_b4 = _make_factory("efficientnet_b4")
efficientnet_b5 = _make_factory("efficientnet_b5")
efficientnet_b6 = _make_factory("efficientnet_b6")
efficientnet_b7 = _make_factory("efficientnet_b7")
efficientnet_v2_s = _make_factory("efficientnet_v2_s")
efficientnet_v2_m = _make_factory("efficientnet_v2_m")
efficientnet_v2_l = _make_factory("efficientnet_v2_l")
