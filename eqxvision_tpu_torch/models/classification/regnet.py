"""RegNet X and Y, NHWC batched (eqxvision_tpu/models/classification/regnet.py).

The quantized log-space width schedule (``BlockParams.from_init_params``,
torchvision's and pycls's arithmetic in numpy, so every variant's widths and
group widths are the published ones), X stages (plain bottleneck) and Y
stages (with squeeze-excitation of width ``round(se_ratio * width_in)``).
torchvision's names: ``stem`` (a ``ConvNormActivation``),
``trunk_output.block{i}.block{i}-{j}`` (module names with a ``-``), a
block's ``proj`` before its ``f`` (``a``, ``b``, ``se``, ``c``), and ``fc``.
cuDNN convolutions, grouped ones included, on the channels-last view; no
kernel of the port runs here.
"""
from __future__ import annotations

import math
from collections import OrderedDict
from typing import Any, Callable, Optional, Union

import numpy as np
import torch
from torch import nn

from ... import nn as N
from ...layers import ConvNormActivation, SqueezeExcitation
from ...utils import _make_divisible
from .._common import debatch, default_generator, ensure_nhwc, maybe_load_state_dict, resolve_device


class BlockParams:
    def __init__(self, depths, widths, group_widths, bottleneck_multipliers, strides, se_ratio=None):
        self.depths = depths
        self.widths = widths
        self.group_widths = group_widths
        self.bottleneck_multipliers = bottleneck_multipliers
        self.strides = strides
        self.se_ratio = se_ratio

    @classmethod
    def from_init_params(cls, depth, w_0, w_a, w_m, group_width, bottleneck_multiplier=1.0, se_ratio=None):
        """Widths w_0 + i w_a snapped to powers of w_m and multiples of 8;
        runs of equal widths form the stages. The arithmetic is
        torchvision's, step for step, so that its checkpoints load."""
        QUANT, STRIDE = 8, 2
        if w_a < 0 or w_0 <= 0 or w_m <= 1 or w_0 % 8 != 0:
            raise ValueError("Invalid RegNet settings")
        widths_cont = np.arange(depth) * w_a + w_0
        block_capacity = np.round(np.log(widths_cont / w_0) / math.log(w_m))
        block_widths = (np.round(w_0 * np.power(w_m, block_capacity) / QUANT) * QUANT).astype(int).tolist()
        num_stages = len(set(block_widths))

        split_helper = zip(block_widths + [0], [0] + block_widths, block_widths + [0], [0] + block_widths)
        splits = [w != wp or r != rp for w, wp, r, rp in split_helper]
        stage_widths = [w for w, t in zip(block_widths, splits[:-1]) if t]
        stage_depths = np.diff([d for d, t in enumerate(splits) if t]).astype(int).tolist()

        strides = [STRIDE] * num_stages
        bottleneck_multipliers = [bottleneck_multiplier] * num_stages
        group_widths = [group_width] * num_stages
        stage_widths, group_widths = cls._adjust_widths_groups_compatibility(
            stage_widths, bottleneck_multipliers, group_widths)
        return cls(stage_depths, stage_widths, group_widths, bottleneck_multipliers, strides, se_ratio)

    def _get_expanded_params(self):
        return zip(self.widths, self.strides, self.depths, self.group_widths, self.bottleneck_multipliers)

    @staticmethod
    def _adjust_widths_groups_compatibility(stage_widths, bottleneck_ratios, group_widths):
        widths = [int(w * b) for w, b in zip(stage_widths, bottleneck_ratios)]
        group_widths_min = [min(g, w_bot) for g, w_bot in zip(group_widths, widths)]
        ws_bot = [_make_divisible(w_bot, g) for w_bot, g in zip(widths, group_widths_min)]
        stage_widths = [int(w_bot / b) for w_bot, b in zip(ws_bot, bottleneck_ratios)]
        return stage_widths, group_widths_min


class SimpleStemIN(ConvNormActivation):
    """The 3x3 stride-2 stem."""

    def __init__(self, width_in, width_out, norm_layer, activation_layer, *, generator, device=None):
        super().__init__(width_in, width_out, kernel_size=3, stride=2, norm_layer=norm_layer,
                         activation_layer=activation_layer, generator=generator, device=device)


class BottleneckTransform(nn.Sequential):
    """1x1, grouped 3x3 (strided), squeeze-excitation where ``se_ratio``, 1x1."""

    def __init__(self, width_in, width_out, stride, norm_layer, activation_layer, group_width, bottleneck_multiplier,
                 se_ratio, *, generator, device=None):
        kw = dict(norm_layer=norm_layer, generator=generator, device=device)
        w_b = int(round(width_out * bottleneck_multiplier))
        layers = OrderedDict()
        layers["a"] = ConvNormActivation(width_in, w_b, kernel_size=1, activation_layer=activation_layer, **kw)
        layers["b"] = ConvNormActivation(w_b, w_b, kernel_size=3, stride=stride, groups=w_b // group_width,
                                         activation_layer=activation_layer, **kw)
        if se_ratio:
            layers["se"] = SqueezeExcitation(w_b, int(round(se_ratio * width_in)), activation=activation_layer,
                                             generator=generator, device=device)
        layers["c"] = ConvNormActivation(w_b, width_out, kernel_size=1, activation_layer=None, **kw)
        super().__init__(layers)


class ResBottleneckBlock(nn.Module):
    """relu(proj(x) + f(x)), the projection a strided 1x1 where the width or
    the stride changes."""

    def __init__(self, width_in, width_out, stride, norm_layer, activation_layer, group_width=1,
                 bottleneck_multiplier=1.0, se_ratio=None, *, generator, device=None):
        super().__init__()
        kw = dict(generator=generator, device=device)
        self.proj = None
        if width_in != width_out or stride != 1:
            self.proj = ConvNormActivation(width_in, width_out, kernel_size=1, stride=stride, norm_layer=norm_layer,
                                           activation_layer=None, **kw)
        self.f = BottleneckTransform(width_in, width_out, stride, norm_layer, activation_layer, group_width,
                                     bottleneck_multiplier, se_ratio, **kw)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        fx = self.f(x)
        return torch.relu((x if self.proj is None else self.proj(x)) + fx)


class AnyStage(nn.Sequential):
    """A stage of ``depth`` ``ResBottleneckBlock``s named ``block{i}-{j}``."""

    def __init__(self, width_in, width_out, stride, depth, norm_layer, activation_layer, group_width,
                 bottleneck_multiplier, se_ratio=None, stage_index=0, *, generator, device=None):
        super().__init__()
        for i in range(depth):
            self.add_module(f"block{stage_index}-{i}", ResBottleneckBlock(
                width_in if i == 0 else width_out, width_out, stride if i == 0 else 1, norm_layer, activation_layer,
                group_width, bottleneck_multiplier, se_ratio, generator=generator, device=device))


class RegNet(nn.Module):
    def __init__(
        self,
        block_params: BlockParams,
        num_classes: int = 1000,
        stem_width: int = 32,
        norm_layer: Callable[..., nn.Module] = N.BatchNorm,
        activation_layer: Callable = N.relu,
        *,
        generator: Optional[torch.Generator] = None,
        device: Union[str, torch.device] = "cuda",
    ):
        super().__init__()
        kw = dict(generator=default_generator(generator), device=resolve_device(device))
        self.stem = SimpleStemIN(3, stem_width, norm_layer, activation_layer, **kw)
        current_width = stem_width
        stages = OrderedDict()
        for i, (width_out, stride, depth, group_width, bottleneck_multiplier) in enumerate(
            block_params._get_expanded_params()
        ):
            stages[f"block{i + 1}"] = AnyStage(current_width, width_out, stride, depth, norm_layer, activation_layer,
                                               group_width, bottleneck_multiplier, block_params.se_ratio, i + 1, **kw)
            current_width = width_out
        self.trunk_output = nn.Sequential(stages)
        self.fc = N.Linear(current_width, num_classes, **kw)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x, single = ensure_nhwc(x)
        x = self.trunk_output(self.stem(x)).mean((1, 2))
        return debatch(self.fc(x), single)


_CONFIGS = {
    # name: (depth, w_0, w_a, w_m, group_width, se_ratio)
    "regnet_y_400mf": (16, 48, 27.89, 2.09, 8, 0.25),
    "regnet_y_800mf": (14, 56, 38.84, 2.4, 16, 0.25),
    "regnet_y_1_6gf": (27, 48, 20.71, 2.65, 24, 0.25),
    "regnet_y_3_2gf": (21, 80, 42.63, 2.66, 24, 0.25),
    "regnet_y_8gf": (17, 192, 76.82, 2.19, 56, 0.25),
    "regnet_y_16gf": (18, 200, 106.23, 2.48, 112, 0.25),
    "regnet_y_32gf": (20, 232, 115.89, 2.53, 232, 0.25),
    "regnet_y_128gf": (27, 456, 160.83, 2.52, 264, 0.25),
    "regnet_x_400mf": (22, 24, 24.48, 2.54, 16, None),
    "regnet_x_800mf": (16, 56, 35.73, 2.28, 16, None),
    "regnet_x_1_6gf": (18, 80, 34.01, 2.25, 24, None),
    "regnet_x_3_2gf": (25, 88, 26.31, 2.25, 48, None),
    "regnet_x_8gf": (23, 80, 49.56, 2.88, 120, None),
    "regnet_x_16gf": (22, 216, 55.59, 2.1, 128, None),
    "regnet_x_32gf": (23, 320, 69.86, 2.0, 168, None),
}


def block_params(name: str) -> BlockParams:
    depth, w_0, w_a, w_m, group_width, se_ratio = _CONFIGS[name]
    return BlockParams.from_init_params(depth, w_0, w_a, w_m, group_width, se_ratio=se_ratio)


def _make_factory(name: str):
    def factory(torch_weights: Optional[str] = None, **kwargs: Any) -> RegNet:
        return maybe_load_state_dict(RegNet(block_params(name), **kwargs), torch_weights)

    factory.__name__ = factory.__qualname__ = name
    factory.__doc__ = f"{name}: its published width schedule."
    return factory


regnet_y_400mf = _make_factory("regnet_y_400mf")
regnet_y_800mf = _make_factory("regnet_y_800mf")
regnet_y_1_6gf = _make_factory("regnet_y_1_6gf")
regnet_y_3_2gf = _make_factory("regnet_y_3_2gf")
regnet_y_8gf = _make_factory("regnet_y_8gf")
regnet_y_16gf = _make_factory("regnet_y_16gf")
regnet_y_32gf = _make_factory("regnet_y_32gf")
regnet_y_128gf = _make_factory("regnet_y_128gf")
regnet_x_400mf = _make_factory("regnet_x_400mf")
regnet_x_800mf = _make_factory("regnet_x_800mf")
regnet_x_1_6gf = _make_factory("regnet_x_1_6gf")
regnet_x_3_2gf = _make_factory("regnet_x_3_2gf")
regnet_x_8gf = _make_factory("regnet_x_8gf")
regnet_x_16gf = _make_factory("regnet_x_16gf")
regnet_x_32gf = _make_factory("regnet_x_32gf")
