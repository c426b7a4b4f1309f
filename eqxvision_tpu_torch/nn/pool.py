"""Pooling layers on NHWC tensors (eqxvision_tpu/nn/pool.py).

Each runs torch's pooling op on the channels-last view ``permute(0, 3, 1,
2)``, which needs no copy, and has the JAX layer's geometry: torch's own
``ceil_mode`` rule (a window that would start in the bottom or right padding
is dropped), -inf padding for the max, ``count_include_pad`` for the mean,
whose divisor under ceil mode counts only the positions inside the input
and its declared padding, and adaptive bins ``[floor(i S / O), ceil((i + 1)
S / O))``. The means accumulate a bf16 input in f32 and round once.
torch's ops take a padding of at most half the kernel (no model of the
zoo pads more); a wider one raises where the layer is built.
"""
from __future__ import annotations

from typing import Sequence, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn


def _pair(v: Union[int, Sequence[int]]) -> Tuple[int, int]:
    if isinstance(v, int):
        return (v, v)
    a, b = v
    return (int(a), int(b))


def _checked_padding(padding, kernel_size) -> Tuple[int, int]:
    padding = _pair(padding)
    if any(p > k // 2 for p, k in zip(padding, kernel_size)):
        raise ValueError(f"padding {padding} exceeds half the kernel {kernel_size}, which torch's pooling refuses")
    return padding


def _nchw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 3, 1, 2)


def _nhwc(y: torch.Tensor) -> torch.Tensor:
    return y.permute(0, 2, 3, 1)


class MaxPool2d(nn.Module):
    def __init__(self, kernel_size, stride=None, padding=0, dilation=1, use_ceil: bool = False, ceil_mode: bool = None):
        super().__init__()
        self.kernel_size = _pair(kernel_size)
        self.stride = _pair(stride if stride is not None else kernel_size)
        self.padding = _checked_padding(padding, self.kernel_size)
        self.dilation = _pair(dilation)
        self.use_ceil = bool(use_ceil if ceil_mode is None else ceil_mode)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.max_pool2d(_nchw(x), self.kernel_size, self.stride, self.padding, self.dilation, self.use_ceil)
        return _nhwc(y)


class AvgPool2d(nn.Module):
    """``count_include_pad=True`` (torch's default)."""

    def __init__(self, kernel_size, stride=None, padding=0, use_ceil: bool = False, ceil_mode: bool = None):
        super().__init__()
        self.kernel_size = _pair(kernel_size)
        self.stride = _pair(stride if stride is not None else kernel_size)
        self.padding = _checked_padding(padding, self.kernel_size)
        self.use_ceil = bool(use_ceil if ceil_mode is None else ceil_mode)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.avg_pool2d(_nchw(x), self.kernel_size, self.stride, self.padding, self.use_ceil, True)
        return _nhwc(y)


def adaptive_avg_pool2d(x: torch.Tensor, output_size) -> torch.Tensor:
    """torch.nn.AdaptiveAvgPool2d on an (N, H, W, C) input."""
    return _nhwc(F.adaptive_avg_pool2d(_nchw(x), _pair(output_size)))


class AdaptiveAvgPool2d(nn.Module):
    def __init__(self, output_size):
        super().__init__()
        self.output_size = _pair(output_size)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return adaptive_avg_pool2d(x, self.output_size)


class AdaptiveMaxPool2d(nn.Module):
    def __init__(self, output_size):
        super().__init__()
        self.output_size = _pair(output_size)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return _nhwc(F.adaptive_max_pool2d(_nchw(x), self.output_size))
