"""Pooling layers on NHWC tensors (eqxvision_tpu/nn/pool.py).

Each runs torch's pooling op on the channels-last view ``permute(0, 3, 1,
2)``, which needs no copy, and has the JAX layer's geometry: torch's own
``ceil_mode`` rule (a window that would start in the bottom or right padding
is dropped), -inf padding for the max, ``count_include_pad`` for the mean,
whose divisor under ceil mode counts only the positions inside the input
and its declared padding, and adaptive bins ``[floor(i S / O), ceil((i + 1)
S / O))``. The means accumulate a bf16 input in f32 and round once.
torch's ops take a padding of at most half the kernel (every model of the
zoo pads less). A wider one is padded explicitly, as the JAX layer's
``reduce_window`` pads: by the declared padding before and by what the
geometry needs after (``_pool_padding``, the JAX function), with -inf for
the max and zeros for the mean, whose divisor is the kernel's area, or
under ceil mode the positions inside the input and its declared padding;
the pool itself then runs unpadded.
"""
from __future__ import annotations

from typing import Sequence, Tuple, Union

import math

import torch
import torch.nn.functional as F
from torch import nn


def _pair(v: Union[int, Sequence[int]]) -> Tuple[int, int]:
    if isinstance(v, int):
        return (v, v)
    a, b = v
    return (int(a), int(b))


def _wide(padding, kernel_size) -> bool:
    """A padding past half the kernel, which torch's pooling refuses."""
    return any(p > k // 2 for p, k in zip(padding, kernel_size))


def _pool_padding(in_size: int, k: int, s: int, p: int, d: int, ceil_mode: bool) -> Tuple[int, int]:
    """(before, after) padding of one axis that gives torch's pooling
    geometry with an unpadded pool: ``p`` before, after what the last
    window needs (under ceil mode, one that starts in the padding is
    dropped)."""
    ek = (k - 1) * d + 1  # the window's extent
    if ceil_mode:
        out = math.ceil((in_size + 2 * p - ek) / s) + 1
        if (out - 1) * s >= in_size + p:
            out -= 1
    else:
        out = math.floor((in_size + 2 * p - ek) / s) + 1
    return (p, max((out - 1) * s + ek - in_size - p, 0))


def _padded(x: torch.Tensor, kernel, stride, padding, dilation, ceil_mode, value: float):
    """NCHW ``x`` padded explicitly with ``value``; and the (before, after)
    paddings of H and W."""
    pad_h, pad_w = (_pool_padding(x.shape[2 + i], kernel[i], stride[i], padding[i], dilation[i], ceil_mode)
                    for i in range(2))
    return F.pad(x, (*pad_w, *pad_h), value=value), pad_h, pad_w


def _nchw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 3, 1, 2)


def _nhwc(y: torch.Tensor) -> torch.Tensor:
    return y.permute(0, 2, 3, 1)


class MaxPool2d(nn.Module):
    def __init__(self, kernel_size, stride=None, padding=0, dilation=1, use_ceil: bool = False, ceil_mode: bool = None):
        super().__init__()
        self.kernel_size = _pair(kernel_size)
        self.stride = _pair(stride if stride is not None else kernel_size)
        self.padding = _pair(padding)
        self.dilation = _pair(dilation)
        self.use_ceil = bool(use_ceil if ceil_mode is None else ceil_mode)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not _wide(self.padding, self.kernel_size):
            return _nhwc(F.max_pool2d(_nchw(x), self.kernel_size, self.stride, self.padding, self.dilation,
                                      self.use_ceil))
        xp, _, _ = _padded(_nchw(x), self.kernel_size, self.stride, self.padding, self.dilation, self.use_ceil,
                           -math.inf)
        return _nhwc(F.max_pool2d(xp, self.kernel_size, self.stride, 0, self.dilation))


class AvgPool2d(nn.Module):
    """``count_include_pad=True`` (torch's default)."""

    def __init__(self, kernel_size, stride=None, padding=0, use_ceil: bool = False, ceil_mode: bool = None):
        super().__init__()
        self.kernel_size = _pair(kernel_size)
        self.stride = _pair(stride if stride is not None else kernel_size)
        self.padding = _pair(padding)
        self.use_ceil = bool(use_ceil if ceil_mode is None else ceil_mode)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not _wide(self.padding, self.kernel_size):
            return _nhwc(F.avg_pool2d(_nchw(x), self.kernel_size, self.stride, self.padding, self.use_ceil, True))
        (kh, kw), (ph, pw) = self.kernel_size, self.padding
        xp, pad_h, pad_w = _padded(_nchw(x).float(), self.kernel_size, self.stride, self.padding, (1, 1),
                                   self.use_ceil, 0.0)
        summed = F.avg_pool2d(xp, self.kernel_size, self.stride, divisor_override=1)
        if self.use_ceil and (pad_h[1] > ph or pad_w[1] > pw):
            # the divisor counts the positions inside the input and its declared padding
            inside = F.pad(torch.ones((1, 1, x.shape[1] + 2 * ph, x.shape[2] + 2 * pw), device=x.device),
                           (0, pad_w[1] - pw, 0, pad_h[1] - ph))
            y = summed / F.avg_pool2d(inside, self.kernel_size, self.stride, divisor_override=1)
        else:
            y = summed / (kh * kw)
        return _nhwc(y).to(x.dtype)


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
