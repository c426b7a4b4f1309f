"""2-D convolution on NHWC tensors (eqxvision_tpu/nn/conv.py), as far as
``PatchEmbed`` needs it: kernel size and stride, no padding, dilation or
groups yet.

The public layout stays the JAX package's, (N, H, W, C) in and out; the
weight is torch's OIHW, (out, in, kh, kw). A contiguous NHWC tensor seen
through ``permute(0, 3, 1, 2)`` is torch's channels-last layout, so the
convolution needs no copy.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn

from ..core import init


def _pair(v: Union[int, Sequence[int]]) -> Tuple[int, int]:
    if isinstance(v, int):
        return (v, v)
    a, b = v
    return (int(a), int(b))


class Conv2d(nn.Module):
    def __init__(
        self,
        in_channels: int,
        out_channels: int,
        kernel_size: Union[int, Sequence[int]],
        stride: Union[int, Sequence[int]] = 1,
        use_bias: bool = True,
        *,
        generator: torch.Generator,
        device: Optional[torch.device] = None,
    ):
        super().__init__()
        self.in_channels = int(in_channels)
        self.out_channels = int(out_channels)
        self.kernel_size = _pair(kernel_size)
        self.stride = _pair(stride)
        fan_in = in_channels * self.kernel_size[0] * self.kernel_size[1]
        kw = dict(generator=generator, device=device)
        self.weight = nn.Parameter(init.kaiming_uniform((out_channels, in_channels, *self.kernel_size), fan_in, **kw))
        self.bias = nn.Parameter(init.uniform_fan_in((out_channels,), fan_in, **kw)) if use_bias else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        bias = None if self.bias is None else self.bias.to(x.dtype)
        y = F.conv2d(x.permute(0, 3, 1, 2), self.weight.to(x.dtype), bias, self.stride)
        return y.permute(0, 2, 3, 1)
