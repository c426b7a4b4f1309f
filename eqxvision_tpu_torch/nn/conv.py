"""2-D convolution on NHWC tensors (eqxvision_tpu/nn/conv.py).

The public layout stays the JAX package's, (N, H, W, C) in and out; the
weight is torch's OIHW, (out, in // groups, kh, kw). A contiguous NHWC
tensor seen through ``permute(0, 3, 1, 2)`` is torch's channels-last
layout, so the convolution needs no copy. Padding takes the JAX layer's
forms: an int, a pair (one per spatial dim, both sides), or a pair of
(before, after) pairs; uneven sides are padded with ``F.pad`` first. As in
the JAX layer, ``EQXVISION_TPU_S2D_STEM=1`` sends a stride-2 convolution of
at most 4 input channels with even padding through the exact
space-to-depth rewrite (``ops.space_to_depth``), opt-in. The bias is added, in its stored type, to the f32 accumulator,
which is rounded once: one call where the bias has the input's type, else
(f32 parameters and a bf16 input) the convolution runs in f32 on the upcast
operands, which holds every product exactly, and is rounded after the bias.
A bf16 input with bf16 parameters takes that one call, and on the card
cuDNN rounds the convolution's output before it adds the bias, so such an
output is rounded twice (a step or so off the JAX layer's on 8-21% of
outputs). Widening those convolutions too would cost convnext_tiny's bf16
forward most of its depthwise convolutions' speed; ROADMAP C.9 records the
choice and its measurements.
"""
from __future__ import annotations

import os
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


def _pad_pairs(padding) -> Tuple[Tuple[int, int], Tuple[int, int]]:
    if isinstance(padding, int):
        return ((padding, padding), (padding, padding))
    if len(padding) == 2 and all(isinstance(p, int) for p in padding):
        return ((padding[0], padding[0]), (padding[1], padding[1]))
    (a, b), (c, d) = padding
    return ((int(a), int(b)), (int(c), int(d)))


class Conv2d(nn.Module):
    def __init__(
        self,
        in_channels: int,
        out_channels: int,
        kernel_size: Union[int, Sequence[int]],
        stride: Union[int, Sequence[int]] = 1,
        padding=0,
        dilation: Union[int, Sequence[int]] = 1,
        groups: int = 1,
        use_bias: bool = True,
        *,
        generator: torch.Generator,
        device: Optional[torch.device] = None,
    ):
        super().__init__()
        if in_channels % groups or out_channels % groups:
            raise ValueError("channels must be divisible by groups")
        self.in_channels = int(in_channels)
        self.out_channels = int(out_channels)
        self.kernel_size = _pair(kernel_size)
        self.stride = _pair(stride)
        self.padding = _pad_pairs(padding)
        self.dilation = _pair(dilation)
        self.groups = int(groups)
        fan_in = in_channels // groups * self.kernel_size[0] * self.kernel_size[1]
        kw = dict(generator=generator, device=device)
        self.weight = nn.Parameter(
            init.kaiming_uniform((out_channels, in_channels // groups, *self.kernel_size), fan_in, **kw)
        )
        self.bias = nn.Parameter(init.uniform_fan_in((out_channels,), fan_in, **kw)) if use_bias else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if (
            self.stride == (2, 2)
            and self.groups == 1
            and self.dilation == (1, 1)
            and os.environ.get("EQXVISION_TPU_S2D_STEM") == "1"
        ):
            from ..ops import space_to_depth as s2d  # lazy: ops imports nn

            if s2d.applicable(self.in_channels, self.stride, self.kernel_size, self.padding):
                return s2d.conv2d_stride2_s2d(x, self.weight, self.bias, self.padding)
        dt = x.dtype
        w, bias = self.weight.to(dt), self.bias
        if bias is not None and bias.dtype != dt:
            wide = torch.promote_types(dt, torch.float32)
            x, w, bias = x.to(wide), w.to(wide), bias.to(wide)
        return conv2d_nhwc(x, w, bias, self.stride, self.padding, self.dilation, self.groups).to(dt)


def conv2d_nhwc(x, w, bias, stride, padding, dilation, groups) -> torch.Tensor:
    """``F.conv2d`` on NHWC ``x`` with an OIHW ``w`` and ``padding`` as
    (before, after) pairs, in the operands' type; the output is NHWC."""
    (top, bottom), (left, right) = padding
    if top == bottom and left == right:
        pad = (top, left)
    else:  # uneven sides: pad H and W of the NHWC tensor, then convolve unpadded
        x = F.pad(x, (0, 0, left, right, top, bottom))
        pad = (0, 0)
    return F.conv2d(x.permute(0, 3, 1, 2), w, bias, stride, pad, dilation, groups).permute(0, 2, 3, 1)
