"""Flatten NHWC maps in torch's CHW order (eqxvision_tpu/nn/flatten.py).

A torchvision classifier's first Linear reads (C, H, W) features flattened
channel-major: AlexNet's 256 x 6 x 6 and VGG's 512 x 7 x 7. The maps here
are NHWC, so they are seen as NCHW before the flatten, and a checkpoint's
Linear weight applies unchanged.
"""
from __future__ import annotations

import torch
from torch import nn


def flatten_chw(x: torch.Tensor) -> torch.Tensor:
    """(N, H, W, C) -> (N, C * H * W), flattened in CHW order."""
    return x.permute(0, 3, 1, 2).reshape(x.shape[0], -1)


class FlattenCHW(nn.Module):
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return flatten_chw(x)
