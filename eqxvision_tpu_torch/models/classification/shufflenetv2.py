"""ShuffleNetV2 x0.5/x1.0/x1.5/x2.0, NHWC batched
(eqxvision_tpu/models/classification/shufflenetv2.py).

torchvision's module tree and state-dict names: ``conv1`` (conv, BatchNorm,
ReLU), ``maxpool``, ``stage2``-``stage4`` of ``_InvertedResidual`` blocks
(``branch1`` and ``branch2`` ``nn.Sequential``s), ``conv5``, ``fc``. A
stride-1 block splits the channels in half and concatenates ``[x1,
branch2(x2)]``, a stride-2 block ``[branch1(x), branch2(x)]``; the channel
shuffle then works on the last axis of the NHWC map. ``x2`` is a strided
view of the map: seen as NCHW it keeps channels-last strides, so cuDNN
copies it into a channels-last tensor and takes its channels-last kernels.
No kernel of the port runs here.
"""
from __future__ import annotations

from typing import Any, List, Optional, Union

import torch
from torch import nn

from ...nn import BatchNorm, Conv2d, Linear, MaxPool2d
from .._common import debatch, default_generator, ensure_nhwc, maybe_load_state_dict, resolve_device


def channel_shuffle(x: torch.Tensor, groups: int) -> torch.Tensor:
    """Shuffle the last (channel) axis: (..., groups, C // groups), the
    last two axes swapped, back to (..., C)."""
    *lead, c = x.shape
    return x.reshape(*lead, groups, c // groups).transpose(-1, -2).reshape(*lead, c)


class _InvertedResidual(nn.Module):
    def __init__(self, inp, oup, stride, *, generator, device=None):
        super().__init__()
        if stride not in (1, 2):
            raise ValueError("illegal stride value")
        self.stride = stride
        branch_features = oup // 2
        if stride == 1 and inp != branch_features * 2:
            raise ValueError("invalid inp/oup for stride 1")
        kw = dict(generator=generator, device=device)
        if stride > 1:
            self.branch1 = nn.Sequential(
                Conv2d(inp, inp, 3, stride=stride, padding=1, groups=inp, use_bias=False, **kw),
                BatchNorm(inp, device=device),
                Conv2d(inp, branch_features, 1, use_bias=False, **kw),
                BatchNorm(branch_features, device=device),
                nn.ReLU(),
            )
        else:
            self.branch1 = nn.Sequential()
        self.branch2 = nn.Sequential(
            Conv2d(inp if stride > 1 else branch_features, branch_features, 1, use_bias=False, **kw),
            BatchNorm(branch_features, device=device),
            nn.ReLU(),
            Conv2d(branch_features, branch_features, 3, stride=stride, padding=1, groups=branch_features,
                   use_bias=False, **kw),
            BatchNorm(branch_features, device=device),
            Conv2d(branch_features, branch_features, 1, use_bias=False, **kw),
            BatchNorm(branch_features, device=device),
            nn.ReLU(),
        )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.stride == 1:
            x1, x2 = x.chunk(2, dim=-1)
            out = torch.cat([x1, self.branch2(x2)], dim=-1)
        else:
            out = torch.cat([self.branch1(x), self.branch2(x)], dim=-1)
        return channel_shuffle(out, 2)


class ShuffleNetV2(nn.Module):
    def __init__(
        self,
        stages_repeats: List[int],
        stages_out_channels: List[int],
        num_classes: int = 1000,
        *,
        generator: Optional[torch.Generator] = None,
        device: Union[str, torch.device] = "cuda",
    ):
        super().__init__()
        if len(stages_repeats) != 3:
            raise ValueError("expected stages_repeats as list of 3 positive ints")
        if len(stages_out_channels) != 5:
            raise ValueError("expected stages_out_channels as list of 5 positive ints")
        kw = dict(generator=default_generator(generator), device=resolve_device(device))
        device = kw["device"]
        input_channels = stages_out_channels[0]
        self.conv1 = nn.Sequential(
            Conv2d(3, input_channels, 3, 2, 1, use_bias=False, **kw), BatchNorm(input_channels, device=device),
            nn.ReLU(),
        )
        self.maxpool = MaxPool2d(3, 2, 1)
        for i, (repeats, output_channels) in enumerate(zip(stages_repeats, stages_out_channels[1:4])):
            seq = [_InvertedResidual(input_channels, output_channels, 2, **kw)]
            seq += [_InvertedResidual(output_channels, output_channels, 1, **kw) for _ in range(repeats - 1)]
            setattr(self, f"stage{i + 2}", nn.Sequential(*seq))
            input_channels = output_channels
        output_channels = stages_out_channels[-1]
        self.conv5 = nn.Sequential(
            Conv2d(input_channels, output_channels, 1, use_bias=False, **kw), BatchNorm(output_channels, device=device),
            nn.ReLU(),
        )
        self.fc = Linear(output_channels, num_classes, **kw)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x, single = ensure_nhwc(x)
        x = self.maxpool(self.conv1(x))
        x = self.conv5(self.stage4(self.stage3(self.stage2(x))))
        return debatch(self.fc(x.mean((1, 2))), single)


def _shufflenet(repeats, channels, torch_weights, **kwargs) -> ShuffleNetV2:
    return maybe_load_state_dict(ShuffleNetV2(repeats, channels, **kwargs), torch_weights)


def shufflenet_v2_x0_5(torch_weights: Optional[str] = None, **kwargs: Any) -> ShuffleNetV2:
    return _shufflenet([4, 8, 4], [24, 48, 96, 192, 1024], torch_weights, **kwargs)


def shufflenet_v2_x1_0(torch_weights: Optional[str] = None, **kwargs: Any) -> ShuffleNetV2:
    return _shufflenet([4, 8, 4], [24, 116, 232, 464, 1024], torch_weights, **kwargs)


def shufflenet_v2_x1_5(torch_weights: Optional[str] = None, **kwargs: Any) -> ShuffleNetV2:
    return _shufflenet([4, 8, 4], [24, 176, 352, 704, 1024], torch_weights, **kwargs)


def shufflenet_v2_x2_0(torch_weights: Optional[str] = None, **kwargs: Any) -> ShuffleNetV2:
    return _shufflenet([4, 8, 4], [24, 244, 488, 976, 2048], torch_weights, **kwargs)
