"""DeepLabV3 semantic segmentation (eqxvision_tpu/models/segmentation/deeplabv3.py).

``DeepLabHead``: ``ASPP`` (a 1x1 branch, three ``ASPPConv`` at atrous
rates 12, 24 and 36, and ``ASPPPooling``, concatenated on the channel axis,
then the projection with Dropout 0.5), a 3x3 conv, BatchNorm, ReLU and the
1x1 classifier. ``ASPPPooling`` is torchvision's ``nn.Sequential``
(adaptive average pool to 1 x 1, conv, BatchNorm, ReLU), so its keys are
``convs.4.1.weight`` and ``convs.4.2.*``; its 1 x 1 result is broadcast
back over the map, which equals the JAX module's broadcast and
torchvision's bilinear resize of a 1 x 1 map. The aux head is an
``FCNHead``. In training mode at batch 1 torch's ``F.batch_norm`` would
refuse the pooled map's one value per channel, but the port's training
BatchNorm computes its own statistics and takes it, as the JAX one does.
No kernel of the port runs here.
"""
from __future__ import annotations

from typing import Callable, Optional, Sequence, Union

import torch
from torch import nn

from ... import nn as N
from ._utils import _SimpleSegmentationModel
from .fcn import FCNHead, _build_simple_seg


class DeepLabV3(_SimpleSegmentationModel):
    """DeepLabV3."""


class ASPPConv(nn.Sequential):
    def __init__(self, in_channels, out_channels, dilation, *, generator, device=None):
        super().__init__(
            N.Conv2d(in_channels, out_channels, 3, padding=dilation, dilation=dilation, use_bias=False,
                     generator=generator, device=device),
            N.BatchNorm(out_channels, device=device),
            nn.ReLU(),
        )


class ASPPPooling(nn.Sequential):
    def __init__(self, in_channels, out_channels, *, generator, device=None):
        super().__init__(
            N.AdaptiveAvgPool2d(1),
            N.Conv2d(in_channels, out_channels, 1, use_bias=False, generator=generator, device=device),
            N.BatchNorm(out_channels, device=device),
            nn.ReLU(),
        )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        s = super().forward(x)
        return s.expand(x.shape[0], x.shape[1], x.shape[2], s.shape[-1])


class ASPP(nn.Module):
    def __init__(self, in_channels: int, atrous_rates: Sequence[int], out_channels: int = 256, *, generator,
                 device=None):
        super().__init__()
        kw = dict(generator=generator, device=device)
        branches = [nn.Sequential(
            N.Conv2d(in_channels, out_channels, 1, use_bias=False, **kw),
            N.BatchNorm(out_channels, device=device),
            nn.ReLU(),
        )]
        branches += [ASPPConv(in_channels, out_channels, rate, **kw) for rate in atrous_rates]
        branches.append(ASPPPooling(in_channels, out_channels, **kw))
        self.convs = nn.ModuleList(branches)
        self.project = nn.Sequential(
            N.Conv2d(len(branches) * out_channels, out_channels, 1, use_bias=False, **kw),
            N.BatchNorm(out_channels, device=device),
            nn.ReLU(),
            N.Dropout(0.5),
        )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.project(torch.cat([branch(x) for branch in self.convs], dim=-1))


class DeepLabHead(nn.Sequential):
    def __init__(self, in_channels: int, out_channels: int, *, generator, device=None):
        kw = dict(generator=generator, device=device)
        super().__init__(
            ASPP(in_channels, [12, 24, 36], **kw),
            N.Conv2d(256, 256, 3, padding=1, use_bias=False, **kw),
            N.BatchNorm(256, device=device),
            nn.ReLU(),
            N.Conv2d(256, out_channels, 1, **kw),
        )


def deeplabv3(
    num_classes: Optional[int] = 21,
    backbone: Optional[nn.Module] = None,
    intermediate_layers: Optional[Callable] = None,
    classifier_module: Optional[Callable] = None,
    classifier_in_channels: int = 2048,
    aux_in_channels: Optional[int] = None,
    silence_layers: Optional[Callable] = None,
    torch_weights: Optional[str] = None,
    *,
    generator: Optional[torch.Generator] = None,
    device: Union[str, torch.device] = "cuda",
) -> DeepLabV3:
    """DeepLabV3; the contract of ``fcn``, with a ``DeepLabHead`` and an
    ``FCNHead`` as the aux head."""
    return _build_simple_seg(
        DeepLabV3, DeepLabHead, num_classes, backbone, intermediate_layers, classifier_module,
        classifier_in_channels, aux_in_channels, silence_layers, torch_weights, generator, device,
        aux_module=FCNHead,
    )
