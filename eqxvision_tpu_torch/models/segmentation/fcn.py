"""FCN semantic segmentation (eqxvision_tpu/models/segmentation/fcn.py).

``FCNHead`` is torchvision's ``nn.Sequential``: 3x3 conv (no bias),
BatchNorm, ReLU, Dropout 0.1, 1x1 conv (indices 0-4). ``_build_simple_seg``
is the JAX factories' contract, shared with DeepLabV3: the default backbone
is a ResNet-50 with ``replace_stride_with_dilation=[False, True, True]``,
the default taps ``[layer3, layer4]``, ``silence_layers`` (default the
``fc``) becomes ``nn.Identity``, and the tap count must be 2 with an aux
head and 1 without, else ``ValueError``: ``fcn()`` with no arguments
raises, as the JAX one does. No kernel of the port runs here.
"""
from __future__ import annotations

from typing import Callable, Optional, Union

import torch
from torch import nn

from ... import nn as N
from ...experimental import intermediate_layer_getter
from ..classification.resnet import resnet50
from .._common import default_generator, maybe_load_state_dict, resolve_device
from ._utils import _SimpleSegmentationModel


class FCN(_SimpleSegmentationModel):
    """Fully Convolutional Network."""


class FCNHead(nn.Sequential):
    def __init__(self, in_channels: int, out_channels: int, *, generator: torch.Generator, device=None):
        kw = dict(generator=generator, device=device)
        inter_channels = in_channels // 4
        super().__init__(
            N.Conv2d(in_channels, inter_channels, 3, padding=1, use_bias=False, **kw),
            N.BatchNorm(inter_channels, device=device),
            nn.ReLU(),
            N.Dropout(0.1),
            N.Conv2d(inter_channels, out_channels, 1, **kw),
        )


def _replace_module(model: nn.Module, target: nn.Module, new: nn.Module) -> None:
    """Put ``new`` in ``target``'s slot of ``model`` (found by identity)."""
    for parent in model.modules():
        for name, child in parent.named_children():
            if child is target:
                setattr(parent, name, new)
                return
    raise ValueError("target layer not found in model")


def _build_simple_seg(
    model_cls,
    head_cls,
    num_classes,
    backbone,
    intermediate_layers,
    classifier_module,
    classifier_in_channels,
    aux_in_channels,
    silence_layers,
    torch_weights,
    generator,
    device,
    aux_module: Optional[Callable] = None,
):
    kw = dict(generator=default_generator(generator), device=resolve_device(device))
    classifier_module = head_cls if classifier_module is None else classifier_module
    aux_module = FCNHead if aux_module is None else aux_module
    if backbone is None:
        backbone = resnet50(replace_stride_with_dilation=[False, True, True], **kw)
    if intermediate_layers is None:
        intermediate_layers = lambda m: [m.layer3, m.layer4]  # noqa: E731

    num_layers = len(intermediate_layers(backbone))
    if aux_in_channels is not None and num_layers != 2:
        raise ValueError(
            "aux_in_channels requires the intermediate_layers to return exactly "
            "2 layers corresponding to aux and final."
        )
    if aux_in_channels is None and num_layers != 1:
        raise ValueError(
            f"With no aux_in_channels, the aux layer is disabled. Received "
            f"{num_layers} from intermediate_layers, expected number of layers is 1."
        )
    if silence_layers is None:
        silence_layers = lambda m: m.fc  # noqa: E731
    _replace_module(backbone, silence_layers(backbone), nn.Identity())
    backbone = intermediate_layer_getter(backbone, intermediate_layers)

    classifier = classifier_module(in_channels=classifier_in_channels, out_channels=num_classes, **kw)
    aux_classifier = None
    if aux_in_channels is not None:
        aux_classifier = aux_module(in_channels=aux_in_channels, out_channels=num_classes, **kw)
    return maybe_load_state_dict(model_cls(backbone, classifier, aux_classifier), torch_weights)


def fcn(
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
) -> FCN:
    """FCN; the default backbone is a dilated ResNet-50 tapped at layer3
    and layer4 (pass ``aux_in_channels=1024`` for the aux head)."""
    return _build_simple_seg(
        FCN, FCNHead, num_classes, backbone, intermediate_layers, classifier_module, classifier_in_channels,
        aux_in_channels, silence_layers, torch_weights, generator, device,
    )
