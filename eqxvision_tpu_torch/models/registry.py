"""Model registry: ``create_model("vit_base")`` over the ported factories,
the JAX registry's 74 (eqxvision_tpu/models/registry.py): 71 classifiers
and the three segmentation models. Returns the ``nn.Module``, built on the
card unless ``device=`` names another device."""
from __future__ import annotations

from typing import Any, Callable, Dict, List

from torch import nn

from . import classification as C
from . import segmentation as S

_NAMES = (
    "alexnet",
    "convnext_base",
    "convnext_large",
    "convnext_small",
    "convnext_tiny",
    "densenet121",
    "densenet161",
    "densenet169",
    "densenet201",
    "efficientnet_b0",
    "efficientnet_b1",
    "efficientnet_b2",
    "efficientnet_b3",
    "efficientnet_b4",
    "efficientnet_b5",
    "efficientnet_b6",
    "efficientnet_b7",
    "efficientnet_v2_l",
    "efficientnet_v2_m",
    "efficientnet_v2_s",
    "googlenet",
    "mobilenet_v2",
    "mobilenet_v3_large",
    "mobilenet_v3_small",
    "regnet_x_16gf",
    "regnet_x_1_6gf",
    "regnet_x_32gf",
    "regnet_x_3_2gf",
    "regnet_x_400mf",
    "regnet_x_800mf",
    "regnet_x_8gf",
    "regnet_y_128gf",
    "regnet_y_16gf",
    "regnet_y_1_6gf",
    "regnet_y_32gf",
    "regnet_y_3_2gf",
    "regnet_y_400mf",
    "regnet_y_800mf",
    "regnet_y_8gf",
    "resnet101",
    "resnet152",
    "resnet18",
    "resnet34",
    "resnet50",
    "resnext101_32x8d",
    "resnext50_32x4d",
    "shufflenet_v2_x0_5",
    "shufflenet_v2_x1_0",
    "shufflenet_v2_x1_5",
    "shufflenet_v2_x2_0",
    "squeezenet1_0",
    "squeezenet1_1",
    "swin_b",
    "swin_s",
    "swin_t",
    "swin_v2_b",
    "swin_v2_s",
    "swin_v2_t",
    "vgg11",
    "vgg11_bn",
    "vgg13",
    "vgg13_bn",
    "vgg16",
    "vgg16_bn",
    "vgg19",
    "vgg19_bn",
    "vit_base",
    "vit_small",
    "vit_tiny",
    "wide_resnet101_2",
    "wide_resnet50_2",
)
_SEGMENTATION = ("deeplabv3", "fcn", "lraspp_mobilenet_v3_large")
_REGISTRY: Dict[str, Callable[..., nn.Module]] = {name: getattr(C, name) for name in _NAMES}
_REGISTRY.update({name: getattr(S, name) for name in _SEGMENTATION})


def list_models() -> List[str]:
    return sorted(_REGISTRY)


def create_model(name: str, pretrained: bool = False, **kwargs: Any) -> nn.Module:
    """Build a model by name. Factory keywords pass through, including
    ``generator=``, ``device=`` and ``torch_weights=<local state_dict file>``."""
    if name not in _REGISTRY:
        raise ValueError(f"unknown model {name!r}; see list_models()")
    if pretrained:
        raise NotImplementedError(
            "pretrained=True needs the checkpoint URL registry, which is not ported yet; "
            "pass torch_weights=<path to a local state_dict file> instead"
        )
    return _REGISTRY[name](**kwargs)
