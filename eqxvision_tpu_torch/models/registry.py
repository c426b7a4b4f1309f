"""Model registry: ``create_model("vit_base")`` over the ported factories
(eqxvision_tpu/models/registry.py). Returns the ``nn.Module``, built on the
card unless ``device=`` names another device."""
from __future__ import annotations

from typing import Any, Callable, Dict, List

from torch import nn

from .classification import (
    convnext_base,
    convnext_large,
    convnext_small,
    convnext_tiny,
    swin_b,
    swin_s,
    swin_t,
    swin_v2_b,
    swin_v2_s,
    swin_v2_t,
    vit_base,
    vit_small,
    vit_tiny,
)

_REGISTRY: Dict[str, Callable[..., nn.Module]] = {
    "convnext_base": convnext_base,
    "convnext_large": convnext_large,
    "convnext_small": convnext_small,
    "convnext_tiny": convnext_tiny,
    "swin_b": swin_b,
    "swin_s": swin_s,
    "swin_t": swin_t,
    "swin_v2_b": swin_v2_b,
    "swin_v2_s": swin_v2_s,
    "swin_v2_t": swin_v2_t,
    "vit_base": vit_base,
    "vit_small": vit_small,
    "vit_tiny": vit_tiny,
}


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
