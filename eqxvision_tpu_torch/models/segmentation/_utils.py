"""Bilinear resize and the generic segmentation model
(eqxvision_tpu/models/segmentation/_utils.py).

``resize_bilinear`` is ``F.interpolate(mode="bilinear",
align_corners=False)`` on the NCHW view of an NHWC map: half-pixel
centres, as ``jax.image.resize(method="bilinear")``. The JAX function
antialiases where it shrinks an axis (its kernel widens by the scale), and
``F.interpolate`` does so only with ``antialias=True``, so that is passed
whenever either side shrinks; where both grow the two agree without it.
Every path of the zoo upsamples.

``_SimpleSegmentationModel`` returns ``(aux or None, out)``, both NHWC and
resized to the input's size; the JAX model returns the same pair beside
its ``State``.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from .._common import debatch, ensure_nhwc


def resize_bilinear(x: torch.Tensor, height: int, width: int) -> torch.Tensor:
    """(N, H, W, C) -> (N, height, width, C), bilinear, half-pixel centres;
    antialiased where an axis shrinks, in f32 for a narrower input (torch's
    antialiased kernel takes no bf16 on the CPU) and rounded once."""
    if height < x.shape[1] or width < x.shape[2]:
        y = F.interpolate(x.permute(0, 3, 1, 2).float(), size=(height, width), mode="bilinear",
                          align_corners=False, antialias=True)
        return y.permute(0, 2, 3, 1).to(x.dtype)
    y = F.interpolate(x.permute(0, 3, 1, 2), size=(height, width), mode="bilinear", align_corners=False)
    return y.permute(0, 2, 3, 1)


class _SimpleSegmentationModel(nn.Module):
    def __init__(self, backbone: nn.Module, classifier: nn.Module, aux_classifier: Optional[nn.Module] = None):
        super().__init__()
        self.backbone = backbone  # an IntermediateLayerGetter
        self.classifier = classifier
        self.aux_classifier = aux_classifier

    def forward(self, x: torch.Tensor):
        x, single = ensure_nhwc(x)
        _, xs = self.backbone(x)
        out = resize_bilinear(self.classifier(xs[-1]), x.shape[1], x.shape[2])
        aux = None
        if self.aux_classifier is not None:
            aux = resize_bilinear(self.aux_classifier(xs[0]), x.shape[1], x.shape[2])
        return debatch((aux, out), single)
