"""Bilinear resize and the generic segmentation model
(eqxvision_tpu/models/segmentation/_utils.py).

``resize_bilinear`` lives in ``ops.preprocessing``, which the eval
pipeline shares; it is re-exported here, where the JAX package has it.

``_SimpleSegmentationModel`` returns ``(aux or None, out)``, both NHWC and
resized to the input's size; the JAX model returns the same pair beside
its ``State``.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ...ops.preprocessing import resize_bilinear
from .._common import debatch, ensure_nhwc


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
