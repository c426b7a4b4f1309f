"""ConvNeXt Tiny/Small/Base/Large, NHWC batched
(eqxvision_tpu/models/classification/convnext.py).

torchvision's module tree and state-dict names: ``features.0`` the 4x4/4
stem conv and its LayerNorm2d, stages of ``CNBlock``s and LayerNorm2d +
2x2/2 downsampling convs in ``features.1`` ... ``features.7``, and
``classifier.0`` (LayerNorm2d) / ``classifier.2`` (Linear). A block is
``block.0`` the depthwise 7x7 conv, ``block.2`` the LayerNorm, ``block.3``
and ``block.5`` the Linears, with ``layer_scale`` of shape (C, 1, 1). The
activations stay NHWC end to end, so torchvision's ``Permute`` and
``Flatten`` slots hold parameter-free placeholders. A block's LayerNorm,
Linears, GELU, layer scale and residual run as one ``ops.fused_mlp_half``
(the MLP-half kernel on the card); the other LayerNorms run
``ops.layer_norm``; the convolutions are cuDNN and the classifier Linear
cuBLAS, as the JAX package leaves them to XLA.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Optional, Sequence, Union

import torch
from torch import nn

from ...layers import DropPath, LayerNorm2d
from ...nn import Conv2d, LayerNorm, Linear
from ...ops.mlp_half import fused_mlp_half
from .._common import debatch, default_generator, ensure_nhwc, maybe_load_state_dict, resolve_device


@dataclass
class CNBlockConfig:
    input_channels: int
    out_channels: Optional[int]
    num_layers: int


class CNBlock(nn.Module):
    """dwconv 7x7 -> LN -> Linear(C, 4C) -> GELU -> Linear(4C, C), times the
    layer scale, plus the residual. Everything after the depthwise conv is
    one ``ops.fused_mlp_half`` call (the MLP-half kernel on the card), save
    in training with an active stochastic depth, which drops the branch
    before the residual add, and with quantized Linears (``quantize``),
    which are called as in the JAX block: those run the layers one by one."""

    def __init__(self, dim: int, layer_scale: float, stochastic_depth_prob: float, *, generator, device=None):
        super().__init__()
        kw = dict(generator=generator, device=device)
        self.layer_scale = nn.Parameter(torch.full((dim, 1, 1), float(layer_scale), device=device))
        self.block = nn.Sequential(
            Conv2d(dim, dim, 7, padding=3, groups=dim, **kw),
            nn.Identity(),  # torchvision's Permute: the map is NHWC already
            LayerNorm(dim, eps=1e-6, device=device),
            Linear(dim, 4 * dim, **kw),
            nn.GELU(),  # exact GELU; the fused op applies it to fc1's f32 accumulator
            Linear(4 * dim, dim, **kw),
            nn.Identity(),  # torchvision's Permute back
        )
        self.stochastic_depth = DropPath(stochastic_depth_prob)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        norm, fc1, fc2 = self.block[2], self.block[3], self.block[5]
        quantized = not (isinstance(fc1, Linear) and isinstance(fc2, Linear))
        if quantized or self.training and self.stochastic_depth.p > 0.0:
            # the JAX block's order: gelu on fc1's f32 accumulator, rounded once; stochastic
            # depth drops the branch before the residual add
            out = norm(self.block[0](x))
            out = self.block[4](fc1.preactivation(out)).to(out.dtype)
            out = fc2(out) * self.layer_scale.reshape(-1).to(out.dtype)
            return x + self.stochastic_depth(out)
        return fused_mlp_half(
            self.block[0](x), x, norm.weight, norm.bias, fc1.weight, fc1.bias, fc2.weight, fc2.bias,
            self.layer_scale.reshape(-1), norm.eps,
        )


class ConvNeXt(nn.Module):
    def __init__(
        self,
        block_setting: Sequence[CNBlockConfig],
        stochastic_depth_prob: float = 0.0,
        layer_scale: float = 1e-6,
        num_classes: int = 1000,
        *,
        generator: Optional[torch.Generator] = None,
        device: Union[str, torch.device] = "cuda",
    ):
        super().__init__()
        generator = default_generator(generator)
        device = resolve_device(device)
        kw = dict(generator=generator, device=device)
        total_blocks = sum(c.num_layers for c in block_setting)
        first = block_setting[0].input_channels
        layers = [nn.Sequential(Conv2d(3, first, 4, stride=4, **kw), LayerNorm2d(first, eps=1e-6, device=device))]
        block_id = 0
        for cnf in block_setting:
            stage = []
            for _ in range(cnf.num_layers):
                sd_prob = stochastic_depth_prob * block_id / (total_blocks - 1.0)
                stage.append(CNBlock(cnf.input_channels, layer_scale, sd_prob, **kw))
                block_id += 1
            layers.append(nn.Sequential(*stage))
            if cnf.out_channels is not None:
                layers.append(
                    nn.Sequential(
                        LayerNorm2d(cnf.input_channels, eps=1e-6, device=device),
                        Conv2d(cnf.input_channels, cnf.out_channels, 2, stride=2, **kw),
                    )
                )
        self.features = nn.Sequential(*layers)
        last = block_setting[-1].out_channels or block_setting[-1].input_channels
        self.classifier = nn.Sequential(
            LayerNorm2d(last, eps=1e-6, device=device), nn.Flatten(1), Linear(last, num_classes, **kw)
        )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x, single = ensure_nhwc(x)
        x = self.features(x).mean(dim=(1, 2), keepdim=True)  # avgpool to (N, 1, 1, C)
        return debatch(self.classifier(x), single)


def _convnext(block_setting, sd_prob, torch_weights, **kwargs):
    kwargs.setdefault("stochastic_depth_prob", sd_prob)
    return maybe_load_state_dict(ConvNeXt(block_setting, **kwargs), torch_weights)


def convnext_tiny(torch_weights: Optional[str] = None, **kwargs: Any) -> ConvNeXt:
    setting = [CNBlockConfig(96, 192, 3), CNBlockConfig(192, 384, 3), CNBlockConfig(384, 768, 9), CNBlockConfig(768, None, 3)]
    return _convnext(setting, 0.1, torch_weights, **kwargs)


def convnext_small(torch_weights: Optional[str] = None, **kwargs: Any) -> ConvNeXt:
    setting = [CNBlockConfig(96, 192, 3), CNBlockConfig(192, 384, 3), CNBlockConfig(384, 768, 27), CNBlockConfig(768, None, 3)]
    return _convnext(setting, 0.4, torch_weights, **kwargs)


def convnext_base(torch_weights: Optional[str] = None, **kwargs: Any) -> ConvNeXt:
    setting = [
        CNBlockConfig(128, 256, 3), CNBlockConfig(256, 512, 3), CNBlockConfig(512, 1024, 27), CNBlockConfig(1024, None, 3)
    ]
    return _convnext(setting, 0.5, torch_weights, **kwargs)


def convnext_large(torch_weights: Optional[str] = None, **kwargs: Any) -> ConvNeXt:
    setting = [
        CNBlockConfig(192, 384, 3), CNBlockConfig(384, 768, 3), CNBlockConfig(768, 1536, 27), CNBlockConfig(1536, None, 3)
    ]
    return _convnext(setting, 0.5, torch_weights, **kwargs)
