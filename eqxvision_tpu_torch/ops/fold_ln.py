"""Fold LayerNorm affine parameters into the Linear or convolution after
them (eqxvision_tpu/ops/fold_ln.py).

A pre-norm block applies ``Linear(LN(x))`` with ``LN(x) = g * xhat + b``,
so ``LN(x) @ W.T + c == xhat @ (W * g).T + (W @ b + c)``, and the norm
keeps no affine (``weight`` and ``bias`` None). The fold is exact algebra,
computed in f32 and rounded once to each layer's type: fold before casting
a model to bf16. It folds, as the JAX function does:

- ViT: each block's ``norm1 -> attn.qkv`` and ``norm2 -> mlp.fc1``, and the
  final ``norm -> head`` where the head is a Linear. A qkv without a bias
  gets one (``W @ b``). The folded blocks still run the two fused halves
  on the card, whose kernels then read a unit affine (``ops.attention.
  unit_affine``).
- ConvNeXt: each block's norm -> first Linear, each downsampling
  LayerNorm2d -> its 2x2 stride-2 convolution (padding 0, so every tap
  reads a real norm output and the bias shift is exact) and the
  classifier's norm -> Linear. The stem's norm follows its convolution
  and stays.

Swin raises ``TypeError``: v1's whole-block kernel reads the affine at no
cost and v2 is post-norm, where the affine does not commute into a
following product. Inference only; returns a folded copy.
"""
from __future__ import annotations

import copy

import torch
from torch import nn

from ..nn import conv, linear, norm  # modules, not their classes: nn.norm imports ops while ops is imported


def _fold_pair(ln: nn.Module, layer: nn.Module) -> None:
    """Fold ``ln``'s affine into ``layer`` (a Linear, or a padding-0,
    ungrouped Conv2d), in place; ``ln`` keeps no affine."""
    if ln.weight is None:
        return
    if isinstance(layer, conv.Conv2d) and (any(p != (0, 0) for p in layer.padding) or layer.groups != 1):
        raise ValueError("a LayerNorm folds into a convolution only with padding 0 and groups 1")
    g, b = ln.weight.detach().float(), ln.bias.detach().float()
    w = layer.weight.detach().float()  # (out, in) or OIHW
    g_in = g.reshape((1, -1) + (1,) * (w.ndim - 2))
    shift = (w * b.reshape(g_in.shape)).sum(dim=tuple(range(1, w.ndim)))
    dtype = layer.weight.dtype
    layer.weight = nn.Parameter((w * g_in).to(dtype))
    bias = shift if layer.bias is None else layer.bias.detach().float() + shift
    layer.bias = nn.Parameter(bias.to(dtype if layer.bias is None else layer.bias.dtype))
    ln.weight = None
    ln.bias = None


def _fold_convnext(model: nn.Module) -> None:
    from ..models.classification.convnext import CNBlock

    for stage in model.features:
        blocks = list(stage)
        if blocks and all(isinstance(m, CNBlock) for m in blocks):
            for blk in blocks:
                _fold_pair(blk.block[2], blk.block[3])
        elif len(blocks) == 2 and isinstance(blocks[0], norm.LayerNorm) and isinstance(blocks[1], conv.Conv2d):
            _fold_pair(blocks[0], blocks[1])  # downsample: LayerNorm2d, 2x2 stride-2 conv
    if isinstance(model.classifier[2], linear.Linear):
        _fold_pair(model.classifier[0], model.classifier[2])


def fold_layernorm(model: nn.Module) -> nn.Module:
    """A copy of a ``VisionTransformer`` or ``ConvNeXt`` with every pre-norm
    LayerNorm affine folded into the weights after it."""
    from ..models.classification.convnext import ConvNeXt
    from ..models.classification.vit import VisionTransformer

    if not isinstance(model, (VisionTransformer, ConvNeXt)):
        raise TypeError(
            "fold_layernorm supports VisionTransformer and ConvNeXt (pre-norm); got "
            f"{type(model).__name__}. Swin is intentionally unsupported (see the module docstring)."
        )
    model = copy.deepcopy(model)
    with torch.no_grad():
        if isinstance(model, ConvNeXt):
            _fold_convnext(model)
            return model
        for blk in model.blocks:
            _fold_pair(blk.norm1, blk.attn.qkv)
            _fold_pair(blk.norm2, blk.mlp.fc1)
        if isinstance(model.head, linear.Linear):
            _fold_pair(model.norm, model.head)
    return model
