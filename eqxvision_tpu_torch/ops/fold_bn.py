"""Fold inference BatchNorm into the convolution before it
(eqxvision_tpu/ops/fold_bn.py).

An eval-mode BatchNorm is a per-channel affine, ``y = x g + b`` with ``g =
weight / sqrt(var + eps)`` and ``b = bias - mean g``; after a Conv2d it
folds into the convolution's weight and bias. A pair folds where the JAX
function folds it: (a) adjacent in an ``nn.Sequential``, (b) fields
``conv*`` and ``bn*`` of one block (``conv1``/``bn1``, and ``conv``/``bn``),
(c) fields named ``conv`` and ``norm``. The folded BatchNorm's slot holds an
``nn.Identity``, so every other name stays. A BatchNorm in training mode is
left as it is. The fold is an op the user calls: no factory applies it.

No BatchNorm that comes before its conv folds (ROADMAP C.14): DenseNet's
dense layers name theirs ``norm1``/``conv1`` (no ``bn*`` pair), and its
transition is a named ``nn.Sequential`` (``norm``, ``relu``, ``conv``,
``pool``), which rule (a) alone reads, so of a DenseNet only the stem's
``norm0`` folds, into ``conv0``. The JAX fold pairs the JAX transition's
fields ``conv`` and ``norm`` by rule (c) and raises.
"""
from __future__ import annotations

import copy

import torch
from torch import nn

from ..nn import conv, norm  # modules, not their classes: nn.norm imports ops while ops is imported


def _is_conv(m) -> bool:
    return isinstance(m, conv.Conv2d)


def _foldable(bn) -> bool:
    return isinstance(bn, norm.BatchNorm) and not bn.training


def _fold_into_conv(layer: nn.Module, bn: nn.Module) -> None:
    """The JAX function's rounding points: ``g`` and ``b`` in f32, the f32
    product ``w g`` rounded to the conv's type, the bias computed in f32
    and rounded to the conv's type."""
    g = torch.reciprocal(torch.sqrt(bn.running_var.float() + bn.eps))
    if bn.weight is not None:
        g = g * bn.weight.float()
    b = -bn.running_mean.float() * g
    if bn.bias is not None:
        b = b + bn.bias.float()
    dtype = layer.weight.dtype
    with torch.no_grad():
        w = layer.weight.float() * g.reshape(-1, 1, 1, 1)  # OIHW: scale the output channels
        bias = b if layer.bias is None else layer.bias.float() * g + b
    layer.weight = nn.Parameter(w.to(dtype))
    layer.bias = nn.Parameter(bias.to(dtype))


def _fold(node: nn.Module) -> None:
    for child in node.children():
        _fold(child)
    names = dict(node.named_children())
    if isinstance(node, nn.Sequential):
        for i in range(len(node) - 1):
            if _is_conv(node[i]) and _foldable(node[i + 1]):
                _fold_into_conv(node[i], node[i + 1])
                node[i + 1] = nn.Identity()
        return
    for name, child in names.items():
        if not _is_conv(child) or "conv" not in name:
            continue
        bn_name = name.replace("conv", "bn")
        if bn_name in names and _foldable(getattr(node, bn_name)):
            _fold_into_conv(child, getattr(node, bn_name))
            setattr(node, bn_name, nn.Identity())
    if _is_conv(names.get("conv")) and _foldable(getattr(node, "norm", None)):
        _fold_into_conv(node.conv, node.norm)
        node.norm = nn.Identity()


def fold_batchnorm(model: nn.Module) -> nn.Module:
    """A copy of ``model`` with each foldable eval-mode Conv2d + BatchNorm
    pair absorbed into the conv. ``model`` is left as it is."""
    model = copy.deepcopy(model)
    _fold(model)
    return model
