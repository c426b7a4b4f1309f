"""Carry the JAX package's parameters into the port.

The input is ``{path: np.ndarray}`` keyed as
``eqxvision_tpu.weights.serialize._flatten_with_paths`` writes it, e.g.
``.blocks[0].attn.qkv.weight``. Names become torch's
(``blocks.0.attn.qkv.weight``); ``Linear`` weights go from (in, out) to
(out, in), and ``Conv2d`` weights from HWIO to OIHW. Nothing here imports JAX.

Where the JAX model's tree differs from torchvision's:

- a JAX ``nn.Sequential`` keeps its children in ``.layers[i]``; torch's
  ``nn.Sequential`` indexes them directly (``features.1.0``);
- Swin: the JAX stem is ``[Conv2d, LayerNorm]``, torchvision's ``[Conv2d,
  Permute, LayerNorm]``, so the stem norm moves from index 1 to 2; the JAX
  MLP names ``fc1``/``fc2`` are torchvision's ``mlp.0``/``mlp.3``;
- ConvNeXt: a JAX ``CNBlock`` names its layers ``dwconv``, ``norm``,
  ``pwconv1``, ``pwconv2``, torchvision's ``block.0``, ``block.2``,
  ``block.3``, ``block.5``; ``classifier_norm``/``classifier_fc`` are
  ``classifier.0``/``classifier.2``; ``layer_scale`` goes from (C,) to
  (C, 1, 1).

A rename applies only where the plain name is not the model's and the
renamed one is. Buffers that the JAX model does not hold
(``relative_position_index``, ``relative_coords_table``) keep the values
the port computed; the load stays strict over parameters.
"""
from __future__ import annotations

import re
from typing import Collection, Dict, Mapping

import numpy as np
import torch
from torch import nn

from ..nn.conv import Conv2d
from ..nn.linear import Linear

_RENAMES = (
    (re.compile(r"^features\.0\.1\."), "features.0.2."),
    (re.compile(r"\.mlp\.fc1\."), ".mlp.0."),
    (re.compile(r"\.mlp\.fc2\."), ".mlp.3."),
    (re.compile(r"\.dwconv\."), ".block.0."),
    (re.compile(r"\.norm\."), ".block.2."),
    (re.compile(r"\.pwconv1\."), ".block.3."),
    (re.compile(r"\.pwconv2\."), ".block.5."),
    (re.compile(r"^classifier_norm\."), "classifier.0."),
    (re.compile(r"^classifier_fc\."), "classifier.2."),
)


def _torch_name(path: str, names: Collection[str]) -> str:
    """``.features.layers[1].layers[0].mlp.fc1.weight`` -> ``features.1.0.mlp.0.weight``."""
    name = re.sub(r"\.layers\[(\d+)\]", r".\1", path)
    name = re.sub(r"\[(\d+)\]", r".\1", name).lstrip(".")
    if name in names:
        return name
    for pattern, repl in _RENAMES:
        renamed = pattern.sub(repl, name)
        if renamed in names:
            return renamed
    return name


def state_dict_from_jax(model: nn.Module, params: Mapping[str, np.ndarray]) -> Dict[str, torch.Tensor]:
    modules = dict(model.named_modules())
    names = set(model.state_dict())
    out = {}
    for path, value in params.items():
        name = _torch_name(path, names)
        owner, _, leaf = name.rpartition(".")
        module = modules.get(owner)
        a = np.asarray(value)
        if leaf == "weight" and isinstance(module, Linear):
            a = a.T
        elif leaf == "weight" and isinstance(module, Conv2d):
            a = a.transpose(3, 2, 0, 1)
        elif leaf == "layer_scale":
            a = a.reshape(-1, 1, 1)
        out[name] = torch.tensor(np.ascontiguousarray(a))
    return out


def load_jax_params(model: nn.Module, params: Mapping[str, np.ndarray]) -> nn.Module:
    """Load JAX parameters into ``model`` with ``strict=True``, keeping the
    model's own buffers where the JAX model has none; returns it."""
    state = state_dict_from_jax(model, params)
    param_names = {n for n, _ in model.named_parameters()}
    for name, value in model.state_dict().items():
        if name not in param_names:
            state.setdefault(name, value)
    model.load_state_dict(state, strict=True)
    return model
