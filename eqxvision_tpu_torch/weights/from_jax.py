"""Carry the JAX package's parameters into the port.

The input is ``{path: np.ndarray}`` keyed as
``eqxvision_tpu.weights.serialize._flatten_with_paths`` writes it, e.g.
``.blocks[0].attn.qkv.weight``. Names become torch's
(``blocks.0.attn.qkv.weight``); ``Linear`` weights go from (in, out) to
(out, in), and ``Conv2d`` weights from HWIO to OIHW. Nothing here imports JAX.
"""
from __future__ import annotations

import re
from typing import Dict, Mapping

import numpy as np
import torch
from torch import nn

from ..nn.conv import Conv2d
from ..nn.linear import Linear


def _torch_name(path: str) -> str:
    """``.blocks[0].attn.qkv.weight`` -> ``blocks.0.attn.qkv.weight``."""
    return re.sub(r"\[(\d+)\]", r".\1", path).lstrip(".")


def state_dict_from_jax(model: nn.Module, params: Mapping[str, np.ndarray]) -> Dict[str, torch.Tensor]:
    modules = dict(model.named_modules())
    out = {}
    for path, value in params.items():
        name = _torch_name(path)
        owner, _, leaf = name.rpartition(".")
        module = modules.get(owner)
        a = np.asarray(value)
        if leaf == "weight" and isinstance(module, Linear):
            a = a.T
        elif leaf == "weight" and isinstance(module, Conv2d):
            a = a.transpose(3, 2, 0, 1)
        out[name] = torch.tensor(np.ascontiguousarray(a))
    return out


def load_jax_params(model: nn.Module, params: Mapping[str, np.ndarray]) -> nn.Module:
    """Load JAX parameters into ``model`` with ``strict=True``; returns it."""
    model.load_state_dict(state_dict_from_jax(model, params), strict=True)
    return model
