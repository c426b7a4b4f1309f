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
  (C, 1, 1);
- a JAX ``ConvNormActivation`` names its layers ``conv`` and ``norm``; the
  port's is torchvision's ``nn.Sequential``, indices 0 and 1. The renames
  are anchored on the leaf (``.conv.weight``, ``.norm.running_mean``), so
  MobileNetV2's block Sequential, itself a field named ``conv``, keeps its
  name;
- RegNet: the JAX trunk is a Sequential of Sequentials,
  ``trunk_output.layers[i].layers[j]``, torchvision's
  ``trunk_output.block{i+1}.block{i+1}-{j}``;
- DenseNet: the JAX ``features`` is a plain Sequential, torchvision's a
  named one: ``features.layers[0]``/``[1]`` are ``conv0``/``norm0``, from
  index 4 on the blocks and transitions alternate (``denseblock{k}``,
  ``transition{k}``) and the last BatchNorm is ``norm5``; a block's
  ``layers[j]`` is ``denselayer{j+1}``. A transition's ``norm`` keeps its
  name (the ConvNormActivation and ConvNeXt renames of ``norm`` give no
  name of a DenseNet);
- segmentation: the JAX getter wraps the backbone (``backbone.model.``) and
  each tapped layer (``.inner.``); the port's getter shares the backbone's
  names, so both drop out (``backbone.model.layer3.inner.0.conv1`` ->
  ``backbone.layer3.0.conv1``). DeepLabV3's ``ASPPPooling`` names its conv
  and BatchNorm ``conv`` and ``bn``, torchvision's Sequential ``1`` and
  ``2`` (``classifier.0.convs.4.1.weight``).

A path may need more than one rename (a RegNet block's CNA: the stage and
the CNA's layer). The renames are tried alone, then two at a time, and so
on; the first round that gives names of the model gives the name, and a
round that gives two raises. A path no round maps keeps its plain name,
which the strict load then refuses. Buffers that the JAX model does not hold
(``relative_position_index``, ``relative_coords_table``,
``num_batches_tracked``) keep the values the port computed; the load stays
strict over parameters. A BatchNorm's running statistics live in the JAX
model's ``State``: ``eqxvision_tpu.weights.serialize.state_to_paths`` keys
them by the layer's path (``.layer1.layers[0].downsample.layers[1]``), and
``load_jax_params(..., state=)`` maps that path by the same rules onto the
port's ``BatchNorm`` (``layer1.0.downsample.1``).
"""
from __future__ import annotations

import re
from typing import AbstractSet, Dict, Mapping, Optional, Tuple

import numpy as np
import torch
from torch import nn

from ..nn.conv import Conv2d
from ..nn.linear import Linear
from ..nn.norm import BatchNorm


def _densenet_features(m: re.Match) -> str:
    i, rest = int(m[1]), m[2]
    if i < 2:
        return f"features.{('conv0', 'norm0')[i]}.{rest}"
    if "." not in rest:
        return f"features.norm5.{rest}"
    k = (i - 4) // 2 + 1
    if (i - 4) % 2:
        return f"features.transition{k}.{rest}"
    return f"features.denseblock{k}." + re.sub(r"^(\d+)\.", lambda j: f"denselayer{int(j[1]) + 1}.", rest)


_RENAMES = (
    (re.compile(r"(^|\.)conv\.(weight|bias)$"), r"\g<1>0.\2"),
    (re.compile(r"(^|\.)norm\.(weight|bias|running_mean|running_var)$"), r"\g<1>1.\2"),
    (re.compile(r"^trunk_output\.(\d+)\.(\d+)\."),
     lambda m: "trunk_output.block{0}.block{0}-{1}.".format(int(m[1]) + 1, m[2])),
    (re.compile(r"^features\.0\.1\."), "features.0.2."),
    (re.compile(r"\.mlp\.fc1\."), ".mlp.0."),
    (re.compile(r"\.mlp\.fc2\."), ".mlp.3."),
    (re.compile(r"\.dwconv\."), ".block.0."),
    (re.compile(r"\.norm\."), ".block.2."),
    (re.compile(r"\.pwconv1\."), ".block.3."),
    (re.compile(r"\.pwconv2\."), ".block.5."),
    (re.compile(r"^classifier_norm\."), "classifier.0."),
    (re.compile(r"^classifier_fc\."), "classifier.2."),
    (re.compile(r"^features\.(\d+)\.(.+)$"), _densenet_features),
    (re.compile(r"^backbone\.model\.(.+)$"), lambda m: "backbone." + m[1].replace(".inner.", ".")),
    (re.compile(r"(^|\.)convs\.(\d+)\.conv\.(weight|bias)$"), r"\g<1>convs.\2.1.\3"),
    (re.compile(r"(^|\.)convs\.(\d+)\.bn\.(weight|bias|running_mean|running_var)$"), r"\g<1>convs.\2.2.\3"),
)


def _torch_name(path: str, names: AbstractSet[str]) -> str:
    """``.features.layers[1].layers[0].mlp.fc1.weight`` -> ``features.1.0.mlp.0.weight``."""
    name = re.sub(r"\.layers\[(\d+)\]", r".\1", path)
    name = re.sub(r"\[(\d+)\]", r".\1", name).lstrip(".")
    seen, tier = {name}, {name}
    found = tier & names
    while tier and not found:
        tier = {pattern.sub(repl, n) for n in tier for pattern, repl in _RENAMES} - seen
        seen |= tier
        found = tier & names
    if len(found) > 1:
        raise ValueError(f"JAX path {path!r} maps onto several names of the model: {sorted(found)}")
    return found.pop() if found else name


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


def _running_stats_from_jax(
    model: nn.Module, state: Mapping[str, Tuple[np.ndarray, np.ndarray]]
) -> Dict[str, torch.Tensor]:
    """``{path: (mean, var)}`` -> the ``running_mean``/``running_var``
    entries of the port's BatchNorms; raises on a path that names none."""
    modules = dict(model.named_modules())
    names = set(model.state_dict())
    out = {}
    for path, (mean, var) in state.items():
        name = _torch_name(path + ".running_mean", names).rpartition(".")[0]
        if not isinstance(modules.get(name), BatchNorm):
            raise KeyError(f"state path {path!r} names no BatchNorm of the model (mapped to {name!r})")
        for leaf, value in (("running_mean", mean), ("running_var", var)):
            out[f"{name}.{leaf}"] = torch.tensor(np.asarray(value, np.float32))
    return out


def load_jax_params(
    model: nn.Module,
    params: Mapping[str, np.ndarray],
    state: Optional[Mapping[str, Tuple[np.ndarray, np.ndarray]]] = None,
) -> nn.Module:
    """Load JAX parameters into ``model`` with ``strict=True``, and the
    running statistics of ``state`` (``{path: (mean, var)}``, as
    ``state_to_paths`` gives them) where given, keeping the model's own
    buffers where the JAX model has none; returns it."""
    loaded = state_dict_from_jax(model, params)
    if state is not None:
        loaded.update(_running_stats_from_jax(model, state))
    param_names = {n for n, _ in model.named_parameters()}
    for name, value in model.state_dict().items():
        if name not in param_names:
            loaded.setdefault(name, value)
    model.load_state_dict(loaded, strict=True)
    return model
