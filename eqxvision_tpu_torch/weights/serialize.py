"""Save and load a model as one ``.npz`` (eqxvision_tpu/weights/serialize.py).

The file holds every entry of ``state_dict()`` (parameters, BatchNorm
statistics, every buffer) under its torch name, as plain arrays: no
pickle, readable with numpy alone. numpy has no bfloat16, so a bf16 tensor
is stored as f32 (exactly) and loaded back into the template's type.

``load_model`` is strict: a missing or unexpected name, a shape that
differs, or a BatchNorm statistic the file lacks raises. It also reads a
file that the JAX package's ``save_model`` wrote (``m:<path>`` parameters
and ``s:<layer path>:<j>`` statistics), through ``weights.from_jax``'s
renames and layouts.

``join_shards`` joins the files of a tensor-parallel model, one per model
rank (each ``save_model`` of that rank's shard), into the one-card file
that ``load_model`` and the eval CLI read.
"""
from __future__ import annotations

from typing import Dict, Mapping, Optional, Sequence

import numpy as np
import torch
from torch import nn

from ..nn.norm import BatchNorm
from .from_jax import _running_stats_from_jax, load_jax_params


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


def save_model(path: str, model: nn.Module) -> None:
    np.savez(path, **{name: _to_numpy(t) for name, t in model.state_dict().items()})


def _load_jax_file(model: nn.Module, stored: Mapping[str, np.ndarray], path: str) -> nn.Module:
    params = {k[2:]: v for k, v in stored.items() if k.startswith("m:")}
    # the JAX State keys each BatchNorm's (mean, var) by its layer's path
    stats: Dict[str, list] = {}
    for k, v in stored.items():
        if k.startswith("s:"):
            layer, _, j = k[2:].rpartition(":")
            stats.setdefault(layer, [None, None])[int(j)] = v
    stats = {layer: tuple(mv) for layer, mv in stats.items()}
    loaded = _running_stats_from_jax(model, stats)
    missing = [name for name, m in model.named_modules()
               if isinstance(m, BatchNorm) and f"{name}.running_mean" not in loaded]
    if missing:
        raise KeyError(f"{path!r} holds no running statistics for the BatchNorms {missing}")
    return load_jax_params(model, params, stats)


def load_model(path: str, model: nn.Module) -> nn.Module:
    """Load ``path`` into ``model`` (a template of the same structure, e.g. a
    fresh factory call) in place, keeping each tensor's type and device;
    returns the model."""
    with np.load(path, allow_pickle=False) as data:
        stored = {k: data[k] for k in data.files}
    if any(k.startswith(("m:", "s:")) for k in stored):
        return _load_jax_file(model, stored, path)
    model.load_state_dict({k: torch.from_numpy(v) for k, v in stored.items()}, strict=True)
    return model


def join_shards(shard_paths: Sequence[str], shardings: Mapping[str, Sequence[int]],
                out_path: Optional[str] = None) -> Dict[str, np.ndarray]:
    """The whole model from the files of its model ranks' shards, in model
    order: each entry that ``shardings`` names (``(dim, parts)``, as
    ``parallel.param_shardings`` gives them) joined, the others taken from
    the first file (every rank holds them whole). Written to ``out_path``
    as one ``save_model`` file where given; returns the arrays."""
    from ..parallel.mesh import Shard, join_tensors

    states = []
    for path in shard_paths:
        with np.load(path, allow_pickle=False) as data:
            states.append({k: data[k] for k in data.files})
    joined = {k: v if k not in shardings else
              join_tensors([torch.from_numpy(s[k]) for s in states], Shard(*shardings[k])).numpy()
              for k, v in states[0].items()}
    if out_path is not None:
        np.savez(out_path, **joined)
    return joined


__all__ = ["join_shards", "load_model", "save_model"]
