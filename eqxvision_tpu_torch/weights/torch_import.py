"""Torch checkpoints into the port's models (eqxvision_tpu/weights/torch_import.py).

The port's modules carry torch's parameter names and layouts, so a
torchvision-format ``state_dict`` loads by name through
``nn.Module.load_state_dict``: the JAX importer's layout transforms and visit
order have no counterpart here. What this module keeps is the way in: a
local path, the file's name in torch's hub cache, else a fetch through
``torch.hub``; the unwrapping of DINO-, timm- and trainer-style checkpoints
nested under ``"state_dict"`` or ``"model"``; ``weights_only`` loading unless
the caller allows pickle; and the Swin buffers that the model computes from
its window size (``DERIVED_BUFFERS``), which a load skips.
"""
from __future__ import annotations

import os
import re
from typing import Dict, Sequence
from urllib.parse import urlparse

import numpy as np
import torch
from torch import nn

# Buffers that torchvision's Swin checkpoints carry and the port computes from
# the window size; a load skips exactly these (the JAX loader's list).
DERIVED_BUFFERS = ("relative_position_index", "relative_coords_table", "attn_mask")


def _is_url(path_or_url: str) -> bool:
    return str(path_or_url).startswith(("http://", "https://"))


def resolve_torch_checkpoint(path_or_url: str) -> str:
    """A local path for ``path_or_url``: the path itself where it exists,
    else the file of that name in torch's hub cache
    (``torch.hub.get_dir()/checkpoints``, where
    ``torch.hub.load_state_dict_from_url`` keeps it), else a URL fetched
    into that cache (``torch.hub.download_url_to_file``, which writes a
    temporary file and moves it into place)."""
    path_or_url = str(path_or_url)
    if os.path.exists(path_or_url):
        return path_or_url
    cache = os.path.join(torch.hub.get_dir(), "checkpoints")
    cached = os.path.join(cache, os.path.basename(urlparse(path_or_url).path))
    if os.path.exists(cached):
        return cached
    if not _is_url(path_or_url):
        raise FileNotFoundError(f"no checkpoint at {path_or_url}, nor {cached} in torch's hub cache")
    os.makedirs(cache, exist_ok=True)
    torch.hub.download_url_to_file(path_or_url, cached)
    return cached


def load_torch_state_dict(path_or_url: str, *, allow_pickle: bool = False) -> Dict[str, torch.Tensor]:
    """A checkpoint (a local path, or a URL through
    ``torch.hub.load_state_dict_from_url``, which reads the file of that
    name in the hub cache before it fetches) as an ordered name -> CPU
    tensor dict. A torch file is
    read with ``weights_only=True`` unless ``allow_pickle`` (unpickling a
    file from a URL runs its code; pass it only for a trusted checkpoint
    that is not a plain state dict), and unwrapped where it nests the state
    dict under ``"state_dict"`` or ``"model"``; entries that are not tensors
    are dropped. A local ``.npz`` is read as ``weights.save_model`` writes
    it (entries under their torch names, e.g. a joined tensor-parallel
    checkpoint)."""
    if _is_url(path_or_url) and not os.path.exists(path_or_url):
        # torch's own cached fetch: the file of that name in the hub cache, else a download into it
        obj = torch.hub.load_state_dict_from_url(path_or_url, map_location="cpu", weights_only=not allow_pickle)
    else:
        path = resolve_torch_checkpoint(path_or_url)
        if path.endswith(".npz"):
            with np.load(path, allow_pickle=False) as data:
                return {k: torch.from_numpy(data[k]) for k in data.files}
        obj = torch.load(path, map_location="cpu", weights_only=not allow_pickle)
    for key in ("state_dict", "model"):
        if isinstance(obj, dict) and isinstance(obj.get(key), dict):
            obj = obj[key]
    return {name: t.detach() for name, t in obj.items() if torch.is_tensor(t)}


def _derived(name: str) -> bool:
    return name.rsplit(".", 1)[-1] in DERIVED_BUFFERS


def load_torch_weights(
    model: nn.Module, path_or_url: str, *, skip_patterns: Sequence[str] = (), strict: bool = True
) -> nn.Module:
    """Load a torchvision-format checkpoint (a path or a URL) into ``model``
    by name, in place, and return it. Checkpoint entries that match a
    regex of ``skip_patterns`` are dropped, and so are the derived buffers.
    Every parameter and buffer of the model must get a value, but for the
    derived buffers and ``num_batches_tracked`` (which the JAX importer
    never reads); with ``strict`` a checkpoint entry the model lacks raises
    too. A shape that differs always raises."""
    if path_or_url is None:
        raise ValueError("torch_weights parameter cannot be empty!")
    skip = [re.compile(p) for p in skip_patterns]
    state = {k: v for k, v in load_torch_state_dict(path_or_url).items()
             if not _derived(k) and not any(r.search(k) for r in skip)}
    missing, unexpected = model.load_state_dict(state, strict=False)
    missing = [k for k in missing if not _derived(k) and not k.endswith("num_batches_tracked")]
    if missing or (strict and unexpected):
        raise RuntimeError(f"checkpoint {path_or_url} does not fit {type(model).__name__}: "
                           f"missing keys {missing}, unexpected keys {unexpected if strict else []}")
    return model
