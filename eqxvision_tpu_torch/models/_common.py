"""Shared model plumbing (eqxvision_tpu/models/_common.py).

Input contract, as in the JAX package: batched NHWC ``(N, H, W, C)``, or one
``(C, H, W)`` sample, which is transposed, batched, and unbatched again on
the way out.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn


def ensure_nhwc(x: torch.Tensor) -> Tuple[torch.Tensor, bool]:
    """Accept (N,H,W,C) or a single (C,H,W) sample; return NHWC + flag."""
    if x.ndim == 3:
        return x.permute(1, 2, 0)[None], True
    if x.ndim != 4:
        raise ValueError(f"expected (N,H,W,C) or (C,H,W) input, got shape {tuple(x.shape)}")
    return x, False


def debatch(out, was_single: bool):
    """Drop the batch axis of a single sample's output: of a tensor, of each
    tensor of a tuple; ``None`` stays."""
    if not was_single:
        return out
    if isinstance(out, tuple):
        return tuple(debatch(o, True) for o in out)
    return None if out is None else out[0]


def default_generator(generator: Optional[torch.Generator]) -> torch.Generator:
    """An omitted generator means a CPU generator seeded with 0, as an
    omitted key means PRNGKey(0) in the JAX package."""
    return torch.Generator().manual_seed(0) if generator is None else generator


def resolve_device(device) -> torch.device:
    """A model's device: the card unless the caller names another. Asking
    for the card where there is none raises; nothing moves to the CPU
    quietly."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA card is available; models build on device='cuda' unless the caller "
            "passes another device, e.g. device='cpu'"
        )
    return device


# Buffers that torchvision's Swin checkpoints carry and the port computes from
# the window size; a load skips exactly these (the JAX loader's list).
DERIVED_BUFFERS = ("relative_position_index", "relative_coords_table", "attn_mask")


def load_state(torch_weights: str) -> dict:
    """A torch ``state_dict`` from a local file, or from a URL through
    ``torch.hub.load_state_dict_from_url`` (torch's checkpoint cache). A
    local ``.npz`` is read as ``weights.save_model`` writes it (entries
    under their torch names, e.g. a joined tensor-parallel checkpoint)."""
    if str(torch_weights).endswith(".npz") and not str(torch_weights).startswith(("http://", "https://")):
        import numpy as np

        with np.load(torch_weights, allow_pickle=False) as data:
            return {k: torch.from_numpy(data[k]) for k in data.files}
    if str(torch_weights).startswith(("http://", "https://")):
        return torch.hub.load_state_dict_from_url(torch_weights, map_location="cpu", weights_only=True)
    return torch.load(torch_weights, map_location="cpu", weights_only=True)


def maybe_load_state_dict(model: nn.Module, torch_weights: Optional[str]) -> nn.Module:
    """Factory tail: load a torch ``state_dict`` (a local file or a URL)
    strictly, but for the derived buffers (``DERIVED_BUFFERS``), which the
    model keeps as it computed them."""
    if torch_weights is None:
        return model
    derived = lambda key: key.rsplit(".", 1)[-1] in DERIVED_BUFFERS  # noqa: E731
    state = {k: v for k, v in load_state(torch_weights).items() if not derived(k)}
    missing, unexpected = model.load_state_dict(state, strict=False)
    missing = [k for k in missing if not derived(k)]
    if missing or unexpected:
        raise RuntimeError(f"checkpoint {torch_weights} does not fit {type(model).__name__}: "
                           f"missing keys {missing}, unexpected keys {unexpected}")
    return model
