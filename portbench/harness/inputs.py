"""Everything a run makes from its seed: weights, canvases, labels, and the
seeds of the generators the program draws from.

Weights are drawn on the card in one call for the whole model (a normal
draw of every element at once, then a per-element scale and shift, each
one call), in the type they are used in, and cut into the leaves the
reference names. Matrices, embeddings and tables take N(0, 0.02^2), as
timm initialises a ViT; biases N(0, 0.02^2); LayerNorm scales (the one-axis
``weight`` leaves) 1 + N(0, 0.1^2), so that no scale is exactly one.

Canvases are uint8 (N, side, side, 3) noise and labels uniform over the
classes, made on the host with numpy, one generator a batch, as the
training CLI's ``--synthetic`` feed makes them: every batch of a pool has
its own rows. The seed may be any whole number below 2**64.
"""
from __future__ import annotations

import math
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

MASK64 = (1 << 64) - 1

# What each seed of a run is derived for (``sub_seed``).
WEIGHTS, CANVASES, AUGMENT, DROP_PATH, CHECK = range(5)


def sub_seed(seed: int, what: int, index: int = 0) -> int:
    """A seed of its own for each use of the run's seed (splitmix64)."""
    z = (int(seed) * 0x9E3779B97F4A7C15 + what * 0xBF58476D1CE4E5B9 + index * 0x94D049BB133111EB) & MASK64
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & MASK64
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & MASK64
    return (z ^ (z >> 31)) & ((1 << 63) - 1)


def _init(name: str, shape: Sequence[int]) -> Tuple[float, float]:
    """(mean, std) of a leaf."""
    if len(shape) == 1 and name.endswith(".weight"):
        return 1.0, 0.1
    return 0.0, 0.02


def make_weights(shapes: List[Tuple[str, Tuple[int, ...]]], seed: int, device, dtype) -> Dict[str, torch.Tensor]:
    """The leaves of ``shapes``, views of one flat tensor on ``device``."""
    numels = [math.prod(s) for _, s in shapes]
    total = sum(numels)
    g = torch.Generator(device=device).manual_seed(sub_seed(seed, WEIGHTS))
    flat = torch.randn(total, generator=g, device=device, dtype=dtype)
    counts = torch.tensor(numels, device=device)
    mean_std = torch.tensor([_init(n, s) for n, s in shapes], dtype=dtype, device=device)
    scale = torch.repeat_interleave(mean_std[:, 1], counts, output_size=total)
    flat.mul_(scale)
    del scale
    flat.add_(torch.repeat_interleave(mean_std[:, 0], counts, output_size=total))
    return {name: t.view(shape) for (name, shape), t in zip(shapes, flat.split(numels))}


def canvases(seed: int, index: int, batch: int, side: int, classes: int) -> Tuple[np.ndarray, np.ndarray]:
    """Batch ``index`` of the run: uint8 (batch, side, side, 3), int32 (batch,)."""
    rng = np.random.default_rng(sub_seed(seed, CANVASES, index))
    x = rng.integers(0, 256, (batch, side, side, 3), dtype=np.uint8)
    y = rng.integers(0, classes, (batch,), dtype=np.int32)
    return x, y


def load_into(model: torch.nn.Module, weights: Dict[str, torch.Tensor]) -> None:
    """Copy ``weights`` into ``model`` by name: every parameter of the model
    gets one, and no weight is left over (its buffers are the model's own)."""
    params = dict(model.named_parameters())
    missing = sorted(set(params) - set(weights))
    extra = sorted(set(weights) - set(params))
    if missing or extra:
        raise RuntimeError(f"the model's parameters differ from the reference's: missing {missing[:5]}, "
                           f"extra {extra[:5]}")
    with torch.no_grad():
        for name, p in params.items():
            if tuple(p.shape) != tuple(weights[name].shape):
                raise RuntimeError(f"{name}: the model holds {tuple(p.shape)}, the reference {tuple(weights[name].shape)}")
            p.copy_(weights[name])
