"""The port's counterpart of the JAX package's entry points
(``__graft_entry__.entry`` and ``dryrun_multichip``).

``forward, (model, x) = entry()``; ``forward(model, x)`` gives the logits.
The model is resnet50 in eval mode, random weights from seed 0, and x is
zeros of shape (8, 224, 224, 3) in f32, both on the card unless ``device``
names another; without a card, ``device="cuda"`` raises.

``dryrun_multichip(n)`` runs the sharded training path in a world of ``n``
local processes (``parallel.launch``): one AdamW step of the JAX dry run's
ViT (32 px, patch 16, width 64, depth 2, 4 heads, 5 classes) on a ``n/T x
T`` mesh (T = 2 tensor-parallel ranks where n is even), and one step of
``resnet18(num_classes=5)`` on ``n`` data ranks with synchronised
BatchNorm. Both losses must be finite. The ranks run on the cards unless
``device="cpu"``, placed by ``launch.placement``: one card a rank over
NCCL where there are ``n`` cards, else round-robin on the cards over gloo
(all ``n`` on one card where there is one). Without a card,
``device="cuda"`` raises. A rank that fails, or a world still running
after ``timeout_s``, raises.
"""
from __future__ import annotations

import math
from typing import Callable, Dict, Tuple, Union

import torch
from torch import nn

from .models.classification.resnet import resnet18, resnet50


def forward(model: nn.Module, x: torch.Tensor) -> torch.Tensor:
    with torch.inference_mode():
        return model(x)


def entry(device: Union[str, torch.device] = "cuda") -> Tuple[Callable, Tuple[nn.Module, torch.Tensor]]:
    model = resnet50(generator=torch.Generator().manual_seed(0), device=device).eval()
    x = torch.zeros(8, 224, 224, 3, device=device)
    return forward, (model, x)


def _dryrun_rank() -> Dict[str, float]:
    """One rank of ``dryrun_multichip``: the JAX dry run's two steps."""
    import torch.distributed as dist

    from .models.classification.vit import VisionTransformer
    from .parallel import make_mesh, make_train_step, parallelize, shard_batch
    from .parallel.launch import rank_device

    n = dist.get_world_size()
    dev = rank_device()
    tp = 2 if n % 2 == 0 else 1
    batch = max(n // tp, 2) * 2
    losses = {}
    gen = torch.Generator().manual_seed(0)

    mesh = make_mesh(data=n // tp, model=tp)
    vit = VisionTransformer(img_size=32, patch_size=16, embed_dim=64, depth=2, num_heads=4, num_classes=5,
                            generator=gen, device=dev).train()
    parallelize(vit, mesh)
    opt = torch.optim.AdamW(vit.parameters(), lr=1e-3)
    x, y = torch.zeros(batch, 32, 32, 3, device=dev), torch.zeros(batch, dtype=torch.long, device=dev)
    losses["vit"] = make_train_step(mesh=mesh)(vit, opt, *shard_batch((x, y), mesh)).item()

    mesh = make_mesh(data=n)
    res = parallelize(resnet18(num_classes=5, generator=gen, device=dev).train(), mesh)
    opt = torch.optim.AdamW(res.parameters(), lr=1e-3)
    losses["resnet18"] = make_train_step(mesh=mesh)(res, opt, *shard_batch((x, y), mesh)).item()
    for name, loss in losses.items():
        if not math.isfinite(loss):
            raise FloatingPointError(f"{name}: the sharded train step's loss is {loss}")
    return losses


def dryrun_multichip(n_devices: int, device: str = "cuda", timeout_s: float = 600.0) -> Dict[str, float]:
    """The sharded training path on ``n_devices`` ranks; returns rank 0's
    losses ``{"vit": ..., "resnet18": ...}``."""
    from .parallel import launch

    if device == "cuda" and torch.cuda.is_available():
        from . import _native

        _native.library()  # built here, once: the ranks load it
    return launch.run(_dryrun_rank, n_devices, device=device, timeout_s=timeout_s)[0]
