"""Several processes: the world, sharded loading and global evaluation
(eqxvision_tpu/parallel/multihost.py).

- ``initialize()`` joins the ``torch.distributed`` world that ``torchrun``
  describes in the environment (``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``,
  ``MASTER_PORT``), or the one its arguments name; it does nothing for one
  process and nothing a second time. The backend is NCCL where each rank
  has a card of its own, gloo on the CPU (and for ranks that share a card:
  gloo all-reduces and broadcasts CUDA tensors, NCCL refuses two ranks on
  one card); name it to choose.
- ``local_shard(items)``: this process's contiguous share of a sample list,
  the tail padded so that every process yields as many batches.
- ``evaluate_multihost``: top-1 and top-5 of every rank's own batches,
  summed over the data group, so that every rank returns the same
  accuracy.

The JAX module's ``host_local_to_global`` has no counterpart: there is no
global array here, each rank's rows with its data group play its part
(ROADMAP A.14).
"""
from __future__ import annotations

import os
from typing import Any, Iterable, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from .mesh import Mesh
from .train import evaluate, make_eval_step


def initialize(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    *,
    backend: Optional[str] = None,
    device: Optional[torch.device] = None,
) -> None:
    """Join the world (idempotent; a no-op for one process).

    ``coordinator_address`` (``host:port``), ``num_processes`` and
    ``process_id`` default to torchrun's ``MASTER_ADDR:MASTER_PORT``,
    ``WORLD_SIZE`` and ``RANK``. ``backend`` defaults to ``nccl`` where
    ``device`` is a card, else ``gloo``."""
    if dist.is_initialized():
        return
    env = os.environ
    world = int(num_processes if num_processes is not None else env.get("WORLD_SIZE", 1))
    if world <= 1 and coordinator_address is None:
        return
    rank = int(process_id if process_id is not None else env["RANK"])
    address = coordinator_address or f"{env['MASTER_ADDR']}:{env['MASTER_PORT']}"
    if backend is None:
        backend = "nccl" if device is not None and torch.device(device).type == "cuda" else "gloo"
    kwargs = {}
    if backend == "nccl" and device is not None:
        kwargs["device_id"] = torch.device(device)
    dist.init_process_group(backend, init_method=f"tcp://{address}", world_size=world, rank=rank, **kwargs)


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def local_shard(items: Sequence, index: Optional[int] = None, count: Optional[int] = None) -> list:
    """This process's contiguous shard of ``items`` (padding the tail
    shard by repeating the last item so every process yields the same
    number of batches — collective eval steps must stay in lockstep)."""
    count = process_count() if count is None else count
    index = process_index() if index is None else index
    if count == 1:
        return list(items)
    per = -(-len(items) // count)  # ceil
    shard = list(items[index * per : (index + 1) * per])
    while shard and len(shard) < per:
        shard.append(shard[-1])
    return shard


def make_global_eval_step(mesh: Mesh, tta_fn: Any = None):
    """``eval_step(model, x, y) -> (top1, top5, n)`` on this rank's rows,
    the counts and the size summed over the data group."""
    return make_eval_step(tta_fn, mesh=mesh)


def evaluate_multihost(
    model: torch.nn.Module,
    local_batches: Iterable[Tuple[torch.Tensor, torch.Tensor]],
    mesh: Mesh,
    *,
    eval_step=None,
) -> Tuple[float, float]:
    """Top-1 and top-5 over every data rank's own batches (its
    ``local_shard``; the model ranks of a data index see the same ones).
    Every rank must iterate as many batches; every rank returns the same
    global accuracy."""
    return evaluate(model, local_batches, eval_step=eval_step or make_global_eval_step(mesh))
