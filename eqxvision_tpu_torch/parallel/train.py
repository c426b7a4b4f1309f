"""Training and evaluation steps (eqxvision_tpu/parallel/train.py), one card.

The JAX step is a pure function of (model, state, opt_state); here the
model holds its parameters and BatchNorm buffers and the optimiser its own
state, so a step updates both in place and returns the loss:

    step = make_train_step(compute_dtype=torch.bfloat16, augment_fn=...)
    loss = step(model, optimizer, x_uint8, y, generator)

``compute_dtype`` selects mixed precision as the JAX step does: the f32
master parameters are cast inside the differentiated function
(``torch.func.functional_call`` with the cast parameters; the buffers, f32
BatchNorm statistics among them, stay as they are), so each gradient is the
bf16 backward's output accumulated into the f32 leaf, and the optimiser
updates f32 masters. ``torch.autocast`` is no counterpart: it picks its own
types and rounding points op by op. The loss comes from f32 logits; a
floating input is cast to the compute type, an integer one never.

``remat=True`` wraps the whole forward in ``torch.utils.checkpoint``
(non-reentrant), as ``jax.checkpoint`` wraps it. Two things the recompute
would change silently are kept as in the JAX step, which returns its state
once: the buffers (BatchNorm's running statistics and
``num_batches_tracked``) are put back after the recompute, so they move
once a step; and the RNG state of the CPU and of the input's device is
replayed, so dropout and drop path draw the same masks.

On a mesh (``parallel.make_mesh``; ``mesh=``), each rank's step takes its
rows of the global batch: after the backward the gradients are averaged
over the data group in a few flat all-reduces (``mesh.all_reduce_grads``)
before the optimiser steps, and the loss the step returns is the global
batch's mean. The model's tensor-parallel blocks and synchronised
BatchNorms (``parallel.parallelize``) run their own collectives in the
forward and backward; with remat, the recompute runs them again, in the
same order on every rank. Dropout and drop path draw from the default
generators, seeded by (seed, data index) (``mesh.seed_rank``, ROADMAP
C.22).

The optimiser's update rule is torch's (``torch.optim.SGD``/``AdamW`` on
the two parameter groups of ``param_groups``), not optax's: the same
arithmetic where the two are stated alike (tests/test_torch_train.py).
"""
from __future__ import annotations

import contextlib
from typing import Callable, Iterable, List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.func import functional_call
from torch.utils.checkpoint import checkpoint

from ..nn.collectives import all_reduce_
from ..observability import annotate
from .mesh import Mesh, all_reduce_grads

AUX_LOSS_WEIGHT = 0.3  # GoogLeNet's aux heads, as in the JAX step


def softmax_cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean cross-entropy over integer labels ``(N,)`` or soft targets
    ``(N, C)`` (mixup, cutmix, ``smooth_labels``)."""
    if labels.ndim == logits.ndim:
        return -(labels * F.log_softmax(logits, dim=-1)).sum(-1).mean()
    return F.cross_entropy(logits, labels.long())


def param_groups(model: nn.Module, weight_decay: float) -> List[dict]:
    """The "no weight decay on norms and biases" recipe: decay on the
    parameters with more than one axis (matrices, convolutions, embeddings),
    none on the rest, as the JAX CLI's ``ndim > 1`` mask."""
    params = [p for p in model.parameters() if p.requires_grad]
    return [
        {"params": [p for p in params if p.ndim > 1], "weight_decay": weight_decay},
        {"params": [p for p in params if p.ndim <= 1], "weight_decay": 0.0},
    ]


@contextlib.contextmanager
def _buffers_kept(model: nn.Module):
    """Put every buffer back as it was on entry: the remat recompute runs
    the training forward again, which would move the running statistics a
    second time."""
    saved = [(b, b.clone()) for b in model.buffers()]
    try:
        yield
    finally:
        with torch.no_grad():
            for b, value in saved:
                b.copy_(value)


def _forward(model: nn.Module, x: torch.Tensor, compute_dtype: Optional[torch.dtype], remat: bool):
    params = None
    if compute_dtype is not None:
        params = {name: p.to(compute_dtype) for name, p in model.named_parameters()}
        if x.is_floating_point():
            x = x.to(compute_dtype)

    def run(x_):
        return model(x_) if params is None else functional_call(model, params, (x_,))

    if not remat:
        return run(x)
    return checkpoint(run, x, use_reentrant=False, preserve_rng_state=True,
                      context_fn=lambda: (contextlib.nullcontext(), _buffers_kept(model)))


def _loss(logits, y, loss_fn: Callable, aux: bool) -> torch.Tensor:
    """``loss_fn`` on f32 logits; a tuple of outputs (GoogLeNet's logits,
    aux2, aux1) adds ``AUX_LOSS_WEIGHT`` times each aux loss where ``aux``,
    else keeps the logits alone."""
    if not isinstance(logits, tuple):
        return loss_fn(logits.float(), y)
    main, *rest = logits
    loss = loss_fn(main.float(), y)
    if aux:
        for a in rest:
            if a is not None:
                loss = loss + AUX_LOSS_WEIGHT * loss_fn(a.float(), y)
    return loss


def _make_step(loss_fn, compute_dtype, remat, augment_fn, aux, mesh=None):
    if loss_fn is None:
        loss_fn = softmax_cross_entropy

    syncs = mesh is not None and mesh.data > 1

    def loss_of(model, x, y, generator=None):
        if augment_fn is not None:
            with annotate("eqxvision.train.augment"):
                x, y = augment_fn(generator, x, y)
        with annotate("eqxvision.train.forward"):
            return _loss(_forward(model, x, compute_dtype, remat), y, loss_fn, aux)

    def update(optimizer, loss):
        with annotate("eqxvision.train.backward"):
            optimizer.zero_grad(set_to_none=True)
            loss.backward()
        if syncs:
            with annotate("eqxvision.train.sync"):
                all_reduce_grads((p for g in optimizer.param_groups for p in g["params"]), mesh)
        with annotate("eqxvision.train.optimizer"):
            optimizer.step()

    def step(model, optimizer, x, y, generator=None):
        loss = loss_of(model, x, y, generator)
        update(optimizer, loss)
        if not syncs:
            return loss.detach()
        with annotate("eqxvision.train.sync"):  # the global batch's mean
            return all_reduce_(loss.detach().clone(), mesh.data_group) / mesh.data

    step.loss, step.update = loss_of, update
    return step


def make_train_step(
    loss_fn: Optional[Callable] = None,
    compute_dtype: Optional[torch.dtype] = None,
    remat: bool = False,
    augment_fn: Optional[Callable] = None,
    mesh: Optional[Mesh] = None,
):
    """Build ``step(model, optimizer, x, y, generator) -> loss``: one
    optimiser step, the f32 loss returned as a 0-d tensor on the model's
    device (no host sync on one rank). With ``mesh``, ``x`` and ``y`` are
    this rank's rows (``shard_batch``), the gradients are averaged over
    the data group and the loss is the global batch's.

    ``loss_fn(logits, y)`` defaults to ``softmax_cross_entropy``.
    ``augment_fn(generator, x, y) -> (x, y)`` runs first, on the device, so
    the host ships uint8 canvases; ``generator`` (on x's device) is its one
    source of randomness. The model's mode is the caller's (``train()``).
    The JAX ``make_train_step``'s optax argument has no counterpart: the
    torch optimiser holds its state and is passed to each step, where the
    JAX step takes ``opt_state``.

    The step is ``step.loss`` (augmentation, forward and loss, with the
    graph; on a mesh this rank's loss) then ``step.update(optimizer,
    loss)`` (backward, the gradients' all-reduce and the optimiser step),
    which a caller may time apart.
    """
    return _make_step(loss_fn, compute_dtype, remat, augment_fn, aux=True, mesh=mesh)


def make_scan_epoch(
    loss_fn: Optional[Callable] = None,
    compute_dtype: Optional[torch.dtype] = None,
    augment_fn: Optional[Callable] = None,
):
    """Build ``epoch(model, optimizer, xs, ys, generator) -> losses``: one
    step for each of the stacked batches ``xs (steps, N, H, W, C)``, ``ys
    (steps, N)``, returning the ``(steps,)`` f32 losses. As the JAX
    ``lax.scan`` epoch, a tuple of outputs keeps its logits alone."""
    step = _make_step(loss_fn, compute_dtype, False, augment_fn, aux=False)

    def epoch(model, optimizer, xs, ys, generator=None):
        return torch.stack([step(model, optimizer, x, y, generator) for x, y in zip(xs, ys)])

    return epoch


def make_eval_step(tta_fn: Optional[Callable] = None, mesh: Optional[Mesh] = None):
    """Build ``eval_step(model, x, y) -> (top1, top5, n)``: the correct
    counts as 0-d tensors on the device, and the batch size. With ``mesh``,
    ``x`` and ``y`` are this rank's rows and the counts and the size are
    summed over the data group: every rank gets the global batch's.

    ``tta_fn(x) -> (K, N, h, w, C)`` (e.g. ``functools.partial(ten_crop,
    crop_h=224)``) folds the K crops into one forward and averages the
    per-crop softmax probabilities, in f32, before the top-k."""

    @torch.no_grad()
    def eval_step(model, x, y):
        if tta_fn is not None:
            crops = tta_fn(x)
            k, n = crops.shape[:2]
            logits = model(crops.reshape(k * n, *crops.shape[2:])).float()
            logits = torch.softmax(logits, dim=-1).reshape(k, n, -1).mean(0)
        else:
            logits = model(x)
        top1 = (logits.argmax(-1) == y).sum()
        top5 = (logits.topk(5, dim=-1).indices == y[:, None]).any(-1).sum()
        if mesh is None or mesh.data == 1:
            return top1, top5, y.shape[0]
        counts = all_reduce_(torch.stack([top1, top5, top1.new_tensor(y.shape[0])]), mesh.data_group)
        return counts[0], counts[1], int(counts[2])

    return eval_step


def evaluate(model: nn.Module, batches: Iterable, *, eval_step=None, mesh: Optional[Mesh] = None
             ) -> Tuple[float, float]:
    """Top-1 and top-5 accuracy over an iterable of ``(x, y)`` batches (with
    ``mesh``, this rank's rows of each global batch: every rank of the data
    group must see as many batches)."""
    if eval_step is None:
        eval_step = make_eval_step(mesh=mesh)
    c1 = c5 = n = 0
    for x, y in batches:
        t1, t5, bn = eval_step(model, x, y)
        c1 += int(t1)
        c5 += int(t5)
        n += int(bn)
    return c1 / max(n, 1), c5 / max(n, 1)
