"""The collectives that layers run inside a forward, with their gradients.

Tensor parallel (Megatron) splits a block's first product by columns and
its second by rows over a model group. Two autograd functions mark where
the activations enter and leave the split region:

- ``copy_to_group``: the identity forward, an all-reduce backward. Each
  rank's column-parallel product sees the whole input, and its gradient
  with respect to that input is a partial sum over the rank's columns.
- ``reduce_from_group``: an all-reduce forward, the identity backward. The
  row-parallel product's partial sums add up to the output, and the
  gradient that arrives there is already the same on every rank, so it
  passes through. (``torch.distributed.nn.functional.all_reduce`` reduces
  the gradient again, which multiplies it by the group's size here.)

``all_reduce_sum`` is the third case, an all-reduce forward and an
all-reduce backward: every rank's output depends on every rank's input,
as the synchronised BatchNorm's statistics do.

A ``Group`` of one rank (or ``None``) makes each of them the identity, so
the layers call them unconditionally. Sums of types narrower than f32 are
taken in f32 and rounded back once.

``ColumnParallelLinear`` and ``RowParallelLinear`` are the two halves as
layers: ``parallel.shard_params_tp`` swaps them in for a block's Linears
under the same names, and the block, whose fused kernels read whole
``Linear`` weights, then calls them on its unfused route, as it calls a
quantized layer.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from .linear import linear, preactivation


class Group:
    """A process group with its ranks (global, in group order). Copies of a
    module share it (``copy.deepcopy`` returns the group itself: a process
    group cannot be copied)."""

    def __init__(self, ranks: Sequence[int], group: Optional[dist.ProcessGroup] = None):
        self.ranks = tuple(int(r) for r in ranks)
        self.group = group
        self.size = len(self.ranks)

    @property
    def src(self) -> int:
        """The global rank of the group's first member."""
        return self.ranks[0]

    def __deepcopy__(self, memo):
        return self

    def __repr__(self) -> str:
        return f"Group(ranks={self.ranks})"


def _active(group: Optional[Group]) -> bool:
    return group is not None and group.size > 1


def all_reduce_(t: torch.Tensor, group: Group) -> torch.Tensor:
    """Sum ``t`` over ``group`` in place (in f32 where ``t`` is narrower)
    and return it; no gradient."""
    if not _active(group):
        return t
    if t.dtype in (torch.bfloat16, torch.float16):
        wide = t.float()
        dist.all_reduce(wide, group=group.group)
        return t.copy_(wide)
    dist.all_reduce(t, group=group.group)
    return t


def _summed(t: torch.Tensor, group: Group) -> torch.Tensor:
    return all_reduce_(t.detach().clone(memory_format=torch.contiguous_format), group)


class _CopyToGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return _summed(grad, ctx.group), None


class _ReduceFromGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return _summed(x, group)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _summed(x, group)

    @staticmethod
    def backward(ctx, grad):
        return _summed(grad, ctx.group), None


def copy_to_group(x: torch.Tensor, group: Optional[Group]) -> torch.Tensor:
    """Identity forward, all-reduce backward: the entry of a tensor-parallel region."""
    return _CopyToGroup.apply(x, group) if _active(group) else x


def reduce_from_group(x: torch.Tensor, group: Optional[Group]) -> torch.Tensor:
    """All-reduce forward, identity backward: the exit of a tensor-parallel region."""
    return _ReduceFromGroup.apply(x, group) if _active(group) else x


def all_reduce_sum(x: torch.Tensor, group: Optional[Group]) -> torch.Tensor:
    """All-reduce forward and backward: a sum every rank's output depends on."""
    return _AllReduceSum.apply(x, group) if _active(group) else x


def broadcast_from_first(x: torch.Tensor, group: Optional[Group]) -> torch.Tensor:
    """``x`` of the group's first rank on every rank of the group; no gradient."""
    if not _active(group):
        return x
    out = x.detach().clone(memory_format=torch.contiguous_format)
    dist.broadcast(out, src=group.src, group=group.group)
    return out


def row_parallel_linear(
    x: torch.Tensor, weight: torch.Tensor, bias: Optional[torch.Tensor], group: Optional[Group],
    round_before_bias: bool = False,
) -> torch.Tensor:
    """A Linear whose input features are split over ``group``: each rank's
    product of its features (``weight`` holds its columns, torch's (out,
    in) layout) rounds to x's type once, the partial sums add up in f32,
    and the bias, kept whole on every rank, is added once after the sum.
    The result rounds to x's type once as ``Linear`` rounds it, or, with
    ``round_before_bias``, before the bias too (the JAX Swin's windowed
    projection: product rounded, then ``+ bias`` rounded)."""
    partial = F.linear(x, weight.to(x.dtype))
    wide = partial.float() if partial.dtype in (torch.bfloat16, torch.float16) else partial
    y = reduce_from_group(wide, group)
    if bias is None:
        return y.to(x.dtype)
    if round_before_bias:
        return y.to(x.dtype) + bias.to(x.dtype)
    return (y + bias.to(y.dtype)).to(x.dtype)


class ColumnParallelLinear(nn.Module):
    """A Linear whose output features are split over ``group``: ``weight``
    and ``bias`` hold this rank's rows (torch's (out, in) layout). The input
    enters through ``copy_to_group``; the rest is ``nn.Linear``'s
    ``forward`` and ``preactivation`` on this rank's features."""

    def __init__(self, weight: nn.Parameter, bias: Optional[nn.Parameter], group: Group):
        super().__init__()
        self.out_features, self.in_features = weight.shape
        self.weight, self.bias, self.group = weight, bias, group

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return linear(copy_to_group(x, self.group), self.weight, self.bias)

    def preactivation(self, x: torch.Tensor) -> torch.Tensor:
        return preactivation(copy_to_group(x, self.group), self.weight, self.bias)


class RowParallelLinear(nn.Module):
    """A Linear whose input features are split over ``group``: ``weight``
    holds this rank's columns, ``bias`` stays whole
    (``row_parallel_linear``)."""

    def __init__(self, weight: nn.Parameter, bias: Optional[nn.Parameter], group: Group):
        super().__init__()
        self.out_features, self.in_features = weight.shape
        self.weight, self.bias, self.group = weight, bias, group

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return row_parallel_linear(x, self.weight, self.bias, self.group)
