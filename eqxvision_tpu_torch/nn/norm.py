"""Last-axis LayerNorm, channels-last BatchNorm and GroupNorm
(eqxvision_tpu/nn/norm.py).

LayerNorm's forward is ``ops.layer_norm``, as the JAX layer's is: the mean
and the centred variance in f32, the affine parameters read in their stored
type and applied in f32, and one rounding to the input's type at the end.
On a CUDA tensor that is the hand-written kernel (``csrc/layer_norm.cu``).

BatchNorm normalises over every axis but the last. Its running statistics
are buffers with torchvision's names and stay f32 whatever the module is
cast to, as the JAX package's ``State`` stays f32 when the model is cast.
GroupNorm takes each image's statistics over its spatial positions and
the channels of a group in f32, applies the affine in f32 and rounds once
to the input's type, as the JAX layer does.

A BatchNorm given a data group (``process_group``, set by
``parallel.sync_batchnorm``) takes its training statistics over the whole
group's batch, as the JAX layer's do over a batch sharded on the mesh.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.layernorm import layer_norm
from .collectives import Group, all_reduce_sum, broadcast_from_first


class LayerNorm(nn.Module):
    def __init__(
        self, dim: int, eps: float = 1e-5, elementwise_affine: bool = True, *, device: Optional[torch.device] = None
    ):
        super().__init__()
        self.dim = int(dim)
        self.eps = float(eps)
        if elementwise_affine:
            self.weight = nn.Parameter(torch.ones(self.dim, device=device))
            self.bias = nn.Parameter(torch.zeros(self.dim, device=device))
        else:
            self.register_parameter("weight", None)
            self.register_parameter("bias", None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return layer_norm(x, self.weight, self.bias, self.eps)


class GroupNorm(nn.Module):
    """torch.nn.GroupNorm on channels-last input ``(N, ..., C)``."""

    def __init__(self, num_groups: int, num_channels: int, eps: float = 1e-5, affine: bool = True, *,
                 device: Optional[torch.device] = None):
        super().__init__()
        if num_channels % num_groups:
            raise ValueError("num_channels must divide num_groups")
        self.num_groups = int(num_groups)
        self.num_channels = int(num_channels)
        self.eps = float(eps)
        if affine:
            self.weight = nn.Parameter(torch.ones(self.num_channels, device=device))
            self.bias = nn.Parameter(torch.zeros(self.num_channels, device=device))
        else:
            self.register_parameter("weight", None)
            self.register_parameter("bias", None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        g = self.num_groups
        xf = x.float().reshape(x.shape[0], -1, g, self.num_channels // g)
        var, mean = torch.var_mean(xf, dim=(1, 3), keepdim=True, correction=0)
        y = ((xf - mean) * torch.rsqrt(var + self.eps)).reshape(x.shape)
        if self.weight is not None:
            y = y * self.weight.float() + self.bias.float()
        return y.to(x.dtype)


_STATS = ("running_mean", "running_var")


def apply_keeping_f32(module: nn.Module, fn, recurse: bool, names) -> nn.Module:
    """``nn.Module._apply`` for ``module``, save that its buffers ``names``
    move with it but stay f32: a cast (``.to(torch.bfloat16)``, ``.half()``)
    leaves them as they are."""
    kept = {name: module._buffers[name] for name in names}
    nn.Module._apply(module, fn, recurse)
    for name, old in kept.items():
        new = module._buffers[name]
        if new.dtype != torch.float32:
            module._buffers[name] = old.to(new.device)
    return module


class BatchNorm(nn.Module):
    """torch.nn.BatchNorm2d/1d semantics on channels-last input (..., C).

    Inference (``eval()``): ``scale = rsqrt(var + eps) * weight`` and ``shift
    = bias - mean * scale`` in f32, ``y = x * scale + shift`` in f32, rounded
    once to x's type: one ``F.batch_norm`` call, whose f32 arithmetic runs
    in one pass over x (an f64 x is computed in f32 and cast back). Training (``train()``): the JAX layer's one-pass
    statistics, sums taken about the batch's first element in f32, normalise
    with the biased batch variance, and the running statistics move by
    ``momentum`` towards the mean and the unbiased variance. ``momentum``
    is a float, as in the JAX layer, which has no cumulative mode;
    ``num_batches_tracked`` counts the training forwards, as torch's does.

    With a ``process_group`` of several data ranks, the statistics are the
    global batch's: the pivot is the global batch's first element (the
    group's first rank's, broadcast), and the f32 sums of ``x - pivot`` and
    its square and the element count are summed over the group in one f64
    all-reduce, whose backward all-reduces too (every rank's output
    depends on every rank's sums). The running statistics then move alike
    on every rank.
    """

    process_group: Optional[Group] = None

    def __init__(
        self, num_features: int, eps: float = 1e-5, momentum: float = 0.1, affine: bool = True, *,
        device: Optional[torch.device] = None,
    ):
        super().__init__()
        self.num_features = int(num_features)
        self.eps = float(eps)
        self.momentum = float(momentum)
        if affine:
            self.weight = nn.Parameter(torch.ones(self.num_features, device=device))
            self.bias = nn.Parameter(torch.zeros(self.num_features, device=device))
        else:
            self.register_parameter("weight", None)
            self.register_parameter("bias", None)
        self.register_buffer("running_mean", torch.zeros(self.num_features, device=device))
        self.register_buffer("running_var", torch.ones(self.num_features, device=device))
        self.register_buffer("num_batches_tracked", torch.zeros((), dtype=torch.long, device=device))

    def _apply(self, fn, recurse=True):
        """Move the statistics with the module but keep them f32: a cast
        (``.to(torch.bfloat16)``, ``.half()``) reaches the affine only."""
        return apply_keeping_f32(self, fn, recurse, _STATS)

    def _affine(self):
        w = None if self.weight is None else self.weight.float()
        b = None if self.bias is None else self.bias.float()
        return w, b

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            w, b = self._affine()
            # F.batch_norm takes f32, bf16 or f16 beside f32 statistics and
            # refuses a wider x: that one computes in f32, as the JAX layer does
            xc = x.float() if x.dtype.itemsize > 4 else x
            y = F.batch_norm(xc.movedim(-1, 1), self.running_mean, self.running_var, w, b, False, 0.0, self.eps)
            return y.movedim(1, -1).to(x.dtype)
        return self._train_forward(x)

    def _train_forward(self, x: torch.Tensor) -> torch.Tensor:
        axes = tuple(range(x.ndim - 1))
        n = x[..., 0].numel()
        xf = x.float()
        pivot = broadcast_from_first(xf[(0,) * (x.ndim - 1)].detach(), self.process_group)
        xs = xf - pivot
        s1, s2 = xs.sum(axes), (xs * xs).sum(axes)
        bessel = n / max(n - 1, 1)
        if self.process_group is not None and self.process_group.size > 1:
            count = torch.full((1,), float(n), dtype=torch.float64, device=x.device)
            sums = all_reduce_sum(torch.cat([s1.double(), s2.double(), count]), self.process_group)
            c = self.num_features
            s1, s2, n = sums[:c].float(), sums[c : 2 * c].float(), sums[2 * c :].float()
            bessel = n / (n - 1).clamp_min(1)  # kept on the device: no host sync
        mean_s = s1 / n
        var = torch.clamp_min(s2 / n - mean_s * mean_s, 0.0)
        mean = mean_s + pivot
        with torch.no_grad():
            m = self.momentum
            unbiased = var * bessel
            self.running_mean.copy_((1 - m) * self.running_mean + m * mean)
            self.running_var.copy_((1 - m) * self.running_var + m * unbiased)
            self.num_batches_tracked.add_(1)
        scale = torch.rsqrt(var + self.eps)
        w, b = self._affine()
        if w is not None:
            scale = scale * w
        shift = -mean * scale
        if b is not None:
            shift = shift + b
        return (xf * scale + shift).to(x.dtype)
