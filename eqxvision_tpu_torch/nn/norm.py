"""Last-axis LayerNorm and channels-last BatchNorm (eqxvision_tpu/nn/norm.py).

LayerNorm's forward is ``ops.layer_norm``, as the JAX layer's is: the mean
and the centred variance in f32, the affine parameters read in their stored
type and applied in f32, and one rounding to the input's type at the end.
On a CUDA tensor that is the hand-written kernel (``csrc/layer_norm.cu``).

BatchNorm normalises over every axis but the last. Its running statistics
are buffers with torchvision's names and stay f32 whatever the module is
cast to, as the JAX package's ``State`` stays f32 when the model is cast.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.layernorm import layer_norm


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
    """

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
        pivot = xf[(0,) * (x.ndim - 1)].detach()
        xs = xf - pivot
        mean_s = xs.sum(axes) / n
        var = torch.clamp_min((xs * xs).sum(axes) / n - mean_s * mean_s, 0.0)
        mean = mean_s + pivot
        with torch.no_grad():
            m = self.momentum
            unbiased = var * (n / max(n - 1, 1))
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
