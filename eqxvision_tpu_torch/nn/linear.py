"""Dense layer (eqxvision_tpu/nn/linear.py) in torch's own layout.

The weight is stored (out_features, in_features), as torch stores it; the
JAX package stores (in, out), and ``weights.from_jax`` transposes. Parameters
keep their dtype and the weight is cast to the input's at use, as in the JAX
layer. Torch's matmuls accumulate bf16 products in f32. The bias is added,
in its stored type, to the f32 accumulator, which is then rounded once: one
call where the bias has the input's type, else ``preactivation`` (f32
parameters and a bf16 input, the JAX package's mixed path).

``preactivation`` keeps the product's f32 accumulator unrounded
(``wide_product``), computed by one of four branches, chosen by the input:

- f32 (or wider) input: ``F.linear`` in x's type, on every device.
- bf16 or fp16 on the card with no gradient taken (inference): one GEMM on
  the tensor cores with an f32 output (``torch.mm``'s ``out_dtype``).
- bf16 on the card under grad (training): ``_WideProduct``, the same GEMM
  in the forward; in the backward the f32 cotangent is split exactly into
  two bf16 terms (``split_bf16``), so that both products of the backward
  run on the tensor cores too, with f32 outputs.
- everything else (the CPU; fp16 under grad, whose narrow exponent would
  not hold the split's low term): the operands upcast to f32, which is
  exact, since f32 holds every bf16 and fp16 value, and differentiable.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..core import init


class Linear(nn.Module):
    def __init__(
        self, in_features: int, out_features: int, use_bias: bool = True, *,
        generator: torch.Generator, device: Optional[torch.device] = None,
    ):
        super().__init__()
        self.in_features = int(in_features)
        self.out_features = int(out_features)
        kw = dict(generator=generator, device=device)
        self.weight = nn.Parameter(init.kaiming_uniform((out_features, in_features), in_features, **kw))
        self.bias = nn.Parameter(init.uniform_fan_in((out_features,), in_features, **kw)) if use_bias else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return linear(x, self.weight, self.bias)

    def preactivation(self, x: torch.Tensor) -> torch.Tensor:
        """The product accumulated in f32 (or x's type where that is wider)
        plus the bias in that type, before the cast to x's type: the JAX
        layer's ``Linear.preactivation``. An activation applied to it acts on
        the accumulator, not on a rounded output."""
        return preactivation(x, self.weight, self.bias)


def linear(x: torch.Tensor, weight: torch.Tensor, bias: Optional[torch.Tensor]) -> torch.Tensor:
    """``Linear``'s forward on these parameters."""
    if bias is None or bias.dtype == x.dtype:
        return F.linear(x, weight.to(x.dtype), bias)
    return preactivation(x, weight, bias).to(x.dtype)


def preactivation(x: torch.Tensor, weight: torch.Tensor, bias: Optional[torch.Tensor]) -> torch.Tensor:
    """``Linear.preactivation`` on these parameters."""
    y = wide_product(x, weight.to(x.dtype))
    return y if bias is None else y + bias.to(y.dtype)


def wide_product(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w.T`` (w in the (out, in) layout, of x's type) accumulated in
    f32, or in x's type where that is wider, and returned unrounded. On the
    card, where no gradient is taken, a bf16 or fp16 product keeps the
    GEMM's f32 accumulator (``torch.mm``'s ``out_dtype``, which has no
    derivative; ``torch.addmm``'s expands the bias over the output first,
    which is slower); under grad a bf16 product takes ``_WideProduct``, the
    same GEMM with a backward on the tensor cores, and
    ``wide_product.tensor_core_calls`` counts those calls. Otherwise the
    operands are upcast: exact, since f32 (and TF32) holds every bf16
    value, and differentiable."""
    wide = torch.promote_types(x.dtype, torch.float32)
    if x.dtype == wide:
        return F.linear(x, w)
    if x.device.type == "cuda":
        if not (torch.is_grad_enabled() and (x.requires_grad or w.requires_grad)):
            return mm_f32(x.reshape(-1, x.shape[-1]), w.t()).reshape(*x.shape[:-1], w.shape[0])
        if x.dtype == torch.bfloat16:
            wide_product.tensor_core_calls += 1
            return _WideProduct.apply(x, w)
    return F.linear(x.to(wide), w.to(wide))


wide_product.tensor_core_calls = 0


def mm_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` of two bf16 (or fp16) matrices, accumulated and returned in
    f32. On the card, the GEMM's own f32 output: the operands on the tensor
    cores, and never a bf16 output, whose split-K partial sums cuBLAS may
    add in bf16. Elsewhere, where ``torch.mm`` has no ``out_dtype``, the
    upcast operands' f32 product: the same arithmetic, since f32 holds the
    product of two such values exactly."""
    if a.device.type == "cuda":
        return torch.mm(a, b, out_dtype=torch.float32)
    return torch.mm(a.float(), b.float())


def split_bf16(g: torch.Tensor) -> torch.Tensor:
    """An (m, n) f32 matrix as an (m, 2n) bf16 one, ``[hi | lo]`` with
    ``hi = bf16(g)`` and ``lo = bf16(g - hi)``: ``hi`` alone is within
    2^-8 |g| of g (bf16 keeps 8 significant bits), ``hi + lo`` within 2^-17
    |g| elementwise (what ``hi`` misses, exact in f32, rounded to bf16
    again). A product with ``[hi | lo]`` over 2n terms is the product with
    g to that precision. Two passes over g on every device: the first
    writes hi, the second reads g and hi again to write lo."""
    if g.dtype != torch.float32 or g.ndim != 2:
        raise TypeError(f"split_bf16 takes an f32 matrix, got {g.dtype} of shape {tuple(g.shape)}")
    m, n = g.shape
    out = torch.empty(m, 2 * n, dtype=torch.bfloat16, device=g.device)
    hi, lo = out[:, :n], out[:, n:]
    hi.copy_(g)
    torch.sub(g, hi, out=lo)  # g - f32(hi) in f32, rounded once on the store
    return out


def wide_product_grads(
    g: torch.Tensor, x: torch.Tensor, w: torch.Tensor, need_x: bool = True, need_w: bool = True
) -> Tuple[Optional[torch.Tensor], Optional[torch.Tensor]]:
    """The gradients of ``x @ w.T`` (x (m, k) and w (n, k), bf16) from its
    f32 cotangent g (m, n), in f32 before their final cast, each None where
    it is not needed. With ``[hi | lo] = split_bf16(g)``: ``dX = [hi | lo]
    @ [w ; w]``, one GEMM over 2n; ``dW = [hi | lo]^T @ x``, one GEMM whose
    two (n, k) halves add up in f32. The cotangent is never rounded to a
    single bf16 term."""
    gs = split_bf16(g)
    dx = mm_f32(gs, torch.cat([w, w])) if need_x else None
    dw = None
    if need_w:
        halves = mm_f32(gs.t(), x)
        dw = halves[: w.shape[0]] + halves[w.shape[0]:]
    return dx, dw


class _WideProduct(torch.autograd.Function):
    """``x @ w.T`` of bf16 operands with an f32 output, on the tensor cores
    in both directions: the forward is ``mm_f32``, the backward
    ``wide_product_grads``, each gradient rounded once to its operand's
    type (where upcast operands round it, at their cast). It saves the bf16
    operands, half the bytes of the f32 copies upcast operands save."""

    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        return mm_f32(x.reshape(-1, x.shape[-1]), w.t()).reshape(*x.shape[:-1], w.shape[0])

    @staticmethod
    def backward(ctx, grad):
        x, w = ctx.saved_tensors
        dx, dw = wide_product_grads(
            grad.reshape(-1, grad.shape[-1]), x.reshape(-1, x.shape[-1]), w, *ctx.needs_input_grad
        )
        return None if dx is None else dx.to(x.dtype).reshape(x.shape), None if dw is None else dw.to(w.dtype)
