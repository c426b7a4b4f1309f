"""The fused MLP half of a pre-norm block: LayerNorm, fc1, gelu, fc2, layer
scale and residual in one op.

``fused_mlp_half`` is the counterpart of the prototype Pallas kernels
``cn_mlp_fused`` (scripts/ablate_convnext2.py, ConvNeXt's block after its
depthwise conv), ``mlp_fused`` (scripts/ablate_vit2.py) and
``mlp_half_fused`` (scripts/ablate_vit4.py; the row-flattened closure of
scripts/ablate_vit3.py has the same body), the ViT MLP half. A CUDA tensor
goes through a hand-written Hopper kernel (``csrc/mlp_half.cu``), a CPU
tensor through ``mlp_half_reference``; no other device is accepted, and on
CUDA nothing falls back to the plain version. The gradient recomputes
through the plain version.

Rounding points, the prototypes': LayerNorm statistics and affine in f32,
rounded to x's type; fc1 accumulated in f32, plus b1, exact-erf gelu in
f32, rounded to x's type; fc2 accumulated in f32, plus b2, times the layer
scale, plus the residual, in f32, rounded once. gelu thus acts on fc1's f32
accumulator, as in the JAX models, and not on a rounded fc1 output.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from .. import _native
from .attention import _DTYPE_CODES, _aligned, export_op, recompute_grads, unit_affine
from .layernorm import layer_norm_reference


def mlp_half_reference(
    x: torch.Tensor,
    residual: torch.Tensor,
    ln_weight: Optional[torch.Tensor],
    ln_bias: Optional[torch.Tensor],
    w1: torch.Tensor,
    b1: torch.Tensor,
    w2: torch.Tensor,
    b2: torch.Tensor,
    layer_scale: Optional[torch.Tensor] = None,
    eps: float = 1e-6,
) -> torch.Tensor:
    """Plain version: ``residual + layer_scale * (fc2(gelu(fc1(LN(x)))))``
    with the kernel's rounding points; products accumulate in f32 (an f64
    input computes in f64). Weights are (out, in)."""
    wide = torch.promote_types(x.dtype, torch.float32)
    a = layer_norm_reference(x, ln_weight, ln_bias, eps)
    h = F.gelu(F.linear(a.to(wide), w1.to(wide), b1.to(wide))).to(x.dtype)
    y = F.linear(h.to(wide), w2.to(wide), b2.to(wide))
    if layer_scale is not None:
        y = y * layer_scale.to(wide)
    return (residual.to(wide) + y).to(x.dtype)


def _launch_kernel(x, residual, ln_weight, ln_bias, w1, b1, w2, b2, layer_scale, eps):
    if x.dtype not in _DTYPE_CODES:
        raise TypeError(f"fused_mlp_half kernel takes float32 or bfloat16, got {x.dtype}")
    if residual.dtype != x.dtype:
        raise TypeError(f"fused_mlp_half: residual is {residual.dtype}, x is {x.dtype}")
    vectors = [v for v in (ln_weight, ln_bias, b1, b2, layer_scale) if v is not None]
    tensors = [residual, w1, w2, *vectors]
    if any(t.device != x.device for t in tensors):
        raise ValueError(f"fused_mlp_half: every tensor must be on {x.device} with x")
    if any(t.dtype not in _DTYPE_CODES for t in (w1, w2, *vectors)):
        raise TypeError("fused_mlp_half kernel takes float32 or bfloat16 weights, biases and layer scale")
    c, hidden = x.shape[-1], w1.shape[0]
    if c % 8 or hidden % 8:
        raise ValueError(f"fused_mlp_half kernel needs C and the hidden width to be multiples of 8, got {c}, {hidden}")
    # the weights are read as stored; a copy only where their type is not x's
    w1, w2 = (_aligned(w.to(x.dtype)) for w in (w1, w2))
    # the vectors are read in their stored type when they share one, else in f32
    param_dtype = vectors[0].dtype if all(v.dtype == vectors[0].dtype for v in vectors) else torch.float32
    if ln_weight is None:  # a folded norm: the kernel reads unit vectors
        ln_weight, ln_bias = unit_affine(c, param_dtype, x.device)
    ln_weight, ln_bias, b1, b2 = (v.to(param_dtype).contiguous() for v in (ln_weight, ln_bias, b1, b2))
    if layer_scale is not None:
        layer_scale = layer_scale.to(param_dtype).contiguous()
    x2 = _aligned(x.reshape(-1, c))
    res2 = x2 if residual is x else _aligned(residual.reshape(-1, c))
    rows = x2.shape[0]
    out = torch.empty_like(x2)
    if rows == 0:
        return out.view(x.shape)
    h = torch.empty((rows, hidden), dtype=x.dtype, device=x.device)
    stats = torch.empty((rows, 2), dtype=torch.float32, device=x.device)
    lib = _native.library()
    with torch.cuda.device(x.device):
        err = lib.eqx_mlp_half(
            x2.data_ptr(), res2.data_ptr(), ln_weight.data_ptr(), ln_bias.data_ptr(), w1.data_ptr(), b1.data_ptr(),
            w2.data_ptr(), b2.data_ptr(), None if layer_scale is None else layer_scale.data_ptr(), h.data_ptr(),
            stats.data_ptr(), out.data_ptr(), rows, c, hidden, eps, _DTYPE_CODES[x.dtype], _DTYPE_CODES[param_dtype],
            torch.cuda.current_stream().cuda_stream,
        )
    if err:
        _native.check(err, f"fused_mlp_half kernel on x {tuple(x.shape)} {x.dtype}, hidden {hidden}")
    fused_mlp_half.launches += 1
    return out.view(x.shape)


def _forward(*args):
    x = args[0]
    if x.device.type == "cuda":
        return _launch_kernel(*args)
    if x.device.type == "cpu":
        return mlp_half_reference(*args)
    raise ValueError(f"fused_mlp_half runs on cuda (kernel) or cpu (plain torch), not {x.device}")


class _FusedMlpHalf(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, residual, ln_weight, ln_bias, w1, b1, w2, b2, layer_scale, eps):
        ctx.save_for_backward(x, residual, ln_weight, ln_bias, w1, b1, w2, b2, layer_scale)
        ctx.static = (eps,)
        return _forward(x, residual, ln_weight, ln_bias, w1, b1, w2, b2, layer_scale, eps)

    @staticmethod
    def backward(ctx, grad_out):
        return recompute_grads(ctx, mlp_half_reference, grad_out, n_static=1)


def fused_mlp_half(
    x: torch.Tensor,
    residual: torch.Tensor,
    ln_weight: Optional[torch.Tensor],
    ln_bias: Optional[torch.Tensor],
    w1: torch.Tensor,
    b1: torch.Tensor,
    w2: torch.Tensor,
    b2: torch.Tensor,
    layer_scale: Optional[torch.Tensor] = None,
    eps: float = 1e-6,
) -> torch.Tensor:
    """``residual + layer_scale * (fc2(gelu(fc1(LN(x)))))`` over the last
    axis of ``x`` (any lead dims).

    x and residual have one shape (residual may be x itself, as in ViT);
    ln_weight and ln_bias are (C,), or both None for a LayerNorm without
    affine (``ops.fold_layernorm``'s); b2 and layer_scale are (C,), b1 (H,); w1 (H, C) and
    w2 (C, H) in the port's ``Linear`` layout (out, in). ``layer_scale=None``
    means 1. ``fused_mlp_half.launches`` counts kernel launches (one per
    call, which runs the kernel's three launches).
    """
    if x.ndim == 0:
        raise ValueError("fused_mlp_half needs at least one axis")
    c = x.shape[-1]
    hidden = w1.shape[0] if w1.ndim == 2 else -1
    expected = {
        "residual": (residual, tuple(x.shape)), "ln_weight": (ln_weight, (c,)), "ln_bias": (ln_bias, (c,)),
        "w1": (w1, (hidden, c)), "b1": (b1, (hidden,)), "w2": (w2, (c, hidden)), "b2": (b2, (c,)),
    }
    if (ln_weight is None) != (ln_bias is None):
        raise ValueError("fused_mlp_half takes both ln_weight and ln_bias, or neither")
    expected["layer_scale"] = (layer_scale, (c,))
    for name, (t, shape) in expected.items():
        if t is not None and tuple(t.shape) != shape:
            raise ValueError(f"fused_mlp_half: expected {name} of shape {shape}, got {tuple(t.shape)}")
    args = (x, residual, ln_weight, ln_bias, w1, b1, w2, b2, layer_scale, float(eps))
    if torch.compiler.is_exporting():
        return _fused_mlp_half_op(*args)
    return _FusedMlpHalf.apply(*args)


fused_mlp_half.launches = 0
_fused_mlp_half_op = export_op(
    "fused_mlp_half",
    "(Tensor x, Tensor residual, Tensor? ln_weight, Tensor? ln_bias, Tensor w1, Tensor b1, Tensor w2, Tensor b2, "
    "Tensor? layer_scale, float eps) -> Tensor",
    _launch_kernel, mlp_half_reference, lambda x, *rest: x.new_empty(x.shape),
)
