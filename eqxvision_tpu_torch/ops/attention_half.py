"""The fused attention half of a pre-norm ViT block: LayerNorm, the qkv
projection, multi-head attention, the output projection and the residual in
one op.

``fused_attention_half`` is the counterpart of the prototype Pallas kernel
``_attn_kernel`` of scripts/ablate_vit2.py (``attn_fused``) and of
scripts/ablate_vit4.py (``attn_half_fused``), whose bodies are the same. A
CUDA tensor goes through a hand-written Hopper kernel
(``csrc/attention_half.cu``), a CPU tensor through
``attention_half_reference``; no other device is accepted, and on CUDA
nothing falls back to the plain version. The gradient recomputes through
the plain version.

Rounding points, the prototype's: LayerNorm statistics and affine in f32,
rounded to x's type; the qkv projection accumulated in f32 plus its bias,
rounded; per head the scores in f32 times ``scale``, ``p = e / sum(e)`` in
f32 rounded to x's type before ``p . V``, each head's output accumulated in
f32 and rounded; the output projection accumulated in f32, plus its bias,
plus x, in f32, rounded once. The last point differs from the unfused bf16
composition (and the JAX model's bf16 block), which rounds the projection's
output and then adds the residual in bf16.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from .. import _native
from .attention import (
    _DTYPE_CODES, MAX_HEAD_DIM, _aligned, attention_stage_reference, export_op, recompute_grads, unit_affine,
)
from .layernorm import layer_norm_reference


def attention_half_reference(
    x: torch.Tensor,
    ln_weight: Optional[torch.Tensor],
    ln_bias: Optional[torch.Tensor],
    wqkv: torch.Tensor,
    bqkv: Optional[torch.Tensor],
    wproj: torch.Tensor,
    bproj: torch.Tensor,
    num_heads: int,
    scale: float,
    eps: float = 1e-6,
) -> torch.Tensor:
    """Plain version: ``x + proj(attention(qkv(LN(x))))`` with the kernel's
    rounding points; products accumulate in f32 (an f64 input computes in
    f64). Weights are (out, in); x is (B, L, D). The attention is the
    stage's plain version, ``attention_stage_reference``, which K1's plain
    version is too."""
    wide = torch.promote_types(x.dtype, torch.float32)
    a = layer_norm_reference(x, ln_weight, ln_bias, eps)
    qkv = F.linear(a.to(wide), wqkv.to(wide), None if bqkv is None else bqkv.to(wide)).to(x.dtype)
    o = attention_stage_reference(qkv, num_heads, scale)
    return (x.to(wide) + F.linear(o.to(wide), wproj.to(wide), bproj.to(wide))).to(x.dtype)


def _launch_kernel(x, ln_weight, ln_bias, wqkv, bqkv, wproj, bproj, num_heads, scale, eps):
    if x.dtype not in _DTYPE_CODES:
        raise TypeError(f"fused_attention_half kernel takes float32 or bfloat16, got {x.dtype}")
    vectors = [v for v in (ln_weight, ln_bias, bproj, bqkv) if v is not None]
    if any(t.device != x.device for t in (wqkv, wproj, *vectors)):
        raise ValueError(f"fused_attention_half: every tensor must be on {x.device} with x")
    if any(t.dtype not in _DTYPE_CODES for t in (wqkv, wproj, *vectors)):
        raise TypeError("fused_attention_half kernel takes float32 or bfloat16 weights and biases")
    b, l, d = x.shape
    if d % 8:
        raise ValueError(f"fused_attention_half kernel needs D to be a multiple of 8, got {d}")
    # the weights are read as stored; a copy only where their type is not x's
    wqkv, wproj = (_aligned(w.to(x.dtype)) for w in (wqkv, wproj))
    # the vectors are read in their stored type when they share one, else in f32
    param_dtype = vectors[0].dtype if all(v.dtype == vectors[0].dtype for v in vectors) else torch.float32
    if ln_weight is None:  # a folded norm: the kernel reads unit vectors
        ln_weight, ln_bias = unit_affine(d, param_dtype, x.device)
    ln_weight, ln_bias, bproj = (v.to(param_dtype).contiguous() for v in (ln_weight, ln_bias, bproj))
    # no qkv bias is a zero one: the GEMM's epilogue always reads its bias
    if bqkv is None:
        bqkv = torch.zeros(3 * d, dtype=param_dtype, device=x.device)
    bqkv = bqkv.to(param_dtype).contiguous()
    x = _aligned(x)
    out = torch.empty_like(x)
    if x.numel() == 0:
        return out
    rows = b * l
    qkv = torch.empty((rows, 3 * d), dtype=x.dtype, device=x.device)
    attn = torch.empty((rows, d), dtype=x.dtype, device=x.device)
    stats = torch.empty((rows, 2), dtype=torch.float32, device=x.device)
    lib = _native.library()
    with torch.cuda.device(x.device):
        err = lib.eqx_attention_half(
            x.data_ptr(), ln_weight.data_ptr(), ln_bias.data_ptr(), wqkv.data_ptr(), bqkv.data_ptr(),
            wproj.data_ptr(), bproj.data_ptr(), qkv.data_ptr(), attn.data_ptr(), stats.data_ptr(), out.data_ptr(),
            b, l, d, num_heads, scale, eps, _DTYPE_CODES[x.dtype], _DTYPE_CODES[param_dtype],
            torch.cuda.current_stream().cuda_stream,
        )
    if err:
        smem = lib.eqx_attention_half_smem_bytes(l, d // num_heads, _DTYPE_CODES[x.dtype])
        _native.check(
            err,
            f"fused_attention_half kernel on x {tuple(x.shape)} {x.dtype} with {num_heads} heads "
            f"(one attention block needs {smem} bytes of shared memory)",
        )
    fused_attention_half.launches += 1
    return out


def _forward(*args):
    x = args[0]
    if x.device.type == "cuda":
        return _launch_kernel(*args)
    if x.device.type == "cpu":
        return attention_half_reference(*args)
    raise ValueError(f"fused_attention_half runs on cuda (kernel) or cpu (plain torch), not {x.device}")


class _FusedAttentionHalf(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, ln_weight, ln_bias, wqkv, bqkv, wproj, bproj, num_heads, scale, eps):
        ctx.save_for_backward(x, ln_weight, ln_bias, wqkv, bqkv, wproj, bproj)
        ctx.static = (num_heads, scale, eps)
        return _forward(x, ln_weight, ln_bias, wqkv, bqkv, wproj, bproj, num_heads, scale, eps)

    @staticmethod
    def backward(ctx, grad_out):
        return recompute_grads(ctx, attention_half_reference, grad_out, n_static=3)


def fused_attention_half(
    x: torch.Tensor,
    ln_weight: Optional[torch.Tensor],
    ln_bias: Optional[torch.Tensor],
    wqkv: torch.Tensor,
    bqkv: Optional[torch.Tensor],
    wproj: torch.Tensor,
    bproj: torch.Tensor,
    num_heads: int,
    scale: Optional[float] = None,
    eps: float = 1e-6,
) -> torch.Tensor:
    """``x + proj(attention(qkv(LN(x))))`` over x of shape (B, L, D).

    ln_weight and ln_bias are (D,), or both None for a LayerNorm without
    affine (``ops.fold_layernorm``'s); bproj is (D,), bqkv (3D,) or None; wqkv (3D, D)
    laid out [q heads | k heads | v heads] and wproj (D, D) in the port's
    ``Linear`` layout (out, in). ``scale`` defaults to 1/sqrt(D / num_heads).
    The projection, its bias and the residual are summed in f32 and rounded
    once, as in the prototype; the unfused bf16 block rounds the projection
    first. ``fused_attention_half.launches`` counts kernel launches (one per
    call, which runs the kernel's four launches).
    """
    if x.ndim != 3:
        raise ValueError(f"fused_attention_half expects x of shape (B, L, D), got {tuple(x.shape)}")
    d = x.shape[-1]
    if num_heads <= 0 or d % num_heads:
        raise ValueError(f"D={d} is not divisible by num_heads={num_heads}")
    if d // num_heads > MAX_HEAD_DIM:
        raise ValueError(f"fused_attention_half takes head_dim <= {MAX_HEAD_DIM}, got {d // num_heads}")
    if (ln_weight is None) != (ln_bias is None):
        raise ValueError("fused_attention_half takes both ln_weight and ln_bias, or neither")
    expected = {
        "ln_weight": (ln_weight, (d,)), "ln_bias": (ln_bias, (d,)), "wqkv": (wqkv, (3 * d, d)),
        "wproj": (wproj, (d, d)), "bproj": (bproj, (d,)), "bqkv": (bqkv, (3 * d,)),
    }
    for name, (t, shape) in expected.items():
        if t is not None and tuple(t.shape) != shape:
            raise ValueError(f"fused_attention_half: expected {name} of shape {shape}, got {tuple(t.shape)}")
    if scale is None:
        scale = (d // num_heads) ** -0.5
    args = (x, ln_weight, ln_bias, wqkv, bqkv, wproj, bproj, int(num_heads), float(scale), float(eps))
    if torch.compiler.is_exporting():
        return _fused_attention_half_op(*args)
    return _FusedAttentionHalf.apply(*args)


fused_attention_half.launches = 0
_fused_attention_half_op = export_op(
    "fused_attention_half",
    "(Tensor x, Tensor? ln_weight, Tensor? ln_bias, Tensor wqkv, Tensor? bqkv, Tensor wproj, Tensor bproj, "
    "int num_heads, float scale, float eps) -> Tensor",
    _launch_kernel, attention_half_reference, lambda x, *rest: x.new_empty(x.shape),
)
