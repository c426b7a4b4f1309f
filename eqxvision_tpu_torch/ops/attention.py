"""Multi-head attention on a fused qkv projection (ViT's hot path).

Counterpart of ``fused_qkv_attention`` in eqxvision_tpu/ops/attention.py.
A CUDA tensor goes through the hand-written Hopper kernel
(``csrc/fused_qkv_attention.cu``); a CPU tensor goes through
``fused_qkv_attention_reference``, a few lines of torch that mirror the JAX
package's ``_fused_qkv_reference``. No other device is accepted, and on CUDA
nothing falls back to the plain version. The gradient recomputes through the
plain version, as the JAX package's ``_fused_qkv_bwd`` does.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from .. import _native

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
MAX_HEAD_DIM = 128


def fused_qkv_attention_reference(qkv: torch.Tensor, num_heads: int, scale: float) -> torch.Tensor:
    """softmax(q k^T * scale) v per head, scores and softmax in f32.

    qkv: (B, L, 3*D) as [q heads | k heads | v heads]; returns (B, L, D).
    The probabilities are rounded to the input type before p.V, and both
    products accumulate in f32, as in the JAX reference."""
    b, l, three_d = qkv.shape
    d = three_d // 3
    head_dim = d // num_heads
    q, k, v = (t.reshape(b, l, num_heads, head_dim).transpose(1, 2) for t in qkv.split(d, dim=-1))
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    p = torch.softmax(s, dim=-1).to(qkv.dtype)
    o = torch.matmul(p.float(), v.float()).to(qkv.dtype)
    return o.transpose(1, 2).reshape(b, l, d)


def _launch_kernel(qkv: torch.Tensor, num_heads: int, scale: float) -> torch.Tensor:
    if qkv.dtype not in _DTYPE_CODES:
        raise TypeError(f"fused_qkv_attention kernel takes float32 or bfloat16, got {qkv.dtype}")
    if not qkv.is_contiguous():
        raise ValueError("fused_qkv_attention kernel needs a contiguous qkv tensor")
    b, l, three_d = qkv.shape
    d = three_d // 3
    head_dim = d // num_heads
    if head_dim > MAX_HEAD_DIM:
        raise ValueError(f"fused_qkv_attention kernel takes head_dim <= {MAX_HEAD_DIM}, got {head_dim}")
    out = torch.empty((b, l, d), dtype=qkv.dtype, device=qkv.device)
    lib = _native.library()
    with torch.cuda.device(qkv.device):
        err = lib.eqx_fused_qkv_attention(
            qkv.data_ptr(), out.data_ptr(), b, l, num_heads, head_dim, scale,
            _DTYPE_CODES[qkv.dtype], torch.cuda.current_stream().cuda_stream,
        )
    if err:
        smem = lib.eqx_fused_qkv_attention_smem_bytes(l, head_dim, qkv.element_size())
        _native.check(
            err,
            f"fused_qkv_attention kernel on qkv {tuple(qkv.shape)} {qkv.dtype} with {num_heads} heads "
            f"(one block needs {smem} bytes of shared memory)",
        )
    fused_qkv_attention.launches += 1
    return out


def _forward(qkv: torch.Tensor, num_heads: int, scale: float) -> torch.Tensor:
    if qkv.device.type == "cuda":
        return _launch_kernel(qkv, num_heads, scale)
    if qkv.device.type == "cpu":
        return fused_qkv_attention_reference(qkv, num_heads, scale)
    raise ValueError(f"fused_qkv_attention runs on cuda (kernel) or cpu (plain torch), not {qkv.device}")


class _FusedQkvAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, qkv, num_heads, scale):
        ctx.save_for_backward(qkv)
        ctx.num_heads, ctx.scale = num_heads, scale
        return _forward(qkv, num_heads, scale)

    @staticmethod
    def backward(ctx, grad_out):
        (qkv,) = ctx.saved_tensors
        with torch.enable_grad():
            t = qkv.detach().requires_grad_(True)
            out = fused_qkv_attention_reference(t, ctx.num_heads, ctx.scale)
            (grad_qkv,) = torch.autograd.grad(out, t, grad_out)
        return grad_qkv, None, None


def fused_qkv_attention(qkv: torch.Tensor, num_heads: int, scale: Optional[float] = None) -> torch.Tensor:
    """Multi-head attention directly on a fused qkv projection.

    qkv: (B, L, 3*D) laid out [q heads | k heads | v heads] (the
    ``nn.Linear(dim, 3*dim)`` convention); returns (B, L, D) ready for the
    output projection. ``scale`` defaults to 1/sqrt(head_dim).
    ``fused_qkv_attention.launches`` counts kernel launches.
    """
    if qkv.ndim != 3 or qkv.shape[-1] % 3:
        raise ValueError(f"expected qkv of shape (B, L, 3*D), got {tuple(qkv.shape)}")
    d = qkv.shape[-1] // 3
    if d % num_heads:
        raise ValueError(f"D={d} is not divisible by num_heads={num_heads}")
    if scale is None:
        scale = 1.0 / math.sqrt(d // num_heads)
    return _FusedQkvAttention.apply(qkv, num_heads, float(scale))


fused_qkv_attention.launches = 0
