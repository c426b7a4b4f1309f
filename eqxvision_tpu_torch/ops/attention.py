"""Attention ops of eqxvision_tpu/ops/attention.py.

Counterparts of the JAX package's ``fused_qkv_attention`` (ViT's attention
on a fused qkv projection, in training with dropout or drop path; inference
takes ``ops.fused_attention_half``), ``window_qkv_attention``/
``packed_window_attention`` (Swin's windows) and the public ``attention``
(any lead dims, a compact additive bias). A CUDA tensor goes through a
hand-written Hopper kernel (``csrc/fused_qkv_attention.cu``, whose
attention stage ``csrc/attention_stage.cuh`` the fused attention half runs
too, ``csrc/window_attention.cu``, ``csrc/attention.cu``); a CPU tensor goes
through the op's plain version, a few lines of torch that mirror the JAX
package's references. No other device is accepted, and on CUDA nothing
falls back to the plain version. Gradients recompute through the plain
versions, as the JAX package's custom VJPs do.
"""
from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from .. import _native

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
MAX_HEAD_DIM = 128


def attention_stage_reference(qkv: torch.Tensor, num_heads: int, scale: float) -> torch.Tensor:
    """softmax(q k^T * scale) v per head, scores and softmax in f32: the
    plain version of the attention stage that K1 and the fused attention
    half share (``csrc/attention_stage.cuh``).

    qkv: (B, L, 3*D) as [q heads | k heads | v heads]; returns (B, L, D).
    The probabilities are rounded to the input type before p.V, and both
    products accumulate in f32 (an f64 input computes in f64), as in the
    JAX reference."""
    wide = torch.promote_types(qkv.dtype, torch.float32)
    b, l, three_d = qkv.shape
    d = three_d // 3
    q, k, v = (t.reshape(b, l, num_heads, d // num_heads).transpose(1, 2).to(wide) for t in qkv.split(d, dim=-1))
    p = torch.softmax(torch.matmul(q, k.transpose(-1, -2)) * scale, dim=-1).to(qkv.dtype)
    o = torch.matmul(p.to(wide), v).to(qkv.dtype)
    return o.transpose(1, 2).reshape(b, l, d)


# K1's plain version is the stage's.
fused_qkv_attention_reference = attention_stage_reference


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """``t`` contiguous at a 16-byte aligned address (a copy only if not)."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _launch_kernel(qkv: torch.Tensor, num_heads: int, scale: float) -> torch.Tensor:
    if qkv.dtype not in _DTYPE_CODES:
        raise TypeError(f"fused_qkv_attention kernel takes float32 or bfloat16, got {qkv.dtype}")
    if not qkv.is_contiguous():
        raise ValueError("fused_qkv_attention kernel needs a contiguous qkv tensor")
    qkv = _aligned(qkv)  # TMA reads it from a 16-byte aligned base
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


def recompute_grads(ctx, reference, grad_out, n_static):
    """Backward of a kernel whose gradient is recomputed through its plain
    version: the saved tensors are the kernel's tensor inputs, in order,
    and ``reference(*tensors, *static)`` is the plain version. Returns one
    gradient for each input of ``forward`` (None for the statics)."""
    saved = ctx.saved_tensors
    with torch.enable_grad():
        inputs = [
            None if t is None else t.detach().requires_grad_(need)
            for t, need in zip(saved, ctx.needs_input_grad)
        ]
        out = reference(*inputs, *ctx.static)
        wanted = [t for t in inputs if t is not None and t.requires_grad]
        grads = iter(torch.autograd.grad(out, wanted, grad_out) if wanted else ())
    return (*(next(grads) if t is not None and t.requires_grad else None for t in inputs), *([None] * n_static))


class _FusedQkvAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, qkv, num_heads, scale):
        ctx.save_for_backward(qkv)
        ctx.static = (num_heads, scale)
        return _forward(qkv, num_heads, scale)

    @staticmethod
    def backward(ctx, grad_out):
        return recompute_grads(ctx, fused_qkv_attention_reference, grad_out, n_static=2)


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


# --------------------------------------------------------------------------
# Swin window attention on a fused qkv projection
# --------------------------------------------------------------------------

WINDOW_MAX_HEAD_DIM = 64


def window_qkv_attention_reference(
    qkv: torch.Tensor, bias: torch.Tensor, num_heads: int, scale: float, cosine_gs: Optional[torch.Tensor] = None
) -> torch.Tensor:
    """Per window and head, softmax(q k^T * scale + bias) v, scores and
    softmax in f32.

    qkv: (B, nW, L, 3C) as [q heads | k heads | v heads]; bias (nW | 1, H, L,
    L); returns (B, nW, L, C). ``cosine_gs`` (H,) selects Swin v2: q and k
    are L2-normalised per head (norm floored at 1e-12) and q is multiplied
    by its head's ``cosine_gs``, as the JAX package's
    ``_packed_window_reference`` does, but kept in f32 where that rounds
    them to the input type: with a logit scale of up to 100, rounding q
    to bf16 moves scores by ~0.1. The probabilities are rounded to the
    input type before p.V; both products accumulate in f32 (in f64 for an
    f64 qkv) and the output is rounded once."""
    b, nw, l, three_c = qkv.shape
    c = three_c // 3
    hd = c // num_heads
    q, k, v = (t.reshape(b, nw, l, num_heads, hd).transpose(2, 3) for t in qkv.split(c, dim=-1))
    ct = torch.float64 if qkv.dtype == torch.float64 else torch.float32  # f64 in, f64 throughout
    if cosine_gs is not None:
        q = torch.nn.functional.normalize(q.to(ct), dim=-1, eps=1e-12) * cosine_gs.to(ct).reshape(num_heads, 1, 1)
        k = torch.nn.functional.normalize(k.to(ct), dim=-1, eps=1e-12)
    s = torch.matmul(q.to(ct), k.to(ct).transpose(-1, -2)) * scale + bias.to(ct)
    p = torch.softmax(s, dim=-1).to(qkv.dtype)
    o = torch.matmul(p.to(ct), v.to(ct)).to(qkv.dtype)
    return o.transpose(2, 3).reshape(b, nw, l, c)


def _launch_window_kernel(qkv, bias, num_heads, scale, cosine_gs):
    if qkv.dtype not in _DTYPE_CODES:
        raise TypeError(f"window_qkv_attention kernel takes float32 or bfloat16, got {qkv.dtype}")
    b, nw, l, three_c = qkv.shape
    head_dim = three_c // 3 // num_heads
    if head_dim > WINDOW_MAX_HEAD_DIM:
        raise ValueError(f"window_qkv_attention kernel takes head_dim <= {WINDOW_MAX_HEAD_DIM}, got {head_dim}")
    qkv = qkv.contiguous()
    if qkv.data_ptr() % 4:
        raise ValueError("window_qkv_attention kernel reads qkv 4 bytes at a time; pass an aligned tensor")
    bias = bias.to(device=qkv.device, dtype=torch.float32).contiguous()
    gs = None if cosine_gs is None else cosine_gs.to(device=qkv.device, dtype=torch.float32).contiguous()
    out = torch.empty((b, nw, l, three_c // 3), dtype=qkv.dtype, device=qkv.device)
    lib = _native.library()
    with torch.cuda.device(qkv.device):
        err = lib.eqx_window_attention(
            qkv.data_ptr(), bias.data_ptr(), None if gs is None else gs.data_ptr(), out.data_ptr(),
            b * nw, nw, bias.shape[0], l, num_heads, head_dim, scale,
            _DTYPE_CODES[qkv.dtype], torch.cuda.current_stream().cuda_stream,
        )
    if err:
        smem = lib.eqx_window_attention_smem_bytes(l, head_dim, qkv.element_size())
        _native.check(
            err,
            f"window_qkv_attention kernel on qkv {tuple(qkv.shape)} {qkv.dtype} with {num_heads} heads "
            f"(one block needs {smem} bytes of shared memory)",
        )
    window_qkv_attention.launches += 1
    return out


def _window_forward(qkv, bias, num_heads, scale, cosine_gs):
    if qkv.device.type == "cuda":
        return _launch_window_kernel(qkv, bias, num_heads, scale, cosine_gs)
    if qkv.device.type == "cpu":
        return window_qkv_attention_reference(qkv, bias, num_heads, scale, cosine_gs)
    raise ValueError(f"window_qkv_attention runs on cuda (kernel) or cpu (plain torch), not {qkv.device}")


def _window_reference_positional(qkv, bias, cosine_gs, num_heads, scale):
    return window_qkv_attention_reference(qkv, bias, num_heads, scale, cosine_gs)


class _WindowQkvAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, qkv, bias, cosine_gs, num_heads, scale):
        ctx.save_for_backward(qkv, bias, cosine_gs)
        ctx.static = (num_heads, scale)
        return _window_forward(qkv, bias, num_heads, scale, cosine_gs)

    @staticmethod
    def backward(ctx, grad_out):
        return recompute_grads(ctx, _window_reference_positional, grad_out, n_static=2)


def window_qkv_attention(
    qkv: torch.Tensor, bias: torch.Tensor, num_heads: int, scale: float, cosine_gs: Optional[torch.Tensor] = None
) -> torch.Tensor:
    """Swin's windowed multi-head attention on a fused qkv projection.

    qkv: (B, nW, L, 3C) laid out [q heads | k heads | v heads]; bias:
    (nW | 1, H, L, L) additive (relative-position bias plus shift mask),
    taken in f32; returns (B, nW, L, C) ready for the output projection.
    ``cosine_gs`` (H,), the clamped exp(logit_scale), selects Swin v2's
    cosine attention; pass ``scale=1`` with it.

    Counterpart of both ``window_qkv_attention`` and
    ``packed_window_attention`` in eqxvision_tpu/ops/attention.py, which
    compute the same function on two layouts. The 128-lane padding of C
    to Cp, the head-masked K/V stacks and the segment-sum softmax there are
    the TPU's layout devices and are dropped here: the softmax is per head,
    so a head whose scores sit far below another head's still gives finite,
    exact output, and the bias-max prefold and per-head row-max devices
    have no counterpart. A CUDA tensor goes through the hand-written
    kernel (``csrc/window_attention.cu``), a CPU tensor through
    ``window_qkv_attention_reference``. The gradient recomputes through the
    plain version. ``window_qkv_attention.launches`` counts kernel launches.
    """
    if qkv.ndim != 4 or qkv.shape[-1] % 3:
        raise ValueError(f"expected qkv of shape (B, nW, L, 3*C), got {tuple(qkv.shape)}")
    b, nw, l, three_c = qkv.shape
    c = three_c // 3
    if c % num_heads:
        raise ValueError(f"C={c} is not divisible by num_heads={num_heads}")
    if bias.ndim != 4 or bias.shape[0] not in (1, nw) or tuple(bias.shape[1:]) != (num_heads, l, l):
        raise ValueError(f"expected bias of shape ({nw} or 1, {num_heads}, {l}, {l}), got {tuple(bias.shape)}")
    if cosine_gs is not None and cosine_gs.numel() != num_heads:
        raise ValueError(f"cosine_gs needs one value per head ({num_heads}), got {tuple(cosine_gs.shape)}")
    if cosine_gs is not None:
        cosine_gs = cosine_gs.reshape(num_heads)
    return _WindowQkvAttention.apply(qkv, bias, cosine_gs, num_heads, float(scale))


window_qkv_attention.launches = 0


# --------------------------------------------------------------------------
# Scaled dot-product attention with a compact bias (the public op)
# --------------------------------------------------------------------------


def attention_reference(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, bias: Optional[torch.Tensor] = None,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Plain scaled dot-product attention: q, k, v (..., N, Dh), bias
    broadcastable to (..., N, N). Scores, bias and softmax in f32; the
    probabilities rounded to q's type before p.V; f32 accumulation; output
    in q's type, as the JAX package's ``attention_reference``."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    if bias is not None:
        s = s + bias.float()
    p = torch.softmax(s, dim=-1).to(q.dtype)
    return torch.matmul(p.float(), v.float()).to(q.dtype)


def _attention_flat_reference(q, k, v, bias, scale):
    """(B, N, Dh) with a compact bias (Bb, N, N): row b reads bias[b % Bb]."""
    if bias is None:
        return attention_reference(q, k, v, None, scale)
    b, n, dh = q.shape
    r = b // bias.shape[0]
    shape = (r, bias.shape[0], n, dh)
    out = attention_reference(q.reshape(shape), k.reshape(shape), v.reshape(shape), bias[None], scale)
    return out.reshape(b, n, dh)


def _launch_attention_kernel(q, k, v, bias, scale):
    if q.dtype not in _DTYPE_CODES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"attention kernel takes q, k, v all float32 or all bfloat16, got {q.dtype}, {k.dtype}, {v.dtype}")
    b, n, dh = q.shape
    if dh > MAX_HEAD_DIM:
        raise ValueError(f"attention kernel takes head_dim <= {MAX_HEAD_DIM}, got {dh}")
    q, k, v = _aligned(q), _aligned(k), _aligned(v)  # the kernels read them from 16-byte aligned bases
    lib = _native.library()
    n_bias, ld = 1, n
    if bias is not None:  # compact (Bb, N, N), laid out with the kernel's row stride and room after it
        layout = (ctypes.c_int * 2)()
        lib.eqx_attention_bias_layout(n, dh, _DTYPE_CODES[q.dtype], layout)
        n_bias, (ld, slack) = bias.shape[0], layout
        if (ld, slack) == (n, 0):
            bias = bias.to(device=q.device, dtype=torch.float32).contiguous()
        else:  # the row padding and the room are read only at masked keys
            padded = torch.empty(n_bias * n * ld + slack, dtype=torch.float32, device=q.device)
            padded[: n_bias * n * ld].view(n_bias, n, ld)[:, :, :n].copy_(bias)
            bias = padded
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        err = lib.eqx_attention(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), None if bias is None else bias.data_ptr(), ld, out.data_ptr(),
            b, n_bias, n, dh, scale, _DTYPE_CODES[q.dtype],
            torch.cuda.current_stream().cuda_stream,
        )
    if err:
        smem = lib.eqx_attention_smem_bytes(n, dh, q.element_size())
        _native.check(
            err, f"attention kernel on q {tuple(q.shape)} {q.dtype} (one block needs {smem} bytes of shared memory)"
        )
    attention.launches += 1
    return out


def _attention_forward(q, k, v, bias, scale):
    if q.device.type == "cuda":
        return _launch_attention_kernel(q, k, v, bias, scale)
    if q.device.type == "cpu":
        return _attention_flat_reference(q, k, v, bias, scale)
    raise ValueError(f"attention runs on cuda (kernel) or cpu (plain torch), not {q.device}")


class _Attention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, bias, scale):
        ctx.save_for_backward(q, k, v, bias)
        ctx.static = (scale,)
        return _attention_forward(q, k, v, bias, scale)

    @staticmethod
    def backward(ctx, grad_out):
        return recompute_grads(ctx, _attention_flat_reference, grad_out, n_static=1)


def attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, bias: Optional[torch.Tensor] = None,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Fused scaled dot-product attention (differentiable).

    q, k, v: (..., N, Dh) with any number of leading batch dims, flattened to
    B. bias: optional, broadcastable to (..., N, N). A bias whose lead dims,
    after leading 1s are stripped, are a suffix of q's stays compact as
    (Bb, N, N), and row b reads ``bias[b % Bb]``: the kernel never copies it
    over the batch. Any other bias is expanded to (B, N, N), as in the JAX
    package. Counterpart of its ``attention`` and of the Pallas kernels
    ``_attn_kernel``/``kernel4`` behind it (``csrc/attention.cu``: rows of
    at most 64 tokens, bf16 with a head dim of 16, 32, 48 or 64 and f32 with
    16 or 32, on the window stage of ``csrc/window_attention.cu`` as one head
    a window, row b reading bias slab b % Bb; every other shape on the
    attention stage of ``csrc/attention_stage.cuh``); the padding of N
    there is the TPU's and has no counterpart: the kernels mask the ragged
    tail. Any N. ``attention.launches`` counts kernel launches.
    """
    if q.ndim < 2 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(
            f"expected q, k, v of one shape (..., N, Dh), got {tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}"
        )
    lead, (n, dh) = tuple(q.shape[:-2]), q.shape[-2:]
    if scale is None:
        scale = 1.0 / math.sqrt(dh)
    b = math.prod(lead)
    flat = None
    if bias is not None:
        bias = bias.expand(*bias.shape[:-2], n, n)
        while bias.ndim > 2 and bias.shape[0] == 1:
            bias = bias[0]
        blead = tuple(bias.shape[:-2])
        if blead == lead[len(lead) - len(blead):]:
            flat = bias.reshape(-1, n, n)
        else:
            flat = bias.expand(*lead, n, n).reshape(b, n, n)
    out = _Attention.apply(q.reshape(b, n, dh), k.reshape(b, n, dh), v.reshape(b, n, dh), flat, float(scale))
    return out.reshape(q.shape)


attention.launches = 0
