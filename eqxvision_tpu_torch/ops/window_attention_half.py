"""The fused attention half of a Swin v1 block: LayerNorm, the qkv
projection, window attention, the output projection and the residual in one
op, on windows.

``fused_window_attention_half`` is the counterpart of the prototype Pallas
kernel ``_fused_half_kernel`` of scripts/ablate_swin3.py (``fused_attn_half``
with ``with_proj=True``). A CUDA tensor goes through a hand-written Hopper
kernel (``csrc/window_attention_half.cu``), a CPU tensor through
``window_attention_half_reference``; no other device is accepted, and on CUDA
nothing falls back to the plain version. The gradient recomputes through the
plain version. Followed by ``ops.fused_mlp_half`` it computes a whole v1
block, the counterpart of scripts/ablate_swin4.py's ``flat_fused_block``
(without its padding of 49 tokens to 64).

Rounding points, the prototype's: LayerNorm statistics and affine in f32,
rounded to x's type; the qkv product accumulated in f32 and rounded to x's
type, then the bias in x's type added and rounded again (as the JAX package's
windowed projection does); per window and head the scores in f32 times
``scale`` plus the bias, softmax in f32, ``p`` rounded to x's type before
``p . V``, each head's output accumulated in f32 and rounded; the output
projection accumulated in f32, plus its bias, plus x, in f32, rounded once.
The last point differs from the JAX model's unfused bf16 block, which rounds
the projection, adds its bias in bf16 and then the residual in bf16.

The padding trap: torchvision and the JAX model pad the block's input after
``norm1``, so a padding token's LayerNorm output is 0 and its k and v are the
qkv bias alone. This op sees the windows already padded; ``valid`` flags the
tokens of the image, and a padding row's LayerNorm output is set to 0, in the
plain version and in the kernel. (The whole-block kernel pads before its
LayerNorm, in the JAX package and in the port: on a map that is not a
multiple of the window it differs from the unfused block in both.)
"""
from __future__ import annotations

import functools
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from .. import _native
from .attention import _DTYPE_CODES, _aligned, export_op, recompute_grads
from .layernorm import layer_norm_reference
from .window_attention import _Windows, _from_windows, _to_windows, _window_bias

HALF_MAX_WINDOW_LEN = 64
HALF_MAX_HEAD_DIM = 64


def window_attention_half_supported(c: int, num_heads: int, L: int) -> bool:
    """The op's gate, a pure shape rule beside ``fused_swin_block_supported``:
    windows of at most 64 tokens and a head dim that is a multiple of 16 and
    at most 64, where the window attention runs on the tensor cores in bf16.
    Every Swin stage has them (7x7 and 8x8 windows, head dim 32)."""
    return (
        num_heads > 0
        and c % num_heads == 0
        and (c // num_heads) % 16 == 0
        and c // num_heads <= HALF_MAX_HEAD_DIM
        and 0 < L <= HALF_MAX_WINDOW_LEN
    )


def _valid_rows_on(device: torch.device, geo: _Windows, wh: int, ww: int) -> Optional[torch.Tensor]:
    """(nW, L) flags of the windows' tokens that lie in the image, computed
    with numpy from the static geometry and copied to ``device`` once (a
    tensor made while ``torch.export`` traces is a fake one and is not
    kept); None where the map is a multiple of the window (no padding)."""
    if torch.compiler.is_exporting():
        return _valid_rows.__wrapped__(device, geo, wh, ww)
    return _valid_rows(device, geo, wh, ww)


@functools.lru_cache(maxsize=None)
def _valid_rows(device: torch.device, geo: _Windows, wh: int, ww: int) -> Optional[torch.Tensor]:
    if (geo.ph, geo.pw) == (geo.h, geo.w):
        return None
    valid = np.zeros((geo.ph, geo.pw), bool)
    valid[: geo.h, : geo.w] = True
    valid = np.roll(valid, (-geo.sh, -geo.sw), axis=(0, 1))
    valid = valid.reshape(geo.ph // wh, wh, geo.pw // ww, ww).transpose(0, 2, 1, 3).reshape(-1, wh * ww)
    return torch.from_numpy(valid).to(device)


def window_attention_half_reference(
    x: torch.Tensor,
    ln_weight: torch.Tensor,
    ln_bias: torch.Tensor,
    wqkv: torch.Tensor,
    bqkv: Optional[torch.Tensor],
    wproj: torch.Tensor,
    bproj: torch.Tensor,
    bias: torch.Tensor,
    num_heads: int,
    scale: float,
    eps: float = 1e-5,
    valid: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Plain version: ``x + proj(window_attention(qkv(LN(x))))`` over
    windows x (N, nW, L, C) with the kernel's rounding points; products
    accumulate in f32 (an f64 input computes in f64). Weights are (out, in)
    and cast to x's type; bias (nW | 1, H, L, L); valid (nW, L) bool or
    None."""
    wide = torch.promote_types(x.dtype, torch.float32)
    dt = x.dtype
    n, nw, L, c = x.shape
    a = layer_norm_reference(x, ln_weight, ln_bias, eps)
    if valid is not None:
        a = torch.where(valid[..., None].to(a.device), a, torch.zeros((), dtype=dt, device=a.device))
    qkv = F.linear(a.to(wide), wqkv.to(dt).to(wide)).to(dt)
    if bqkv is not None:
        qkv = (qkv.to(wide) + bqkv.to(dt).to(wide)).to(dt)
    q, k, v = (t.reshape(n, nw, L, num_heads, c // num_heads).transpose(2, 3).to(wide) for t in qkv.split(c, dim=-1))
    s = torch.matmul(q, k.transpose(-1, -2)) * scale + bias.to(wide)
    p = torch.softmax(s, dim=-1).to(dt)
    o = torch.matmul(p.to(wide), v).to(dt).transpose(2, 3).reshape(n, nw, L, c)
    return (x.to(wide) + F.linear(o.to(wide), wproj.to(dt).to(wide), bproj.to(wide))).to(dt)


def _launch_kernel(x, ln_weight, ln_bias, wqkv, bqkv, wproj, bproj, bias, num_heads, scale, eps, valid):
    if x.dtype not in _DTYPE_CODES:
        raise TypeError(f"fused_window_attention_half kernel takes float32 or bfloat16, got {x.dtype}")
    vectors = [ln_weight, ln_bias, bproj] + ([] if bqkv is None else [bqkv])
    if any(t.device != x.device for t in (wqkv, wproj, bias, *vectors, *([] if valid is None else [valid]))):
        raise ValueError(f"fused_window_attention_half: every tensor must be on {x.device} with x")
    if any(t.dtype not in _DTYPE_CODES for t in (wqkv, wproj, *vectors)):
        raise TypeError("fused_window_attention_half kernel takes float32 or bfloat16 weights and biases")
    n, nw, L, c = x.shape
    # the weights are read as stored; a copy only where their type is not x's
    wqkv, wproj = (_aligned(w.to(x.dtype)) for w in (wqkv, wproj))
    # the vectors are read in their stored type when they share one, else in f32
    param_dtype = vectors[0].dtype if all(v.dtype == vectors[0].dtype for v in vectors) else torch.float32
    ln_weight, ln_bias, bproj = (v.to(param_dtype).contiguous() for v in (ln_weight, ln_bias, bproj))
    # no qkv bias is a zero one: the GEMM's epilogue always reads its bias
    if bqkv is None:
        bqkv = torch.zeros(3 * c, dtype=param_dtype, device=x.device)
    bqkv = bqkv.to(param_dtype).contiguous()
    bias = bias.to(torch.float32).contiguous()
    flags = None if valid is None else valid.contiguous()  # bool: one byte, 0 or 1
    x = _aligned(x)
    out = torch.empty_like(x)
    if x.numel() == 0:
        return out
    rows = n * nw * L
    qkv = torch.empty((rows, 3 * c), dtype=x.dtype, device=x.device)
    attn = torch.empty((rows, c), dtype=x.dtype, device=x.device)
    stats = torch.empty((rows, 2), dtype=torch.float32, device=x.device)
    lib = _native.library()
    with torch.cuda.device(x.device):
        err = lib.eqx_window_attention_half(
            x.data_ptr(), ln_weight.data_ptr(), ln_bias.data_ptr(), wqkv.data_ptr(), bqkv.data_ptr(),
            wproj.data_ptr(), bproj.data_ptr(), bias.data_ptr(), None if flags is None else flags.data_ptr(),
            qkv.data_ptr(), attn.data_ptr(), stats.data_ptr(), out.data_ptr(),
            n, nw, bias.shape[0], L, c, num_heads, scale, eps, _DTYPE_CODES[x.dtype], _DTYPE_CODES[param_dtype],
            torch.cuda.current_stream().cuda_stream,
        )
    if err:
        smem = lib.eqx_window_attention_half_smem_bytes(L, c // num_heads, _DTYPE_CODES[x.dtype])
        _native.check(
            err,
            f"fused_window_attention_half kernel on windows {tuple(x.shape)} {x.dtype} with {num_heads} heads "
            f"(one block needs up to {smem} bytes of shared memory)",
        )
    fused_window_attention_half.launches += 1
    return out


def _reference_positional(x, ln_weight, ln_bias, wqkv, bqkv, wproj, bproj, bias, valid, num_heads, scale, eps):
    return window_attention_half_reference(x, ln_weight, ln_bias, wqkv, bqkv, wproj, bproj, bias, num_heads, scale,
                                           eps, valid)


class _FusedWindowAttentionHalf(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, ln_weight, ln_bias, wqkv, bqkv, wproj, bproj, bias, valid, num_heads, scale, eps):
        ctx.save_for_backward(x, ln_weight, ln_bias, wqkv, bqkv, wproj, bproj, bias, valid)
        ctx.static = (num_heads, scale, eps)
        args = (x, ln_weight, ln_bias, wqkv, bqkv, wproj, bproj, bias, num_heads, scale, eps, valid)
        if x.device.type == "cuda":
            return _launch_kernel(*args)
        if x.device.type == "cpu":
            return window_attention_half_reference(*args)
        raise ValueError(f"fused_window_attention_half runs on cuda (kernel) or cpu (plain torch), not {x.device}")

    @staticmethod
    def backward(ctx, grad_out):
        return recompute_grads(ctx, _reference_positional, grad_out, n_static=3)


def fused_window_attention_half(
    x_windows: torch.Tensor,
    ln_weight: torch.Tensor,
    ln_bias: torch.Tensor,
    wqkv: torch.Tensor,
    bqkv: Optional[torch.Tensor],
    wproj: torch.Tensor,
    bproj: torch.Tensor,
    bias: torch.Tensor,
    num_heads: int,
    scale: Optional[float] = None,
    eps: float = 1e-5,
    valid: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """``x + proj(window_attention(qkv(LN(x))))`` over windows x of shape
    (N, nW, L, C), already padded, shifted and partitioned.

    ln_weight, ln_bias and bproj are (C,), bqkv (3C,) or None; wqkv (3C, C)
    laid out [q heads | k heads | v heads] and wproj (C, C) in the port's
    ``Linear`` layout (out, in). ``bias`` (nW | 1, H, L, L) holds the
    relative-position bias plus the shift mask, window w reading
    ``bias[w % len(bias)]``. ``valid`` (nW, L) bool flags the tokens of the
    image; a padding token's LayerNorm output is 0, as where the unfused
    block pads after norm1. ``scale`` defaults to 1/sqrt(C / num_heads).
    ``fused_window_attention_half.launches`` counts kernel launches (one per
    call, which runs the kernel's four launches).
    """
    if x_windows.ndim != 4:
        raise ValueError(f"fused_window_attention_half expects windows of shape (N, nW, L, C), got {tuple(x_windows.shape)}")
    n, nw, L, c = x_windows.shape
    if not window_attention_half_supported(c, num_heads, L):
        raise ValueError(
            f"fused_window_attention_half takes L <= {HALF_MAX_WINDOW_LEN} and a head dim that is a multiple of 16 "
            f"and at most {HALF_MAX_HEAD_DIM}; got C={c}, L={L}, {num_heads} heads"
        )
    if bias.ndim != 4 or bias.shape[0] not in (1, nw) or tuple(bias.shape[1:]) != (num_heads, L, L):
        raise ValueError(f"expected bias of shape ({nw} or 1, {num_heads}, {L}, {L}), got {tuple(bias.shape)}")
    if valid is not None and (valid.dtype != torch.bool or tuple(valid.shape) != (nw, L)):
        raise ValueError(f"expected valid of shape ({nw}, {L}) and type bool, got {tuple(valid.shape)} {valid.dtype}")
    expected = {
        "ln_weight": (ln_weight, (c,)), "ln_bias": (ln_bias, (c,)), "wqkv": (wqkv, (3 * c, c)),
        "wproj": (wproj, (c, c)), "bproj": (bproj, (c,)),
    }
    if bqkv is not None:
        expected["bqkv"] = (bqkv, (3 * c,))
    for name, (t, shape) in expected.items():
        if tuple(t.shape) != shape:
            raise ValueError(f"fused_window_attention_half: expected {name} of shape {shape}, got {tuple(t.shape)}")
    if scale is None:
        scale = (c // num_heads) ** -0.5
    args = (x_windows, ln_weight, ln_bias, wqkv, bqkv, wproj, bproj, bias, valid, int(num_heads), float(scale),
            float(eps))
    if torch.compiler.is_exporting():
        return _fused_window_attention_half_op(*args)
    return _FusedWindowAttentionHalf.apply(*args)


fused_window_attention_half.launches = 0
_fused_window_attention_half_op = export_op(
    "fused_window_attention_half",
    "(Tensor x, Tensor ln_weight, Tensor ln_bias, Tensor wqkv, Tensor? bqkv, Tensor wproj, Tensor bproj, "
    "Tensor bias, Tensor? valid, int num_heads, float scale, float eps) -> Tensor",
    lambda x, ln_weight, ln_bias, wqkv, bqkv, wproj, bproj, bias, valid, num_heads, scale, eps: _launch_kernel(
        x, ln_weight, ln_bias, wqkv, bqkv, wproj, bproj, bias, num_heads, scale, eps, valid),
    _reference_positional, lambda x, *rest: x.new_empty(x.shape),
)


def window_attention_half_v1(
    x, *, norm1_w, norm1_b, qkv_weight, qkv_bias, proj_weight, proj_bias, relative_position_bias, window_size,
    shift_size, num_heads, eps=1e-5,
) -> torch.Tensor:
    """A Swin v1 block's first half on NHWC ``x``: ``x + proj(attn(LN1 x))``
    with torchvision's shifted-window attention, through
    ``fused_window_attention_half``. The padding, roll, partition,
    unpartition and crop stay in torch; the padding tokens are flagged."""
    xw, geo = _to_windows(x, window_size, shift_size)
    bias = _window_bias(relative_position_bias, window_size, num_heads, geo)
    valid = _valid_rows_on(x.device, geo, *window_size)
    out = fused_window_attention_half(xw, norm1_w, norm1_b, qkv_weight, qkv_bias, proj_weight, proj_bias, bias,
                                      num_heads, None, eps, valid)
    return _from_windows(out, window_size, geo)
