"""Peaks of one NVIDIA H100 SXM and the operations and bytes of each kernel.

Peaks (NVIDIA's data sheet, dense, at the 700 W power limit): 989 TFLOP/s
of bf16 matrix products on the tensor cores, 67 TFLOP/s of f32 arithmetic
on the CUDA cores (the rate for a kernel's elementwise work, such as a
LayerNorm's), 3.35 TB/s of HBM.

Each ``<kernel>(...)`` below returns ``(operations, bytes)`` for one call
at the given shapes: the matrix products' multiply-adds counted as two
operations each, each input read once and each output written once,
whatever the kernel reads again or keeps on chip. ``bound_s`` turns a pair
into the least time the card could take. A kernel's share of its roofline
is that least time over the device time its launches took.

The operations of the elementwise parts of a fused kernel (LayerNorm,
softmax, gelu) are left out of its product count: the bound stays a lower
bound on the time.
"""
from __future__ import annotations

from typing import Tuple

PRODUCT_FLOPS = 989e12  # bf16 tensor cores
CORE_FLOPS = 67e12  # f32 on the CUDA cores
HBM_BYTES_PER_S = 3.35e12
BF16 = 2


def bound_s(ops_bytes: Tuple[float, float], flops: float = PRODUCT_FLOPS) -> float:
    ops, nbytes = ops_bytes
    return max(ops / flops, nbytes / HBM_BYTES_PER_S)


def attention_half(n: int, tokens: int, dim: int, elt: int = BF16) -> Tuple[float, float]:
    """``ops.fused_attention_half``: LayerNorm, qkv (dim -> 3 dim), attention
    over ``tokens`` (QK^T and PV: 4 n tokens^2 dim), proj, residual."""
    m = n * tokens
    ops = 2 * m * dim * 3 * dim + 4 * n * tokens * tokens * dim + 2 * m * dim * dim
    nbytes = (2 * m * dim + 4 * dim * dim + 6 * dim) * elt
    return ops, nbytes


def mlp_half(rows: int, dim: int, hidden: int, elt: int = BF16) -> Tuple[float, float]:
    """``ops.fused_mlp_half`` with the residual the input itself: LayerNorm,
    fc1 (dim -> hidden), gelu, fc2, residual."""
    ops = 4 * rows * dim * hidden
    nbytes = (2 * rows * dim + 2 * dim * hidden + hidden + 3 * dim) * elt
    return ops, nbytes


def window_attention_half(tokens: int, dim: int, heads: int, window: int, elt: int = BF16) -> Tuple[float, float]:
    """``ops.fused_window_attention_half``: ``tokens`` rows of the map in
    windows of ``window`` tokens (QK^T and PV within each window), the
    relative-position bias (heads, window, window) read once."""
    ops = 2 * tokens * dim * 3 * dim + 4 * tokens * window * dim + 2 * tokens * dim * dim
    nbytes = (2 * tokens * dim + 4 * dim * dim + 6 * dim + heads * window * window) * elt
    return ops, nbytes


def swin_block(tokens: int, dim: int, heads: int, window: int, hidden: int, elt: int = BF16) -> Tuple[float, float]:
    """``ops.fused_swin_block`` (K5): the window attention half, then the
    MLP half, in one kernel."""
    a_ops, a_bytes = window_attention_half(tokens, dim, heads, window, elt)
    m_ops, m_bytes = mlp_half(tokens, dim, hidden, elt)
    # the map between the halves stays on chip: one read and one write less
    return a_ops + m_ops, a_bytes + m_bytes - 2 * tokens * dim * elt


def qkv_attention(n: int, tokens: int, dim: int, elt: int = BF16) -> Tuple[float, float]:
    """``ops.fused_qkv_attention`` (K1): (n, tokens, 3 dim) -> (n, tokens, dim)."""
    return 4 * n * tokens * tokens * dim, 4 * n * tokens * dim * elt


def layer_norm(rows: int, dim: int, elt: int = BF16) -> Tuple[float, float]:
    """``ops.layer_norm`` (K6): mean, variance, normalise, scale and shift,
    about 8 operations an element on the CUDA cores."""
    return 8 * rows * dim, (2 * rows * dim + 2 * dim) * elt


def _rows(shape) -> int:
    rows = 1
    for n in shape[:-1]:
        rows *= n
    return rows


# Each kernel's arguments from the input shapes of one call of the program's
# autograd Function that launches it, in the order of its ``forward``.
def _attention_half_args(s):  # x (n, tokens, dim), ...
    return tuple(s[0])


def _mlp_half_args(s):  # x (..., dim), residual, ln_weight, ln_bias, w1 (hidden, dim), ...
    return _rows(s[0]), s[0][-1], s[4][0]


def _window_attention_half_args(s):  # x (N, nW, L, C), ..., bias (nW | 1, heads, L, L) at 7, ...
    n, nw, win, dim = s[0]
    return n * nw * win, dim, s[7][1], win


def _swin_block_args(s):  # x (N, H, W, C), bias (nW | 1, heads, L, L), cosine_gs, the 12 params: fc1_w (hidden, C) at 11
    # the map's own tokens: a padded map's padding is left out, so the bound stays a lower bound
    return _rows(s[0]), s[0][-1], s[1][1], s[1][2], s[11][0]


def _qkv_attention_args(s):  # qkv (n, tokens, 3 dim), ...
    n, tokens, three_dim = s[0]
    return n, tokens, three_dim // 3


def _layer_norm_args(s):  # x (..., dim), ...
    return _rows(s[0]), s[0][-1]


# Each kernel's function, the flop rate its bound takes, the program's
# autograd Function whose forward launches it (the host op the trace names,
# with its input shapes), and its arguments from those shapes.
KERNELS = {
    "attention_half": (attention_half, PRODUCT_FLOPS, "_FusedAttentionHalf", _attention_half_args),
    "mlp_half": (mlp_half, PRODUCT_FLOPS, "_FusedMlpHalf", _mlp_half_args),
    "window_attention_half": (window_attention_half, PRODUCT_FLOPS, "_FusedWindowAttentionHalf",
                              _window_attention_half_args),
    "swin_block": (swin_block, PRODUCT_FLOPS, "_FusedSwinBlock", _swin_block_args),
    "qkv_attention": (qkv_attention, PRODUCT_FLOPS, "_FusedQkvAttention", _qkv_attention_args),
    "layer_norm": (layer_norm, CORE_FLOPS, "_LayerNorm", _layer_norm_args),
}
KERNEL_OPS = tuple(k[2] for k in KERNELS.values())


def launch_bound_s(kernel: str, shapes) -> float:
    """The least time of one launch of ``kernel``, from the input shapes of
    the op that launched it."""
    fn, flops, op, args = KERNELS[kernel]
    try:
        return bound_s(fn(*args(shapes)), flops)
    except (IndexError, TypeError, ValueError) as e:
        raise RuntimeError(f"the trace's input shapes of {op} do not give {kernel}'s sizes: {shapes}") from e
