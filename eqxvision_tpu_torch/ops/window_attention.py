"""Shifted window attention (Swin v1/v2) on batched NHWC tensors.

Counterpart of eqxvision_tpu/ops/window_attention.py, with torchvision's
semantics: dynamic bottom/right padding to a multiple of the window, the
cyclic shift (zeroed along a side that one window covers), window
partition, relative-position bias plus the 9-region shift mask, v2's
cosine attention with the clamped logit scale, and the k-bias zeroing.

Two ops here hold a hand-written CUDA kernel, each beside its plain torch
version:

- ``window_qkv_attention`` (in ``ops/attention.py``), the attention core
  of every block that does not take the whole-block kernel;
- ``fused_swin_block``, one whole Swin block at inference
  (``csrc/swin_block.cu``), behind ``fused_swin_block_v1``/``_v2``.

A CUDA tensor launches the kernel or raises; a CPU tensor takes the plain
version. Masks and indices are computed with numpy from static shapes.
"""
from __future__ import annotations

import functools
import math
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from .. import _native
from .attention import _DTYPE_CODES, export_op, recompute_grads, window_qkv_attention, window_qkv_attention_reference

_LOG_100 = math.log(100.0)


@functools.lru_cache(maxsize=None)
def relative_position_index(wh: int, ww: int) -> np.ndarray:
    """(wh*ww, wh*ww) indices into the (2wh-1)(2ww-1) bias table."""
    coords = np.stack(np.meshgrid(np.arange(wh), np.arange(ww), indexing="ij"))  # (2, wh, ww)
    coords_flat = coords.reshape(2, -1)
    relative = coords_flat[:, :, None] - coords_flat[:, None, :]  # (2, L, L)
    relative = relative.transpose(1, 2, 0).astype(np.int64)
    relative[:, :, 0] += wh - 1
    relative[:, :, 1] += ww - 1
    relative[:, :, 0] *= 2 * ww - 1
    return relative.sum(-1)


@functools.lru_cache(maxsize=None)
def relative_coords_table(wh: int, ww: int) -> np.ndarray:
    """Swin v2's log-spaced continuous coordinates, (1, 2wh-1, 2ww-1, 2)."""
    rh = np.arange(-(wh - 1), wh, dtype=np.float32)
    rw = np.arange(-(ww - 1), ww, dtype=np.float32)
    table = np.stack(np.meshgrid(rh, rw, indexing="ij")).transpose(1, 2, 0)[None]
    table[:, :, :, 0] /= wh - 1
    table[:, :, :, 1] /= ww - 1
    table *= 8
    return (np.sign(table) * np.log2(np.abs(table) + 1.0) / 3.0).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _shift_attention_mask(pad_h: int, pad_w: int, wh: int, ww: int, sh: int, sw: int) -> np.ndarray:
    """(nW, L, L) additive mask: -100 between tokens of different shift
    regions, 0 within one."""
    img_mask = np.zeros((pad_h, pad_w), np.float32)
    h_slices = ((0, pad_h - wh), (pad_h - wh, pad_h - sh), (pad_h - sh, pad_h))
    w_slices = ((0, pad_w - ww), (pad_w - ww, pad_w - sw), (pad_w - sw, pad_w))
    count = 0
    for h0, h1 in h_slices:
        for w0, w1 in w_slices:
            img_mask[h0:h1, w0:w1] = count
            count += 1
    mask = img_mask.reshape(pad_h // wh, wh, pad_w // ww, ww).transpose(0, 2, 1, 3).reshape(-1, wh * ww)
    attn_mask = mask[:, None, :] - mask[:, :, None]
    return np.where(attn_mask == 0, 0.0, -100.0).astype(np.float32)


def _shift_mask_on(device: torch.device, *shape_args: int) -> torch.Tensor:
    """The shift mask as an f32 tensor, copied to ``device`` once (a tensor
    made while ``torch.export`` traces is a fake one and is not kept)."""
    if torch.compiler.is_exporting():
        return torch.from_numpy(_shift_attention_mask(*shape_args)).to(device)
    return _shift_mask_cached(device, *shape_args)


@functools.lru_cache(maxsize=None)
def _shift_mask_cached(device: torch.device, *shape_args: int) -> torch.Tensor:
    return torch.from_numpy(_shift_attention_mask(*shape_args)).to(device)


def window_partition(x: torch.Tensor, wh: int, ww: int) -> torch.Tensor:
    """(N, H, W, C) -> (N, nW, wh*ww, C); H and W multiples of the window."""
    n, h, w, c = x.shape
    x = x.reshape(n, h // wh, wh, w // ww, ww, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(n, (h // wh) * (w // ww), wh * ww, c)


def window_unpartition(x: torch.Tensor, h: int, w: int, wh: int, ww: int) -> torch.Tensor:
    """(N, nW, wh*ww, C) -> (N, H, W, C), the inverse of window_partition."""
    n, c = x.shape[0], x.shape[-1]
    x = x.reshape(n, h // wh, w // ww, wh, ww, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(n, h, w, c)


class _Windows(NamedTuple):
    """Where an (N, H, W, C) input sits once padded, shifted and cut."""

    h: int
    w: int
    ph: int  # padded height and width
    pw: int
    sh: int  # shift after the rule that zeroes it where one window covers a side
    sw: int


def window_geometry(h: int, w: int, window_size, shift_size) -> _Windows:
    """Where an (N, h, w, C) map's windows sit: padded bottom/right to a
    multiple of the window, and the shift zeroed along a side that one
    window covers. The torch plumbing (``_to_windows``) and the whole-block
    kernel, which reads the windows straight from the map, both take it
    from here."""
    wh, ww = window_size
    ph, pw = h + (wh - h % wh) % wh, w + (ww - w % ww) % ww
    sh, sw = shift_size
    return _Windows(h, w, ph, pw, 0 if wh >= ph else sh, 0 if ww >= pw else sw)


def window_token_index(geo: _Windows, window_size) -> torch.Tensor:
    """(nW, L) index ``y * w + x`` into an image's (h, w) map of each window
    token, -1 for a padding token: the whole-block kernel's formula. Token
    t of window (wy, wx) sits at ``y = (wy * wh + t // ww + sh) % ph``,
    ``x = (wx * ww + t % ww + sw) % pw`` (the roll by -shift of the padded
    map, then the partition); ``y >= h`` or ``x >= w`` is padding."""
    wh, ww = window_size
    wi = torch.arange((geo.ph // wh) * (geo.pw // ww))
    t = torch.arange(wh * ww)
    nwx = geo.pw // ww
    y = ((wi // nwx)[:, None] * wh + (t // ww)[None] + geo.sh) % geo.ph
    x = ((wi % nwx)[:, None] * ww + (t % ww)[None] + geo.sw) % geo.pw
    return torch.where((y < geo.h) & (x < geo.w), y * geo.w + x, -1)


def _to_windows(x: torch.Tensor, window_size, shift_size) -> Tuple[torch.Tensor, _Windows]:
    """Pad bottom/right to the window, roll by -shift, partition."""
    n, h, w, c = x.shape
    geo = window_geometry(h, w, window_size, shift_size)
    if geo.ph != h or geo.pw != w:
        x = F.pad(x, (0, 0, 0, geo.pw - w, 0, geo.ph - h))
    if geo.sh or geo.sw:
        x = torch.roll(x, (-geo.sh, -geo.sw), dims=(1, 2))
    return window_partition(x, *window_size), geo


def _from_windows(xw: torch.Tensor, window_size, geo: _Windows) -> torch.Tensor:
    """Unpartition, roll back and crop: the inverse of _to_windows."""
    x = window_unpartition(xw, geo.ph, geo.pw, *window_size)
    if geo.sh or geo.sw:
        x = torch.roll(x, (geo.sh, geo.sw), dims=(1, 2))
    return x[:, : geo.h, : geo.w, :]


def _window_bias(relative_position_bias: torch.Tensor, window_size, num_heads: int, geo: _Windows) -> torch.Tensor:
    """Relative-position bias (1, H, L, L) plus the shift mask where the
    windows are shifted: (nW | 1, H, L, L), f32."""
    wh, ww = window_size
    L = wh * ww
    bias = relative_position_bias.float().reshape(1, num_heads, L, L)
    if geo.sh or geo.sw:
        mask = _shift_mask_on(bias.device, geo.ph, geo.pw, wh, ww, geo.sh, geo.sw)
        bias = bias + mask[:, None]
    return bias


def _cosine_gs(logit_scale: torch.Tensor, num_heads: int) -> torch.Tensor:
    """Swin v2's per-head scale exp(min(logit_scale, ln 100)), (H,) f32."""
    return torch.exp(torch.clamp(logit_scale.float(), max=_LOG_100)).reshape(num_heads)


def _v2_qkv_bias(qkv_bias: Optional[torch.Tensor], c: int) -> Optional[torch.Tensor]:
    """Swin v2's k has no bias: torchvision zeroes the middle third."""
    if qkv_bias is None:
        return None
    return torch.cat((qkv_bias[:c], torch.zeros_like(qkv_bias[c : 2 * c]), qkv_bias[2 * c :]))


def _product_then_bias(x: torch.Tensor, weight: torch.Tensor, bias: Optional[torch.Tensor]) -> torch.Tensor:
    """``x @ weight.T`` rounded to x's type, then ``bias`` in x's type added
    and rounded again: the JAX package's windowed projections
    (``xw @ w`` then ``+ bias.astype(x.dtype)``), two roundings where
    ``F.linear`` with a bias makes one."""
    y = F.linear(x, weight.to(x.dtype))
    return y if bias is None else y + bias.to(x.dtype)


def shifted_window_attention(
    x: torch.Tensor,
    qkv_weight: torch.Tensor,  # (3C, C), torch's (out, in)
    proj_weight: torch.Tensor,  # (C, C)
    relative_position_bias: torch.Tensor,  # (1, H, L, L)
    window_size: Tuple[int, int],
    num_heads: int,
    shift_size: Tuple[int, int],
    qkv_bias: Optional[torch.Tensor] = None,
    proj_bias: Optional[torch.Tensor] = None,
    logit_scale: Optional[torch.Tensor] = None,  # v2: (H, 1, 1)
    attention_dropout: float = 0.0,
    dropout: float = 0.0,
    training: bool = False,
) -> torch.Tensor:
    """Batched NHWC shifted-window attention, torchvision semantics.

    The attention core is ``window_qkv_attention`` (the kernel on CUDA).
    Training with active attention dropout needs the probabilities, so it
    runs in plain torch with them materialised, as the JAX package does."""
    n, h, w, c = x.shape
    xw, geo = _to_windows(x, window_size, shift_size)
    if logit_scale is not None:
        qkv_bias = _v2_qkv_bias(qkv_bias, c)
    dt = x.dtype
    qkv = _product_then_bias(xw, qkv_weight, qkv_bias)
    bias = _window_bias(relative_position_bias, window_size, num_heads, geo)
    cosine_gs = None if logit_scale is None else _cosine_gs(logit_scale, num_heads)
    scale = 1.0 if logit_scale is not None else (c // num_heads) ** -0.5
    if attention_dropout > 0.0 and training:
        nb, nw, L, _ = qkv.shape
        q, k, v = qkv.reshape(nb, nw, L, 3, num_heads, c // num_heads).permute(3, 0, 1, 4, 2, 5).unbind(0)
        if cosine_gs is not None:
            q = F.normalize(q, dim=-1, eps=1e-12) * cosine_gs.reshape(num_heads, 1, 1).to(dt)
            k = F.normalize(k, dim=-1, eps=1e-12)
        s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale + bias
        p = F.dropout(torch.softmax(s, dim=-1).to(dt), attention_dropout, training=True)
        out = torch.matmul(p, v).transpose(2, 3).reshape(nb, nw, L, c)
    else:
        out = window_qkv_attention(qkv, bias, num_heads, scale, cosine_gs)
    out = _product_then_bias(out, proj_weight, proj_bias)
    out = F.dropout(out, dropout, training=training)
    return _from_windows(out, window_size, geo)


# --------------------------------------------------------------------------
# Whole-block kernel: one Swin block at inference
# --------------------------------------------------------------------------

BLOCK_MAX_CHANNELS = 192
BLOCK_MAX_WINDOW_LEN = 64
BLOCK_MAX_HEAD_DIM = 64


class SwinBlockParams(NamedTuple):
    """One block's weights in torch's (out, in) layout. For v2 the caller
    has zeroed the k third of ``qkv_b``."""

    norm1_w: torch.Tensor
    norm1_b: torch.Tensor
    qkv_w: torch.Tensor  # (3C, C)
    qkv_b: torch.Tensor  # (3C,)
    proj_w: torch.Tensor  # (C, C)
    proj_b: torch.Tensor
    norm2_w: torch.Tensor
    norm2_b: torch.Tensor
    fc1_w: torch.Tensor  # (hidden, C)
    fc1_b: torch.Tensor
    fc2_w: torch.Tensor  # (C, hidden)
    fc2_b: torch.Tensor


def fused_swin_block_supported(c: int, hidden: int, num_heads: int, L: int) -> bool:
    """The whole-block kernel's gate, a pure shape rule: C <= 192 (the
    blocks of Swin's stages 1 and 2), windows of at most 64 tokens (7x7
    and 8x8 windows), a head dim of at most 64, and C, the hidden width
    and the head dim multiples of 16 (the tensor cores' product depth).
    The type does not enter, and the hidden width only through that rule:
    the kernel runs the MLP in chunks of 64 hidden units. The JAX package's
    VMEM budget is the TPU's and is not carried over."""
    return (
        c <= BLOCK_MAX_CHANNELS
        and c % 16 == 0
        and hidden % 16 == 0
        and L <= BLOCK_MAX_WINDOW_LEN
        and c % num_heads == 0
        and c // num_heads <= BLOCK_MAX_HEAD_DIM
        and (c // num_heads) % 16 == 0
    )


def _layer_norm_f32(t: torch.Tensor, w: torch.Tensor, b: torch.Tensor, eps: float) -> torch.Tensor:
    return F.layer_norm(t, (t.shape[-1],), w.to(t.dtype), b.to(t.dtype), eps)


def fused_swin_block_reference(
    xw: torch.Tensor,
    params: SwinBlockParams,
    bias: torch.Tensor,
    num_heads: int,
    scale: float,
    eps: float,
    postnorm: bool,
    cosine_gs: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Plain version of the whole-block kernel, on windows.

    xw: (N, nW, L, C) windows of the padded, shifted input; bias (nW | 1,
    H, L, L) f32; returns the block's output windows. Rounding points, the
    kernel's (``csrc/swin_block.cu``): LayerNorm in f32; every product
    accumulates in f32 with its bias added in f32; the inputs of the four
    products and the attention's q, k, v and p are rounded to the input
    type, and v2's normalised q and k stay in f32; the residual stream
    stays f32 and the output is rounded once. Given f64 windows and
    parameters it computes in f64 throughout (the f32 kernel's yardstick).
      v1: h = x + proj(attn(LN1 x)); out = h + fc2(gelu(fc1(LN2 h)))
      v2: h = x + LN1(proj(cosattn x)); out = h + LN2(fc2(gelu(fc1 h)))
    """
    p = params
    dt = xw.dtype
    ct = torch.float64 if dt == torch.float64 else torch.float32  # f64 in, f64 throughout
    xf = xw.to(ct)

    def linear(t, w, b):  # t in the input type, f32 accumulation and bias
        return F.linear(t.to(ct), w.to(dt).to(ct), b.to(ct))

    attn_in = xw if postnorm else _layer_norm_f32(xf, p.norm1_w, p.norm1_b, eps).to(dt)
    qkv = linear(attn_in, p.qkv_w, p.qkv_b).to(dt)
    o = window_qkv_attention_reference(qkv, bias, num_heads, scale, cosine_gs)
    proj = linear(o, p.proj_w, p.proj_b)
    h = xf + (_layer_norm_f32(proj, p.norm1_w, p.norm1_b, eps) if postnorm else proj)
    mlp_in = (h if postnorm else _layer_norm_f32(h, p.norm2_w, p.norm2_b, eps)).to(dt)
    hidden = F.gelu(linear(mlp_in, p.fc1_w, p.fc1_b)).to(dt)
    y = linear(hidden, p.fc2_w, p.fc2_b)
    return (h + (_layer_norm_f32(y, p.norm2_w, p.norm2_b, eps) if postnorm else y)).to(dt)


def _block_vectors(params: SwinBlockParams, dev: torch.device):
    """The eight LayerNorm and bias vectors on ``dev`` in the type the
    kernel reads them in, and its code: bf16 if all are bf16, else f32
    (a bf16 vector among f32 ones is widened, which is exact)."""
    vecs = (params.norm1_w, params.norm1_b, params.qkv_b, params.proj_b,
            params.norm2_w, params.norm2_b, params.fc1_b, params.fc2_b)
    dt = torch.bfloat16 if all(v.dtype == torch.bfloat16 for v in vecs) else torch.float32
    return [v.to(device=dev, dtype=dt).contiguous() for v in vecs], _DTYPE_CODES[dt]


def _launch_block_kernel(x, params, bias, num_heads, scale, eps, postnorm, cosine_gs, window_size, shift_size):
    """The kernel on the NHWC map x (N, H, W, C), its windows read and
    written in place of the pad, roll, partition and their inverses."""
    if x.dtype not in _DTYPE_CODES:
        raise TypeError(f"fused_swin_block kernel takes float32 or bfloat16, got {x.dtype}")
    n, h, w, c = x.shape
    wh, ww = window_size
    L = wh * ww
    hidden = params.fc1_w.shape[0]
    if not fused_swin_block_supported(c, hidden, num_heads, L):
        raise ValueError(
            f"fused_swin_block kernel takes C <= {BLOCK_MAX_CHANNELS}, L <= {BLOCK_MAX_WINDOW_LEN}, "
            f"head_dim <= {BLOCK_MAX_HEAD_DIM}, and C, hidden and head_dim multiples of 16; "
            f"got C={c}, hidden={hidden}, L={L}, {num_heads} heads"
        )
    geo = window_geometry(h, w, window_size, shift_size)
    dev, dt = x.device, x.dtype
    x = x.contiguous()
    mats = [t.to(device=dev, dtype=dt).contiguous() for t in (params.qkv_w, params.proj_w, params.fc1_w, params.fc2_w)]
    if any(t.data_ptr() % 16 for t in (x, *mats)):
        raise ValueError("fused_swin_block kernel reads the map and weights 16 bytes at a time; pass aligned tensors")
    vecs, param_code = _block_vectors(params, dev)
    bias = bias.to(device=dev, dtype=torch.float32).contiguous()
    gs = None if cosine_gs is None else cosine_gs.to(device=dev, dtype=torch.float32).contiguous()
    out = torch.empty_like(x)
    lib = _native.library()
    # f32: the weights split into TF32 hi and lo once for the call's windows
    n_scratch = lib.eqx_swin_block_scratch_floats(c, hidden, _DTYPE_CODES[dt])
    scratch = torch.empty(n_scratch, dtype=torch.float32, device=dev) if n_scratch else None
    with torch.cuda.device(dev):
        err = lib.eqx_swin_block(
            x.data_ptr(), out.data_ptr(),
            *(m.data_ptr() for m in mats), *(v.data_ptr() for v in vecs),
            bias.data_ptr(), None if gs is None else gs.data_ptr(),
            n, h, w, geo.ph, geo.pw, wh, ww, geo.sh, geo.sw, bias.shape[0], c, hidden, num_heads, scale, eps,
            int(postnorm), _DTYPE_CODES[dt], param_code, None if scratch is None else scratch.data_ptr(),
            torch.cuda.current_stream().cuda_stream,
        )
    if err:
        smem = lib.eqx_swin_block_smem_bytes(c, c // num_heads, x.element_size())
        _native.check(
            err,
            f"fused_swin_block kernel on the map {tuple(x.shape)} {dt}, window {tuple(window_size)}, shift "
            f"{(geo.sh, geo.sw)}, {num_heads} heads (one block needs {smem} bytes of shared memory)",
        )
    fused_swin_block.launches += 1
    return out


def _block_map_reference(x, bias, cosine_gs, *rest):
    """Plain version on the NHWC map: pad, roll, partition, the block on
    windows, then unpartition, roll back and crop. Positional, as the
    autograd function saves it."""
    params, (num_heads, scale, eps, postnorm, window_size, shift_size) = SwinBlockParams(*rest[:12]), rest[12:]
    xw, geo = _to_windows(x, window_size, shift_size)
    out = fused_swin_block_reference(xw, params, bias, num_heads, scale, eps, postnorm, cosine_gs)
    return _from_windows(out, window_size, geo)


class _FusedSwinBlock(torch.autograd.Function):
    """The block on an NHWC map: a CUDA tensor launches the kernel, a CPU
    tensor takes the plain version; the gradient recomputes through it."""

    @staticmethod
    def forward(ctx, x, bias, cosine_gs, *rest):
        params, static = SwinBlockParams(*rest[:12]), rest[12:]
        ctx.save_for_backward(x, bias, cosine_gs, *params)
        ctx.static = static
        if x.device.type == "cuda":
            return _launch_block_kernel(x, params, bias, *static[:4], cosine_gs, *static[4:])
        if x.device.type == "cpu":
            return _block_map_reference(x, bias, cosine_gs, *rest)
        raise ValueError(f"fused_swin_block runs on cuda (kernel) or cpu (plain torch), not {x.device}")

    @staticmethod
    def backward(ctx, grad_out):
        return recompute_grads(ctx, _block_map_reference, grad_out, n_static=6)


def fused_swin_block(
    xw: torch.Tensor,
    params: SwinBlockParams,
    bias: torch.Tensor,
    num_heads: int,
    scale: float,
    eps: float = 1e-5,
    postnorm: bool = False,
    cosine_gs: Optional[torch.Tensor] = None,
    window_size: Optional[Tuple[int, int]] = None,
    shift_size: Tuple[int, int] = (0, 0),
) -> torch.Tensor:
    """One whole Swin block: the counterpart of the JAX package's
    ``_swin_block_kernel``. Without ``window_size``, ``xw`` holds (N, nW, L,
    C) windows, the kernel's own layout (read as a map of (nW, L) tokens
    cut into (1, L) windows, unshifted). With it, ``xw`` is the NHWC map
    (N, H, W, C) and the block runs on its (window_size, shift_size)
    windows as ``fused_swin_block_v1``/``_v2`` give them. A CUDA tensor
    goes through ``csrc/swin_block.cu``, a CPU tensor through
    ``fused_swin_block_reference`` on ``_to_windows``' windows; the
    gradient recomputes through the plain version.
    ``fused_swin_block.launches`` counts kernel launches."""
    if xw.ndim != 4:
        raise ValueError(f"expected windows (N, nW, L, C) or a map (N, H, W, C), got {tuple(xw.shape)}")
    c = xw.shape[-1]
    if c % num_heads:
        raise ValueError(f"C={c} is not divisible by num_heads={num_heads}")
    if window_size is None:
        window_size, shift_size = (1, xw.shape[2]), (0, 0)
    window_size, shift_size = tuple(window_size), tuple(shift_size)
    geo = window_geometry(xw.shape[1], xw.shape[2], window_size, shift_size)
    nw, L = (geo.ph // window_size[0]) * (geo.pw // window_size[1]), window_size[0] * window_size[1]
    if bias.ndim != 4 or bias.shape[0] not in (1, nw) or tuple(bias.shape[1:]) != (num_heads, L, L):
        raise ValueError(f"expected bias of shape ({nw} or 1, {num_heads}, {L}, {L}), got {tuple(bias.shape)}")
    hidden = params.fc1_w.shape[0]
    shapes = ((c,), (c,), (3 * c, c), (3 * c,), (c, c), (c,), (c,), (c,), (hidden, c), (hidden,), (c, hidden), (c,))
    for field, t, shape in zip(SwinBlockParams._fields, params, shapes):
        if tuple(t.shape) != shape:
            raise ValueError(f"fused_swin_block: {field} has shape {tuple(t.shape)}, expected {shape}")
    args = (xw, bias, cosine_gs, *params, num_heads, float(scale), float(eps), bool(postnorm))
    if torch.compiler.is_exporting():
        return _fused_swin_block_op(*args, list(window_size), list(shift_size))
    return _FusedSwinBlock.apply(*args, window_size, shift_size)


fused_swin_block.launches = 0


def _block_op_kernel(x, bias, cosine_gs, *rest):
    params, (num_heads, scale, eps, postnorm, window_size, shift_size) = SwinBlockParams(*rest[:12]), rest[12:]
    return _launch_block_kernel(x, params, bias, num_heads, scale, eps, postnorm, cosine_gs, tuple(window_size),
                                tuple(shift_size))


def _block_op_reference(x, bias, cosine_gs, *rest):
    return _block_map_reference(x, bias, cosine_gs, *rest[:16], tuple(rest[16]), tuple(rest[17]))


_fused_swin_block_op = export_op(
    "fused_swin_block",
    "(Tensor x, Tensor bias, Tensor? cosine_gs, " + ", ".join(f"Tensor {f}" for f in SwinBlockParams._fields)
    + ", int num_heads, float scale, float eps, bool postnorm, int[] window_size, int[] shift_size) -> Tensor",
    _block_op_kernel, _block_op_reference, lambda x, *rest: x.new_empty(x.shape),
)


def _fused_swin_block(
    x, *, norm1_w, norm1_b, qkv_weight, qkv_bias, proj_weight, proj_bias, relative_position_bias,
    norm2_w, norm2_b, fc1_weight, fc1_bias, fc2_weight, fc2_bias, window_size, shift_size, num_heads,
    eps=1e-5, logit_scale=None, postnorm=False,
):
    c = x.shape[-1]

    def zeros(k):
        return torch.zeros(k, device=x.device, dtype=norm1_w.dtype)

    params = SwinBlockParams(
        norm1_w, norm1_b, qkv_weight, zeros(3 * c) if qkv_bias is None else qkv_bias,
        proj_weight, zeros(c) if proj_bias is None else proj_bias, norm2_w, norm2_b,
        fc1_weight, fc1_bias, fc2_weight, fc2_bias,
    )
    geo = window_geometry(x.shape[1], x.shape[2], window_size, shift_size)
    bias = _window_bias(relative_position_bias, window_size, num_heads, geo)
    cosine_gs = None if logit_scale is None else _cosine_gs(logit_scale, num_heads)
    scale = 1.0 if logit_scale is not None else (c // num_heads) ** -0.5
    return fused_swin_block(x, params, bias, num_heads, scale, eps, postnorm, cosine_gs, window_size, shift_size)


def fused_swin_block_v1(x: torch.Tensor, **kw) -> torch.Tensor:
    """One Swin v1 block (pre-norm, inference) on NHWC ``x``:
    ``x + proj(attn(LN1 x))``, then ``+ fc2(gelu(fc1(LN2 .)))``, with
    torchvision's shifted-window attention. Keywords as the JAX package's
    ``fused_swin_block_v1``, weights in torch's (out, in) layout. On the
    card one kernel launch reads the windows from the map and writes the
    block's output back to it (no pad, roll or partition in torch); on the
    CPU the plain version runs on ``_to_windows``' windows."""
    return _fused_swin_block(x, logit_scale=None, postnorm=False, **kw)


def fused_swin_block_v2(x: torch.Tensor, *, logit_scale: torch.Tensor, **kw) -> torch.Tensor:
    """One Swin v2 block (post-norm residuals, cosine attention, inference):
    ``x + LN1(proj(cosattn x))``, then ``+ LN2(fc2(gelu(fc1 .)))``. The
    caller zeroes the k third of ``qkv_bias``, as torchvision does."""
    return _fused_swin_block(x, logit_scale=logit_scale, postnorm=True, **kw)
