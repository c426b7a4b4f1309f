"""Swin Transformer v1 (Liu et al., arXiv:2103.14030), plain PyTorch, NHWC
input, following torchvision's ``swin_transformer.py`` and its parameter
names.

A 4x4 patch projection and LayerNorm, then four stages of blocks, with a
patch merging (2x2 neighbours concatenated in torchvision's order,
LayerNorm, a bias-free reduction to twice the width) between stages. A
block: LayerNorm, shifted-window attention (windows of ``window`` x
``window`` tokens after padding to a multiple of the window, odd blocks
shifted by half a window unless the window covers the map, the learned
relative-position bias, the -100 mask between regions that the shift
brought together, scale head_dim^-0.5), residual, LayerNorm, MLP (exact
gelu), residual; every LayerNorm at eps 1e-5. The final LayerNorm, the
mean over the map and the head.
"""
from __future__ import annotations

from typing import Callable, Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

from .precision import linear, matmul

EPS = 1e-5


def _stages(cfg: Dict):
    for s, (depth, heads) in enumerate(zip(cfg["depths"], cfg["num_heads"])):
        yield s, depth, heads, cfg["embed_dim"] * 2**s


def param_shapes(cfg: Dict) -> List[Tuple[str, Tuple[int, ...]]]:
    c0, p, w = cfg["embed_dim"], cfg["patch_size"], cfg["window_size"]
    out = [("features.0.0.weight", (c0, cfg["in_chans"], p, p)), ("features.0.0.bias", (c0,)),
           ("features.0.2.weight", (c0,)), ("features.0.2.bias", (c0,))]
    stages = list(_stages(cfg))
    for s, depth, heads, c in stages:
        hidden = int(c * cfg["mlp_ratio"])
        for i in range(depth):
            b = f"features.{2 * s + 1}.{i}."
            out += [(b + "norm1.weight", (c,)), (b + "norm1.bias", (c,)),
                    (b + "attn.relative_position_bias_table", ((2 * w - 1) ** 2, heads)),
                    (b + "attn.qkv.weight", (3 * c, c)), (b + "attn.qkv.bias", (3 * c,)),
                    (b + "attn.proj.weight", (c, c)), (b + "attn.proj.bias", (c,)),
                    (b + "norm2.weight", (c,)), (b + "norm2.bias", (c,)),
                    (b + "mlp.0.weight", (hidden, c)), (b + "mlp.0.bias", (hidden,)),
                    (b + "mlp.3.weight", (c, hidden)), (b + "mlp.3.bias", (c,))]
        if s < len(stages) - 1:
            m = f"features.{2 * s + 2}."
            out += [(m + "reduction.weight", (2 * c, 4 * c)), (m + "norm.weight", (4 * c,)), (m + "norm.bias", (4 * c,))]
    c_last = stages[-1][3]
    out += [("norm.weight", (c_last,)), ("norm.bias", (c_last,)),
            ("head.weight", (cfg["num_classes"], c_last)), ("head.bias", (cfg["num_classes"],))]
    return out


def drop_rates(cfg: Dict, rate: float) -> List[float]:
    """Each block's stochastic-depth probability, in block order over the
    stages: linear from 0 to ``rate``."""
    total = sum(cfg["depths"])
    return [rate * i / (total - 1) for i in range(total)]


def relative_position_index(w: int) -> torch.Tensor:
    coords = torch.stack(torch.meshgrid(torch.arange(w), torch.arange(w), indexing="ij")).flatten(1)
    rel = (coords[:, :, None] - coords[:, None, :]).permute(1, 2, 0)
    rel[:, :, 0] += w - 1
    rel[:, :, 1] += w - 1
    rel[:, :, 0] *= 2 * w - 1
    return rel.sum(-1).flatten()


def _shift_mask(ph: int, pw: int, w: int, shift: Tuple[int, int], device) -> torch.Tensor:
    """(windows, L, L): 0 within a region, -100 across two."""
    mask = torch.zeros((ph, pw), device=device)
    count = 0
    for hs in ((0, -w), (-w, -shift[0]), (-shift[0], None)):
        for ws in ((0, -w), (-w, -shift[1]), (-shift[1], None)):
            mask[hs[0]:hs[1], ws[0]:ws[1]] = count
            count += 1
    mask = mask.view(ph // w, w, pw // w, w).permute(0, 2, 1, 3).reshape(-1, w * w)
    diff = mask[:, None, :] - mask[:, :, None]
    return diff.masked_fill(diff != 0, -100.0).masked_fill(diff == 0, 0.0)


def window_attention(x: torch.Tensor, params: Dict, b: str, heads: int, w: int, shifted: bool, q: Callable):
    n, h, wd, c = x.shape
    pad_r, pad_b = (w - wd % w) % w, (w - h % w) % w
    x = F.pad(x, (0, 0, 0, pad_r, 0, pad_b))
    ph, pw = x.shape[1:3]
    shift = [w // 2 if shifted else 0] * 2
    if w >= ph:
        shift[0] = 0
    if w >= pw:
        shift[1] = 0
    if sum(shift):
        x = torch.roll(x, shifts=(-shift[0], -shift[1]), dims=(1, 2))
    nw = (ph // w) * (pw // w)
    t = x.view(n, ph // w, w, pw // w, w, c).permute(0, 1, 3, 2, 4, 5).reshape(n * nw, w * w, c)
    qkv = linear(t, params[b + "qkv.weight"], params[b + "qkv.bias"], q)
    qkv = qkv.reshape(t.shape[0], w * w, 3, heads, c // heads).permute(2, 0, 3, 1, 4)
    qh, kh, vh = qkv[0] * (c // heads) ** -0.5, qkv[1], qkv[2]
    attn = matmul(qh, kh.transpose(-2, -1), q)
    table = params[b + "relative_position_bias_table"]
    bias = table[relative_position_index(w).to(table.device)].view(w * w, w * w, -1).permute(2, 0, 1)
    attn = attn + bias[None]
    if sum(shift):
        mask = _shift_mask(ph, pw, w, shift, x.device)
        attn = (attn.view(n, nw, heads, w * w, w * w) + mask[None, :, None]).view(-1, heads, w * w, w * w)
    attn = torch.softmax(attn, dim=-1)
    o = matmul(attn, vh, q).transpose(1, 2).reshape(t.shape[0], w * w, c)
    o = linear(o, params[b + "proj.weight"], params[b + "proj.bias"], q)
    o = o.view(n, ph // w, pw // w, w, w, c).permute(0, 1, 3, 2, 4, 5).reshape(n, ph, pw, c)
    if sum(shift):
        o = torch.roll(o, shifts=(shift[0], shift[1]), dims=(1, 2))
    return o[:, :h, :wd, :]


def _merge(x: torch.Tensor) -> torch.Tensor:
    h, w = x.shape[1:3]
    x = F.pad(x, (0, 0, 0, w % 2, 0, h % 2))
    return torch.cat([x[:, 0::2, 0::2], x[:, 1::2, 0::2], x[:, 0::2, 1::2], x[:, 1::2, 1::2]], dim=-1)


def forward(params: Dict[str, torch.Tensor], x: torch.Tensor, cfg: Dict, q: Callable,
            drop_path: Optional[Callable[[int, torch.Tensor], torch.Tensor]] = None) -> torch.Tensor:
    """Logits (N, classes) of normalised NHWC images ``x`` (f32)."""
    p, w = cfg["patch_size"], cfg["window_size"]
    n, hh, ww, cin = x.shape
    c0 = cfg["embed_dim"]
    patches = x.reshape(n, hh // p, p, ww // p, p, cin).permute(0, 1, 3, 5, 2, 4).reshape(n, hh // p, ww // p, -1)
    t = linear(patches, params["features.0.0.weight"].reshape(c0, -1), params["features.0.0.bias"], q)
    t = F.layer_norm(t, (c0,), params["features.0.2.weight"], params["features.0.2.bias"], EPS)
    stages = list(_stages(cfg))
    block = 0
    for s, depth, heads, c in stages:
        for i in range(depth):
            b = f"features.{2 * s + 1}.{i}."
            h = F.layer_norm(t, (c,), params[b + "norm1.weight"], params[b + "norm1.bias"], EPS)
            h = window_attention(h, params, b + "attn.", heads, w, i % 2 == 1, q)
            t = t + (drop_path(block, h) if drop_path else h)
            h = F.layer_norm(t, (c,), params[b + "norm2.weight"], params[b + "norm2.bias"], EPS)
            h = F.gelu(linear(h, params[b + "mlp.0.weight"], params[b + "mlp.0.bias"], q))
            h = linear(h, params[b + "mlp.3.weight"], params[b + "mlp.3.bias"], q)
            t = t + (drop_path(block, h) if drop_path else h)
            block += 1
        if s < len(stages) - 1:
            m = f"features.{2 * s + 2}."
            t = F.layer_norm(_merge(t), (4 * c,), params[m + "norm.weight"], params[m + "norm.bias"], EPS)
            t = linear(t, params[m + "reduction.weight"], None, q)
    t = F.layer_norm(t, (stages[-1][3],), params["norm.weight"], params["norm.bias"], EPS)
    return linear(t.mean(dim=(1, 2)), params["head.weight"], params["head.bias"], q)
