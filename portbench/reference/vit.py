"""ViT (Dosovitskiy et al., arXiv:2010.11929), plain PyTorch, NHWC input.

Pre-norm blocks as in timm's and DINO's ``VisionTransformer`` and their
parameter names: a 16x16 patch projection (written here as a product over
the flattened patches), the class token and learned position embeddings,
``depth`` blocks of LayerNorm (eps 1e-6), multi-head attention with a qkv
bias and scale head_dim^-0.5, residual, LayerNorm, MLP (exact gelu),
residual; the final LayerNorm and the head on the class token. Stochastic
depth, in training, scales a kept branch by 1 / (1 - p) and drops the
others, one draw an image (``drop_path``).
"""
from __future__ import annotations

from typing import Callable, Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

from .precision import linear, matmul


def param_shapes(cfg: Dict) -> List[Tuple[str, Tuple[int, ...]]]:
    d, p, c = cfg["embed_dim"], cfg["patch_size"], cfg["in_chans"]
    hidden = int(d * cfg["mlp_ratio"])
    tokens = (cfg["image_size"] // p) ** 2 + 1
    out = [("cls_token", (1, 1, d)), ("pos_embed", (1, tokens, d)),
           ("patch_embed.proj.weight", (d, c, p, p)), ("patch_embed.proj.bias", (d,))]
    for i in range(cfg["depth"]):
        b = f"blocks.{i}."
        out += [(b + "norm1.weight", (d,)), (b + "norm1.bias", (d,)),
                (b + "attn.qkv.weight", (3 * d, d)), (b + "attn.qkv.bias", (3 * d,)),
                (b + "attn.proj.weight", (d, d)), (b + "attn.proj.bias", (d,)),
                (b + "norm2.weight", (d,)), (b + "norm2.bias", (d,)),
                (b + "mlp.fc1.weight", (hidden, d)), (b + "mlp.fc1.bias", (hidden,)),
                (b + "mlp.fc2.weight", (d, hidden)), (b + "mlp.fc2.bias", (d,))]
    out += [("norm.weight", (d,)), ("norm.bias", (d,)),
            ("head.weight", (cfg["num_classes"], d)), ("head.bias", (cfg["num_classes"],))]
    return out


def drop_rates(cfg: Dict, rate: float) -> List[float]:
    """Each block's stochastic-depth probability: linear from 0 to ``rate``."""
    depth = cfg["depth"]
    return [rate * i / max(depth - 1, 1) for i in range(depth)]


def _patches(x: torch.Tensor, p: int) -> torch.Tensor:
    """(N, H, W, C) -> (N, H/p * W/p, C p p), each patch flattened as an
    OIHW convolution weight is (channel, row, column), patches row-major."""
    n, h, w, c = x.shape
    x = x.reshape(n, h // p, p, w // p, p, c).permute(0, 1, 3, 5, 2, 4)
    return x.reshape(n, (h // p) * (w // p), c * p * p)


def forward(params: Dict[str, torch.Tensor], x: torch.Tensor, cfg: Dict, q: Callable,
            drop_path: Optional[Callable[[int, torch.Tensor], torch.Tensor]] = None) -> torch.Tensor:
    """Logits (N, classes) of normalised NHWC images ``x`` (f32)."""
    d, heads, eps = cfg["embed_dim"], cfg["num_heads"], cfg["ln_eps"]
    dh = d // heads
    n = x.shape[0]
    w = params["patch_embed.proj.weight"]
    t = linear(_patches(x, cfg["patch_size"]), w.reshape(d, -1), params["patch_embed.proj.bias"], q)
    t = torch.cat([params["cls_token"].expand(n, -1, -1), t], dim=1) + params["pos_embed"]
    tokens = t.shape[1]
    for i in range(cfg["depth"]):
        b = f"blocks.{i}."
        h = F.layer_norm(t, (d,), params[b + "norm1.weight"], params[b + "norm1.bias"], eps)
        qkv = linear(h, params[b + "attn.qkv.weight"], params[b + "attn.qkv.bias"], q)
        qh, kh, vh = qkv.reshape(n, tokens, 3, heads, dh).permute(2, 0, 3, 1, 4)
        a = torch.softmax(matmul(qh, kh.transpose(-1, -2), q) * dh**-0.5, dim=-1)
        o = matmul(a, vh, q).transpose(1, 2).reshape(n, tokens, d)
        o = linear(o, params[b + "attn.proj.weight"], params[b + "attn.proj.bias"], q)
        t = t + (drop_path(i, o) if drop_path else o)
        h = F.layer_norm(t, (d,), params[b + "norm2.weight"], params[b + "norm2.bias"], eps)
        h = F.gelu(linear(h, params[b + "mlp.fc1.weight"], params[b + "mlp.fc1.bias"], q))
        h = linear(h, params[b + "mlp.fc2.weight"], params[b + "mlp.fc2.bias"], q)
        t = t + (drop_path(i, h) if drop_path else h)
    t = F.layer_norm(t, (d,), params["norm.weight"], params["norm.bias"], eps)
    return linear(t[:, 0], params["head.weight"], params["head.bias"], q)
