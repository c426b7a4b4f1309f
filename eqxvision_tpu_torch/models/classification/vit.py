"""Vision Transformer (DINO-style), NHWC batched
(eqxvision_tpu/models/classification/vit.py).

Each block is two fused ops. The attention half (norm1, qkv, attention,
proj, residual) is one ``ops.fused_attention_half`` call and the MLP half
(norm2, fc1, gelu, fc2, residual) one ``ops.fused_mlp_half`` call, each a
hand-written kernel on the card, unless dropout or drop path is active in
training. Then the layers run one by one: the attention runs the fused-qkv
kernel on the qkv projection's natural (N, L, 3D) layout, or, with
attention dropout active, materialises the probabilities in plain torch,
as in the JAX model.
"""
from __future__ import annotations

from typing import Any, Optional, Union

import torch
from torch import nn

from ...core import init
from ...layers import DropPath, MlpProjection, PatchEmbed
from ...nn import Dropout, Identity, LayerNorm, Linear, gelu
from ...ops.attention import fused_qkv_attention
from ...ops.attention_half import fused_attention_half
from ...ops.mlp_half import fused_mlp_half
from .._common import debatch, default_generator, ensure_nhwc, maybe_load_state_dict, resolve_device


class _VitAttention(nn.Module):
    def __init__(
        self, dim, num_heads=8, qkv_bias=False, qk_scale=None, attn_drop=0.0, proj_drop=0.0, *,
        generator: torch.Generator, device=None,
    ):
        super().__init__()
        self.num_heads = num_heads
        head_dim = dim // num_heads
        self.scale = qk_scale or head_dim**-0.5
        kw = dict(generator=generator, device=device)
        self.qkv = Linear(dim, dim * 3, use_bias=qkv_bias, **kw)
        self.proj = Linear(dim, dim, **kw)
        self.attn_drop = Dropout(attn_drop)
        self.proj_drop = Dropout(proj_drop)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        n, l, d = x.shape
        if self.attn_drop.p > 0.0 and self.training:
            # training with attention dropout needs the probabilities
            qkv = self.qkv(x).reshape(n, l, 3, self.num_heads, d // self.num_heads)
            q, k, v = qkv.permute(2, 0, 3, 1, 4).unbind(0)  # each (N, H, L, Dh)
            s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * self.scale
            p = self.attn_drop(torch.softmax(s, dim=-1).to(x.dtype))
            out = torch.matmul(p, v).transpose(1, 2).reshape(n, l, d)
        else:
            out = fused_qkv_attention(self.qkv(x), self.num_heads, self.scale)
        return self.proj_drop(self.proj(out))


class _VitBlock(nn.Module):
    """Pre-norm transformer block."""

    def __init__(
        self, dim, num_heads, mlp_ratio=4.0, qkv_bias=False, qk_scale=None, drop=0.0, attn_drop=0.0,
        drop_path=0.0, *, generator: torch.Generator, device=None,
    ):
        super().__init__()
        kw = dict(generator=generator, device=device)
        self.norm1 = LayerNorm(dim, eps=1e-6, device=device)
        self.attn = _VitAttention(dim, num_heads, qkv_bias, qk_scale, attn_drop, drop, **kw)
        self.drop_path = DropPath(drop_path)
        self.norm2 = LayerNorm(dim, eps=1e-6, device=device)
        self.mlp = MlpProjection(dim, int(dim * mlp_ratio), dim, gelu, drop, **kw)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        attn = self.attn
        if self.training and (self.drop_path.p > 0.0 or attn.attn_drop.p > 0.0 or attn.proj_drop.p > 0.0):
            x = x + self.drop_path(attn(self.norm1(x)))
        else:
            x = fused_attention_half(
                x, self.norm1.weight, self.norm1.bias, attn.qkv.weight, attn.qkv.bias, attn.proj.weight,
                attn.proj.bias, attn.num_heads, attn.scale, self.norm1.eps,
            )
        if self.training and (self.drop_path.p > 0.0 or self.mlp.drop1.p > 0.0):
            # dropout and drop path act inside the branch
            return x + self.drop_path(self.mlp(self.norm2(x)))
        mlp = self.mlp
        return fused_mlp_half(
            x, x, self.norm2.weight, self.norm2.bias, mlp.fc1.weight, mlp.fc1.bias, mlp.fc2.weight, mlp.fc2.bias,
            None, self.norm2.eps,
        )


class VisionTransformer(nn.Module):
    def __init__(
        self,
        img_size: int = 224,
        patch_size: int = 16,
        in_chans: int = 3,
        num_classes: int = 1000,
        embed_dim: int = 768,
        depth: int = 12,
        num_heads: int = 12,
        mlp_ratio: float = 4.0,
        qkv_bias: bool = True,
        qk_scale: Optional[float] = None,
        drop_rate: float = 0.0,
        attn_drop_rate: float = 0.0,
        drop_path_rate: float = 0.0,
        *,
        generator: Optional[torch.Generator] = None,
        device: Union[str, torch.device] = "cuda",
    ):
        super().__init__()
        generator = default_generator(generator)
        device = resolve_device(device)
        kw = dict(generator=generator, device=device)
        self.embed_dim = embed_dim
        self.patch_embed = PatchEmbed(img_size, patch_size, in_chans, embed_dim, **kw)
        num_patches = self.patch_embed.num_patches
        self.cls_token = nn.Parameter(init.trunc_normal((1, 1, embed_dim), std=0.02, **kw))
        self.pos_embed = nn.Parameter(init.trunc_normal((1, num_patches + 1, embed_dim), std=0.02, **kw))
        self.pos_drop = Dropout(drop_rate)
        dpr = [drop_path_rate * i / max(depth - 1, 1) for i in range(depth)]
        self.blocks = nn.ModuleList(
            _VitBlock(embed_dim, num_heads, mlp_ratio, qkv_bias, qk_scale, drop_rate, attn_drop_rate, dpr[i], **kw)
            for i in range(depth)
        )
        self.norm = LayerNorm(embed_dim, eps=1e-6, device=device)
        self.head = Linear(embed_dim, num_classes, **kw) if num_classes > 0 else Identity()

    def _prepare_tokens(self, x: torch.Tensor) -> torch.Tensor:
        x = self.patch_embed(x)  # (N, L, D)
        cls = self.cls_token.to(x.dtype).expand(x.shape[0], -1, -1)
        x = torch.cat([cls, x], dim=1) + self.pos_embed.to(x.dtype)
        return self.pos_drop(x)

    def features(self, x: torch.Tensor) -> torch.Tensor:
        """cls-token embedding (DINO feature extraction)."""
        x, single = ensure_nhwc(x)
        x = self._prepare_tokens(x)
        for blk in self.blocks:
            x = blk(x)
        x = self.norm(x)
        return debatch(x[:, 0], single)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.head(self.features(x))


def _vit(torch_weights, **kwargs):
    return maybe_load_state_dict(VisionTransformer(**kwargs), torch_weights)


def vit_tiny(torch_weights: Optional[str] = None, patch_size: int = 16, **kwargs: Any) -> VisionTransformer:
    kwargs.setdefault("embed_dim", 192)
    kwargs.setdefault("depth", 12)
    kwargs.setdefault("num_heads", 3)
    return _vit(torch_weights, patch_size=patch_size, **kwargs)


def vit_small(torch_weights: Optional[str] = None, patch_size: int = 16, **kwargs: Any) -> VisionTransformer:
    kwargs.setdefault("embed_dim", 384)
    kwargs.setdefault("depth", 12)
    kwargs.setdefault("num_heads", 6)
    return _vit(torch_weights, patch_size=patch_size, **kwargs)


def vit_base(torch_weights: Optional[str] = None, patch_size: int = 16, **kwargs: Any) -> VisionTransformer:
    kwargs.setdefault("embed_dim", 768)
    kwargs.setdefault("depth", 12)
    kwargs.setdefault("num_heads", 12)
    return _vit(torch_weights, patch_size=patch_size, **kwargs)
