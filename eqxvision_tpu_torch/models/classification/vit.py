"""Vision Transformer (DINO-style), NHWC batched
(eqxvision_tpu/models/classification/vit.py).

Each block is two fused ops. The attention half (norm1, qkv, attention,
proj, residual) is one ``ops.fused_attention_half`` call and the MLP half
(norm2, fc1, gelu, fc2, residual) one ``ops.fused_mlp_half`` call, each a
hand-written kernel on the card, unless dropout or drop path is active in
training, or the Linears are quantized (``quantize``), which the block then
calls as the JAX model does. Then the layers run one by one: the LayerNorm
kernel, and the attention runs the fused-qkv kernel on the qkv projection's
natural (N, L, 3D) layout, or, with attention dropout active, materialises
the probabilities in plain torch, as in the JAX model.

A block split over a model group (``parallel.shard_params_tp``) holds
column- and row-parallel Linears and the attention its heads' share: it
takes the unfused route, the fused-qkv kernel on the rank's heads.

``remat_blocks=True`` recomputes each block in the backward
(non-reentrant ``torch.utils.checkpoint``, the RNG state replayed so that
drop path draws the same masks). ``get_last_self_attention`` returns the
last block's attention probabilities and ``resize_pos_embed`` adapts a
model to another input size.
"""
from __future__ import annotations

import copy
from typing import Any, Optional, Sequence, Union

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

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

    def _qkv(self, x: torch.Tensor):
        qkv = self.qkv(x)
        n, l, three_d = qkv.shape  # 3D, or a tensor-parallel rank's share of it
        qkv = qkv.reshape(n, l, 3, self.num_heads, three_d // 3 // self.num_heads)
        return qkv.permute(2, 0, 3, 1, 4).unbind(0)  # each (N, H, L, Dh)

    def attention_probs(self, x: torch.Tensor) -> torch.Tensor:
        """(N, H, L, L) post-softmax attention in f32, before dropout."""
        q, k, _ = self._qkv(x)
        return torch.softmax(torch.matmul(q.float(), k.float().transpose(-1, -2)) * self.scale, dim=-1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        n, l, _ = x.shape
        if self.attn_drop.p > 0.0 and self.training:
            # training with attention dropout needs the probabilities
            q, k, v = self._qkv(x)
            s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * self.scale
            p = self.attn_drop(torch.softmax(s, dim=-1).to(x.dtype))
            out = torch.matmul(p, v).transpose(1, 2).reshape(n, l, -1)
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

    def _fusable(self) -> bool:
        """The fused halves read the Linears' weights: plain Linears only (a
        quantized layer is called, as in the JAX model, and so is a
        tensor-parallel one: the sum over its group comes between the
        product and the bias and residual the halves' epilogue adds)."""
        return all(isinstance(m, Linear) for m in (self.attn.qkv, self.attn.proj, self.mlp.fc1, self.mlp.fc2))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        attn = self.attn
        fusable = self._fusable()
        if not fusable or self.training and (self.drop_path.p > 0.0 or attn.attn_drop.p > 0.0 or attn.proj_drop.p > 0.0):
            x = x + self.drop_path(attn(self.norm1(x)))
        else:
            x = fused_attention_half(
                x, self.norm1.weight, self.norm1.bias, attn.qkv.weight, attn.qkv.bias, attn.proj.weight,
                attn.proj.bias, attn.num_heads, attn.scale, self.norm1.eps,
            )
        if not fusable or self.training and (self.drop_path.p > 0.0 or self.mlp.drop1.p > 0.0):
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
        remat_blocks: bool = False,
        *,
        generator: Optional[torch.Generator] = None,
        device: Union[str, torch.device] = "cuda",
    ):
        super().__init__()
        generator = default_generator(generator)
        device = resolve_device(device)
        kw = dict(generator=generator, device=device)
        self.embed_dim = embed_dim
        self.remat_blocks = bool(remat_blocks)
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
            x = remat_call(blk, x) if self.remat_blocks else blk(x)
        x = self.norm(x)
        return debatch(x[:, 0], single)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.head(self.features(x))

    def get_last_self_attention(self, x: torch.Tensor) -> torch.Tensor:
        """The last block's attention probabilities, f32: (N, H, L+1, L+1),
        or (H, L+1, L+1) for one (C, H, W) sample. Only in ``eval()``, as
        the JAX model requires inference mode."""
        if self.training:
            raise ValueError("set the model to eval() before extracting attention maps")
        x, single = ensure_nhwc(x)
        x = self._prepare_tokens(x)
        for blk in self.blocks[:-1]:
            x = blk(x)
        last = self.blocks[-1]
        return debatch(last.attn.attention_probs(last.norm1(x)), single)


def remat_call(block: nn.Module, x: torch.Tensor) -> torch.Tensor:
    """``block(x)``, recomputed in the backward where a gradient is taken:
    non-reentrant ``torch.utils.checkpoint`` with the RNG state replayed,
    so the recompute draws the forward's dropout and drop-path masks."""
    if not torch.is_grad_enabled():
        return block(x)
    return checkpoint(block, x, use_reentrant=False, preserve_rng_state=True)


def _keys_cubic(x: torch.Tensor) -> torch.Tensor:
    """Keys' cubic convolution kernel with a = -0.5 (``jax.image``'s)."""
    out = ((1.5 * x - 2.5) * x) * x + 1.0
    out = torch.where(x >= 1.0, ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0, out)
    return torch.where(x >= 2.0, torch.zeros_like(x), out)


def _cubic_weights(n_in: int, n_out: int) -> torch.Tensor:
    """(n_in, n_out) f32 weights of ``jax.image.resize(method="bicubic")``
    along one axis: half-pixel centres, the kernel widened by the scale
    where the axis shrinks (antialiasing), each column normalised, and
    zero where the sample lies outside the input."""
    inv_scale = 1.0 / (n_out / n_in)
    kernel_scale = max(inv_scale, 1.0)
    sample = (torch.arange(n_out, dtype=torch.float32) + 0.5) * inv_scale - 0.5
    x = (sample[None, :] - torch.arange(n_in, dtype=torch.float32)[:, None]).abs() / kernel_scale
    w = _keys_cubic(x)
    total = w.sum(dim=0, keepdim=True)
    eps = 1000.0 * torch.finfo(torch.float32).eps
    w = torch.where(total.abs() > eps, w / torch.where(total != 0, total, torch.ones_like(total)), torch.zeros_like(w))
    inside = (sample >= -0.5) & (sample <= n_in - 0.5)
    return torch.where(inside[None, :], w, torch.zeros_like(w))


def resize_pos_embed(model: VisionTransformer, img_size: Union[int, Sequence[int]]) -> VisionTransformer:
    """A copy of ``model`` for another input size: the grid part of
    ``pos_embed`` resized bicubically to the new patch grid, in f32, as
    ``jax.image.resize(method="bicubic")`` computes it (Keys' a = -0.5,
    antialiased where it shrinks; ``F.interpolate``'s bicubic has a =
    -0.75), and ``PatchEmbed``'s size updated. The class token's embedding
    stays. ``model`` is left as it is; the same size returns it."""
    pe = model.patch_embed
    img_size = (img_size, img_size) if isinstance(img_size, int) else tuple(img_size)
    if img_size == pe.img_size:
        return model
    (gh, gw), d = pe.grid_size, model.pos_embed.shape[-1]
    nh, nw = img_size[0] // pe.patch_size[0], img_size[1] // pe.patch_size[1]
    with torch.no_grad():
        grid = model.pos_embed[:, 1:].reshape(1, gh, gw, d).float()
        wh = _cubic_weights(gh, nh).to(grid.device) if nh != gh else torch.eye(gh, device=grid.device)
        ww = _cubic_weights(gw, nw).to(grid.device) if nw != gw else torch.eye(gw, device=grid.device)
        grid = torch.einsum("nijd,ip,jq->npqd", grid, wh, ww).reshape(1, nh * nw, d)
        new_pe = torch.cat([model.pos_embed[:, :1], grid.to(model.pos_embed.dtype)], dim=1)
    out = copy.deepcopy(model)
    out.pos_embed = nn.Parameter(new_pe)
    out.patch_embed.img_size, out.patch_embed.grid_size, out.patch_embed.num_patches = img_size, (nh, nw), nh * nw
    return out


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
