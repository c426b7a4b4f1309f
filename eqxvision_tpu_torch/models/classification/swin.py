"""Swin Transformer v1 and v2, NHWC batched
(eqxvision_tpu/models/classification/swin.py).

torchvision's module tree and state-dict names (``features.0.0`` stem conv,
``features.0.2`` stem LayerNorm, stages and patch mergings in
``features.1`` ... ``features.7``, ``mlp.0``/``mlp.3``), with the JAX
package's dynamic padding. The buffers ``relative_position_index`` and
(v2) ``relative_coords_table`` are computed here from the window size.

Dispatch: at inference (``eval()``, every dropout and drop-path inert) a
block with C <= 192 runs as one whole-block kernel
(``ops.window_attention.fused_swin_block_v1``/``_v2``), as in the JAX
package; the other v1 blocks (C > 192) run two fused halves,
``ops.fused_window_attention_half`` then ``ops.fused_mlp_half``, the
counterpart of the prototype scripts/ablate_swin4.py; every other block
(training, v2 with C > 192) runs norm -> qkv -> the window-attention kernel
-> proj -> residual -> MLP. The fused kernels read the Linears' ``weight``:
of an int8 model (``quantize``) the dequantized one, cast to the input's
type in the kernel's wrapper, as the JAX model reads it.
``remat_blocks=True`` recomputes each block in the backward
(``vit.remat_call``). A block split over a model group
(``parallel.shard_params_tp``: column- and row-parallel Linears, the
attention's per-head parameters and ``num_heads`` its heads' share) takes
the unfused route, the window-attention kernel on the rank's heads.
"""
from __future__ import annotations

import functools
from typing import Any, Callable, Optional, Sequence, Union

import torch
import torch.nn.functional as F
from torch import nn

from ...core import init
from ...layers import DropPath
from ...layers.mlps import mlp_forward
from ...nn import Dropout, LayerNorm, Linear
from ...nn.collectives import Group, RowParallelLinear, copy_to_group, row_parallel_linear
from ...nn.conv import Conv2d
from ...ops import window_attention as wa
from ...ops import window_attention_half as wah
from ...ops.mlp_half import fused_mlp_half
from .._common import debatch, default_generator, ensure_nhwc, maybe_load_state_dict, resolve_device
from .vit import remat_call


def _merge(x: torch.Tensor) -> torch.Tensor:
    """Concatenate 2x2 neighbours, (N, H, W, C) -> (N, H/2, W/2, 4C), padding
    an odd side with zeros first."""
    h, w = x.shape[1:3]
    if h % 2 or w % 2:
        x = torch.nn.functional.pad(x, (0, 0, 0, w % 2, 0, h % 2))
    x0 = x[:, 0::2, 0::2]
    x1 = x[:, 1::2, 0::2]
    x2 = x[:, 0::2, 1::2]
    x3 = x[:, 1::2, 1::2]
    return torch.cat([x0, x1, x2, x3], dim=-1)


class _PatchMerging(nn.Module):
    """v1: concat 2x2 neighbours -> LN(4C) -> Linear(4C, 2C)."""

    def __init__(self, dim: int, *, generator: torch.Generator, device=None):
        super().__init__()
        self.reduction = Linear(4 * dim, 2 * dim, use_bias=False, generator=generator, device=device)
        self.norm = LayerNorm(4 * dim, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.reduction(self.norm(_merge(x)))


class _PatchMergingV2(nn.Module):
    """v2: concat -> Linear(4C, 2C) -> LN(2C)."""

    def __init__(self, dim: int, *, generator: torch.Generator, device=None):
        super().__init__()
        self.reduction = Linear(4 * dim, 2 * dim, use_bias=False, generator=generator, device=device)
        self.norm = LayerNorm(2 * dim, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.norm(self.reduction(_merge(x)))


class _ShiftedWindowAttention(nn.Module):
    """v1: relative-position bias table, std-0.02 truncated normal."""

    def __init__(
        self, dim, window_size, shift_size, num_heads, qkv_bias=True, proj_bias=True, attention_dropout=0.0,
        dropout=0.0, *, generator: torch.Generator, device=None,
    ):
        super().__init__()
        self.window_size = tuple(window_size)
        self.shift_size = tuple(shift_size)
        self.num_heads = num_heads
        self.attention_dropout = float(attention_dropout)
        self.dropout = float(dropout)
        kw = dict(generator=generator, device=device)
        self._define_position_bias(**kw)
        self.register_buffer(
            "relative_position_index",
            torch.from_numpy(wa.relative_position_index(*self.window_size).reshape(-1)).to(device),
        )
        self.qkv = Linear(dim, dim * 3, use_bias=qkv_bias, **kw)
        self.proj = Linear(dim, dim, use_bias=proj_bias, **kw)

    def _define_position_bias(self, *, generator, device):
        wh, ww = self.window_size
        self.relative_position_bias_table = nn.Parameter(
            init.trunc_normal(((2 * wh - 1) * (2 * ww - 1), self.num_heads), std=0.02, generator=generator, device=device)
        )

    def _gathered(self, table: torch.Tensor) -> torch.Tensor:
        """(T, H) table entries at the window's relative positions, (1, H, L, L)."""
        L = self.window_size[0] * self.window_size[1]
        return table[self.relative_position_index].reshape(L, L, -1).permute(2, 0, 1)[None]

    def get_relative_position_bias(self) -> torch.Tensor:
        return self._gathered(self.relative_position_bias_table)

    def cosine_logit_scale(self) -> Optional[torch.Tensor]:
        """v2's logit scale; None selects v1's scaled dot product."""
        return None

    def model_group(self) -> Optional[Group]:
        """The model group this layer's heads are split over
        (``parallel.shard_params_tp``), or None."""
        return self.proj.group if isinstance(self.proj, RowParallelLinear) else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        group = self.model_group()
        out = wa.shifted_window_attention(
            copy_to_group(x, group), self.qkv.weight, None if group else self.proj.weight,
            self.get_relative_position_bias(), self.window_size, self.num_heads, self.shift_size,
            qkv_bias=self.qkv.bias, proj_bias=self.proj.bias, logit_scale=self.cosine_logit_scale(),
            attention_dropout=self.attention_dropout, dropout=self.dropout, training=self.training,
        )
        if group is None:
            return out
        # tensor parallel: the rank's heads' outputs through its columns of proj, the sum over the
        # group, then proj's bias, the product rounded before it as on one card
        out = row_parallel_linear(out, self.proj.weight, self.proj.bias, group, round_before_bias=True)
        return F.dropout(out, self.dropout, training=self.training)


class _ShiftedWindowAttentionV2(_ShiftedWindowAttention):
    """v2: cosine attention with a per-head logit scale, and the log-spaced
    continuous position bias (cpb_mlp), 16 * sigmoid."""

    def __init__(self, dim, window_size, shift_size, num_heads, *args, generator: torch.Generator, device=None, **kw):
        super().__init__(dim, window_size, shift_size, num_heads, *args, generator=generator, device=device, **kw)
        self.cpb_mlp = nn.Sequential(
            Linear(2, 512, generator=generator, device=device),
            nn.ReLU(),
            Linear(512, num_heads, use_bias=False, generator=generator, device=device),
        )

    def _define_position_bias(self, *, generator, device):
        self.logit_scale = nn.Parameter(torch.log(10.0 * torch.ones((self.num_heads, 1, 1), device=device)))
        table = torch.from_numpy(wa.relative_coords_table(*self.window_size)).to(device)
        self.register_buffer("relative_coords_table", table)

    def get_relative_position_bias(self) -> torch.Tensor:
        cpb = self.cpb_mlp(self.relative_coords_table.reshape(-1, 2))  # ((2wh-1)(2ww-1), H)
        return 16.0 * torch.sigmoid(self._gathered(cpb))

    def cosine_logit_scale(self) -> Optional[torch.Tensor]:
        return self.logit_scale


class _SwinMlp(nn.Sequential):
    """torchvision's Swin MLP and its names: Linear, GELU, Dropout, Linear,
    Dropout, run by ``mlp_forward``: gelu acts on fc1's f32 accumulator and
    is rounded once, as the JAX package's ``MlpProjection`` does."""

    def __init__(self, dim: int, hidden: int, dropout: float, **kw):
        super().__init__(Linear(dim, hidden, **kw), nn.GELU(), Dropout(dropout), Linear(hidden, dim, **kw), Dropout(dropout))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return mlp_forward(*self, x)


class _SwinTransformerBlock(nn.Module):
    """v1 pre-norm block."""

    def __init__(
        self, dim, num_heads, window_size, shift_size, mlp_ratio=4.0, dropout=0.0, attention_dropout=0.0,
        stochastic_depth_prob=0.0, attn_layer=_ShiftedWindowAttention, *, generator: torch.Generator, device=None,
    ):
        super().__init__()
        kw = dict(generator=generator, device=device)
        self.norm1 = LayerNorm(dim, device=device)
        self.attn = attn_layer(
            dim, window_size, shift_size, num_heads, attention_dropout=attention_dropout, dropout=dropout, **kw
        )
        self.stochastic_depth = DropPath(stochastic_depth_prob)
        self.norm2 = LayerNorm(dim, device=device)
        self.mlp = _SwinMlp(dim, int(dim * mlp_ratio), dropout, **kw)

    def _regularizers_inert(self) -> bool:
        """The whole-block kernel computes no dropout or drop-path: each must
        be inert in its own right (eval mode, or p == 0)."""
        regs = (self.stochastic_depth, self.mlp[2], self.mlp[4])
        return all(not r.training or r.p == 0.0 for r in regs)

    def _whole(self) -> bool:
        """The fused kernels add proj's and fc2's bias and the residual in
        their epilogue: a block split over a model group (whose sum comes
        before them) is never fused."""
        return self.attn.model_group() is None

    def _can_fuse(self) -> bool:
        a = self.attn
        return (
            not a.training
            and self._regularizers_inert()
            and self._whole()
            and wa.fused_swin_block_supported(
                a.qkv.in_features, self.mlp[0].out_features, a.num_heads, a.window_size[0] * a.window_size[1]
            )
        )

    def _can_fuse_halves(self) -> bool:
        a = self.attn
        return (
            not a.training
            and self._regularizers_inert()
            and self._whole()
            and wah.window_attention_half_supported(a.qkv.in_features, a.num_heads, a.window_size[0] * a.window_size[1])
        )

    def _fused_kwargs(self) -> dict:
        a = self.attn
        return dict(
            norm1_w=self.norm1.weight, norm1_b=self.norm1.bias,
            qkv_weight=a.qkv.weight, qkv_bias=a.qkv.bias, proj_weight=a.proj.weight, proj_bias=a.proj.bias,
            relative_position_bias=a.get_relative_position_bias(),
            norm2_w=self.norm2.weight, norm2_b=self.norm2.bias,
            fc1_weight=self.mlp[0].weight, fc1_bias=self.mlp[0].bias,
            fc2_weight=self.mlp[3].weight, fc2_bias=self.mlp[3].bias,
            window_size=a.window_size, shift_size=a.shift_size, num_heads=a.num_heads, eps=self.norm1.eps,
        )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self._can_fuse():
            return wa.fused_swin_block_v1(x, **self._fused_kwargs())
        if self._can_fuse_halves():
            a, fc1, fc2 = self.attn, self.mlp[0], self.mlp[3]
            h = wah.window_attention_half_v1(
                x, norm1_w=self.norm1.weight, norm1_b=self.norm1.bias, qkv_weight=a.qkv.weight,
                qkv_bias=a.qkv.bias, proj_weight=a.proj.weight, proj_bias=a.proj.bias,
                relative_position_bias=a.get_relative_position_bias(), window_size=a.window_size,
                shift_size=a.shift_size, num_heads=a.num_heads, eps=self.norm1.eps,
            )
            return fused_mlp_half(h, h, self.norm2.weight, self.norm2.bias, fc1.weight, fc1.bias, fc2.weight,
                                  fc2.bias, None, self.norm2.eps)
        x = x + self.stochastic_depth(self.attn(self.norm1(x)))
        return x + self.stochastic_depth(self.mlp(self.norm2(x)))


class _SwinTransformerBlockV2(_SwinTransformerBlock):
    """v2 post-norm residuals."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self._can_fuse():
            kw = self._fused_kwargs()
            kw["qkv_bias"] = wa._v2_qkv_bias(kw["qkv_bias"], x.shape[-1])
            return wa.fused_swin_block_v2(x, logit_scale=self.attn.cosine_logit_scale(), **kw)
        x = x + self.stochastic_depth(self.norm1(self.attn(x)))
        return x + self.stochastic_depth(self.norm2(self.mlp(x)))


class SwinTransformer(nn.Module):
    def __init__(
        self,
        patch_size: Sequence[int],
        embed_dim: int,
        depths: Sequence[int],
        num_heads: Sequence[int],
        window_size: Sequence[int],
        mlp_ratio: float = 4.0,
        dropout: float = 0.0,
        attention_dropout: float = 0.0,
        stochastic_depth_prob: float = 0.1,
        num_classes: int = 1000,
        block: Optional[Callable[..., nn.Module]] = None,
        downsample_layer: Callable[..., nn.Module] = _PatchMerging,
        remat_blocks: bool = False,
        *,
        generator: Optional[torch.Generator] = None,
        device: Union[str, torch.device] = "cuda",
    ):
        super().__init__()
        generator = default_generator(generator)
        device = resolve_device(device)
        kw = dict(generator=generator, device=device)
        self.remat_blocks = bool(remat_blocks)
        block = block or _SwinTransformerBlock
        layers = [
            nn.Sequential(
                Conv2d(3, embed_dim, tuple(patch_size), stride=tuple(patch_size), **kw),
                nn.Identity(),  # torchvision's Permute: the input is NHWC already
                LayerNorm(embed_dim, device=device),
            )
        ]
        total_blocks = sum(depths)
        block_id = 0
        for i_stage, depth in enumerate(depths):
            dim = embed_dim * 2**i_stage
            stage = []
            for i_layer in range(depth):
                sd_prob = stochastic_depth_prob * float(block_id) / (total_blocks - 1)
                stage.append(
                    block(
                        dim, num_heads[i_stage], window_size=window_size,
                        shift_size=[0 if i_layer % 2 == 0 else w // 2 for w in window_size],
                        mlp_ratio=mlp_ratio, dropout=dropout, attention_dropout=attention_dropout,
                        stochastic_depth_prob=sd_prob, **kw,
                    )
                )
                block_id += 1
            layers.append(nn.Sequential(*stage))
            if i_stage < len(depths) - 1:
                layers.append(downsample_layer(dim, **kw))
        self.features = nn.Sequential(*layers)
        num_features = embed_dim * 2 ** (len(depths) - 1)
        self.norm = LayerNorm(num_features, device=device)
        self.head = Linear(num_features, num_classes, **kw)

    def _features(self, x: torch.Tensor) -> torch.Tensor:
        if not self.remat_blocks:
            return self.features(x)
        for layer in self.features:
            stage = isinstance(layer, nn.Sequential) and all(isinstance(b, _SwinTransformerBlock) for b in layer)
            x = functools.reduce(lambda t, blk: remat_call(blk, t), layer, x) if stage else layer(x)
        return x

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x, single = ensure_nhwc(x)
        x = self.norm(self._features(x))
        return debatch(self.head(x.mean(dim=(1, 2))), single)


def _swin(torch_weights, **kwargs):
    return maybe_load_state_dict(SwinTransformer(**kwargs), torch_weights)


def _defaults(kwargs, embed_dim, depths, num_heads, window, sd_prob):
    kwargs.setdefault("patch_size", (4, 4))
    kwargs.setdefault("embed_dim", embed_dim)
    kwargs.setdefault("depths", depths)
    kwargs.setdefault("num_heads", num_heads)
    kwargs.setdefault("window_size", (window, window))
    kwargs.setdefault("stochastic_depth_prob", sd_prob)
    return kwargs


def _swin_v2(torch_weights, **kwargs):
    kwargs.setdefault("block", functools.partial(_SwinTransformerBlockV2, attn_layer=_ShiftedWindowAttentionV2))
    kwargs.setdefault("downsample_layer", _PatchMergingV2)
    return _swin(torch_weights, **kwargs)


def swin_t(torch_weights: Optional[str] = None, **kwargs: Any) -> SwinTransformer:
    return _swin(torch_weights, **_defaults(kwargs, 96, (2, 2, 6, 2), (3, 6, 12, 24), 7, 0.2))


def swin_s(torch_weights: Optional[str] = None, **kwargs: Any) -> SwinTransformer:
    return _swin(torch_weights, **_defaults(kwargs, 96, (2, 2, 18, 2), (3, 6, 12, 24), 7, 0.3))


def swin_b(torch_weights: Optional[str] = None, **kwargs: Any) -> SwinTransformer:
    return _swin(torch_weights, **_defaults(kwargs, 128, (2, 2, 18, 2), (4, 8, 16, 32), 7, 0.5))


def swin_v2_t(torch_weights: Optional[str] = None, **kwargs: Any) -> SwinTransformer:
    return _swin_v2(torch_weights, **_defaults(kwargs, 96, (2, 2, 6, 2), (3, 6, 12, 24), 8, 0.2))


def swin_v2_s(torch_weights: Optional[str] = None, **kwargs: Any) -> SwinTransformer:
    return _swin_v2(torch_weights, **_defaults(kwargs, 96, (2, 2, 18, 2), (3, 6, 12, 24), 8, 0.3))


def swin_v2_b(torch_weights: Optional[str] = None, **kwargs: Any) -> SwinTransformer:
    return _swin_v2(torch_weights, **_defaults(kwargs, 128, (2, 2, 18, 2), (4, 8, 16, 32), 8, 0.5))
