"""Space-to-depth form of a stride-2 RGB stem convolution
(eqxvision_tpu/ops/space_to_depth.py).

A stride-2 convolution over a few input channels is rewritten as a stride-1
convolution over 2x2 blocks of pixels stacked into 4x the channels:

    o[p,q,f] = sum_{u,v,c} w[f,c,u,v] x[2p+u-P, 2q+v-P, c]
             = sum_{m,n,(a,b,c)} w2[f,(a,b,c),m,n] x2[p+m, q+n, (a,b,c)]

with x2[i,j,(a,b,c)] = xp[2i+a, 2j+b, c] (xp: x padded by P before) and
w2[f,(a,b,c),m,n] = wpad[f,c,2m+a,2n+b] (w padded after to even taps). The
rewrite is exact; the weight stays stored in the OIHW form. The product runs
in f32 (or wider) on upcast operands, which hold every bf16 value, plus the
bias, rounded once to x's type, as the JAX function's f32 accumulation does.
``nn.Conv2d`` takes this route where ``EQXVISION_TPU_S2D_STEM=1``.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F


def applicable(in_channels: int, stride: Tuple[int, int], kernel: Tuple[int, int], padding) -> bool:
    """A stride-2 convolution of at most 4 input channels, each side padded
    evenly."""
    if tuple(stride) != (2, 2) or in_channels > 4:
        return False
    (ph0, ph1), (pw0, pw1) = padding
    return ph0 == ph1 and pw0 == pw1


def conv2d_stride2_s2d(
    x: torch.Tensor,  # (N, H, W, C), C small
    weight: torch.Tensor,  # (F, C, kh, kw), OIHW
    bias: Optional[torch.Tensor],
    padding: Tuple[Tuple[int, int], Tuple[int, int]],
) -> torch.Tensor:
    n, h, w, c = x.shape
    f, _, kh, kw = weight.shape
    ph, pw = padding[0][0], padding[1][0]
    out_h = (h + 2 * ph - kh) // 2 + 1
    out_w = (w + 2 * pw - kw) // 2 + 1
    keh, kew = (kh + 1) // 2 * 2, (kw + 1) // 2 * 2  # even tap counts
    wide = torch.promote_types(x.dtype, torch.float32)

    wp = F.pad(weight.to(wide), (0, kew - kw, 0, keh - kh))  # (F, C, keh, kew)
    w2 = wp.reshape(f, c, keh // 2, 2, kew // 2, 2).permute(0, 3, 5, 1, 2, 4).reshape(f, 4 * c, keh // 2, kew // 2)

    # the input padded by P before and, after, to cover the last window with an even length
    rh = max(2 * (out_h - 1) + keh - (h + ph), 0)
    rw = max(2 * (out_w - 1) + kew - (w + pw), 0)
    rh += (h + ph + rh) % 2
    rw += (w + pw + rw) % 2
    xp = F.pad(x.to(wide), (0, 0, pw, rw, ph, rh))
    hp, wq = xp.shape[1], xp.shape[2]
    x2 = xp.reshape(n, hp // 2, 2, wq // 2, 2, c).permute(0, 1, 3, 2, 4, 5).reshape(n, hp // 2, wq // 2, 4 * c)

    y = F.conv2d(x2.permute(0, 3, 1, 2), w2).permute(0, 2, 3, 1)[:, :out_h, :out_w, :]
    if bias is not None:
        y = y + bias.to(wide)
    return y.to(x.dtype)
