"""Image-to-patch embedding (eqxvision_tpu/layers/patch_embed.py).

NHWC in, (N, L, D) out: a strided Conv2d projection whose (N, H', W', D)
output is flattened row-major, the token order of torch/timm's
``proj(x).flatten(2).transpose(1, 2)``.
"""
from __future__ import annotations

from typing import Optional, Sequence, Union

import torch
from torch import nn

from ..nn.conv import Conv2d


class PatchEmbed(nn.Module):
    def __init__(
        self,
        img_size: Union[int, Sequence[int]] = 224,
        patch_size: Union[int, Sequence[int]] = 16,
        in_chans: int = 3,
        embed_dim: int = 768,
        *,
        generator: torch.Generator,
        device: Optional[torch.device] = None,
    ):
        super().__init__()
        self.img_size = (img_size, img_size) if isinstance(img_size, int) else tuple(img_size)
        self.patch_size = (patch_size, patch_size) if isinstance(patch_size, int) else tuple(patch_size)
        self.grid_size = (self.img_size[0] // self.patch_size[0], self.img_size[1] // self.patch_size[1])
        self.num_patches = self.grid_size[0] * self.grid_size[1]
        self.proj = Conv2d(
            in_chans, embed_dim, self.patch_size, stride=self.patch_size,
            generator=generator, device=device,
        )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        n, h, w, _ = x.shape
        if (h, w) != self.img_size:
            raise ValueError(f"Input image size ({h}x{w}) doesn't match PatchEmbed size {self.img_size}.")
        x = self.proj(x)  # (N, H', W', D)
        return x.reshape(n, -1, x.shape[-1])
