"""Image preprocessing on the device (eqxvision_tpu/ops/preprocessing.py).

Raw uint8 NHWC canvases go to the card (a quarter of the bytes of f32) and
are resized, cropped and normalised there, as torchvision's eval transform
does on the host:

- ``resize_shorter_side``: bilinear, antialiased where it shrinks unless
  ``antialias=False``, as ``jax.image.resize`` (``resize_bilinear``, which
  the segmentation models share);
- ``center_crop``, ``five_crop``, ``ten_crop`` (torchvision's order);
- ``normalize``: ``(x * scale - mean) / std`` in f32, ImageNet defaults.

``resize_bilinear`` is ``F.interpolate(mode="bilinear",
align_corners=False)`` on the NCHW view of an NHWC map: half-pixel
centres, as ``jax.image.resize(method="bilinear")``. The JAX function
antialiases where it shrinks an axis (its kernel widens by the scale), and
``F.interpolate`` does so only with ``antialias=True``, so that is passed
whenever either side shrinks; where both grow the two agree without it.
Without antialias both sample the two nearest source pixels at any scale.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


def resize_bilinear(x: torch.Tensor, height: int, width: int, antialias: bool = True) -> torch.Tensor:
    """(N, H, W, C) -> (N, height, width, C), bilinear, half-pixel centres;
    with ``antialias``, antialiased where an axis shrinks, in f32 for a
    narrower input (torch's antialiased kernel takes no bf16 on the CPU)
    and rounded once."""
    if antialias and (height < x.shape[1] or width < x.shape[2]):
        y = F.interpolate(x.permute(0, 3, 1, 2).float(), size=(height, width), mode="bilinear",
                          align_corners=False, antialias=True)
        return y.permute(0, 2, 3, 1).to(x.dtype)
    y = F.interpolate(x.permute(0, 3, 1, 2), size=(height, width), mode="bilinear", align_corners=False)
    return y.permute(0, 2, 3, 1)


def resize_shorter_side(x: torch.Tensor, size: int, *, antialias: bool = True) -> torch.Tensor:
    """NHWC resize in f32 so that the shorter side equals ``size``, the
    aspect kept (the longer side rounded to the nearest pixel)."""
    n, h, w, c = x.shape
    if h <= w:
        oh, ow = size, max(int(round(w * size / h)), 1)
    else:
        oh, ow = max(int(round(h * size / w)), 1), size
    return resize_bilinear(x.float(), oh, ow, antialias)


def center_crop(x: torch.Tensor, crop_h: int, crop_w: Optional[int] = None) -> torch.Tensor:
    if crop_w is None:
        crop_w = crop_h
    h, w = x.shape[1:3]
    top = (h - crop_h) // 2
    left = (w - crop_w) // 2
    return x[:, top : top + crop_h, left : left + crop_w, :]


def five_crop(x: torch.Tensor, crop_h: int, crop_w: Optional[int] = None) -> torch.Tensor:
    """``(N, H, W, C) -> (5, N, ch, cw, C)``: the four corners and the centre,
    in torchvision's ``five_crop`` order (tl, tr, bl, br, centre)."""
    if crop_w is None:
        crop_w = crop_h
    h, w = x.shape[1:3]
    if crop_h > h or crop_w > w:
        raise ValueError(f"crop ({crop_h},{crop_w}) larger than image ({h},{w})")
    tl = x[:, :crop_h, :crop_w]
    tr = x[:, :crop_h, w - crop_w :]
    bl = x[:, h - crop_h :, :crop_w]
    br = x[:, h - crop_h :, w - crop_w :]
    return torch.stack([tl, tr, bl, br, center_crop(x, crop_h, crop_w)], dim=0)


def ten_crop(
    x: torch.Tensor, crop_h: int, crop_w: Optional[int] = None, *, vertical_flip: bool = False
) -> torch.Tensor:
    """``(N, H, W, C) -> (10, N, ch, cw, C)``: ``five_crop`` of the image,
    then of its flip (horizontal unless ``vertical_flip``), as torchvision's
    ``ten_crop``."""
    flipped = x.flip(1) if vertical_flip else x.flip(2)
    return torch.cat([five_crop(x, crop_h, crop_w), five_crop(flipped, crop_h, crop_w)], dim=0)


def normalize(
    x: torch.Tensor,
    mean: Sequence[float] = IMAGENET_MEAN,
    std: Sequence[float] = IMAGENET_STD,
    *,
    scale: float = 1.0 / 255.0,
) -> torch.Tensor:
    mean = torch.tensor(mean, dtype=torch.float32, device=x.device)
    std = torch.tensor(std, dtype=torch.float32, device=x.device)
    return (x.float() * scale - mean) / std


def imagenet_eval_pipeline(
    images_uint8: torch.Tensor,
    *,
    resize_size: int = 256,
    crop_size: int = 224,
    mean: Sequence[float] = IMAGENET_MEAN,
    std: Sequence[float] = IMAGENET_STD,
    dtype: torch.dtype = torch.float32,
) -> torch.Tensor:
    """uint8 NHWC -> normalised NHWC on the tensor's device: the shorter
    side resized to ``resize_size``, the centre ``crop_size`` square taken,
    normalised, cast to ``dtype``."""
    x = resize_shorter_side(images_uint8, resize_size)
    x = center_crop(x, crop_size)
    return normalize(x, mean, std).to(dtype)
