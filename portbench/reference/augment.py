"""The training input's augmentation, frozen here as a reference.

The recipe of the training cells (DeiT's, without RandAugment): a
RandomResizedCrop (one clamped draw of area fraction in [0.08, 1] and log
aspect in [log 3/4, log 4/3] an image, bilinear resampling at pixel
centres, edges clamped, no antialias), a horizontal flip with probability
1/2, ImageNet normalisation, label smoothing, then mixup or cutmix, a fair
coin a batch choosing which. Mixup mixes each image with a partner of a
random permutation at a Beta(alpha, alpha) weight; cutmix pastes the
partner's box of area fraction 1 - lambda around a uniform centre and
moves the label mass of the pixels pasted.

The draws come from a ``torch.Generator`` in the order and shapes that the
program's augmentation takes them, so that both sides draw the same
values from one seeded state: crop (area, aspect, top, left), flip, the
coin, mixup (two Gamma draws of its lambda, a permutation), cutmix (two
Gamma draws, a permutation, the box centre). Beta is drawn as
G1 / (G1 + G2), below alpha 1 with Gamma(alpha + 1) U^(1 / alpha), in logs.
"""
from __future__ import annotations

import math
from typing import Tuple

import torch
import torch.nn.functional as F

MEAN = (0.485, 0.456, 0.406)
STD = (0.229, 0.224, 0.225)


def _rand(g: torch.Generator, shape, device) -> torch.Tensor:
    return torch.rand(shape, generator=g, device=device)


def _log_gamma(g: torch.Generator, alpha: float, shape, device) -> torch.Tensor:
    if alpha >= 1.0:
        return torch.log(torch._standard_gamma(torch.full(shape, alpha, device=device), generator=g))
    x = torch._standard_gamma(torch.full(shape, alpha + 1.0, device=device), generator=g)
    return torch.log(x) + torch.log(_rand(g, shape, device)) / alpha


def _beta(g: torch.Generator, alpha: float, device) -> torch.Tensor:
    lg = _log_gamma(g, alpha, (2,), device)
    return torch.sigmoid(lg[0] - lg[1])


def resized_crop(g: torch.Generator, x: torch.Tensor, size: int) -> torch.Tensor:
    """(N, H, W, C) uint8 -> (N, size, size, C) f32 in [0, 255]."""
    n, h, w, _ = x.shape
    dev = x.device
    area = (_rand(g, n, dev) * (1.0 - 0.08) + 0.08) * (h * w)
    lo, hi = math.log(3.0 / 4.0), math.log(4.0 / 3.0)
    r = torch.exp(_rand(g, n, dev) * (hi - lo) + lo)
    bw = torch.clamp(torch.sqrt(area * r), 1.0, w)
    bh = torch.clamp(torch.sqrt(area / r), 1.0, h)
    top = _rand(g, n, dev) * (h - bh)
    left = _rand(g, n, dev) * (w - bw)
    grid = (torch.arange(size, dtype=torch.float32, device=dev) + 0.5) / size
    ys = top[:, None] + grid * bh[:, None] - 0.5  # (N, size) source rows
    xs = left[:, None] + grid * bw[:, None] - 0.5
    # separable bilinear weights, edges clamped: (N, size, H) and (N, size, W)
    wy = torch.clamp(1.0 - (ys[:, :, None].clamp(0, h - 1) - torch.arange(h, device=dev)).abs(), min=0.0)
    wx = torch.clamp(1.0 - (xs[:, :, None].clamp(0, w - 1) - torch.arange(w, device=dev)).abs(), min=0.0)
    img = x.float()
    rows = torch.einsum("nih,nhwc->niwc", wy, img)
    return torch.einsum("njw,niwc->nijc", wx, rows)


def augment(g: torch.Generator, x_u8: torch.Tensor, y: torch.Tensor, *, size: int, classes: int,
            smoothing: float, mixup: float, cutmix: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """Normalised (N, size, size, 3) f32 images and (N, classes) targets."""
    dev = x_u8.device
    x = resized_crop(g, x_u8, size) / 255.0
    flip = _rand(g, x.shape[0], dev) < 0.5
    x = torch.where(flip[:, None, None, None], x.flip(2), x)
    x = (x - torch.tensor(MEAN, device=dev)) / torch.tensor(STD, device=dev)
    on, off = 1.0 - smoothing + smoothing / classes, smoothing / classes
    t = F.one_hot(y.long(), classes).float() * (on - off) + off
    n, h, w, _ = x.shape
    pick = _rand(g, (), dev) < 0.5
    lam_m = _beta(g, mixup, dev)
    perm_m = torch.randperm(n, generator=g, device=dev)
    xm, tm = lam_m * x + (1 - lam_m) * x[perm_m], lam_m * t + (1 - lam_m) * t[perm_m]
    lam_c = _beta(g, cutmix, dev)
    perm_c = torch.randperm(n, generator=g, device=dev)
    centre = _rand(g, 2, dev)
    cut = torch.sqrt(1.0 - lam_c)
    cy, cx = centre[0] * h, centre[1] * w
    y0, y1 = torch.clamp(cy - h * cut / 2, 0, h), torch.clamp(cy + h * cut / 2, 0, h)
    x0, x1 = torch.clamp(cx - w * cut / 2, 0, w), torch.clamp(cx + w * cut / 2, 0, w)
    yy = torch.arange(h, dtype=torch.float32, device=dev)[:, None]
    xx = torch.arange(w, dtype=torch.float32, device=dev)[None, :]
    inside = (yy >= y0) & (yy < y1) & (xx >= x0) & (xx < x1)
    xc = torch.where(inside[None, :, :, None], x[perm_c], x)
    kept = 1.0 - inside.float().mean()
    tc = kept * t + (1 - kept) * t[perm_c]
    return torch.where(pick, xm, xc), torch.where(pick, tm, tc)
