"""Training augmentations on the device (eqxvision_tpu/ops/augment.py).

The host ships uint8 NHWC canvases and every random crop, flip, jitter and
batch mix runs on the tensor's device as batched torch ops, in front of the
train step's forward. Each random op is two functions: ``draw_<op>`` takes
an explicit ``torch.Generator`` (on the tensor's device) and returns the
op's random values, and ``apply_<op>`` is the deterministic rest, so that
given the same draws it computes what the JAX op computes. ``<op>`` itself
is the two in turn. The draws are the port's own: torch's generators cannot
reproduce ``jax.random``'s streams (ROADMAP C.16).

As in the JAX package: ``random_resized_crop`` takes one clamped
(area, log-ratio) draw per image, not torchvision's ten-try rejection loop,
and resizes by bilinear sampling without antialias; the colour ops follow
``torchvision.transforms.functional`` on float images, and ``color_jitter``
applies them in the fixed order brightness, contrast, saturation, hue;
``mixup`` and ``cutmix`` take one Beta(alpha, alpha) lambda and one partner
permutation a batch, and cutmix moves the label mass of the pixels its
rasterised box really pastes. Beta is drawn as G1 / (G1 + G2) from two
Gamma(alpha) draws of the generator (``torch.distributions.Beta`` takes
none).

Every op takes and returns float images in [0, 1] unless noted. The
AutoAugment family (``invert`` through ``rotate``, ``rand_augment``,
``trivial_augment_wide``, ``augmix``, ``auto_augment``) is not ported yet
(ROADMAP A.12b).
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from .preprocessing import IMAGENET_MEAN, IMAGENET_STD, normalize

# ITU-R 601 luma weights, as torchvision's rgb_to_grayscale.
_GRAY_W = (0.2989, 0.587, 0.114)


# --------------------------------------------------------------------
# deterministic colour ops (torchvision functional semantics)
# --------------------------------------------------------------------


def _grayscale(x: torch.Tensor) -> torch.Tensor:
    """(..., 3) RGB -> (..., 1) luma."""
    return (x * torch.tensor(_GRAY_W, dtype=x.dtype, device=x.device)).sum(-1, keepdim=True)


def _per_image(factor, like: torch.Tensor, ndim: int) -> torch.Tensor:
    """A scalar or per-image (N,) factor as a tensor of ``like``'s type with
    ``ndim`` axes, broadcastable against it."""
    factor = torch.as_tensor(factor, dtype=like.dtype, device=like.device)
    return factor.reshape(factor.shape + (1,) * (ndim - factor.ndim))


def _blend(a: torch.Tensor, b: torch.Tensor, factor) -> torch.Tensor:
    """torchvision's _blend: factor * a + (1 - factor) * b, clamped to [0, 1]."""
    f = _per_image(factor, a, a.ndim)
    return torch.clamp(a * f + b * (1.0 - f), 0.0, 1.0)


def adjust_brightness(x: torch.Tensor, factor) -> torch.Tensor:
    """Scale toward black; ``factor`` a scalar or per-image ``(N,)``."""
    return _blend(x, torch.zeros((), dtype=x.dtype, device=x.device), factor)


def adjust_contrast(x: torch.Tensor, factor) -> torch.Tensor:
    """Blend with the per-image mean of the grayscale image."""
    return _blend(x, _grayscale(x).mean(dim=(-3, -2, -1), keepdim=True), factor)


def adjust_saturation(x: torch.Tensor, factor) -> torch.Tensor:
    """Blend with the grayscale image (factor 0 gives grayscale)."""
    return _blend(x, _grayscale(x), factor)


def _rgb_to_hsv(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    r, g, b = x[..., 0], x[..., 1], x[..., 2]
    maxc = torch.maximum(torch.maximum(r, g), b)
    minc = torch.minimum(torch.minimum(r, g), b)
    cr = maxc - minc
    ones = torch.ones_like(maxc)
    s = cr / torch.where(maxc == 0, ones, maxc)
    cr_div = torch.where(cr == 0, ones, cr)
    rc = (maxc - r) / cr_div
    gc = (maxc - g) / cr_div
    bc = (maxc - b) / cr_div
    h = torch.where(r == maxc, bc - gc, torch.where(g == maxc, 2.0 + rc - bc, 4.0 + gc - rc))
    h = torch.remainder(h / 6.0, 1.0)
    h = torch.where(cr == 0, torch.zeros_like(h), h)
    return h, s, maxc


def _hsv_to_rgb(h: torch.Tensor, s: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    i = torch.floor(h * 6.0)
    f = h * 6.0 - i
    p = v * (1.0 - s)
    q = v * (1.0 - s * f)
    t = v * (1.0 - s * (1.0 - f))
    i = torch.remainder(i.to(torch.int32), 6)

    def pick(*choices):  # choices[k] where i == k
        out = choices[5]
        for k in range(4, -1, -1):
            out = torch.where(i == k, choices[k], out)
        return out

    return torch.stack([pick(v, q, p, p, t, v), pick(t, v, v, q, p, p), pick(p, p, t, v, v, q)], dim=-1)


def adjust_hue(x: torch.Tensor, factor) -> torch.Tensor:
    """Shift the hue by ``factor`` in [-0.5, 0.5] turns: RGB -> HSV,
    h += factor mod 1, -> RGB (torchvision's float semantics)."""
    h, s, v = _rgb_to_hsv(x)
    h = torch.remainder(h + _per_image(factor, x, x.ndim - 1), 1.0)
    return _hsv_to_rgb(h, s, v).to(x.dtype)


# --------------------------------------------------------------------
# draws
# --------------------------------------------------------------------


def _uniform(generator: torch.Generator, n, lo: float, hi: float, device) -> torch.Tensor:
    """U(lo, hi) in f32, shape ``n`` (an int or a tuple)."""
    return torch.rand(n, generator=generator, device=device) * (hi - lo) + lo


def draw_flip(generator: torch.Generator, n: int, p: float = 0.5, device=None) -> torch.Tensor:
    """(N,) bool: flip each image with probability ``p``."""
    return torch.rand(n, generator=generator, device=device) < p


def draw_beta(generator: torch.Generator, alpha: float, device=None) -> torch.Tensor:
    """One Beta(alpha, alpha) sample, a 0-d f32 tensor on ``device``."""
    g = torch._standard_gamma(torch.full((2,), float(alpha), device=device), generator=generator)
    return g[0] / (g[0] + g[1]).clamp_min(torch.finfo(torch.float32).tiny)


class CropBoxes(NamedTuple):
    """Per-image boxes (N,) each, in pixels of the source frame."""

    top: torch.Tensor
    left: torch.Tensor
    height: torch.Tensor
    width: torch.Tensor


def draw_resized_crop(
    generator: torch.Generator, n: int, h: int, w: int,
    scale: Tuple[float, float] = (0.08, 1.0), ratio: Tuple[float, float] = (3.0 / 4.0, 4.0 / 3.0), device=None,
) -> CropBoxes:
    """Area fraction ~ U(scale), aspect ~ exp(U(log ratio)), the box clamped
    into the ``h`` x ``w`` frame, its corner uniform over the room left."""
    area = _uniform(generator, n, scale[0], scale[1], device) * (h * w)
    r = torch.exp(_uniform(generator, n, math.log(ratio[0]), math.log(ratio[1]), device))
    bw = torch.clamp(torch.sqrt(area * r), 1.0, w)
    bh = torch.clamp(torch.sqrt(area / r), 1.0, h)
    top = torch.rand(n, generator=generator, device=device) * (h - bh)
    left = torch.rand(n, generator=generator, device=device) * (w - bw)
    return CropBoxes(top, left, bh, bw)


class ErasingDraw(NamedTuple):
    apply: torch.Tensor  # (N,) bool
    boxes: CropBoxes


def draw_erasing(
    generator: torch.Generator, n: int, h: int, w: int, p: float = 0.5,
    scale: Tuple[float, float] = (0.02, 0.33), ratio: Tuple[float, float] = (0.3, 3.3), device=None,
) -> ErasingDraw:
    apply = draw_flip(generator, n, p, device)
    return ErasingDraw(apply, draw_resized_crop(generator, n, h, w, scale, ratio, device))


class JitterDraw(NamedTuple):
    """Per-image (N,) factors, None for a colour op that is off."""

    brightness: Optional[torch.Tensor]
    contrast: Optional[torch.Tensor]
    saturation: Optional[torch.Tensor]
    hue: Optional[torch.Tensor]


def draw_color_jitter(
    generator: torch.Generator, n: int, brightness: float = 0.0, contrast: float = 0.0, saturation: float = 0.0,
    hue: float = 0.0, device=None,
) -> JitterDraw:
    """torchvision ColorJitter's ranges: brightness, contrast and saturation
    factors ~ U(max(0, 1 - v), 1 + v), hue ~ U(-v, v)."""

    def factor(v):
        return _uniform(generator, n, max(0.0, 1.0 - v), 1.0 + v, device) if v else None

    return JitterDraw(factor(brightness), factor(contrast), factor(saturation),
                      _uniform(generator, n, -hue, hue, device) if hue else None)


class MixDraw(NamedTuple):
    lam: torch.Tensor  # 0-d
    perm: torch.Tensor  # (N,) partner of each image


def draw_mixup(generator: torch.Generator, n: int, alpha: float = 0.2, device=None) -> MixDraw:
    lam = draw_beta(generator, alpha, device)
    return MixDraw(lam, torch.randperm(n, generator=generator, device=device))


class CutMixDraw(NamedTuple):
    lam: torch.Tensor  # 0-d
    perm: torch.Tensor  # (N,)
    center: torch.Tensor  # (2,) box centre as fractions of (H, W), each U(0, 1)


def draw_cutmix(generator: torch.Generator, n: int, alpha: float = 1.0, device=None) -> CutMixDraw:
    lam = draw_beta(generator, alpha, device)
    perm = torch.randperm(n, generator=generator, device=device)
    return CutMixDraw(lam, perm, torch.rand(2, generator=generator, device=device))


# --------------------------------------------------------------------
# applications
# --------------------------------------------------------------------


def apply_hflip(x: torch.Tensor, flip: torch.Tensor) -> torch.Tensor:
    return torch.where(flip[:, None, None, None], x.flip(2), x)


def apply_vflip(x: torch.Tensor, flip: torch.Tensor) -> torch.Tensor:
    return torch.where(flip[:, None, None, None], x.flip(1), x)


def _bilinear_sample(img: torch.Tensor, ys: torch.Tensor, xs: torch.Tensor) -> torch.Tensor:
    """Sample ``img (N, H, W, C)`` at the grids ``ys (N, S) x xs (N, S)``,
    bilinear and edge-clamped, giving (N, S, S, C): the JAX
    ``_bilinear_sample_one`` over the batch."""
    h, w = img.shape[1:3]
    y0 = torch.clamp(torch.floor(ys), 0, h - 1)
    x0 = torch.clamp(torch.floor(xs), 0, w - 1)
    wy = torch.clamp(ys - y0, 0.0, 1.0)[:, :, None, None]
    wx = torch.clamp(xs - x0, 0.0, 1.0)[:, None, :, None]
    y0i, x0i = y0.long(), x0.long()
    y1i, x1i = torch.clamp(y0i + 1, max=h - 1), torch.clamp(x0i + 1, max=w - 1)
    b = torch.arange(img.shape[0], device=img.device)[:, None, None]

    def at(yi, xi):
        return img[b, yi[:, :, None], xi[:, None, :]]

    top = at(y0i, x0i) * (1 - wx) + at(y0i, x1i) * wx
    bot = at(y1i, x0i) * (1 - wx) + at(y1i, x1i) * wx
    return top * (1 - wy) + bot * wy


def apply_resized_crop(x: torch.Tensor, boxes: CropBoxes, size: int) -> torch.Tensor:
    """Each image's box resampled to ``(size, size)`` at pixel centres, in
    f32, in the input's value range."""
    grid = (torch.arange(size, dtype=torch.float32, device=x.device) + 0.5) / size
    ys = boxes.top[:, None] + grid * boxes.height[:, None] - 0.5
    xs = boxes.left[:, None] + grid * boxes.width[:, None] - 0.5
    return _bilinear_sample(x.float(), ys, xs)


def apply_color_jitter(x: torch.Tensor, draw: JitterDraw) -> torch.Tensor:
    if draw.brightness is not None:
        x = adjust_brightness(x, draw.brightness)
    if draw.contrast is not None:
        x = adjust_contrast(x, draw.contrast)
    if draw.saturation is not None:
        x = adjust_saturation(x, draw.saturation)
    if draw.hue is not None:
        x = adjust_hue(x, draw.hue)
    return x


def apply_erasing(x: torch.Tensor, draw: ErasingDraw, value: float = 0.0) -> torch.Tensor:
    n, h, w, _ = x.shape
    top, left, bh, bw = (t[:, None, None] for t in draw.boxes)
    yy = torch.arange(h, dtype=torch.float32, device=x.device)[:, None]
    xx = torch.arange(w, dtype=torch.float32, device=x.device)[None, :]
    inside = (yy >= top) & (yy < top + bh) & (xx >= left) & (xx < left + bw)
    mask = inside & draw.apply[:, None, None]
    return torch.where(mask[..., None], torch.tensor(value, dtype=x.dtype, device=x.device), x)


def apply_mixup(x: torch.Tensor, y: torch.Tensor, draw: MixDraw) -> Tuple[torch.Tensor, torch.Tensor]:
    lam = draw.lam
    return lam * x + (1.0 - lam) * x[draw.perm], lam * y + (1.0 - lam) * y[draw.perm]


def apply_cutmix(x: torch.Tensor, y: torch.Tensor, draw: CutMixDraw) -> Tuple[torch.Tensor, torch.Tensor]:
    n, h, w, _ = x.shape
    cut = torch.sqrt(1.0 - draw.lam)
    ch, cw = h * cut, w * cut
    cy, cx = draw.center[0] * h, draw.center[1] * w
    y0, y1 = torch.clamp(cy - ch / 2, 0, h), torch.clamp(cy + ch / 2, 0, h)
    x0, x1 = torch.clamp(cx - cw / 2, 0, w), torch.clamp(cx + cw / 2, 0, w)
    yy = torch.arange(h, dtype=torch.float32, device=x.device)[:, None]
    xx = torch.arange(w, dtype=torch.float32, device=x.device)[None, :]
    inside = (yy >= y0) & (yy < y1) & (xx >= x0) & (xx < x1)
    xm = torch.where(inside[None, :, :, None], x[draw.perm], x)
    # the label mass from the rasterised mask: pixels pasted and label
    # mass moved agree exactly
    lam = 1.0 - inside.float().mean()
    return xm, lam * y + (1.0 - lam) * y[draw.perm]


# --------------------------------------------------------------------
# random ops: a draw, then its application
# --------------------------------------------------------------------


def random_hflip(generator: torch.Generator, x: torch.Tensor, p: float = 0.5) -> torch.Tensor:
    """Per-image horizontal flip with probability ``p`` (NHWC)."""
    return apply_hflip(x, draw_flip(generator, x.shape[0], p, x.device))


def random_vflip(generator: torch.Generator, x: torch.Tensor, p: float = 0.5) -> torch.Tensor:
    """Per-image vertical flip with probability ``p`` (NHWC)."""
    return apply_vflip(x, draw_flip(generator, x.shape[0], p, x.device))


def random_resized_crop(
    generator: torch.Generator, x: torch.Tensor, size: int,
    scale: Tuple[float, float] = (0.08, 1.0), ratio: Tuple[float, float] = (3.0 / 4.0, 4.0 / 3.0),
) -> torch.Tensor:
    """Batched RandomResizedCrop to ``(size, size)``, f32 in the input's
    value range."""
    n, h, w, _ = x.shape
    return apply_resized_crop(x, draw_resized_crop(generator, n, h, w, scale, ratio, x.device), size)


def color_jitter(
    generator: torch.Generator, x: torch.Tensor, brightness: float = 0.0, contrast: float = 0.0,
    saturation: float = 0.0, hue: float = 0.0,
) -> torch.Tensor:
    """Per-image random colour jitter in the fixed order brightness,
    contrast, saturation, hue."""
    draw = draw_color_jitter(generator, x.shape[0], brightness, contrast, saturation, hue, x.device)
    return apply_color_jitter(x, draw)


def random_erasing(
    generator: torch.Generator, x: torch.Tensor, p: float = 0.5, scale: Tuple[float, float] = (0.02, 0.33),
    ratio: Tuple[float, float] = (0.3, 3.3), value: float = 0.0,
) -> torch.Tensor:
    """Per-image random rectangle erased to ``value`` with probability ``p``
    (torchvision RandomErasing, one clamped draw)."""
    n, h, w, _ = x.shape
    return apply_erasing(x, draw_erasing(generator, n, h, w, p, scale, ratio, x.device), value)


def mixup(generator: torch.Generator, x: torch.Tensor, y: torch.Tensor, alpha: float = 0.2):
    """Mixup (Zhang et al. 2018); ``y`` soft labels ``(N, num_classes)``."""
    return apply_mixup(x, y, draw_mixup(generator, x.shape[0], alpha, x.device))


def cutmix(generator: torch.Generator, x: torch.Tensor, y: torch.Tensor, alpha: float = 1.0):
    """CutMix (Yun et al. 2019): a partner's random rectangle pasted in;
    ``y`` soft labels."""
    return apply_cutmix(x, y, draw_cutmix(generator, x.shape[0], alpha, x.device))


def smooth_labels(labels: torch.Tensor, num_classes: int, smoothing: float = 0.0) -> torch.Tensor:
    """Integer labels ``(N,)`` -> f32 soft targets ``(N, C)``: on = 1 - s +
    s / C, off = s / C."""
    on = 1.0 - smoothing + smoothing / num_classes
    off = smoothing / num_classes
    return F.one_hot(labels.long(), num_classes).float() * (on - off) + off


# --------------------------------------------------------------------
# end-to-end training pipeline
# --------------------------------------------------------------------


def imagenet_train_pipeline(
    generator: torch.Generator,
    images_uint8: torch.Tensor,
    *,
    size: int = 224,
    scale: Tuple[float, float] = (0.08, 1.0),
    hflip: float = 0.5,
    jitter: Optional[Tuple[float, float, float, float]] = None,
    auto_augment_policy: Optional[str] = None,
    mean: Sequence[float] = IMAGENET_MEAN,
    std: Sequence[float] = IMAGENET_STD,
    dtype: torch.dtype = torch.float32,
) -> torch.Tensor:
    """uint8 NHWC canvases -> augmented, normalised NHWC on their device:
    RandomResizedCrop(size), a horizontal flip with probability ``hflip``,
    the optional ``jitter=(b, c, s, h)``, normalisation. Draws in that
    order from ``generator``."""
    if auto_augment_policy is not None:
        raise NotImplementedError(
            f"auto_augment_policy={auto_augment_policy!r}: the AutoAugment family is not ported yet (ROADMAP A.12b)"
        )
    x = random_resized_crop(generator, images_uint8, size, scale=scale) / 255.0
    if hflip:
        x = random_hflip(generator, x, hflip)
    if jitter is not None:
        x = color_jitter(generator, x, *jitter)
    return normalize(x, mean, std, scale=1.0).to(dtype)
