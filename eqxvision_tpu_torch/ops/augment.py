"""Training augmentations on the device (eqxvision_tpu/ops/augment.py).

The host ships uint8 NHWC canvases and every random crop, flip, jitter,
auto-augmentation and batch mix runs on the tensor's device as batched
torch ops, in front of the train step's forward. Each random op is two
functions: ``draw_<op>`` takes an explicit ``torch.Generator`` (on the
tensor's device) and returns the op's random values, and ``apply_<op>`` is
the deterministic rest, so that given the same draws it computes what the
JAX op computes. ``<op>`` itself is the two in turn. The draws are the
port's own: torch's generators cannot reproduce ``jax.random``'s streams
(ROADMAP C.16).

As in the JAX package: ``random_resized_crop`` takes one clamped
(area, log-ratio) draw per image, not torchvision's ten-try rejection loop,
and resizes by bilinear sampling without antialias; the colour ops follow
``torchvision.transforms.functional`` on float images, and ``color_jitter``
applies them in the fixed order brightness, contrast, saturation, hue;
``mixup`` and ``cutmix`` take one Beta(alpha, alpha) lambda and one partner
permutation a batch, and cutmix moves the label mass of the pixels its
rasterised box really pastes. Beta is drawn as G1 / (G1 + G2) from two
Gamma(alpha) draws of the generator (``torch.distributions.Beta`` takes
none), and AugMix's Dirichlet weights as Gamma draws over their sum.

The AutoAugment family: the PIL-style point ops (``invert``, ``solarize``,
``posterize``, ``autocontrast``, ``equalize``, ``sharpness``), the inverse
mapped bilinear ``affine`` and ``rotate`` about the image's centre, and the
policies ``rand_augment``, ``trivial_augment_wide``, ``augmix`` and
``auto_augment`` with torchvision's op tables and magnitudes. A policy
picks each image's op among its candidates by ``torch.where``, as the JAX
package computes every candidate and selects; the five geometric
candidates of a slot are one warp, each image with its own op's parameters
(the same numbers, image by image, as the JAX candidate it selects). No
op syncs with the host: no boolean-mask indexing, ``nonzero``, ``.item()``
or ``bincount``, and no Python number copied to the card (scalars enter as
kernel arguments or as 0-d CPU tensors, tables through pinned memory).

Every op takes and returns float images in [0, 1] unless noted.
"""
from __future__ import annotations

import math
import numbers
from typing import Callable, Dict, NamedTuple, Optional, Sequence, Tuple

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
    r, g, b = x[..., 0:1], x[..., 1:2], x[..., 2:3]
    return r * _GRAY_W[0] + g * _GRAY_W[1] + b * _GRAY_W[2]


def _per_image(factor, like: torch.Tensor, ndim: int) -> torch.Tensor:
    """A scalar or per-image (N,) factor as a tensor of ``like``'s type,
    broadcastable against ``ndim`` axes: a Python number as a 0-d CPU
    tensor (a kernel argument, nothing copied to the card), a per-image
    factor with ``ndim`` axes."""
    if isinstance(factor, numbers.Number):
        return torch.tensor(factor, dtype=like.dtype)
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
# PIL-style point ops (torchvision functional semantics, [0, 1] floats)
# --------------------------------------------------------------------


def invert(x: torch.Tensor) -> torch.Tensor:
    return 1.0 - x


def solarize(x: torch.Tensor, threshold) -> torch.Tensor:
    """Invert the pixels at or above ``threshold`` (a scalar or per-image
    ``(N,)``)."""
    return torch.where(x >= _per_image(threshold, x, x.ndim), 1.0 - x, x)


def _div(t: torch.Tensor, d: float) -> torch.Tensor:
    """``t / d`` rounded as IEEE division, on every device: torch's CUDA
    kernel multiplies by the reciprocal of a Python divisor, which can land
    an ulp away, so the divisor goes in as a 0-d tensor on ``t``'s device
    (filled there, not copied)."""
    return t / torch.full((), float(d), dtype=t.dtype, device=t.device)


def _quantize(x: torch.Tensor) -> torch.Tensor:
    """[0, 1] floats -> int32 in [0, 255], truncated as the JAX ``astype``."""
    return torch.clamp((x * 255.0).to(torch.int32), 0, 255)


def posterize(x: torch.Tensor, bits) -> torch.Tensor:
    """Keep the top ``bits`` bits of each 8-bit-quantised channel; ``bits``
    a scalar or per-image ``(N,)`` integer in [0, 8] (8 keeps all, 0
    none)."""
    if isinstance(bits, numbers.Integral):
        mask = (0xFF << (8 - int(bits))) & 0xFF
    else:
        b = torch.as_tensor(bits, device=x.device).to(torch.int32)
        b = b.reshape(b.shape + (1,) * (x.ndim - b.ndim))
        mask = torch.bitwise_left_shift(torch.full_like(b, 0xFF), 8 - b) & 0xFF
    return _div((_quantize(x) & mask).to(x.dtype), 255.0)


def autocontrast(x: torch.Tensor) -> torch.Tensor:
    """Per-image, per-channel linear stretch of the value range to [0, 1];
    a constant channel stays as it is (PIL)."""
    lo = torch.amin(x, dim=(-3, -2), keepdim=True)
    hi = torch.amax(x, dim=(-3, -2), keepdim=True)
    span = hi - lo
    out = (x - lo) / torch.where(span == 0, torch.ones_like(span), span)
    return torch.where(span == 0, x, torch.clamp(out, 0.0, 1.0))


def equalize(x: torch.Tensor) -> torch.Tensor:
    """Per-image, per-channel histogram equalisation of the 8-bit
    quantisation (NHWC), PIL's LUT: ``step = (count - hist[max]) // 255``,
    ``lut = (cumsum + step // 2) // step`` shifted one bin up, identity
    where ``step`` is 0. Integer arithmetic throughout: the histogram by
    ``scatter_add_`` into an (N, C, 256) tensor, ``hist[max]`` by
    ``gather``, so nothing syncs with the host."""
    n, h, w, c = x.shape
    q = _quantize(x).permute(0, 3, 1, 2).reshape(n * c, h * w).long()
    hist = torch.zeros(n * c, 256, dtype=torch.int64, device=x.device)
    hist.scatter_add_(1, q, torch.ones_like(q))
    step = (h * w - hist.gather(1, q.amax(1, keepdim=True))) // 255
    lut = (torch.cumsum(hist, 1) + step // 2) // torch.clamp_min(step, 1)
    lut = torch.clamp(F.pad(lut[:, :-1], (1, 0)), 0, 255)
    out = torch.where(step == 0, q, lut.gather(1, q))
    return _div(out.reshape(n, c, h, w).permute(0, 2, 3, 1).to(x.dtype), 255.0)


def sharpness(x: torch.Tensor, factor) -> torch.Tensor:
    """Blend with the image smoothed by PIL's SMOOTH kernel (centre 5, the
    eight neighbours 1, over 13), whose one-pixel border stays unsmoothed
    (torchvision ``adjust_sharpness``). The smoothing is nine shifted
    slices summed in f32 (a convolution could run on TF32 on the card)."""
    n, h, w, _ = x.shape
    xf = x.float()
    inner = xf[:, 1 : h - 1, 1 : w - 1] * (5.0 / 13.0)
    for dy in range(3):
        for dx in range(3):
            if (dy, dx) != (1, 1):
                inner = inner + xf[:, dy : dy + h - 2, dx : dx + w - 2] * (1.0 / 13.0)
    smooth = xf.clone()
    smooth[:, 1 : h - 1, 1 : w - 1] = inner
    return _blend(x, smooth.to(x.dtype), factor)


# --------------------------------------------------------------------
# affine warps (inverse-mapped bilinear, constant fill: torchvision affine)
# --------------------------------------------------------------------


def _param(v, n: int, device) -> torch.Tensor:
    """A scalar or per-image parameter as an (N,) f32 tensor on ``device``
    (a Python number filled there, not copied)."""
    if isinstance(v, numbers.Number):
        return torch.full((n,), float(v), device=device)
    return torch.broadcast_to(torch.as_tensor(v, dtype=torch.float32, device=device), (n,))


def _affine_grid(
    shape, device, *, angle=0.0, translate=(0.0, 0.0), shear=(0.0, 0.0), scale=1.0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The source coordinates ``(ys, xs)``, each (N, H, W), that ``affine``
    samples for an NHWC ``shape``: torchvision's forward matrix
    RotateScale @ Shear about the centre ``((w - 1) / 2, (h - 1) / 2)``,
    inverted, applied to each output pixel less the translation."""
    n, h, w = shape[:3]
    ang = -torch.deg2rad(_param(angle, n, device))  # y points down: counter-clockwise is negative
    sx = torch.deg2rad(_param(shear[0], n, device))
    sy = torch.deg2rad(_param(shear[1], n, device))
    tx, ty = _param(translate[0], n, device), _param(translate[1], n, device)
    sc = _param(scale, n, device)
    a = sc * torch.cos(ang + sy) / torch.cos(sy)
    b = -sc * (torch.cos(ang + sy) * torch.tan(sx) / torch.cos(sy) + torch.sin(ang))
    c = sc * torch.sin(ang + sy) / torch.cos(sy)
    d = -sc * (torch.sin(ang + sy) * torch.tan(sx) / torch.cos(sy) - torch.cos(ang))
    det = a * d - b * c
    ia, ib, ic, id_ = (t[:, None, None] for t in (d / det, -b / det, -c / det, a / det))
    cx, cy = (w - 1) / 2.0, (h - 1) / 2.0
    ox = (torch.arange(w, dtype=torch.float32, device=device) - cx)[None, None, :] - tx[:, None, None]
    oy = (torch.arange(h, dtype=torch.float32, device=device) - cy)[None, :, None] - ty[:, None, None]
    return ic * ox + id_ * oy + cy, ia * ox + ib * oy + cx


def _warp(img: torch.Tensor, ys: torch.Tensor, xs: torch.Tensor, fill: float = 0.0) -> torch.Tensor:
    """Sample ``img (N, H, W, C)`` bilinearly at ``ys, xs (N, Ho, Wo)``: a
    point within half a pixel of the frame (``-0.5 <= y <= h - 0.5``, the
    same for x) is edge-clamped, one farther out is ``fill``. One batched
    gather a corner."""
    n, h, w, _ = img.shape
    valid = (ys >= -0.5) & (ys <= h - 0.5) & (xs >= -0.5) & (xs <= w - 0.5)
    y0 = torch.clamp(torch.floor(ys), 0, h - 1)
    x0 = torch.clamp(torch.floor(xs), 0, w - 1)
    wy = torch.clamp(ys - y0, 0.0, 1.0)[..., None]
    wx = torch.clamp(xs - x0, 0.0, 1.0)[..., None]
    y0i, x0i = y0.long(), x0.long()
    y1i, x1i = torch.clamp(y0i + 1, max=h - 1), torch.clamp(x0i + 1, max=w - 1)
    bi = torch.arange(n, device=img.device)[:, None, None]
    top = img[bi, y0i, x0i] * (1 - wx) + img[bi, y0i, x1i] * wx
    bot = img[bi, y1i, x0i] * (1 - wx) + img[bi, y1i, x1i] * wx
    return torch.where(valid[..., None], top * (1 - wy) + bot * wy, fill)


def affine(x: torch.Tensor, *, angle=0.0, translate=(0.0, 0.0), shear=(0.0, 0.0), scale=1.0,
           fill: float = 0.0) -> torch.Tensor:
    """Batched affine warp about the image's centre, torchvision
    ``F.affine``'s conventions: ``angle`` degrees counter-clockwise,
    ``translate = (tx, ty)`` pixels, ``shear = (sx, sy)`` degrees,
    bilinear, ``fill`` outside the frame. Every parameter is a scalar or
    per-image ``(N,)``."""
    ys, xs = _affine_grid(x.shape, x.device, angle=angle, translate=translate, shear=shear, scale=scale)
    return _warp(x, ys, xs, fill)


def rotate(x: torch.Tensor, angle, fill: float = 0.0) -> torch.Tensor:
    return affine(x, angle=angle, fill=fill)


# --------------------------------------------------------------------
# draws
# --------------------------------------------------------------------


def _uniform(generator: torch.Generator, n, lo: float, hi: float, device) -> torch.Tensor:
    """U(lo, hi) in f32, shape ``n`` (an int or a tuple)."""
    return torch.rand(n, generator=generator, device=device) * (hi - lo) + lo


def draw_flip(generator: torch.Generator, n: int, p: float = 0.5, device=None) -> torch.Tensor:
    """(N,) bool: flip each image with probability ``p``."""
    return torch.rand(n, generator=generator, device=device) < p


def _log_gamma(generator: torch.Generator, alpha: float, shape: Tuple[int, ...], device=None) -> torch.Tensor:
    """The logs of Gamma(alpha) draws of ``shape``. Below alpha 1 a draw is
    Gamma(alpha + 1) U^(1 / alpha), taken in logs: the product underflows
    f32 at a small alpha (at 1e-4, almost always to 0)."""
    alpha = float(alpha)
    if alpha >= 1.0:
        return torch.log(torch._standard_gamma(torch.full(shape, alpha, device=device), generator=generator))
    g = torch._standard_gamma(torch.full(shape, alpha + 1.0, device=device), generator=generator)
    return torch.log(g) + torch.log(torch.rand(shape, generator=generator, device=device)) / alpha


def draw_beta(generator: torch.Generator, alpha: float, device=None, shape: Tuple[int, ...] = ()) -> torch.Tensor:
    """Beta(alpha, alpha) samples of ``shape`` (one, 0-d, by default), f32
    on ``device``: G1 / (G1 + G2) of two Gamma(alpha) draws, from their
    logs."""
    lg = _log_gamma(generator, alpha, (2,) + tuple(shape), device)
    return torch.sigmoid(lg[0] - lg[1])


def _draw_dirichlet(generator: torch.Generator, alpha: float, n: int, k: int, device=None) -> torch.Tensor:
    """(n, k) rows of Dirichlet(alpha, ..., alpha): k Gamma(alpha) draws a
    row over their sum, from their logs."""
    return torch.softmax(_log_gamma(generator, alpha, (n, k), device), dim=1)


def _draw_sign(generator: torch.Generator, shape, device=None) -> torch.Tensor:
    """Fair +-1.0 signs (f32) of ``shape``."""
    return torch.where(torch.rand(shape, generator=generator, device=device) < 0.5, 1.0, -1.0)


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
# auto-augmentation policies: a draw, then compute-all and select
# --------------------------------------------------------------------


def _on_device(values, dtype: torch.dtype, device) -> torch.Tensor:
    """A small constant table on ``device`` without a host sync: through
    pinned memory and an asynchronous copy where the device is the card."""
    t = torch.tensor(values, dtype=dtype)
    device = torch.device("cpu" if device is None else device)
    return t if device.type == "cpu" else t.pin_memory().to(device, non_blocking=True)


def _select(x: torch.Tensor, op: torch.Tensor, geometric: dict, others: Dict[int, Callable], fill: float):
    """Each image's candidate by its ``op`` (N,): slot 0 is ``x`` itself,
    slots 1-5 the geometric ops, one warp with each image's own parameters
    (``geometric``: ``affine``'s keywords, per image, zero where the image
    takes no geometric op), and slot ``k`` of ``others`` ``others[k](x)``.
    One candidate is computed and merged at a time."""
    sel = op.reshape(-1, 1, 1, 1)
    out = torch.where((sel >= 1) & (sel <= 5), affine(x, fill=fill, **geometric), x)
    for k, fn in others.items():
        out = torch.where(sel == k, fn(x), out)
    return out


def _geometric(op: torch.Tensor, shear_x, shear_y, translate_x, translate_y, angle) -> dict:
    """``affine``'s per-image keywords for the slots ShearX (1), ShearY (2),
    TranslateX (3), TranslateY (4) and Rotate (5): each image's value of
    its own op, 0 in every other parameter, as the JAX candidate of that
    op passes them."""

    def at(k, v):
        return torch.where(op == k, v, 0.0)

    return dict(shear=(at(1, shear_x), at(2, shear_y)), translate=(at(3, translate_x), at(4, translate_y)),
                angle=at(5, angle))


class RandAugmentDraw(NamedTuple):
    op: torch.Tensor  # (num_ops, N) int64 in [0, 14)
    sign: torch.Tensor  # (num_ops, N) f32, +-1


def draw_rand_augment(generator: torch.Generator, n: int, num_ops: int = 2, device=None) -> RandAugmentDraw:
    """Per slot and image an op index uniform in [0, 14) and a fair sign."""
    op = torch.randint(0, 14, (num_ops, n), generator=generator, device=device)
    return RandAugmentDraw(op, _draw_sign(generator, (num_ops, n), device))


def apply_rand_augment(x: torch.Tensor, draw: RandAugmentDraw, magnitude: int = 9, num_bins: int = 31,
                       fill: float = 0.0) -> torch.Tensor:
    """torchvision's 14-op RandAugment table at ``magnitude`` of
    ``num_bins``, slot after slot: identity, ShearX, ShearY, TranslateX,
    TranslateY, Rotate, Brightness, Color, Contrast, Sharpness, Posterize,
    Solarize, AutoContrast, Equalize."""
    h, w = x.shape[1:3]
    m = magnitude
    lin = lambda hi: float(hi) * m / max(num_bins - 1, 1)  # noqa: E731
    shear_deg = math.degrees(math.atan(lin(0.3)))
    trans_x, trans_y = lin(150.0 / 331.0) * w, lin(150.0 / 331.0) * h
    rot_deg, color_mag = lin(30.0), lin(0.9)
    post_bits = 8 - int(round(4.0 * m / max(num_bins - 1, 1)))
    solar_t = 1.0 - m / max(num_bins - 1, 1)
    for op, sign in zip(draw.op, draw.sign):
        f_pos = 1.0 + sign * color_mag
        geo = _geometric(op, sign * shear_deg, sign * shear_deg, sign * trans_x, sign * trans_y, sign * rot_deg)
        x = _select(x, op, geo, {
            6: lambda t: adjust_brightness(t, f_pos),
            7: lambda t: adjust_saturation(t, f_pos),  # "Color"
            8: lambda t: adjust_contrast(t, f_pos),
            9: lambda t: sharpness(t, f_pos),
            10: lambda t: posterize(t, post_bits),
            11: lambda t: solarize(t, solar_t),
            12: autocontrast,
            13: equalize,
        }, fill)
    return x


def rand_augment(generator: torch.Generator, x: torch.Tensor, num_ops: int = 2, magnitude: int = 9,
                 num_bins: int = 31, fill: float = 0.0) -> torch.Tensor:
    """RandAugment (Cubuk et al. 2020): ``num_ops`` uniformly drawn ops an
    image at a fixed magnitude, signed ops flipped with p 0.5."""
    return apply_rand_augment(x, draw_rand_augment(generator, x.shape[0], num_ops, x.device), magnitude, num_bins,
                              fill)


class TrivialAugmentDraw(NamedTuple):
    op: torch.Tensor  # (N,) int64 in [0, 14)
    sign: torch.Tensor  # (N,) f32, +-1
    bin: torch.Tensor  # (N,) int64 in [0, num_bins)


def draw_trivial_augment_wide(generator: torch.Generator, n: int, num_bins: int = 31,
                              device=None) -> TrivialAugmentDraw:
    op = torch.randint(0, 14, (n,), generator=generator, device=device)
    sign = _draw_sign(generator, n, device)
    return TrivialAugmentDraw(op, sign, torch.randint(0, num_bins, (n,), generator=generator, device=device))


def apply_trivial_augment_wide(x: torch.Tensor, draw: TrivialAugmentDraw, num_bins: int = 31,
                               fill: float = 0.0) -> torch.Tensor:
    """One op an image from RandAugment's table at its own magnitude bin,
    the wide ranges: shear 0.99, translate 32 px, rotate 135 degrees,
    colour 0.99, posterize down to 2 bits."""
    u = _div(draw.bin.float(), max(num_bins - 1, 1))
    s = draw.sign * u
    f_color = 1.0 + s * 0.99
    shear_deg = torch.rad2deg(torch.atan(s * 0.99))
    post_bits = 8 - torch.round(u * 6.0).to(torch.int32)
    geo = _geometric(draw.op, shear_deg, shear_deg, s * 32.0, s * 32.0, s * 135.0)
    return _select(x, draw.op, geo, {
        6: lambda t: adjust_brightness(t, f_color),
        7: lambda t: adjust_saturation(t, f_color),
        8: lambda t: adjust_contrast(t, f_color),
        9: lambda t: sharpness(t, f_color),
        10: lambda t: posterize(t, post_bits),
        11: lambda t: solarize(t, 1.0 - u),
        12: autocontrast,
        13: equalize,
    }, fill)


def trivial_augment_wide(generator: torch.Generator, x: torch.Tensor, num_bins: int = 31,
                         fill: float = 0.0) -> torch.Tensor:
    """TrivialAugmentWide (Mueller & Hutter 2021): one uniformly drawn op an
    image at a uniformly drawn magnitude bin."""
    return apply_trivial_augment_wide(x, draw_trivial_augment_wide(generator, x.shape[0], num_bins, x.device),
                                      num_bins, fill)


class AugMixDraw(NamedTuple):
    m: torch.Tensor  # (N,) f32, the original image's weight, Beta(alpha, alpha)
    weights: torch.Tensor  # (N, width) f32, the chains' Dirichlet(alpha) weights
    depth: torch.Tensor  # (width, N) int64 in {1, 2, 3}
    op: torch.Tensor  # (width, steps, N) int64 in [1, 1 + num_ops)
    sign: torch.Tensor  # (width, steps, N) f32, +-1
    u: torch.Tensor  # (width, steps, N) f32, magnitude bin / 10


_AUGMIX_STEPS = 3  # the most ops a chain of drawn depth takes


def draw_augmix(generator: torch.Generator, n: int, severity: int = 3, mixture_width: int = 3,
                chain_depth: int = -1, alpha: float = 1.0, all_ops: bool = True, device=None) -> AugMixDraw:
    """The mix weights, then per chain a depth in {1, 2, 3} (used where
    ``chain_depth`` <= 0) and per step an op (13 with ``all_ops``, else the
    9 that are no colour op), a fair sign and a magnitude bin uniform in
    [0, severity) of torchvision's 10."""
    steps = chain_depth if chain_depth > 0 else _AUGMIX_STEPS
    num_ops = 13 if all_ops else 9
    m = draw_beta(generator, alpha, device, (n,))
    weights = _draw_dirichlet(generator, alpha, n, mixture_width, device)
    depth = torch.randint(1, 4, (mixture_width, n), generator=generator, device=device)
    shape = (mixture_width, steps, n)
    op = torch.randint(1, 1 + num_ops, shape, generator=generator, device=device)
    sign = _draw_sign(generator, shape, device)
    u = _div(torch.randint(0, severity, shape, generator=generator, device=device).float(), 10.0)
    return AugMixDraw(m, weights, depth, op, sign, u)


def apply_augmix(x: torch.Tensor, draw: AugMixDraw, chain_depth: int = -1, all_ops: bool = True,
                 fill: float = 0.0) -> torch.Tensor:
    """AugMix's chains, each its ops in turn (a step past an image's drawn
    depth is the identity), mixed by the Dirichlet weights, then blended
    with the original by ``m``; torchvision's ops: shear 0.3, translate a
    third of the side, rotate 30 degrees, posterize ``4 - round(4 u)``
    bits, solarize ``1 - u``, autocontrast, equalize and, with
    ``all_ops``, brightness, colour, contrast and sharpness by 0.9. The
    output stays in the inputs' convex hull."""
    h, w = x.shape[1:3]
    mix = draw.m[:, None, None, None] * x
    for i in range(draw.op.shape[0]):
        aug = x
        for s in range(draw.op.shape[1]):
            op, sign, u = draw.op[i, s], draw.sign[i, s], draw.u[i, s]
            if chain_depth <= 0:
                op = torch.where(s < draw.depth[i], op, 0)
            su = sign * u
            shear = torch.rad2deg(torch.atan(su * 0.3))
            geo = _geometric(op, shear, shear, su * (w / 3.0), su * (h / 3.0), su * 30.0)
            others = {
                6: lambda t: posterize(t, 4 - torch.round(u * 4.0).to(torch.int32)),
                7: lambda t: solarize(t, 1.0 - u),
                8: autocontrast,
                9: equalize,
            }
            if all_ops:
                f = 1.0 + su * 0.9
                others.update({
                    10: lambda t: adjust_brightness(t, f),
                    11: lambda t: adjust_saturation(t, f),  # "Color"
                    12: lambda t: adjust_contrast(t, f),
                    13: lambda t: sharpness(t, f),
                })
            aug = _select(aug, op, geo, others, fill)
        mix = mix + ((1.0 - draw.m) * draw.weights[:, i])[:, None, None, None] * aug
    return mix.to(x.dtype)


def augmix(generator: torch.Generator, x: torch.Tensor, severity: int = 3, mixture_width: int = 3,
           chain_depth: int = -1, alpha: float = 1.0, all_ops: bool = True, fill: float = 0.0) -> torch.Tensor:
    """AugMix (Hendrycks et al. 2020), torchvision's semantics."""
    draw = draw_augmix(generator, x.shape[0], severity, mixture_width, chain_depth, alpha, all_ops, x.device)
    return apply_augmix(x, draw, chain_depth, all_ops, fill)


# Op name -> candidate slot of auto_augment's table (slot 0 is the identity:
# a stage that does not fire).
_AA_OPS = {
    "ShearX": 1, "ShearY": 2, "TranslateX": 3, "TranslateY": 4, "Rotate": 5, "Brightness": 6, "Color": 7,
    "Contrast": 8, "Sharpness": 9, "Posterize": 10, "Solarize": 11, "AutoContrast": 12, "Equalize": 13,
    "Invert": 14,
}

# AutoAugment's ImageNet policy (Cubuk et al. 2019, Table 9; torchvision's
# AutoAugmentPolicy.IMAGENET): 25 sub-policies of two (op, probability,
# magnitude bin of 10) stages; None where the op takes no magnitude.
IMAGENET_AUTO_AUGMENT_POLICY: Tuple = (
    (("Posterize", 0.4, 8), ("Rotate", 0.6, 9)),
    (("Solarize", 0.6, 5), ("AutoContrast", 0.6, None)),
    (("Equalize", 0.8, None), ("Equalize", 0.6, None)),
    (("Posterize", 0.6, 7), ("Posterize", 0.6, 6)),
    (("Equalize", 0.4, None), ("Solarize", 0.2, 4)),
    (("Equalize", 0.4, None), ("Rotate", 0.8, 8)),
    (("Solarize", 0.6, 3), ("Equalize", 0.6, None)),
    (("Posterize", 0.8, 5), ("Equalize", 1.0, None)),
    (("Rotate", 0.2, 3), ("Solarize", 0.6, 8)),
    (("Equalize", 0.6, None), ("Posterize", 0.4, 6)),
    (("Rotate", 0.8, 8), ("Color", 0.4, 0)),
    (("Rotate", 0.4, 9), ("Equalize", 0.6, None)),
    (("Equalize", 0.0, None), ("Equalize", 0.8, None)),
    (("Invert", 0.6, None), ("Equalize", 1.0, None)),
    (("Color", 0.6, 4), ("Contrast", 1.0, 8)),
    (("Rotate", 0.8, 8), ("Color", 1.0, 2)),
    (("Color", 0.8, 8), ("Solarize", 0.8, 7)),
    (("Sharpness", 0.4, 7), ("Invert", 0.6, None)),
    (("ShearX", 0.6, 5), ("Equalize", 1.0, None)),
    (("Color", 0.4, 0), ("Equalize", 0.6, None)),
    (("Equalize", 0.4, None), ("Solarize", 0.2, 4)),
    (("Solarize", 0.6, 5), ("AutoContrast", 0.6, None)),
    (("Invert", 0.6, None), ("Equalize", 1.0, None)),
    (("Color", 0.6, 4), ("Contrast", 1.0, 8)),
    (("Equalize", 0.8, None), ("Equalize", 0.6, None)),
)


class AutoAugmentDraw(NamedTuple):
    policy: torch.Tensor  # (N,) int64, each image's sub-policy
    fire: torch.Tensor  # (2, N) bool, whether each stage applies
    sign: torch.Tensor  # (2, N) f32, +-1


def draw_auto_augment(generator: torch.Generator, n: int, policy: Sequence = IMAGENET_AUTO_AUGMENT_POLICY,
                      device=None) -> AutoAugmentDraw:
    """A sub-policy uniform over ``policy`` an image, then per stage
    whether it fires (U(0, 1) below the stage's probability) and a fair
    sign."""
    pol = torch.randint(0, len(policy), (n,), generator=generator, device=device)
    p_tab = _on_device([[st[1] for st in sp] for sp in policy], torch.float32, device)
    fire, sign = [], []
    for s in range(2):
        fire.append(torch.rand(n, generator=generator, device=device) < p_tab[pol, s])
        sign.append(_draw_sign(generator, n, device))
    return AutoAugmentDraw(pol, torch.stack(fire), torch.stack(sign))


def apply_auto_augment(x: torch.Tensor, draw: AutoAugmentDraw, policy: Sequence = IMAGENET_AUTO_AUGMENT_POLICY,
                       fill: float = 0.0) -> torch.Tensor:
    """Each image's two stages in turn, torchvision's AutoAugment magnitudes
    at bin b of 10 (u = b / 9): shear 0.3 u, translate 150/331 u of the
    side, rotate 30 u degrees, colour 0.9 u, posterize ``8 - round(4 u)``
    bits, solarize ``1 - u``; signed ops take the drawn sign. ``policy``
    is any table of ``((op, p, bin), (op, p, bin))`` sub-policies."""
    h, w = x.shape[1:3]
    op_tab = _on_device([[_AA_OPS[st[0]] for st in sp] for sp in policy], torch.int64, x.device)
    u_tab = _on_device([[(st[2] or 0) / 9.0 for st in sp] for sp in policy], torch.float32, x.device)
    for s in range(2):
        op = torch.where(draw.fire[s], op_tab[draw.policy, s], 0)
        u = u_tab[draw.policy, s]
        su = torch.where(draw.sign[s] > 0, u, -u)
        f_color = 1.0 + su * 0.9
        shear_deg = torch.rad2deg(torch.atan(su * 0.3))
        geo = _geometric(op, shear_deg, shear_deg, su * (150.0 / 331.0) * w, su * (150.0 / 331.0) * h, su * 30.0)
        x = _select(x, op, geo, {
            6: lambda t: adjust_brightness(t, f_color),
            7: lambda t: adjust_saturation(t, f_color),  # "Color"
            8: lambda t: adjust_contrast(t, f_color),
            9: lambda t: sharpness(t, f_color),
            10: lambda t: posterize(t, 8 - torch.round(u * 4.0).to(torch.int32)),
            11: lambda t: solarize(t, 1.0 - u),
            12: autocontrast,
            13: equalize,
            14: invert,
        }, fill)
    return x


def auto_augment(generator: torch.Generator, x: torch.Tensor, policy: Sequence = IMAGENET_AUTO_AUGMENT_POLICY,
                 fill: float = 0.0) -> torch.Tensor:
    """AutoAugment (Cubuk et al. 2019), torchvision's semantics: a
    uniformly drawn sub-policy an image, each of its stages firing with
    its probability. Only the ImageNet policy is built in; pass another
    table (torchvision's CIFAR10 or SVHN, a learned one) as ``policy``."""
    return apply_auto_augment(x, draw_auto_augment(generator, x.shape[0], policy, x.device), policy, fill)


# The policies of ``imagenet_train_pipeline(auto_augment_policy=...)`` and
# the training CLI's ``--aa``, each a draw and its application.
AUTO_AUGMENT_POLICIES = {
    "autoaugment": (lambda g, n, dev: draw_auto_augment(g, n, device=dev), apply_auto_augment),
    "randaugment": (lambda g, n, dev: draw_rand_augment(g, n, device=dev), apply_rand_augment),
    "trivialaugmentwide": (lambda g, n, dev: draw_trivial_augment_wide(g, n, device=dev), apply_trivial_augment_wide),
    "augmix": (lambda g, n, dev: draw_augmix(g, n, device=dev), apply_augmix),
}


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
    then either ``jitter=(b, c, s, h)`` or ``auto_augment_policy`` (one of
    ``AUTO_AUGMENT_POLICIES``: "autoaugment", "randaugment",
    "trivialaugmentwide", "augmix", each at its defaults), normalisation.
    Draws in that order from ``generator``."""
    if jitter is not None and auto_augment_policy is not None:
        raise ValueError("pass either jitter= or auto_augment_policy=, not both")
    if auto_augment_policy is not None and auto_augment_policy not in AUTO_AUGMENT_POLICIES:
        raise ValueError(f"auto_augment_policy={auto_augment_policy!r}: not one of {sorted(AUTO_AUGMENT_POLICIES)}")
    x = random_resized_crop(generator, images_uint8, size, scale=scale) / 255.0
    if hflip:
        x = random_hflip(generator, x, hflip)
    if jitter is not None:
        x = color_jitter(generator, x, *jitter)
    elif auto_augment_policy is not None:
        draw_fn, apply_fn = AUTO_AUGMENT_POLICIES[auto_augment_policy]
        x = apply_fn(x, draw_fn(generator, x.shape[0], x.device))
    return normalize(x, mean, std, scale=1.0).to(dtype)
