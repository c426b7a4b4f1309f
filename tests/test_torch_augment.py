"""The port's preprocessing and training augmentations against the JAX package.

Every deterministic function gets the same numpy-seeded inputs on both
sides. Every random op is held to the JAX op through its application: the
JAX op's own draws (taken from its key exactly as the JAX op splits it)
go into the port's ``apply_<op>``, and the two outputs must agree in f32.
The port's draws come from a ``torch.Generator`` and cannot equal
``jax.random``'s (ROADMAP C.16), so they are held to their distributions
(ranges, flip rate, Beta's mean) and to the seed (same generator state,
same batch). Tolerances: pixel values in [0, 255] at atol 1e-3 (f32
sampling weights on values up to 255: about 30 f32 steps), [0, 1] images
and labels at atol 1e-5 (a few f32 steps of the blend and HSV arithmetic).
"""
import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eqxvision_tpu.ops import augment as JA
from eqxvision_tpu.ops import preprocessing as JP
from eqxvision_tpu_torch.ops import augment as A
from eqxvision_tpu_torch.ops import preprocessing as P

PIXEL_ATOL = 1e-3
UNIT_ATOL = 1e-5


def _images(seed, n=4, h=20, w=24, u8=False):
    rng = np.random.RandomState(seed)
    if u8:
        return rng.randint(0, 256, (n, h, w, 3)).astype(np.uint8)
    return rng.uniform(0.0, 1.0, (n, h, w, 3)).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.asarray(a).copy())


def _soft(seed, n=4, c=5):
    labels = np.random.RandomState(seed).randint(0, c, n)
    return labels, np.asarray(JA.smooth_labels(jnp.asarray(labels), c, 0.1))


# --------------------------------------------------------------------
# preprocessing
# --------------------------------------------------------------------


@pytest.mark.parametrize("shape, size", [((2, 20, 28, 3), 40), ((2, 28, 20, 3), 12), ((2, 33, 33, 3), 16)])
def test_resize_shorter_side_matches_jax(shape, size):
    """Up by 2, down (antialiased), and a square down by about 2."""
    x = np.random.RandomState(0).uniform(0, 255, shape).astype(np.float32)
    want = np.asarray(JP.resize_shorter_side(jnp.asarray(x), size))
    got = P.resize_shorter_side(_t(x), size).numpy()
    assert got.shape == want.shape and got.dtype == np.float32
    np.testing.assert_allclose(got, want, atol=PIXEL_ATOL)


@pytest.mark.parametrize("fn", ["center_crop", "five_crop", "ten_crop", "ten_crop_vertical"])
def test_crops_match_jax(fn):
    x = _images(1, h=21, w=26)
    if fn == "ten_crop_vertical":
        want = JP.ten_crop(jnp.asarray(x), 12, 10, vertical_flip=True)
        got = P.ten_crop(_t(x), 12, 10, vertical_flip=True)
    else:
        want = getattr(JP, fn)(jnp.asarray(x), 12, 10)
        got = getattr(P, fn)(_t(x), 12, 10)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_five_crop_refuses_a_crop_larger_than_the_image():
    with pytest.raises(ValueError, match="larger than image"):
        P.five_crop(torch.zeros(1, 8, 8, 3), 9)


@pytest.mark.parametrize("scale", [1.0 / 255.0, 1.0])
def test_normalize_matches_jax(scale):
    x = _images(2, u8=True).astype(np.float32) * (1.0 if scale != 1.0 else 1.0 / 255.0)
    want = JP.normalize(jnp.asarray(x), scale=scale)
    np.testing.assert_allclose(P.normalize(_t(x), scale=scale).numpy(), np.asarray(want), atol=UNIT_ATOL)


def test_imagenet_eval_pipeline_matches_jax():
    """uint8 canvases, resized down (antialiased) and centre-cropped."""
    x = _images(3, n=2, h=40, w=48, u8=True)
    want = JP.imagenet_eval_pipeline(jnp.asarray(x), resize_size=32, crop_size=28)
    got = P.imagenet_eval_pipeline(_t(x), resize_size=32, crop_size=28)
    assert got.shape == (2, 28, 28, 3) and got.dtype == torch.float32
    # normalised values: the pixel bound over 255 * std (0.225 at least)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=PIXEL_ATOL / (255 * 0.224))
    bf16 = P.imagenet_eval_pipeline(_t(x), resize_size=32, crop_size=28, dtype=torch.bfloat16)
    assert bf16.dtype == torch.bfloat16


# --------------------------------------------------------------------
# deterministic colour ops
# --------------------------------------------------------------------

COLOR_OPS = {
    "brightness": (JA.adjust_brightness, A.adjust_brightness, (0.3, 1.7)),
    "contrast": (JA.adjust_contrast, A.adjust_contrast, (0.3, 1.7)),
    "saturation": (JA.adjust_saturation, A.adjust_saturation, (0.0, 1.7)),
    "hue": (JA.adjust_hue, A.adjust_hue, (-0.5, 0.5)),
}


@pytest.mark.parametrize("per_image", [False, True])
@pytest.mark.parametrize("op", list(COLOR_OPS))
def test_color_ops_match_jax(op, per_image):
    jax_fn, port_fn, (lo, hi) = COLOR_OPS[op]
    x = _images(4)
    x[0, :2] = 0.5  # grey pixels: hue and saturation 0
    factor = np.random.RandomState(5).uniform(lo, hi, 4).astype(np.float32) if per_image else np.float32(0.8 * hi)
    want = np.asarray(jax_fn(jnp.asarray(x), jnp.asarray(factor)))
    got = port_fn(_t(x), _t(factor) if per_image else float(factor)).numpy()
    np.testing.assert_allclose(got, want, atol=UNIT_ATOL)


def test_hsv_round_trip_matches_jax():
    x = _images(6)
    h, s, v = (np.asarray(t) for t in JA._rgb_to_hsv(jnp.asarray(x)))
    ph, ps, pv = (t.numpy() for t in A._rgb_to_hsv(_t(x)))
    for got, want in ((ph, h), (ps, s), (pv, v)):
        np.testing.assert_allclose(got, want, atol=UNIT_ATOL)
    np.testing.assert_allclose(A._hsv_to_rgb(_t(h), _t(s), _t(v)).numpy(), x, atol=UNIT_ATOL)


def test_smooth_labels_matches_jax():
    labels = np.array([0, 3, 4, 1])
    want = JA.smooth_labels(jnp.asarray(labels), 5, 0.1)
    got = A.smooth_labels(_t(labels), 5, 0.1)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-7)


# --------------------------------------------------------------------
# random ops given the JAX draws
# --------------------------------------------------------------------


def _jax_boxes(key, n, h, w, scale, ratio, n_split=4):
    """The box draws of the JAX ``random_resized_crop`` (keys 0-3 of its
    split) or ``random_erasing`` (keys 1-4), as the port's CropBoxes."""
    keys = jax.random.split(key, n_split)[n_split - 4:]
    area = jax.random.uniform(keys[0], (n,), minval=scale[0], maxval=scale[1]) * (h * w)
    r = jnp.exp(jax.random.uniform(keys[1], (n,), minval=jnp.log(ratio[0]), maxval=jnp.log(ratio[1])))
    bw = jnp.clip(jnp.sqrt(area * r), 1.0, w)
    bh = jnp.clip(jnp.sqrt(area / r), 1.0, h)
    top = jax.random.uniform(keys[2], (n,)) * (h - bh)
    left = jax.random.uniform(keys[3], (n,)) * (w - bw)
    return A.CropBoxes(*(_t(a) for a in (top, left, bh, bw)))


@pytest.mark.parametrize("scale", [(0.08, 1.0), (0.5, 1.0)])
@pytest.mark.parametrize("u8", [True, False])
def test_resized_crop_given_jax_boxes(u8, scale):
    """The same boxes sampled the same way: bilinear, edge-clamped, pixel
    centres, a 16 px output from a 20 x 24 frame."""
    x = _images(7, u8=u8)
    key = jax.random.PRNGKey(11)
    want = np.asarray(JA.random_resized_crop(key, jnp.asarray(x), 16, scale=scale))
    boxes = _jax_boxes(key, 4, 20, 24, scale, (3.0 / 4.0, 4.0 / 3.0))
    got = A.apply_resized_crop(_t(x), boxes, 16).numpy()
    assert got.shape == (4, 16, 16, 3) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, atol=PIXEL_ATOL if u8 else UNIT_ATOL)


@pytest.mark.parametrize("axis", ["h", "v"])
def test_flips_given_jax_draws(axis):
    x = _images(8, n=8)
    key = jax.random.PRNGKey(3)
    jax_fn, apply = (JA.random_hflip, A.apply_hflip) if axis == "h" else (JA.random_vflip, A.apply_vflip)
    want = np.asarray(jax_fn(key, jnp.asarray(x), 0.5))
    flip = np.asarray(jax.random.bernoulli(key, 0.5, (8,)))
    assert 0 < flip.sum() < 8  # both branches
    np.testing.assert_array_equal(apply(_t(x), _t(flip)).numpy(), want)


def test_color_jitter_given_jax_draws():
    x = _images(9)
    key = jax.random.PRNGKey(5)
    b, c, s, h = 0.4, 0.3, 0.5, 0.1
    want = np.asarray(JA.color_jitter(key, jnp.asarray(x), b, c, s, h))
    kb, kc, ks, kh = jax.random.split(key, 4)
    draw = A.JitterDraw(*(
        _t(jax.random.uniform(k, (4,), minval=lo, maxval=hi))
        for k, (lo, hi) in ((kb, (1 - b, 1 + b)), (kc, (1 - c, 1 + c)), (ks, (1 - s, 1 + s)), (kh, (-h, h)))
    ))
    np.testing.assert_allclose(A.apply_color_jitter(_t(x), draw).numpy(), want, atol=UNIT_ATOL)


def test_random_erasing_given_jax_draws():
    x = _images(10, n=8)
    key = jax.random.PRNGKey(6)
    want = np.asarray(JA.random_erasing(key, jnp.asarray(x), p=0.5, value=0.25))
    apply = np.asarray(jax.random.bernoulli(jax.random.split(key, 5)[0], 0.5, (8,)))
    assert 0 < apply.sum() < 8
    draw = A.ErasingDraw(_t(apply), _jax_boxes(key, 8, 20, 24, (0.02, 0.33), (0.3, 3.3), n_split=5))
    np.testing.assert_array_equal(A.apply_erasing(_t(x), draw, value=0.25).numpy(), want)


def test_mixup_given_jax_draws():
    x = _images(11)
    _, y = _soft(12)
    key = jax.random.PRNGKey(7)
    want_x, want_y = JA.mixup(key, jnp.asarray(x), jnp.asarray(y), alpha=0.4)
    k_lam, k_perm = jax.random.split(key)
    draw = A.MixDraw(_t(jax.random.beta(k_lam, 0.4, 0.4)), _t(jax.random.permutation(k_perm, 4)))
    got_x, got_y = A.apply_mixup(_t(x), _t(y), draw)
    np.testing.assert_allclose(got_x.numpy(), np.asarray(want_x), atol=UNIT_ATOL)
    np.testing.assert_allclose(got_y.numpy(), np.asarray(want_y), atol=UNIT_ATOL)


@pytest.mark.parametrize("seed", [8, 9, 10])
def test_cutmix_given_jax_draws(seed):
    """The same box and permutation: the same pasted pixels, and the label
    mass of the rasterised box."""
    x = _images(13)
    _, y = _soft(14)
    key = jax.random.PRNGKey(seed)
    want_x, want_y = JA.cutmix(key, jnp.asarray(x), jnp.asarray(y), alpha=1.0)
    k_lam, k_perm, k_cy, k_cx = jax.random.split(key, 4)
    center = np.array([jax.random.uniform(k_cy), jax.random.uniform(k_cx)], np.float32)
    draw = A.CutMixDraw(_t(jax.random.beta(k_lam, 1.0, 1.0)), _t(jax.random.permutation(k_perm, 4)), _t(center))
    got_x, got_y = A.apply_cutmix(_t(x), _t(y), draw)
    np.testing.assert_array_equal(got_x.numpy(), np.asarray(want_x))
    np.testing.assert_allclose(got_y.numpy(), np.asarray(want_y), atol=UNIT_ATOL)


def test_train_pipeline_given_jax_draws():
    """The JAX pipeline's crop, flip and jitter draws through the port's
    applications and normalisation, from uint8 canvases."""
    x = _images(15, u8=True)
    key = jax.random.PRNGKey(21)
    jitter = (0.4, 0.4, 0.4, 0.1)
    want = np.asarray(JA.imagenet_train_pipeline(key, jnp.asarray(x), size=16, jitter=jitter))
    k_crop, k_flip, k_jit = jax.random.split(key, 3)
    boxes = _jax_boxes(k_crop, 4, 20, 24, (0.08, 1.0), (3.0 / 4.0, 4.0 / 3.0))
    flip = _t(jax.random.bernoulli(k_flip, 0.5, (4,)))
    keys = jax.random.split(k_jit, 4)
    draw = A.JitterDraw(*(_t(jax.random.uniform(k, (4,), minval=lo, maxval=hi)) for k, (lo, hi) in
                          zip(keys, ((0.6, 1.4), (0.6, 1.4), (0.6, 1.4), (-0.1, 0.1)))))
    got = A.apply_resized_crop(_t(x), boxes, 16) / 255.0
    got = P.normalize(A.apply_color_jitter(A.apply_hflip(got, flip), draw), scale=1.0)
    np.testing.assert_allclose(got.numpy(), want, atol=UNIT_ATOL / 0.224)


# --------------------------------------------------------------------
# the port's own draws
# --------------------------------------------------------------------


def test_train_pipeline_is_its_draws_in_order():
    """``imagenet_train_pipeline`` is draw_resized_crop, draw_flip and
    draw_color_jitter in that order from one generator, then the
    applications; the same generator state gives the same batch."""
    x = _t(_images(16, u8=True))
    jitter = (0.2, 0.3, 0.4, 0.05)
    out = A.imagenet_train_pipeline(torch.Generator().manual_seed(4), x, size=16, jitter=jitter)
    again = A.imagenet_train_pipeline(torch.Generator().manual_seed(4), x, size=16, jitter=jitter)
    other = A.imagenet_train_pipeline(torch.Generator().manual_seed(5), x, size=16, jitter=jitter)
    g = torch.Generator().manual_seed(4)
    boxes = A.draw_resized_crop(g, 4, 20, 24)
    flip = A.draw_flip(g, 4, 0.5, None)
    draw = A.draw_color_jitter(g, 4, *jitter)
    want = A.apply_color_jitter(A.apply_hflip(A.apply_resized_crop(x, boxes, 16) / 255.0, flip), draw)
    torch.testing.assert_close(out, P.normalize(want, scale=1.0), rtol=0, atol=0)
    torch.testing.assert_close(again, out, rtol=0, atol=0)
    assert not torch.equal(other, out)


def test_draws_stay_in_their_ranges():
    g = torch.Generator().manual_seed(0)
    n, h, w = 4000, 30, 50
    boxes = A.draw_resized_crop(g, n, h, w, scale=(0.08, 1.0))
    assert bool((boxes.height >= 1).all() and (boxes.height <= h).all())
    assert bool((boxes.width >= 1).all() and (boxes.width <= w).all())
    assert bool((boxes.top >= 0).all() and (boxes.top + boxes.height <= h + 1e-4).all())
    assert bool((boxes.left >= 0).all() and (boxes.left + boxes.width <= w + 1e-4).all())
    ratio = boxes.width / boxes.height
    unclamped = (boxes.width < w) & (boxes.height < h) & (boxes.width > 1) & (boxes.height > 1)
    assert bool((ratio[unclamped] >= 0.75 - 1e-5).all() and (ratio[unclamped] <= 4 / 3 + 1e-5).all())
    flips = A.draw_flip(g, n, 0.3, None)
    assert abs(flips.float().mean().item() - 0.3) < 4 * math.sqrt(0.3 * 0.7 / n)
    jit = A.draw_color_jitter(g, n, 0.4, 0.0, 0.5, 0.1)
    assert jit.contrast is None
    assert bool((jit.brightness >= 0.6).all() and (jit.brightness <= 1.4).all())
    assert bool((jit.saturation >= 0.5).all() and (jit.saturation <= 1.5).all())
    assert bool((jit.hue.abs() <= 0.1).all())


@pytest.mark.parametrize("alpha", [0.2, 1.0])
def test_beta_draws_follow_their_distribution(alpha):
    """Beta(alpha, alpha) from the generator: in [0, 1], mean 1/2, variance
    1 / (4 (2 alpha + 1)); mixup's lambda and permutation from the seed."""
    g = torch.Generator().manual_seed(1)
    lam = torch.stack([A.draw_beta(g, alpha, None) for _ in range(2000)])
    assert bool(((lam >= 0) & (lam <= 1)).all())
    var = 1.0 / (4 * (2 * alpha + 1))
    assert abs(lam.mean().item() - 0.5) < 4 * math.sqrt(var / 2000)
    assert abs(lam.var().item() - var) < 0.2 * var
    d1 = A.draw_mixup(torch.Generator().manual_seed(3), 8, alpha)
    d2 = A.draw_mixup(torch.Generator().manual_seed(3), 8, alpha)
    assert torch.equal(d1.lam, d2.lam) and torch.equal(d1.perm, d2.perm)
    assert sorted(d1.perm.tolist()) == list(range(8))


@pytest.mark.parametrize("op", ["mixup", "cutmix"])
def test_batch_mixing_keeps_label_mass(op):
    """Each row of the mixed labels sums to 1; cutmix moves the label mass
    of the pixels it pastes: images coded by their index show the box."""
    x = torch.arange(8, dtype=torch.float32).reshape(8, 1, 1, 1).expand(8, 20, 24, 3).contiguous()
    _, y = _soft(18, n=8)
    draw = getattr(A, f"draw_{op}")(torch.Generator().manual_seed(2), 8, 1.0)
    xm, ym = getattr(A, op)(torch.Generator().manual_seed(2), x, _t(y), 1.0)
    torch.testing.assert_close(ym.sum(-1), torch.ones(8), rtol=0, atol=1e-6)
    if op == "mixup":
        lam = draw.lam
        torch.testing.assert_close(xm[:, 0, 0, 0], lam * x[:, 0, 0, 0] + (1 - lam) * draw.perm.float())
    else:
        pasted = xm[..., 0] == draw.perm.float()[:, None, None]
        moved = pasted[(draw.perm != torch.arange(8)).nonzero()[0, 0]].float().mean()
        assert 0 < moved < 1
        torch.testing.assert_close(ym, (1 - moved) * _t(y) + moved * _t(y)[draw.perm])


def test_auto_augment_policy_raises():
    with pytest.raises(NotImplementedError, match="A.12b"):
        A.imagenet_train_pipeline(torch.Generator(), torch.zeros(1, 8, 8, 3, dtype=torch.uint8), size=4,
                                  auto_augment_policy="randaugment")


def test_ops_export_the_pipelines():
    from eqxvision_tpu_torch import ops

    assert ops.imagenet_train_pipeline is A.imagenet_train_pipeline
    assert ops.imagenet_eval_pipeline is P.imagenet_eval_pipeline
    assert functools.partial(ops.ten_crop, crop_h=4)(torch.zeros(1, 8, 8, 3)).shape == (10, 1, 4, 4, 3)
