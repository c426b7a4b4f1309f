"""The port's AutoAugment family against the JAX package.

The point ops and the affine warps get the same numpy-seeded images and
parameters on both sides: ``invert``, ``solarize``, ``posterize`` and
``equalize`` must be equal (integer arithmetic, or one exact f32 step), the
rest within UNIT_ATOL. Each policy is held to the JAX policy through its
application: the JAX function's own draws, rebuilt from its key as the JAX
code splits it, go into the port's ``apply_<policy>``. The port's draws
come from a ``torch.Generator`` (ROADMAP C.16), so they are held to their
ranges and statistics and to the seed.

``affine`` near the frame's edge: torch's and XLA's cos, sin and tan may
differ by an ulp, so a source point on ``-0.5`` or ``h - 0.5`` can be
valid on one side and filled on the other. The affine tests count the
pixels whose validity differs, from the JAX coordinates, bound their share
by EDGE_SHARE and hold every other pixel at UNIT_ATOL.
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eqxvision_tpu.ops import augment as JA
from eqxvision_tpu_torch.ops import augment as A
from eqxvision_tpu_torch.ops import preprocessing as P

UNIT_ATOL = 1e-5
EDGE_SHARE = 1e-3


def _images(seed, n=8, h=16, w=16):
    x = np.random.RandomState(seed).uniform(0.0, 1.0, (n, h, w, 3)).astype(np.float32)
    x[0, :, :, 1] = 0.25  # a constant channel: autocontrast and equalize leave it
    x[1] = np.round(x[1] * 255.0) / 255.0  # exact 8-bit levels
    return x


def _t(a):
    return torch.from_numpy(np.asarray(a).copy())


def _both(fn_jax, fn_port, x, *args):
    """``fn`` on the JAX and the port side; numpy array arguments go to
    each side as its own array, everything else as it is."""
    ja = [jnp.asarray(a) if isinstance(a, np.ndarray) else a for a in args]
    pa = [_t(a) if isinstance(a, np.ndarray) else a for a in args]
    return np.asarray(fn_jax(jnp.asarray(x), *ja)), fn_port(_t(x), *pa).numpy()


# --------------------------------------------------------------------
# point ops
# --------------------------------------------------------------------

PER_IMAGE = {
    "threshold": np.array([0.0, 0.3, 0.5, 0.77, 1.0, 1.5, 0.1, 0.9], np.float32),
    "bits": np.array([0, 1, 4, 7, 8, 3, 2, 6], np.int32),
    "factor": np.array([0.0, 0.4, 1.0, 1.6, 2.0, 0.9, 0.1, 1.3], np.float32),
}
EXACT_OPS = {
    "invert": (JA.invert, A.invert, ()),
    "solarize scalar": (JA.solarize, A.solarize, (0.6,)),
    "solarize per image": (JA.solarize, A.solarize, (PER_IMAGE["threshold"],)),
    "posterize scalar": (JA.posterize, A.posterize, (3,)),
    "posterize 8 bits": (JA.posterize, A.posterize, (8,)),
    "posterize 0 bits": (JA.posterize, A.posterize, (0,)),
    "posterize per image": (JA.posterize, A.posterize, (PER_IMAGE["bits"],)),
    "equalize": (JA.equalize, A.equalize, ()),
}
CLOSE_OPS = {
    "autocontrast": (JA.autocontrast, A.autocontrast, ()),
    "sharpness scalar": (JA.sharpness, A.sharpness, (1.7,)),
    "sharpness per image": (JA.sharpness, A.sharpness, (PER_IMAGE["factor"],)),
}


@pytest.mark.parametrize("name", list(EXACT_OPS))
def test_exact_point_ops_match_jax(name):
    fn_jax, fn_port, args = EXACT_OPS[name]
    want, got = _both(fn_jax, fn_port, _images(1), *args)
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("name", list(CLOSE_OPS))
def test_point_ops_match_jax(name):
    fn_jax, fn_port, args = CLOSE_OPS[name]
    want, got = _both(fn_jax, fn_port, _images(2), *args)
    np.testing.assert_allclose(got, want, rtol=0, atol=UNIT_ATOL)


@pytest.mark.parametrize("shape", [(3, 2, 5, 3), (2, 1, 1, 3), (2, 16, 16, 3)])
def test_equalize_and_sharpness_small_frames(shape):
    """Frames with no interior (sharpness leaves the border) and a one-pixel
    frame (equalize's step 0), and a spread of flat histograms."""
    x = np.random.RandomState(3).randint(0, 4, shape).astype(np.float32) / 3.0
    for fn_jax, fn_port, args in ((JA.equalize, A.equalize, ()), (JA.sharpness, A.sharpness, (0.3,))):
        want, got = _both(fn_jax, fn_port, x, *args)
        np.testing.assert_allclose(got, want, rtol=0, atol=UNIT_ATOL if args else 0)


def test_point_op_identities():
    """A double invert gives x back; solarize at 0 inverts every pixel and
    above 1 none; posterize at 8 bits is the 8-bit quantisation; the
    sharpness factor 1 is the identity."""
    x = _t(_images(4))
    torch.testing.assert_close(A.invert(A.invert(x)), x, rtol=0, atol=1e-6)
    assert torch.equal(A.solarize(x, 0.0), 1.0 - x) and torch.equal(A.solarize(x, 1.01), x)
    assert torch.equal(A.posterize(x, 8), torch.floor(x * 255.0) / 255.0)
    torch.testing.assert_close(A.sharpness(x, 1.0), x, rtol=0, atol=1e-7)


# --------------------------------------------------------------------
# affine warps
# --------------------------------------------------------------------


def _jax_coords(shape, angle, translate, shear, scale):
    """The source coordinates the JAX ``affine`` samples, computed by its
    own formula (``eqxvision_tpu/ops/augment.py`` ``affine``)."""
    n, h, w = shape[:3]
    b = lambda v: jnp.broadcast_to(jnp.asarray(v, jnp.float32), (n,))  # noqa: E731
    ang, sx, sy = -jnp.deg2rad(b(angle)), jnp.deg2rad(b(shear[0])), jnp.deg2rad(b(shear[1]))
    tx, ty, sc = b(translate[0]), b(translate[1]), b(scale)
    a = sc * jnp.cos(ang + sy) / jnp.cos(sy)
    bb = -sc * (jnp.cos(ang + sy) * jnp.tan(sx) / jnp.cos(sy) + jnp.sin(ang))
    c = sc * jnp.sin(ang + sy) / jnp.cos(sy)
    d = -sc * (jnp.sin(ang + sy) * jnp.tan(sx) / jnp.cos(sy) - jnp.cos(ang))
    det = a * d - bb * c
    ia, ib, ic, id_ = (v[:, None, None] for v in (d / det, -bb / det, -c / det, a / det))
    cx, cy = (w - 1) / 2.0, (h - 1) / 2.0
    gy = jnp.broadcast_to((jnp.arange(h, dtype=jnp.float32) - cy)[:, None], (h, w))[None]
    gx = jnp.broadcast_to((jnp.arange(w, dtype=jnp.float32) - cx)[None, :], (h, w))[None]
    ox, oy = gx - tx[:, None, None], gy - ty[:, None, None]
    ys, xs = ic * ox + id_ * oy + cy, ia * ox + ib * oy + cx
    return np.asarray(ys), np.asarray(xs)


def _valid(ys, xs, h, w):
    return (ys >= -0.5) & (ys <= h - 0.5) & (xs >= -0.5) & (xs <= w - 0.5)


ANGLES = np.array([-30.0, 0.0, 12.5, 90.0, 180.0, -135.0, 45.0, 270.0], np.float32)
AFFINE_CASES = {
    "rotate per image": dict(angle=ANGLES),
    "shear x": dict(shear=(ANGLES / 4, 0.0)),
    "shear y": dict(shear=(0.0, ANGLES / 4)),
    "translate": dict(translate=(ANGLES / 10, -3.0)),
    "all, scaled": dict(angle=ANGLES, translate=(1.5, ANGLES / 20), shear=(5.0, -7.0), scale=1.25),
}


@pytest.mark.parametrize("name", list(AFFINE_CASES))
def test_affine_matches_jax_off_the_edge(name):
    """Every pixel whose validity the two sides agree on within UNIT_ATOL;
    the share whose validity differs (from the JAX coordinates) at most
    EDGE_SHARE; the fill outside."""
    kw = AFFINE_CASES[name]
    full = dict(dict(angle=0.0, translate=(0.0, 0.0), shear=(0.0, 0.0), scale=1.0), **kw)
    x = _images(5)
    n, h, w, _ = x.shape

    def side(conv):
        return {k: tuple(conv(u) for u in v) if isinstance(v, tuple) else conv(v) for k, v in kw.items()}

    jnp_or = lambda v: jnp.asarray(v) if isinstance(v, np.ndarray) else v  # noqa: E731
    torch_or = lambda v: _t(v) if isinstance(v, np.ndarray) else v  # noqa: E731
    want = np.asarray(JA.affine(jnp.asarray(x), fill=0.5, **side(jnp_or)))
    got = A.affine(_t(x), fill=0.5, **side(torch_or)).numpy()
    ys_j, xs_j = _jax_coords(x.shape, **full)
    ys_p, xs_p = (t.numpy() for t in A._affine_grid(x.shape, "cpu", **side(torch_or)))
    np.testing.assert_allclose(ys_p, ys_j, rtol=0, atol=1e-4)
    np.testing.assert_allclose(xs_p, xs_j, rtol=0, atol=1e-4)
    flips = _valid(ys_j, xs_j, h, w) != _valid(ys_p, xs_p, h, w)
    print(f"{name}: validity differs at {flips.sum()} of {flips.size} pixels")
    assert flips.mean() <= EDGE_SHARE
    np.testing.assert_allclose(got[~flips], want[~flips], rtol=0, atol=UNIT_ATOL)
    outside = ~_valid(ys_p, xs_p, h, w)
    assert np.all(got[outside] == 0.5)


def test_rotate_and_integer_translation():
    """``rotate`` is ``affine(angle=)``; 180 degrees about the centre
    reverses both axes; a whole-pixel translation moves the image."""
    x = _t(_images(6, n=2))
    assert torch.equal(A.rotate(x, 17.0, fill=0.2), A.affine(x, angle=17.0, fill=0.2))
    torch.testing.assert_close(A.rotate(x, 180.0), x.flip(1).flip(2), rtol=0, atol=1e-5)
    moved = A.affine(x, translate=(2.0, 0.0))
    assert torch.equal(moved[:, :, 2:], x[:, :, :-2]) and torch.equal(moved[:, :, :2], torch.zeros_like(x[:, :, :2]))


# --------------------------------------------------------------------
# the policies, given the JAX draws
# --------------------------------------------------------------------


def _sign(key, n):
    return jnp.where(jax.random.bernoulli(key, 0.5, (n,)), 1.0, -1.0)


def _long(a):
    return _t(np.asarray(a)).long()


def jax_rand_augment_draw(key, n, num_ops=2):
    ops, signs = [], []
    for k in jax.random.split(key, num_ops):
        k_op, k_sign = jax.random.split(k)
        ops.append(jax.random.randint(k_op, (n,), 0, 14))
        signs.append(_sign(k_sign, n))
    return A.RandAugmentDraw(_long(np.stack(ops)), _t(np.stack(signs)))


def jax_trivial_augment_draw(key, n, num_bins=31):
    k_op, k_sign, k_mag = jax.random.split(key, 3)
    return A.TrivialAugmentDraw(_long(jax.random.randint(k_op, (n,), 0, 14)), _t(_sign(k_sign, n)),
                                _long(jax.random.randint(k_mag, (n,), 0, num_bins)))


def jax_augmix_draw(key, n, severity=3, mixture_width=3, chain_depth=-1, alpha=1.0, all_ops=True):
    k_m, k_w, key = jax.random.split(key, 3)
    m = jax.random.beta(k_m, alpha, alpha, (n,))
    weights = jax.random.dirichlet(k_w, jnp.full((mixture_width,), jnp.float32(alpha)), (n,))
    steps = chain_depth if chain_depth > 0 else 3
    depth, ops, signs, us = [], [], [], []
    for i in range(mixture_width):
        k_d, ki = jax.random.split(jax.random.fold_in(key, i))
        depth.append(jax.random.randint(k_d, (n,), 1, 4))
        for s in range(steps):
            k_op, k_sign, k_mag = jax.random.split(jax.random.fold_in(ki, s), 3)
            ops.append(jax.random.randint(k_op, (n,), 1, 1 + (13 if all_ops else 9)))
            signs.append(_sign(k_sign, n))
            us.append(jax.random.randint(k_mag, (n,), 0, severity).astype(jnp.float32) / 10.0)
    shape = (mixture_width, steps, n)
    return A.AugMixDraw(_t(m), _t(weights), _long(np.stack(depth)), _long(np.reshape(ops, shape)),
                        _t(np.reshape(signs, shape)), _t(np.reshape(us, shape)))


def jax_auto_augment_draw(key, n, policy=JA.IMAGENET_AUTO_AUGMENT_POLICY):
    p_tab = jnp.array([[st[1] for st in sp] for sp in policy], jnp.float32)
    k_pol, key = jax.random.split(key)
    pol = jax.random.randint(k_pol, (n,), 0, len(policy))
    fire, signs = [], []
    for s in range(2):
        k_fire, k_sign = jax.random.split(jax.random.fold_in(key, s))
        fire.append(jax.random.uniform(k_fire, (n,)) < p_tab[pol, s])
        signs.append(_sign(k_sign, n))
    return A.AutoAugmentDraw(_long(pol), _t(np.stack(fire)), _t(np.stack(signs)))


POLICIES = {
    "randaugment": (JA.rand_augment, jax_rand_augment_draw, A.apply_rand_augment),
    "trivialaugmentwide": (JA.trivial_augment_wide, jax_trivial_augment_draw, A.apply_trivial_augment_wide),
    "augmix": (JA.augmix, jax_augmix_draw, A.apply_augmix),
    "autoaugment": (JA.auto_augment, jax_auto_augment_draw, A.apply_auto_augment),
}


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("policy", list(POLICIES))
def test_policy_given_jax_draws(policy, seed):
    fn_jax, draw_jax, apply = POLICIES[policy]
    x = _images(10 + seed)
    key = jax.random.PRNGKey(seed)
    want = np.asarray(fn_jax(key, jnp.asarray(x)))
    got = apply(_t(x), draw_jax(key, 8)).numpy()
    assert got.shape == x.shape and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0, atol=UNIT_ATOL)


CUSTOM_POLICY = (
    (("ShearY", 0.7, 6), ("TranslateX", 0.9, 3)),
    (("TranslateY", 1.0, 9), ("Invert", 0.5, None)),
    (("Brightness", 0.8, 2), ("Sharpness", 0.6, 8)),
)
OPTIONS = {
    "rand_augment 3 ops, magnitude 15 of 21": (
        lambda k, x: JA.rand_augment(k, x, num_ops=3, magnitude=15, num_bins=21, fill=0.5),
        lambda k, x: A.apply_rand_augment(x, jax_rand_augment_draw(k, 8, 3), 15, 21, 0.5)),
    "trivial_augment_wide 11 bins": (
        lambda k, x: JA.trivial_augment_wide(k, x, num_bins=11),
        lambda k, x: A.apply_trivial_augment_wide(x, jax_trivial_augment_draw(k, 8, 11), 11)),
    "augmix depth 2, no colour ops": (
        lambda k, x: JA.augmix(k, x, chain_depth=2, all_ops=False),
        lambda k, x: A.apply_augmix(x, jax_augmix_draw(k, 8, chain_depth=2, all_ops=False), 2, False)),
    "augmix severity 5, width 2, depth 1, alpha 0.5": (
        lambda k, x: JA.augmix(k, x, severity=5, mixture_width=2, chain_depth=1, alpha=0.5),
        lambda k, x: A.apply_augmix(x, jax_augmix_draw(k, 8, 5, 2, 1, 0.5), 1)),
    "auto_augment custom policy": (
        lambda k, x: JA.auto_augment(k, x, policy=CUSTOM_POLICY, fill=0.25),
        lambda k, x: A.apply_auto_augment(x, jax_auto_augment_draw(k, 8, CUSTOM_POLICY), CUSTOM_POLICY, 0.25)),
}


@pytest.mark.parametrize("name", list(OPTIONS))
def test_policy_options_given_jax_draws(name):
    fn_jax, fn_port = OPTIONS[name]
    x = _images(20)
    key = jax.random.PRNGKey(7)
    np.testing.assert_allclose(fn_port(key, _t(x)).numpy(), np.asarray(fn_jax(key, jnp.asarray(x))),
                               rtol=0, atol=UNIT_ATOL)


def _jax_boxes(key, n, h, w, scale=(0.08, 1.0), ratio=(3.0 / 4.0, 4.0 / 3.0)):
    """The JAX ``random_resized_crop``'s box draws (keys 0-3 of its split)."""
    keys = jax.random.split(key, 4)
    area = jax.random.uniform(keys[0], (n,), minval=scale[0], maxval=scale[1]) * (h * w)
    r = jnp.exp(jax.random.uniform(keys[1], (n,), minval=jnp.log(ratio[0]), maxval=jnp.log(ratio[1])))
    bw = jnp.clip(jnp.sqrt(area * r), 1.0, w)
    bh = jnp.clip(jnp.sqrt(area / r), 1.0, h)
    top = jax.random.uniform(keys[2], (n,)) * (h - bh)
    left = jax.random.uniform(keys[3], (n,)) * (w - bw)
    return A.CropBoxes(*(_t(a) for a in (top, left, bh, bw)))


@pytest.mark.parametrize("policy", list(POLICIES))
def test_train_pipeline_with_policy_given_jax_draws(policy):
    """The JAX pipeline's crop, flip and policy draws through the port's
    applications and normalisation, from uint8 canvases."""
    x = np.random.RandomState(21).randint(0, 256, (8, 20, 24, 3)).astype(np.uint8)
    key = jax.random.PRNGKey(31)
    want = np.asarray(JA.imagenet_train_pipeline(key, jnp.asarray(x), size=16, auto_augment_policy=policy))
    k_crop, k_flip, k_aa = jax.random.split(key, 3)
    got = A.apply_resized_crop(_t(x), _jax_boxes(k_crop, 8, 20, 24), 16) / 255.0
    got = A.apply_hflip(got, _t(jax.random.bernoulli(k_flip, 0.5, (8,))))
    got = P.normalize(POLICIES[policy][2](got, POLICIES[policy][1](k_aa, 8)), scale=1.0)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=UNIT_ATOL / 0.224)


# --------------------------------------------------------------------
# the port's own draws
# --------------------------------------------------------------------


@pytest.mark.parametrize("policy", list(A.AUTO_AUGMENT_POLICIES))
def test_pipeline_policy_is_its_draws_in_order(policy):
    """The pipeline with a policy is the crop, flip and policy draws in that
    order from one generator, then the applications; the same seed gives
    the same batch, another seed another; outputs in [0, 1] before the
    normalisation."""
    x = _t(np.random.RandomState(22).randint(0, 256, (6, 20, 24, 3)).astype(np.uint8))
    run = lambda seed: A.imagenet_train_pipeline(torch.Generator().manual_seed(seed), x, size=16,  # noqa: E731
                                                 auto_augment_policy=policy)
    out = run(4)
    g = torch.Generator().manual_seed(4)
    boxes = A.draw_resized_crop(g, 6, 20, 24)
    flip = A.draw_flip(g, 6)
    draw_fn, apply_fn = A.AUTO_AUGMENT_POLICIES[policy]
    pre = A.apply_hflip(A.apply_resized_crop(x, boxes, 16) / 255.0, flip)
    aug = apply_fn(pre, draw_fn(g, 6, None))
    assert bool((aug >= -1e-6).all() and (aug <= 1 + 1e-6).all())
    assert torch.equal(out, P.normalize(aug, scale=1.0))
    assert torch.equal(run(4), out) and not torch.equal(run(5), out)


def test_pipeline_refuses_jitter_with_a_policy_and_unknown_policies():
    x = torch.zeros(1, 8, 8, 3, dtype=torch.uint8)
    with pytest.raises(ValueError, match="either jitter"):
        A.imagenet_train_pipeline(torch.Generator(), x, size=4, jitter=(0.1, 0.1, 0.1, 0.1),
                                  auto_augment_policy="randaugment")
    with pytest.raises(ValueError, match="not one of"):
        A.imagenet_train_pipeline(torch.Generator(), x, size=4, auto_augment_policy="cutout")


def _uniform_ok(values, k):
    """Counts over k equally likely values within 5 standard deviations."""
    counts = np.bincount(np.asarray(values).ravel(), minlength=k)[:k]
    n = counts.sum()
    return np.abs(counts - n / k).max() < 5 * math.sqrt(n / k * (1 - 1 / k))


def test_rand_and_trivial_augment_draws():
    g = torch.Generator().manual_seed(0)
    ra = A.draw_rand_augment(g, 3000, num_ops=3)
    assert ra.op.shape == (3, 3000) and ra.op.dtype == torch.int64
    assert int(ra.op.min()) == 0 and int(ra.op.max()) == 13 and _uniform_ok(ra.op, 14)
    assert set(ra.sign.unique().tolist()) == {-1.0, 1.0}
    assert abs(ra.sign.mean().item()) < 5 / math.sqrt(9000)
    ta = A.draw_trivial_augment_wide(g, 4000, num_bins=11)
    assert _uniform_ok(ta.op, 14) and _uniform_ok(ta.bin, 11) and int(ta.bin.max()) == 10
    assert abs(ta.sign.mean().item()) < 5 / math.sqrt(4000)


def test_augmix_draws():
    """Beta(alpha, alpha) of shape (N,): in [0, 1], mean 1/2, variance
    1 / (4 (2 alpha + 1)); Dirichlet rows on the simplex with mean 1/width;
    depths in {1, 2, 3}; ops in [1, 14), or [1, 10) without the colour
    ops; magnitudes in {0, 0.1, 0.2} at severity 3."""
    g = torch.Generator().manual_seed(1)
    n, alpha = 4000, 0.5
    d = A.draw_augmix(g, n, alpha=alpha)
    var = 1.0 / (4 * (2 * alpha + 1))
    assert d.m.shape == (n,) and bool(((d.m >= 0) & (d.m <= 1)).all())
    assert abs(d.m.mean().item() - 0.5) < 5 * math.sqrt(var / n) and abs(d.m.var().item() - var) < 0.15 * var
    assert d.weights.shape == (n, 3) and bool((d.weights >= 0).all())
    torch.testing.assert_close(d.weights.sum(1), torch.ones(n), rtol=0, atol=1e-6)
    assert (d.weights.mean(0) - 1 / 3).abs().max() < 0.02
    assert d.depth.shape == (3, n) and _uniform_ok(d.depth - 1, 3) and int(d.depth.min()) == 1
    assert d.op.shape == (3, 3, n) and int(d.op.min()) == 1 and int(d.op.max()) == 13 and _uniform_ok(d.op - 1, 13)
    assert set(d.u.unique().tolist()) == {0.0, np.float32(0.1).item(), np.float32(0.2).item()}
    narrow = A.draw_augmix(g, 500, severity=5, mixture_width=2, chain_depth=1, all_ops=False)
    assert narrow.op.shape == (2, 1, 500) and int(narrow.op.max()) == 9 and narrow.weights.shape == (500, 2)
    assert np.isclose(narrow.u.max().item(), 0.4)


def test_auto_augment_draws():
    """Sub-policies uniform over the table; each stage fires at its
    probability (ImageNet table: the mean over sub-policies)."""
    g = torch.Generator().manual_seed(2)
    n = 20000
    d = A.draw_auto_augment(g, n)
    assert _uniform_ok(d.policy, 25)
    p = torch.tensor([[st[1] for st in sp] for sp in A.IMAGENET_AUTO_AUGMENT_POLICY])[d.policy].T
    rate = d.fire.float().mean(1)
    assert (rate - p.mean(1)).abs().max() < 5 * math.sqrt(0.25 / n)
    assert not bool((d.fire & (p == 0)).any()) and bool((d.fire | (p < 1)).all())
    assert abs(d.sign.mean().item()) < 5 / math.sqrt(2 * n)


def test_auto_augment_contract_cases():
    """p = 0 stages never fire: the identity; two sure inverts give x back;
    the ImageNet table is the JAX one, entry for entry."""
    x = _t(_images(23))
    ident = (("Solarize", 0.0, 5), ("Rotate", 0.0, 9))
    assert torch.equal(A.auto_augment(torch.Generator().manual_seed(0), x, policy=(ident,)), x)
    inv2 = (("Invert", 1.0, None), ("Invert", 1.0, None))
    torch.testing.assert_close(A.auto_augment(torch.Generator().manual_seed(0), x, policy=(inv2,)), x,
                               rtol=0, atol=1e-6)
    assert A.IMAGENET_AUTO_AUGMENT_POLICY == JA.IMAGENET_AUTO_AUGMENT_POLICY
    assert A._AA_OPS == JA._AA_OPS


@pytest.mark.parametrize("policy", ["rand_augment", "trivial_augment_wide", "augmix", "auto_augment"])
def test_policies_are_deterministic_and_bounded(policy):
    x = _t(_images(24))
    fn = getattr(A, policy)
    out = fn(torch.Generator().manual_seed(0), x)
    assert out.shape == x.shape and out.dtype == x.dtype
    assert bool(torch.isfinite(out).all() and (out >= -1e-6).all() and (out <= 1 + 1e-6).all())
    assert torch.equal(fn(torch.Generator().manual_seed(0), x), out)
    assert not torch.equal(fn(torch.Generator().manual_seed(1), x), out)


def test_augmix_original_weight():
    """As alpha -> 0, Beta(alpha, alpha) saturates: the original image's
    weight is about 0 or 1 an image, so some images come back nearly
    untouched."""
    x = _t(_images(25))
    out = A.augmix(torch.Generator().manual_seed(3), x, alpha=1e-4)
    assert bool(((out - x).abs().reshape(8, -1).mean(1) < 1e-3).any())


def test_ops_export_the_family():
    from eqxvision_tpu_torch import ops

    for name in ("invert", "solarize", "posterize", "autocontrast", "equalize", "sharpness", "affine", "rotate",
                 "rand_augment", "trivial_augment_wide", "augmix", "auto_augment"):
        assert getattr(ops, name) is getattr(A, name) and name in ops.__all__


# --------------------------------------------------------------------
# the training CLI's --aa
# --------------------------------------------------------------------

CLI_FLAGS = ["--device", "cpu", "--model", "squeezenet1_0", "--synthetic", "2", "--batch-size", "8", "--canvas", "40",
             "--crop", "32", "--num-classes", "10", "--warmup-epochs", "0", "--lr", "0.01", "--epochs", "1",
             "--log-every", "1", "--mixup", "0.2", "--cutmix", "1.0"]


@pytest.mark.parametrize("policy", list(A.AUTO_AUGMENT_POLICIES))
def test_train_cli_aa(policy):
    """``--aa`` trains on one process with each policy, mixup and cutmix
    after it; the same seed gives the same model."""
    from eqxvision_tpu_torch.cli import train_imagenet as cli

    step, ts = cli.main(CLI_FLAGS + ["--aa", policy])
    assert step == 2 and all(bool(torch.isfinite(p).all()) for p in ts.model.parameters())
    if policy == "randaugment":
        _, again = cli.main(CLI_FLAGS + ["--aa", policy])
        assert all(torch.equal(a, b) for a, b in zip(ts.model.parameters(), again.model.parameters()))


def test_train_cli_augment_fn_given_jax_draws(monkeypatch):
    """The CLI's augmentation with ``--aa trivialaugmentwide`` and no batch
    mix, given the JAX pipeline's crop, flip and policy draws in place of
    the port's: the JAX pipeline's batch, and smoothed labels."""
    from eqxvision_tpu_torch.cli import train_imagenet as cli

    x = np.random.RandomState(40).randint(0, 256, (8, 20, 24, 3)).astype(np.uint8)
    key = jax.random.PRNGKey(41)
    want = np.asarray(JA.imagenet_train_pipeline(key, jnp.asarray(x), size=16,
                                                 auto_augment_policy="trivialaugmentwide"))
    k_crop, k_flip, k_aa = jax.random.split(key, 3)
    monkeypatch.setattr(A, "draw_resized_crop", lambda *a, **k: _jax_boxes(k_crop, 8, 20, 24))
    monkeypatch.setattr(A, "draw_flip", lambda *a, **k: _t(jax.random.bernoulli(k_flip, 0.5, (8,))))
    monkeypatch.setattr(A, "draw_trivial_augment_wide", lambda *a, **k: jax_trivial_augment_draw(k_aa, 8))
    augment_fn = cli.make_augment_fn(10, 16, 0.1, 0.0, 0.0, "trivialaugmentwide")
    labels = torch.tensor([0, 3, 9, 3, 1, 2, 0, 5])
    got, y = augment_fn(torch.Generator().manual_seed(0), _t(x), labels)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=UNIT_ATOL / 0.224)
    assert torch.equal(y, A.smooth_labels(labels, 10, 0.1))
