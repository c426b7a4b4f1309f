"""The arithmetic plans of the port's window attention kernels (K3/K4),
emulated in torch on the CPU and held against the JAX package.

``csrc/window_attention.cu`` runs windows of at most 64 tokens on its
window stage: bf16 on TMA-fed wgmma, f32 by split TF32 on mma.sync. The
card is needed to run either; this file repeats their arithmetic with torch
on the CPU:

- bf16, v1: the accumulators start at the bias over the scale (f32), the
  products q . k accumulate onto them, then the sum is multiplied by
  scale log2(e); v2: the products alone, times q's row scale gs[h] / |q|
  (with scale log2(e)) and k's column scale 1 / |k|, plus the bias times
  log2(e). Then p = 2^(s - max) / sum rounded to bf16, o = p . v in f32
  rounded to bf16. Each window reads its bias slab through the kernel's
  flat index ((w % nW) % nWb) H + h.
- f32: S and P V by split TF32 (hi + lo, three products), s = (q . k)
  scale + bias, v2 s = (q . k) (gs[h] / |q|) scale / |k| + bias; O divided
  by the row sum after P V.

The plans are held against the JAX kernels K3 (``_window_qkv_kernel``) and
K4 (``_packed_window_kernel``) in interpret mode with a bias shared by all
windows and one a window, and against the port's plain version at the
stage shapes of swin_t and swin_v2_t (one image) with the -100 shift mask,
v2 logit scales up to 100 and a head 300 log-units down. Bounds: bf16 those
of tests/test_hw_parity.py (0.02 v1, 0.12 v2), f32 1e-4 against f64.

The public attention (K2, ``csrc/attention.cu``) runs its rows of at most
64 tokens on the same stage as its one-head case: row b of (B, N, Dh) is
window b of nW = Bb windows reading bias slab b % Bb, or no slab without
a bias (the products alone, times scale log2(e)). That plan is held
against the JAX kernels behind the public attention (``_attn_kernel`` and
``kernel4``, through ``_attention_pallas``) in interpret mode and against
the port's plain version, at N 1 to 64, head dims 16 to 64, Bb of 1, a
divisor of B and B, no bias, and scales other than 1/sqrt(Dh); the f32
plan against f64. The stage's two walks are emulated too: every tile
once, runs equal to within one tile; K2's slab walk (each block a
contiguous run of slab-major tiles) changes slab once or twice a block, K3's
strided walk almost every tile where the grid is not a multiple of the
slabs.
"""
import importlib
from unittest import mock

import jax.experimental.pallas as pl
import jax.numpy as jnp
import numpy as np
import pytest
import torch

A = importlib.import_module("eqxvision_tpu.ops.attention")
T = importlib.import_module("eqxvision_tpu_torch.ops.attention")

LOG2E = 1.4426950408889634
BF16_BOUND = {False: 0.02, True: 0.12}  # v1, v2
F32_BOUND = 1e-4


def _f32(x):
    return torch.tensor(x, dtype=torch.float32)


def _heads(qkv, heads):
    """q, k, v (windows, H, L, Dh) in f32 from qkv (B, nW, L, 3C)."""
    b, nw, L, three_c = qkv.shape
    x = qkv.float().reshape(b * nw, L, 3, heads, three_c // 3 // heads)
    return (x[:, :, i].transpose(1, 2) for i in range(3))


def _bias_slabs(bias, b, nw, heads):
    """Each (window, head)'s bias (windows, H, L, L), read as the kernels
    read it: slab ((w % nW) % nWb) H + h of the flat (nWb H, L, L) bias."""
    nwb, _, L, _ = bias.shape
    flat = bias.float().reshape(nwb * heads, L, L)
    w = torch.arange(b * nw) % nw % nwb
    return flat[w[:, None] * heads + torch.arange(heads)[None, :]]


def _out(o, qkv):
    windows, heads, L, dh = o.shape
    b, nw = qkv.shape[:2]
    return o.transpose(1, 2).reshape(b, nw, L, heads * dh)


def stage_scores(qkv, bias, heads, scale, gs=None):
    """The bf16 window stage's scores, in log2 units (s log2(e))."""
    q, k, _ = _heads(qkv, heads)
    prod = q @ k.transpose(-1, -2)
    if bias is None:  # no slab: the products from zero
        return prod * _f32(scale * LOG2E)
    bt = _bias_slabs(bias, *qkv.shape[:2], heads)
    if gs is None:
        return (bt * _f32(1.0 / scale) + prod) * _f32(scale * LOG2E)
    qs = gs.float().reshape(heads, 1) / q.norm(dim=-1).clamp_min(1e-12) * _f32(scale * LOG2E)
    ki = 1.0 / k.norm(dim=-1).clamp_min(1e-12)
    return prod * qs[..., None] * ki[..., None, :] + bt * _f32(LOG2E)


def stage_plan(qkv, bias, heads, scale, gs=None):
    """The bf16 window stage's output: p = 2^(s - max) / sum rounded to bf16,
    p . v accumulated in f32 and rounded to bf16."""
    _, _, v = _heads(qkv, heads)
    s = stage_scores(qkv, bias, heads, scale, gs)
    e = torch.exp2(s - s.amax(-1, keepdim=True))
    p = (e * (1.0 / e.sum(-1, keepdim=True))).to(qkv.dtype).float()
    return _out((p @ v).to(qkv.dtype), qkv)


def _tf32(x):
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def _split_matmul(a, b):
    """a @ b in split TF32: hi = tf32(x), lo = tf32(x - hi); the two small
    products first, then hi hi."""
    ah, bh = _tf32(a), _tf32(b)
    al, bl = _tf32(a - ah), _tf32(b - bh)
    return ah @ bl + al @ bh + ah @ bh


def f32_plan(qkv, bias, heads, scale, gs=None):
    """The f32 window stage: split-TF32 products, then the scale (v2: q's
    row scale gs / |q| times the scale, and k's column scale 1 / |k|), then
    the bias."""
    q, k, v = _heads(qkv, heads)
    s = _split_matmul(q, k.transpose(-1, -2))
    if bias is None:
        s = s * scale
    elif gs is None:
        s = s * scale + _bias_slabs(bias, *qkv.shape[:2], heads)
    else:
        qs = gs.float().reshape(heads, 1) / q.norm(dim=-1).clamp_min(1e-12) * scale
        s = s * qs[..., None] * (1.0 / k.norm(dim=-1).clamp_min(1e-12))[..., None, :]
        s = s + _bias_slabs(bias, *qkv.shape[:2], heads)
    e = torch.exp(s - s.amax(-1, keepdim=True))
    return _out(_split_matmul(e, v) / e.sum(-1, keepdim=True), qkv)


def _interpret(orig):
    def wrapper(*args, **kwargs):
        kwargs["interpret"] = True
        return orig(*args, **kwargs)

    return wrapper


def _jax_window(kernel, qkv, bias, heads, scale, gs):
    """K3 or K4 in interpret mode on bf16 q|k|v (the f32 bias)."""
    c, L = qkv.shape[-1] // 3, qkv.shape[2]
    with mock.patch.object(pl, "pallas_call", _interpret(pl.pallas_call)), \
            mock.patch.object(A, "_use_pallas", lambda *a: True):
        if kernel == "K3":
            out = A._window_qkv_attention(jnp.asarray(qkv, jnp.bfloat16), jnp.asarray(bias), heads, scale)
        else:  # K4's layout: q, k, v each zero-padded to 128 lanes; the bias (nWb, L, H L)
            cp = -(-c // 128) * 128
            pad = [(0, 0)] * 3 + [(0, cp - c)]
            qkvp = np.concatenate([np.pad(t, pad) for t in np.split(qkv, 3, axis=-1)], axis=-1)
            packed = np.transpose(bias, (0, 2, 1, 3)).reshape(bias.shape[0], L, heads * L)
            out = A._packed_window_attention(jnp.asarray(qkvp, jnp.bfloat16), jnp.asarray(packed),
                                             None if gs is None else jnp.asarray(gs), heads, c, scale)[..., :c]
    return torch.from_numpy(np.array(out.astype(jnp.float32)))


def _rand(rng, *shape, s=1.0):
    return (s * rng.standard_normal(shape)).astype(np.float32)


# (JAX kernel, v2, bias per window): K3 is v1 only; K4 takes both.
PLAN_CASES = [("K3", False, False), ("K3", False, True), ("K4", False, False), ("K4", False, True),
              ("K4", True, False), ("K4", True, True)]


@pytest.mark.parametrize("kernel,v2,per_window", PLAN_CASES,
                         ids=[f"{k}-{'v2' if v else 'v1'}-nWb-{'nW' if p else '1'}" for k, v, p in PLAN_CASES])
def test_stage_plan_matches_jax_kernels_and_plain(kernel, v2, per_window):
    """Two images of four windows, 3 heads of 32: the bias slab of each
    (window, head) at ((w % nW) % nWb) H + h, for nWb = 1 and nWb = nW."""
    rng = np.random.default_rng(11 + 2 * v2 + per_window)
    c, heads, nw, L = 96, 3, 4, 64 if v2 else 49
    qkv = np.array(jnp.asarray(_rand(rng, 2, nw, L, 3 * c), jnp.bfloat16).astype(jnp.float32))
    bias = _rand(rng, nw if per_window else 1, heads, L, L)
    if per_window:
        bias[1:, :, : L // 2, L // 2:] -= 100.0  # a shift mask in all but the first window
    gs = np.array([3.0, 6.0, 9.0], np.float32) if v2 else None  # test_ops.py's: K4 rounds q gs to bf16
    scale = 1.0 if v2 else (c // heads) ** -0.5
    ref = _jax_window(kernel, qkv, bias, heads, scale, gs)
    qkv_t = torch.from_numpy(qkv).to(torch.bfloat16)
    gs_t = None if gs is None else torch.from_numpy(gs)
    plan = stage_plan(qkv_t, torch.from_numpy(bias), heads, scale, gs_t).float()
    plain = T.window_qkv_attention_reference(qkv_t, torch.from_numpy(bias), heads, scale, gs_t).float()
    assert float((plan - ref).abs().max()) < BF16_BOUND[v2]
    assert float((plan - plain).abs().max()) < BF16_BOUND[v2]


def _stage_shapes():
    """(name, stage, nW, L, C, H, shifted) of swin_t (224 px) and swin_v2_t (256 px)."""
    for name, size, win, heads in (("swin_t", 224, 7, (3, 6, 12, 24)), ("swin_v2_t", 256, 8, (3, 6, 12, 24))):
        side = size // 4
        for s, h in enumerate(heads):
            yield name, s + 1, (-(-side // win)) ** 2, win * win, 96 * 2**s, h, side > win
            side = -(-side // 2)


STAGES = list(_stage_shapes())


def _stage_inputs(nw, L, c, h, shifted, v2, seed):
    """One image: q|k|v of std 0.5, a relative-position bias plus the -100
    shift mask (per window where shifted), v2 logit scales 100, 0.02 and 10
    by head, and one head 300 log-units below the others."""
    rng = np.random.default_rng(seed)
    qkv = torch.from_numpy(_rand(rng, 1, nw, L, 3 * c, s=0.5))
    bias = torch.from_numpy(_rand(rng, nw if shifted else 1, h, L, L))
    if shifted:
        bias[:, :, : L // 2, L // 2:] -= 100.0
    bias[:, h // 2] -= 300.0
    gs = torch.tensor([100.0, 0.02, 10.0]).repeat(h // 3 + 1)[:h] if v2 else None
    return qkv, bias, (1.0 if v2 else (c // h) ** -0.5), gs


@pytest.mark.parametrize("name,stage,nw,L,c,h,shifted", STAGES, ids=[f"{s[0]}-s{s[1]}" for s in STAGES])
def test_stage_plan_scales_match_the_normalised_form(name, stage, nw, L, c, h, shifted):
    """The bf16 plan's scores (v2: row and column scales on the raw
    products; v1: the bias over the scale under the products) equal the
    plain version's normalised form in f32, and its output the plain
    version's within the bf16 bound."""
    v2 = name == "swin_v2_t"
    qkv, bias, scale, gs = _stage_inputs(nw, L, c, h, shifted, v2, seed=stage + 10 * v2)
    qkv = qkv.to(torch.bfloat16)
    q, k, _ = _heads(qkv, h)
    if v2:
        q = torch.nn.functional.normalize(q, dim=-1, eps=1e-12) * gs.reshape(h, 1, 1)
        k = torch.nn.functional.normalize(k, dim=-1, eps=1e-12)
    want = q @ k.transpose(-1, -2) * scale + _bias_slabs(bias, 1, nw, h)
    got = stage_scores(qkv, bias, h, scale, gs) / LOG2E
    # scores up to ~400 in magnitude (the -300 head, the -100 mask): f32's resolution there
    torch.testing.assert_close(got, want, atol=2e-4 * max(1.0, float(want.abs().max()) / 100), rtol=0)
    out = stage_plan(qkv, bias, h, scale, gs).float()
    plain = T.window_qkv_attention_reference(qkv, bias, h, scale, gs).float()
    assert bool(torch.isfinite(out).all())
    assert float((out - plain).abs().max()) < BF16_BOUND[v2]


def _f64_reference(qkv, bias, heads, scale, gs=None):
    """The plain version's function in f64."""
    q, k, v = (t.double() for t in _heads(qkv, heads))
    if gs is not None:
        q = torch.nn.functional.normalize(q, dim=-1, eps=1e-12) * gs.double().reshape(heads, 1, 1)
        k = torch.nn.functional.normalize(k, dim=-1, eps=1e-12)
    s = q @ k.transpose(-1, -2) * scale + _bias_slabs(bias, *qkv.shape[:2], heads).double()
    return _out(torch.softmax(s, dim=-1) @ v, qkv)


@pytest.mark.parametrize("name,stage,nw,L,c,h,shifted", STAGES, ids=[f"{s[0]}-s{s[1]}" for s in STAGES])
def test_f32_plan_matches_f64(name, stage, nw, L, c, h, shifted):
    """The f32 path's split TF32, with the window's bias per (window, head)
    and v2's scales, within 1e-4 of the plain version in f64."""
    v2 = name == "swin_v2_t"
    qkv, bias, scale, gs = _stage_inputs(nw, L, c, h, shifted, v2, seed=100 + stage + 10 * v2)
    out = f32_plan(qkv, bias, h, scale, gs)
    ref = _f64_reference(qkv, bias, h, scale, gs)
    assert float((out.double() - ref).abs().max()) < F32_BOUND
    plain = T.window_qkv_attention_reference(qkv, bias, h, scale, gs)
    assert float((plain.double() - ref).abs().max()) < F32_BOUND


# ---- the public attention's (K2) short rows: the stage's one-head case ----


def _k2_as_windows(q, k, v, bias):
    """K2's rows (B, N, Dh) as the stage's windows: qkv (B / Bb, Bb, N, 3 Dh)
    with one head, so that row b is window b of nW = Bb windows and reads
    slab (b % nW) % nWb = b % Bb of the bias (Bb, 1, N, N)."""
    b, n, dh = q.shape
    bb = 1 if bias is None else bias.shape[0]
    qkv = torch.cat([q, k, v], dim=-1).reshape(b // bb, bb, n, 3 * dh)
    return qkv, None if bias is None else bias.reshape(bb, 1, n, n)


def k2_plan(q, k, v, bias, scale, plan=stage_plan):
    """The window stage's output on K2's rows, back as (B, N, Dh)."""
    qkv, slabs = _k2_as_windows(q, k, v, bias)
    return plan(qkv, slabs, 1, scale).reshape(q.shape)


def _k2_inputs(b, n, dh, bb, seed, dtype=torch.bfloat16):
    rng = np.random.default_rng(seed)
    q, k, v = (torch.from_numpy(_rand(rng, b, n, dh)).to(dtype) for _ in range(3))
    bias = None if bb is None else torch.from_numpy(_rand(rng, bb, n, n))
    return q, k, v, bias


# (B, N, Dh, Bb or None, scale or None for 1/sqrt(Dh)): the JAX kernel
# test's case (Bb a divisor of B, scale 0.17), Bb = B, Bb = 1 at the stage's
# 64 rows, one token a row without a bias, head dim 48 (the stage's 64-column
# box), no bias at head dim 64.
K2_CASES = [(6, 49, 32, 3, 0.17), (4, 17, 16, 4, None), (4, 64, 64, 1, None), (3, 1, 48, None, None),
            (4, 64, 48, 2, 0.3), (2, 17, 64, None, 0.25)]


@pytest.mark.parametrize("b,n,dh,bb,scale", K2_CASES,
                         ids=[f"B{c[0]}-N{c[1]}-Dh{c[2]}-Bb{c[3] or 'none'}" for c in K2_CASES])
def test_k2_short_rows_plan_matches_jax_kernels_and_plain(b, n, dh, bb, scale):
    """The bf16 plan on K2's rows against the JAX kernels (``kernel4`` with a
    bias, ``_attn_kernel`` without) in interpret mode on the same bf16
    inputs, and against the port's plain version."""
    q, k, v, bias = _k2_inputs(b, n, dh, bb, seed=b * n + dh)
    scale = dh**-0.5 if scale is None else scale
    with mock.patch.object(pl, "pallas_call", _interpret(pl.pallas_call)):
        ref = A._attention_pallas(*(jnp.asarray(t.float().numpy(), jnp.bfloat16) for t in (q, k, v)),
                                  None if bias is None else jnp.asarray(bias.numpy()), scale)
    ref = torch.from_numpy(np.array(ref.astype(jnp.float32)))
    plan = k2_plan(q, k, v, bias, scale).float()
    lead = (b,) if bias is None else (b // bb, bb)
    plain = T.attention(*(t.reshape(*lead, n, dh) for t in (q, k, v)), bias, scale).reshape(b, n, dh).float()
    assert plan.shape == (b, n, dh) and bool(torch.isfinite(plan).all())
    assert float((plan - ref).abs().max()) < BF16_BOUND[False]
    assert float((plan - plain).abs().max()) < BF16_BOUND[False]


@pytest.mark.parametrize("bb", [192, None], ids=["Bb192", "no-bias"])
def test_k2_short_rows_plan_at_swin_t_stage_1(bb):
    """swin_t stage 1's call through the public op, cut to two images (768
    rows of 49 x 32, 192 slabs), with the -100 shift mask in half the
    slabs: the plan against the plain version."""
    q, k, v, bias = _k2_inputs(768, 49, 32, bb, seed=7)
    if bias is not None:
        bias[96:, :24, 24:] -= 100.0
    plan = k2_plan(q, k, v, bias, 32**-0.5).float()
    plain = T._attention_flat_reference(q, k, v, bias, 32**-0.5).float()
    assert float((plan - plain).abs().max()) < BF16_BOUND[False]


@pytest.mark.parametrize("b,n,dh,bb,scale", [(6, 49, 32, 3, 0.17), (4, 64, 16, 1, None), (3, 17, 32, None, 0.5),
                                             (4, 1, 16, 4, None)],
                         ids=["B6-N49-Dh32-Bb3", "B4-N64-Dh16-Bb1", "B3-N17-Dh32-none", "B4-N1-Dh16-Bb4"])
def test_k2_short_rows_f32_plan_matches_f64(b, n, dh, bb, scale):
    """The f32 stage's split TF32 on K2's rows within 1e-4 of f64."""
    q, k, v, bias = _k2_inputs(b, n, dh, bb, seed=3 * n + dh, dtype=torch.float32)
    scale = dh**-0.5 if scale is None else scale
    out = k2_plan(q, k, v, bias, scale, plan=f32_plan)
    ref = T._attention_flat_reference(q.double(), k.double(), v.double(),
                                      None if bias is None else bias.double(), scale)
    assert float((out.double() - ref).abs().max()) < F32_BOUND


def walk(tiles, grid, windows, heads, group, slab_walk):
    """The stage's walk (win_tile_at in csrc/window_attention.cu): block j's
    tiles as (window, head). The slab walk (K2's rows): a contiguous run of
    the slab-major order; else (K3/K4) tiles j, j + grid, ... of the
    (window, head) order."""
    per, extra = divmod(tiles, grid)
    reps = windows // group
    runs = []
    for j in range(grid):
        first, step = (j * per + min(j, extra), 1) if slab_walk else (j, grid)
        run = []
        for it in range(per + (j < extra)):
            i = first + it * step
            s = i // reps if slab_walk else i
            w = (i - s * reps) * group + s // heads if slab_walk else s // heads
            run.append((w, s % heads))
        runs.append(run)
    return runs


# (what, windows, H, nW, nWb, grid, slab walk): K2 at swin_t stage 1 (192
# slabs, the bf16 grid of 528 blocks), with a bias a row and without one;
# K3 at swin_t stage 3 shifted (a bias a window; the grid a multiple of the
# 48 slabs) and stage 1 (192 slabs, which 528 blocks do not divide).
WALKS = [("K2 swin_t s1", 24576, 1, 192, 192, 528, True), ("K2 Bb = B", 48, 1, 48, 48, 10, True),
         ("K2 no bias", 1000, 1, 1, 1, 132, True), ("K3 swin_t s3", 512, 12, 4, 4, 528, False),
         ("K3 swin_t s1", 8192, 3, 64, 64, 528, False)]


@pytest.mark.parametrize("what,windows,heads,nw,nwb,grid,slab_walk", WALKS, ids=[w[0] for w in WALKS])
def test_walk_covers_every_tile_and_crosses_few_slabs(what, windows, heads, nw, nwb, grid, slab_walk):
    """Every (window, head) once, runs equal to within one tile. The slab
    walk changes slab at most as often as a run's length over a slab's
    tiles, plus one; the strided walk keeps one slab a block where the grid
    is a multiple of the slabs, and changes it almost every tile where not."""
    group = nwb if nw % nwb == 0 else nw
    runs = walk(windows * heads, grid, windows, heads, group, slab_walk)
    assert sorted(t for run in runs for t in run) == [(w, h) for w in range(windows) for h in range(heads)]
    assert max(map(len, runs)) - min(map(len, runs)) <= 1
    changes = [sum(a != b for a, b in zip(sl, sl[1:])) for sl in ([((w % nw) % nwb, h) for w, h in run]
                                                                  for run in runs)]
    if slab_walk:
        assert all(c <= len(run) // (windows // group) + 1 for c, run in zip(changes, runs))
    elif grid % (nwb * heads) == 0:
        assert max(changes) == 0
    else:
        assert sum(changes) > 0.9 * sum(len(run) - 1 for run in runs)
