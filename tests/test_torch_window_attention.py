"""Swin's window ops in the PyTorch port against the JAX package.

The same seeded numpy inputs go through the JAX functions and their port
counterparts: the numpy helpers (relative-position index, v2 coordinate
table, shift mask), window partition with padding and roll, the
window-attention op against the JAX Pallas kernels K3
(``_window_qkv_kernel``) and K4 (``_packed_window_kernel``) in interpret
mode and the prototype P6 (scripts/ablate_swin2.py) in interpret mode, and
the whole-block op against K5 (``_swin_block_kernel``) in interpret mode.
On a CPU tensor the port's ops run their plain torch
versions; the CUDA kernels are compared with those in
tests/test_torch_kernels_cuda.py, on the card. f32 throughout.
"""
import functools
import importlib
import importlib.util
import os
from unittest import mock

import jax.experimental.pallas as pl
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eqxvision_tpu_torch.ops import window_attention as TW

A = importlib.import_module("eqxvision_tpu.ops.attention")
T = importlib.import_module("eqxvision_tpu_torch.ops.attention")
WA = importlib.import_module("eqxvision_tpu.ops.window_attention")
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def rand(*shape, seed=0, scale=1.0):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32) * scale


def _interpret(orig):
    def wrapper(*args, **kwargs):
        kwargs["interpret"] = True
        return orig(*args, **kwargs)

    return wrapper


def _pallas_interpret():
    return mock.patch.object(pl, "pallas_call", _interpret(pl.pallas_call))


# ---------------------------------------------------------------- helpers


@pytest.mark.parametrize("window", [(7, 7), (8, 8), (3, 5)])
def test_position_tables_match_jax(window):
    np.testing.assert_array_equal(TW.relative_position_index(*window), WA.relative_position_index(*window))
    np.testing.assert_allclose(TW.relative_coords_table(*window), WA.relative_coords_table(*window), rtol=0, atol=0)


@pytest.mark.parametrize("args", [(14, 14, 7, 7, 3, 3), (16, 16, 8, 8, 4, 4), (21, 14, 7, 7, 3, 3), (16, 8, 8, 8, 4, 0)])
def test_shift_mask_matches_jax(args):
    np.testing.assert_array_equal(TW._shift_attention_mask(*args), WA._shift_attention_mask(*args))


@pytest.mark.parametrize(
    "hw,window,shift",
    [((14, 14), (7, 7), (3, 3)), ((10, 13), (7, 7), (3, 3)), ((6, 20), (7, 7), (3, 3)), ((12, 12), (8, 8), (0, 0))],
    ids=["exact", "padded", "window-covers-height", "unshifted"],
)
def test_windows_match_jax(hw, window, shift):
    """Pad, roll (with the shift zeroed where one window covers a side) and
    partition, as the JAX ops do, and back again."""
    h, w = hw
    x = rand(2, h, w, 5, seed=h * w)
    wh, ww = window
    pb, pr = (wh - h % wh) % wh, (ww - w % ww) % ww
    xp = np.pad(x, ((0, 0), (0, pb), (0, pr), (0, 0)))
    sh = 0 if wh >= h + pb else shift[0]
    sw = 0 if ww >= w + pr else shift[1]
    ref = WA.window_partition(jnp.roll(jnp.asarray(xp), (-sh, -sw), axis=(1, 2)), wh, ww)
    xw, geo = TW._to_windows(torch.from_numpy(x), window, shift)
    assert (geo.ph, geo.pw, geo.sh, geo.sw) == (h + pb, w + pr, sh, sw)
    np.testing.assert_array_equal(xw.numpy(), np.asarray(ref))
    np.testing.assert_array_equal(TW._from_windows(xw, window, geo).numpy(), x)
    np.testing.assert_array_equal(
        TW.window_unpartition(xw, geo.ph, geo.pw, wh, ww).numpy(),
        np.asarray(WA.window_unpartition(ref, h + pb, w + pr, wh, ww)),
    )


# The whole-block kernel reads its windows straight from the NHWC map with
# window_token_index's formula: written here as a torch gather and scatter,
# it must equal the pad / roll / partition plumbing and its inverse. The
# geometries of every BLOCK_CASES entry (below), a map whose height one
# window covers (shift zeroed there), a 20 x 6 map of 3 windows (width
# covered), and v2's 8 x 8 window on a map it covers whole.
GEOMETRY_CASES = {
    "v1-unshifted": ((14, 14), 7, 0), "v1-shifted": ((14, 14), 7, 3), "v1-padded": ((10, 10), 7, 3),
    "v2-unshifted": ((16, 16), 8, 0), "v2-shifted": ((16, 16), 8, 4), "v2-padded": ((12, 12), 8, 4),
    "height-covered": ((6, 20), 7, 3), "20x6-three-windows": ((20, 6), 7, 3), "v2-one-window": ((8, 8), 8, 4),
}


@pytest.mark.parametrize("case", list(GEOMETRY_CASES))
def test_window_token_index_matches_torch_plumbing(case):
    (h, w), win, shift = GEOMETRY_CASES[case]
    window, shifts = (win, win), (shift, shift)
    x = torch.from_numpy(rand(2, h, w, 5, seed=h * w + shift))
    xw, geo = TW._to_windows(x, window, shifts)
    assert geo == TW.window_geometry(h, w, window, shifts)
    idx = TW.window_token_index(geo, window)
    nw = (geo.ph // win) * (geo.pw // win)
    assert idx.shape == (nw, win * win)
    valid = idx >= 0
    # every token of the map is read by exactly one window position
    assert sorted(idx[valid].tolist()) == list(range(h * w))
    flat = x.reshape(2, h * w, 5)
    gathered = torch.zeros(2, nw, win * win, 5)
    gathered[:, valid] = flat[:, idx[valid]]
    torch.testing.assert_close(gathered, xw, rtol=0, atol=0)
    scattered = torch.empty_like(flat)
    scattered[:, idx[valid]] = xw[:, valid]
    torch.testing.assert_close(scattered.reshape(2, h, w, 5), TW._from_windows(xw, window, geo), rtol=0, atol=0)
    torch.testing.assert_close(scattered.reshape(2, h, w, 5), x, rtol=0, atol=0)


# ---------------------------------------------------------------- window attention (K3, K4)


def _window_case(c, heads, nw, L, shifted, seed):
    """qkv (2, nW, L, 3C) and a bias built as the model builds it: a
    relative-position bias, plus the shift mask when shifted."""
    qkv = rand(2, nw, L, 3 * c, seed=seed)
    rel = rand(1, heads, L, L, seed=seed + 1)
    if not shifted:
        return qkv, rel
    side = int(round(np.sqrt(nw * L)))
    w = int(round(np.sqrt(L)))
    return qkv, rel + WA._shift_attention_mask(side, side, w, w, w // 2, w // 2)[:, None]


def _packed(qkv, bias, c, heads, L):
    """The JAX K4 layout: q, k, v each zero-padded to Cp lanes; bias (nW, L, H*L)."""
    cp = -(-c // 128) * 128
    pad = [(0, 0)] * 3 + [(0, cp - c)]
    qkvp = np.concatenate([np.pad(t, pad) for t in np.split(qkv, 3, axis=-1)], axis=-1)
    bias_packed = np.transpose(bias, (0, 2, 1, 3)).reshape(bias.shape[0], L, heads * L)
    return jnp.asarray(qkvp), jnp.asarray(bias_packed), cp


WINDOW_CASES = {
    "v1-K3": ("K3", None),
    "v1-K4": ("K4", None),
    "v2-K4": ("K4", np.array([3.0, 6.0, 9.0], np.float32)),  # test_ops.py's logit scales
}


@pytest.mark.parametrize("shifted", [False, True], ids=["unshifted", "shifted"])
@pytest.mark.parametrize("case", list(WINDOW_CASES))
def test_window_attention_matches_jax_kernels(case, shifted):
    kernel, gs = WINDOW_CASES[case]
    c, heads, nw, L = 96, 3, 4, 49 if gs is None else 64
    qkv, bias = _window_case(c, heads, nw, L, shifted, seed=7 + 3 * shifted)
    scale = 1.0 if gs is not None else (c // heads) ** -0.5
    with _pallas_interpret(), mock.patch.object(A, "_use_pallas", lambda *a: True):
        if kernel == "K3":
            ref = np.asarray(A._window_qkv_attention(jnp.asarray(qkv), jnp.asarray(bias), heads, scale))
        else:
            qkvp, bias_packed, cp = _packed(qkv, bias, c, heads, L)
            gs_j = None if gs is None else jnp.asarray(gs)
            ref = np.asarray(A._packed_window_attention(qkvp, bias_packed, gs_j, heads, c, scale))[..., :c]
    gs_t = None if gs is None else torch.from_numpy(gs)
    out = T.window_qkv_attention(torch.from_numpy(qkv), torch.from_numpy(bias), heads, scale, gs_t).numpy()
    np.testing.assert_allclose(out, ref, atol=1e-5)


@functools.lru_cache(maxsize=None)
def _ablate_swin2():
    spec = importlib.util.spec_from_file_location("ablate_swin2", os.path.join(REPO, "scripts", "ablate_swin2.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.mark.parametrize("shifted", [False, True], ids=["shared-bias", "bias-per-window"])
def test_window_attention_matches_p6_prototype(shifted):
    """The prototype P6, ``packed_window_attention`` of
    scripts/ablate_swin2.py, in interpret mode, on q|k|v and a bias packed
    with the script's own ``pack_qkv`` and ``pack_bias``: K3/K4's v1
    function, which the port's plain version (and csrc/window_attention.cu)
    computes."""
    P6 = _ablate_swin2()
    c, heads, nw, L = 96, 3, 4, 49
    qkv, bias = _window_case(c, heads, nw, L, shifted, seed=31 + shifted)
    assert bias.shape[0] == (nw if shifted else 1)
    scale = (c // heads) ** -0.5
    cp = -(-c // 128) * 128
    with _pallas_interpret():
        qkvp = P6.pack_qkv(jnp.asarray(qkv), c, cp)
        ref = np.asarray(P6.packed_window_attention(qkvp, P6.pack_bias(jnp.asarray(bias), heads, L), heads, scale, c))
    out = T.window_qkv_attention(torch.from_numpy(qkv), torch.from_numpy(bias), heads, scale).numpy()
    np.testing.assert_allclose(out, ref[..., :c], atol=1e-5)


@pytest.mark.parametrize("v2", [False, True], ids=["v1", "v2"])
def test_gradient_recomputes_through_plain(v2):
    c, heads, nw, L = 64, 2, 4, 16
    qkv, bias = _window_case(c, heads, nw, L, True, seed=21)
    g = torch.from_numpy(rand(2, nw, L, c, seed=22))
    gs = torch.tensor([4.0, 20.0]) if v2 else None
    scale = 1.0 if v2 else 0.25

    def grads(fn):
        t = [torch.from_numpy(qkv).requires_grad_(True), torch.from_numpy(bias).requires_grad_(True)]
        if v2:
            t.append(gs.clone().requires_grad_(True))
        fn(t[0], t[1], heads, scale, t[2] if v2 else None).backward(g)
        return [x.grad for x in t]

    for got, want in zip(grads(T.window_qkv_attention), grads(T.window_qkv_attention_reference)):
        torch.testing.assert_close(got, want)


@pytest.mark.parametrize("v2", [False, True], ids=["v1", "v2"])
def test_cross_head_spread_stays_finite_and_exact(v2):
    """A head biased 300 log-units below the others: the per-head softmax
    is shift-invariant, so the output is finite and equals the unbiased one."""
    c, heads, nw, L = 96, 3, 4, 49
    qkv, bias = _window_case(c, heads, nw, L, True, seed=31)
    offset = np.array([0.0, -300.0, 0.0], np.float32).reshape(1, heads, 1, 1)
    gs = torch.tensor([100.0, 0.01, 10.0]) if v2 else None
    args = (heads, 1.0 if v2 else 0.18, gs)
    far = T.window_qkv_attention(torch.from_numpy(qkv), torch.from_numpy(bias + offset), *args)
    near = T.window_qkv_attention(torch.from_numpy(qkv), torch.from_numpy(bias), *args)
    assert torch.isfinite(far).all()
    # adding -300 to O(1) biases rounds the scores at f32's resolution near 300
    torch.testing.assert_close(far, near, atol=1e-4, rtol=0)


@pytest.mark.parametrize(
    "shape,bias_shape,device",
    [((2, 4, 9, 30), (4, 3, 9, 9), "cpu"), ((2, 4, 9, 31), (4, 3, 9, 9), "cpu"), ((2, 4, 9, 36), (2, 3, 9, 9), "cpu"),
     ((2, 4, 9, 36), (1, 3, 9, 9), "meta")],
    ids=["C-not-divisible", "not-3C", "bias-windows", "meta-device"],
)
def test_window_attention_rejects(shape, bias_shape, device):
    with pytest.raises(ValueError):
        T.window_qkv_attention(torch.zeros(shape, device=device), torch.zeros(bias_shape, device=device), 3, 1.0)


# ---------------------------------------------------------------- shifted window attention (module level)


@pytest.mark.parametrize("v2", [False, True], ids=["v1", "v2"])
@pytest.mark.parametrize("hw", [14, 10])
def test_shifted_window_attention_matches_jax(v2, hw):
    c, heads = 64, 2
    win = (8, 8) if v2 else (7, 7)
    L = win[0] * win[1]
    x = rand(2, hw, hw, c, seed=hw, scale=0.5)
    qkv_w, proj_w = rand(c, 3 * c, seed=1, scale=0.1), rand(c, c, seed=2, scale=0.1)
    qkv_b, proj_b = rand(3 * c, seed=3, scale=0.1), rand(c, seed=4, scale=0.1)
    bias = rand(1, heads, L, L, seed=5)
    ls = np.log(np.array([10.0, 40.0], np.float32)).reshape(heads, 1, 1) if v2 else None
    shift = (win[0] // 2,) * 2
    ref = WA.shifted_window_attention(
        jnp.asarray(x), jnp.asarray(qkv_w), jnp.asarray(proj_w), jnp.asarray(bias), win, heads, shift,
        qkv_bias=jnp.asarray(qkv_b), proj_bias=jnp.asarray(proj_b),
        logit_scale=None if ls is None else jnp.asarray(ls),
    )
    t = torch.from_numpy
    out = TW.shifted_window_attention(
        t(x), t(qkv_w.T.copy()), t(proj_w.T.copy()), t(bias), win, heads, shift, qkv_bias=t(qkv_b),
        proj_bias=t(proj_b), logit_scale=None if ls is None else t(ls),
    )
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5)


# ---------------------------------------------------------------- whole block (K5)


def _block_weights(c, heads, win, seed, table_offset=None):
    """JAX-layout (in, out) weights of one block, and the relative bias."""
    hidden = 4 * c
    r = np.random.RandomState(seed)
    w = {
        "norm1_w": 1 + 0.1 * r.randn(c), "norm1_b": 0.1 * r.randn(c),
        "qkv_weight": 0.1 * r.randn(c, 3 * c), "qkv_bias": 0.1 * r.randn(3 * c),
        "proj_weight": 0.1 * r.randn(c, c), "proj_bias": 0.1 * r.randn(c),
        "norm2_w": 1 + 0.1 * r.randn(c), "norm2_b": 0.1 * r.randn(c),
        "fc1_weight": 0.1 * r.randn(c, hidden), "fc1_bias": 0.1 * r.randn(hidden),
        "fc2_weight": 0.1 * r.randn(hidden, c), "fc2_bias": 0.1 * r.randn(c),
    }
    L = win[0] * win[1]
    bias = r.randn(1, heads, L, L)
    if table_offset is not None:
        bias = bias + np.asarray(table_offset).reshape(1, heads, 1, 1)
    w["relative_position_bias"] = bias
    return {k: np.asarray(v, np.float32) for k, v in w.items()}


def _port_block(fn, x, w, **kw):
    t = {k: torch.from_numpy(v.T.copy() if k.endswith("_weight") else v) for k, v in w.items()}
    if "logit_scale" in kw:
        kw["logit_scale"] = torch.from_numpy(kw["logit_scale"])
        t["qkv_bias"] = TW._v2_qkv_bias(t["qkv_bias"], x.shape[-1])
    return fn(torch.from_numpy(x), **t, **kw).numpy()


BLOCK_CASES = {
    "v1-unshifted": (False, 14, 0),
    "v1-shifted": (False, 14, 3),
    "v1-padded": (False, 10, 3),
    "v2-unshifted": (True, 16, 0),
    "v2-shifted": (True, 16, 4),
    "v2-padded": (True, 12, 4),
}


@pytest.mark.parametrize("case", list(BLOCK_CASES))
def test_fused_block_matches_jax_kernel(case):
    v2, hw, shift = BLOCK_CASES[case]
    c, heads = 64, 2
    win = (8, 8) if v2 else (7, 7)
    w = _block_weights(c, heads, win, seed=hw + shift)
    x = rand(2, hw, hw, c, seed=shift, scale=0.5)
    kw = dict(window_size=win, shift_size=(shift, shift), num_heads=heads)
    jw = {k: jnp.asarray(v) for k, v in w.items()}
    if v2:
        ls = np.log(np.array([10.0, 30.0], np.float32)).reshape(heads, 1, 1)
        jw["qkv_bias"] = jw["qkv_bias"].at[c : 2 * c].set(0.0)
        with _pallas_interpret():
            ref = WA.fused_swin_block_v2(jnp.asarray(x), logit_scale=jnp.asarray(ls), **jw, **kw)
        out = _port_block(TW.fused_swin_block_v2, x, w, logit_scale=ls, **kw)
    else:
        with _pallas_interpret():
            ref = WA.fused_swin_block_v1(jnp.asarray(x), **jw, **kw)
        out = _port_block(TW.fused_swin_block_v1, x, w, **kw)
    np.testing.assert_allclose(out, np.asarray(ref), atol=1e-4)


def test_fused_block_cross_head_spread_stays_finite():
    c, heads, win = 64, 2, (7, 7)
    x = rand(2, 14, 14, c, seed=41, scale=0.5)
    kw = dict(window_size=win, shift_size=(3, 3), num_heads=heads)
    far = _port_block(TW.fused_swin_block_v1, x, _block_weights(c, heads, win, 42, [0.0, -300.0]), **kw)
    near = _port_block(TW.fused_swin_block_v1, x, _block_weights(c, heads, win, 42), **kw)
    assert np.isfinite(far).all()
    np.testing.assert_allclose(far, near, atol=1e-4)


def test_fused_block_gradient_recomputes_through_plain():
    c, heads, win = 32, 1, (7, 7)
    w = {k: torch.from_numpy(v.T.copy() if k.endswith("_weight") else v) for k, v in _block_weights(c, heads, win, 5).items()}
    x = torch.from_numpy(rand(1, 7, 14, c, seed=6)).requires_grad_(True)
    xw, geo = TW._to_windows(x, win, (3, 3))
    params = TW.SwinBlockParams(
        w["norm1_w"], w["norm1_b"], w["qkv_weight"], w["qkv_bias"], w["proj_weight"], w["proj_bias"],
        w["norm2_w"], w["norm2_b"], w["fc1_weight"], w["fc1_bias"], w["fc2_weight"], w["fc2_bias"],
    )
    bias = TW._window_bias(w["relative_position_bias"], win, heads, geo)
    args = (xw, params, bias, heads, c**-0.5, 1e-5, False)
    (g_op,) = torch.autograd.grad(TW.fused_swin_block(*args).square().sum(), x)
    (g_ref,) = torch.autograd.grad(TW.fused_swin_block_reference(*args).square().sum(), x)
    torch.testing.assert_close(g_op, g_ref)


@pytest.mark.parametrize("postnorm", [False, True], ids=["v1", "v2"])
def test_fused_block_map_entry_matches_windows_entry(postnorm):
    """fused_swin_block on the NHWC map (window_size given) is the windows
    entry between _to_windows and _from_windows, gradient included."""
    c, heads, win, shift = 32, 1, (7, 7), (3, 3)
    w = {k: torch.from_numpy(v.T.copy() if k.endswith("_weight") else v) for k, v in _block_weights(c, heads, win, 7).items()}
    params = TW.SwinBlockParams(
        w["norm1_w"], w["norm1_b"], w["qkv_weight"], w["qkv_bias"], w["proj_weight"], w["proj_bias"],
        w["norm2_w"], w["norm2_b"], w["fc1_weight"], w["fc1_bias"], w["fc2_weight"], w["fc2_bias"],
    )
    x = torch.from_numpy(rand(2, 10, 13, c, seed=8)).requires_grad_(True)
    geo = TW.window_geometry(10, 13, win, shift)
    bias = TW._window_bias(w["relative_position_bias"], win, heads, geo)
    gs = torch.tensor([10.0]) if postnorm else None
    out = TW.fused_swin_block(x, params, bias, heads, c**-0.5, 1e-5, postnorm, gs, win, shift)
    xw, _ = TW._to_windows(x, win, shift)
    ref = TW._from_windows(TW.fused_swin_block(xw, params, bias, heads, c**-0.5, 1e-5, postnorm, gs), win, geo)
    torch.testing.assert_close(out, ref)
    (g_map,) = torch.autograd.grad(out.square().sum(), x)
    (g_win,) = torch.autograd.grad(ref.square().sum(), x)
    torch.testing.assert_close(g_map, g_win)


def test_fused_block_rejects_misshapen_weights():
    w = {k: torch.from_numpy(v.T.copy() if k.endswith("_weight") else v) for k, v in _block_weights(32, 1, (7, 7), 5).items()}
    params = TW.SwinBlockParams(
        w["norm1_w"], w["norm1_b"], w["qkv_weight"], w["qkv_bias"], w["proj_weight"], w["proj_bias"],
        w["norm2_w"], w["norm2_b"], w["fc1_weight"].T, w["fc1_bias"], w["fc2_weight"], w["fc2_bias"],
    )
    with pytest.raises(ValueError, match="fc1_w"):
        TW.fused_swin_block(torch.zeros(1, 1, 49, 32), params, torch.zeros(1, 1, 49, 49), 1, 0.18)


@pytest.mark.parametrize(
    "c,hidden,heads,L,ok",
    [(96, 384, 3, 49, True), (192, 768, 6, 64, True), (384, 1536, 12, 49, False), (96, 384, 3, 144, False),
     (128, 512, 1, 49, False), (72, 288, 3, 49, False), (96, 384, 4, 49, False)],
)
def test_fused_block_gate_is_a_shape_rule(c, hidden, heads, L, ok):
    assert TW.fused_swin_block_supported(c, hidden, heads, L) is ok
