"""The port's CUDA kernels against their plain torch versions, on the card.

Every test here needs a CUDA card and skips without one. On the card, run
``python -m pytest --noconftest -m cuda tests/test_torch_kernels_cuda.py``
(``--noconftest``: the suite's conftest imports JAX, which the port's
machine need not have). This file imports only torch and the port.
"""
import copy
import ctypes
import importlib

import pytest
import torch

from eqxvision_tpu_torch import _native
from eqxvision_tpu_torch.layers import MlpProjection
from eqxvision_tpu_torch.models.classification import swin as S
from eqxvision_tpu_torch.nn import Linear
from eqxvision_tpu_torch.ops import attention_half as AH
from eqxvision_tpu_torch.ops import layernorm as LN
from eqxvision_tpu_torch.ops import mlp_half as M
from eqxvision_tpu_torch.ops import window_attention as W
from eqxvision_tpu_torch.ops import window_attention_half as WH

A = importlib.import_module("eqxvision_tpu_torch.ops.attention")

pytestmark = pytest.mark.cuda

# (B, L, H, Dh): ViT-B/16's shape, a ragged one, and head dims 32 and 128.
SHAPES = [(2, 197, 12, 64), (3, 50, 3, 64), (2, 33, 2, 32), (2, 70, 2, 128), (1, 1, 1, 64)]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.parametrize("dtype,bound", [(torch.bfloat16, 0.02), (torch.float32, 1e-4)], ids=["bf16", "f32"])
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_fused_qkv_kernel_matches_plain(cuda, shape, dtype, bound):
    b, l, h, dh = shape
    qkv = torch.randn(b, l, 3 * h * dh, device=cuda, generator=torch.Generator(cuda).manual_seed(0)).to(dtype)
    before = A.fused_qkv_attention.launches
    out = A.fused_qkv_attention(qkv, h)
    ref = A.fused_qkv_attention_reference(qkv.float(), h, dh**-0.5)
    torch.cuda.synchronize()
    assert A.fused_qkv_attention.launches == before + 1
    assert out.dtype == dtype and out.shape == (b, l, h * dh)
    assert float((out.float() - ref).abs().max()) < bound


def test_fused_qkv_kernel_gradient_recomputes_plain(cuda):
    qkv = torch.randn(2, 49, 3 * 128, device=cuda, generator=torch.Generator(cuda).manual_seed(1))
    g = torch.randn(2, 49, 128, device=cuda, generator=torch.Generator(cuda).manual_seed(2))
    t = qkv.clone().requires_grad_(True)
    A.fused_qkv_attention(t, 2).backward(g)
    r = qkv.clone().requires_grad_(True)
    A.fused_qkv_attention_reference(r, 2, 64**-0.5).backward(g)
    torch.testing.assert_close(t.grad, r.grad)


@pytest.mark.parametrize(
    "shape,heads,dtype,error",
    [
        ((1, 8, 3 * 64), 1, torch.float16, TypeError),
        ((1, 8, 3 * 2 * 160), 2, torch.float32, ValueError),
    ],
    ids=["float16", "head_dim-160"],
)
def test_fused_qkv_kernel_refuses(cuda, shape, heads, dtype, error):
    with pytest.raises(error):
        A.fused_qkv_attention(torch.zeros(shape, device=cuda, dtype=dtype), heads)


def test_fused_qkv_kernel_takes_any_length(cuda):
    """L = 4096 at head dim 64: K and V no longer fit in shared memory, and
    the stage loads them per block of 256 keys."""
    qkv = torch.randn(1, 4096, 3 * 64, device=cuda, generator=torch.Generator(cuda).manual_seed(3)).bfloat16()
    out = A.fused_qkv_attention(qkv, 1)
    ref = A.fused_qkv_attention_reference(qkv.float(), 1, 64**-0.5)
    torch.cuda.synchronize()
    assert float((out.float() - ref).abs().max()) < 0.02


# The attention stage (csrc/attention_stage.cuh) at the lengths where it
# changes branch: one key; a piece of 64 keys, less one, more one; vit_base's
# 197 (four pieces, one pass); 200 and 256; 257 (two blocks of 256: two
# passes); 577 (K and V resident in two passes); 1024 (K and V loaded per
# block at head dim 128). Head dims 16, 64 and 128 (two column halves).
STAGE_SHAPES = [(2, 1, 3, 64), (2, 63, 2, 64), (2, 64, 2, 16), (2, 65, 2, 128), (2, 197, 12, 64), (2, 200, 2, 16),
                (1, 256, 2, 128), (2, 257, 2, 64), (1, 577, 2, 64), (1, 577, 1, 128), (1, 1024, 2, 128),
                (1, 1024, 2, 16)]


@pytest.mark.parametrize("dtype,bound", [(torch.bfloat16, 0.02), (torch.float32, 1e-4)], ids=["bf16", "f32"])
@pytest.mark.parametrize("shape", STAGE_SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_attention_stage_through_both_entries(cuda, shape, dtype, bound):
    """K1's entry against the stage's plain version, and the fused attention
    half, which runs the same stage, against its own plain version (bound of
    the half: 0.05 in bf16, as test_attention_half_kernel_matches_plain)."""
    b, l, h, dh = shape
    qkv = torch.randn(b, l, 3 * h * dh, device=cuda, generator=torch.Generator(cuda).manual_seed(l)).to(dtype)
    out = A.fused_qkv_attention(qkv, h)
    ref = A.attention_stage_reference(qkv.float(), h, dh**-0.5)
    torch.cuda.synchronize()
    assert float((out.float() - ref).abs().max()) < bound
    x, params = _ah_inputs(cuda, b, l, h * dh, dtype)
    half = AH.fused_attention_half(x, *params, h)
    half_bound = 0.05 if dtype == torch.bfloat16 else 1e-4
    assert float((half.double() - _ah_plain(x, params, h).double()).abs().max()) < half_bound


@pytest.mark.parametrize("shape", [(8, 197, 12, 64), (2, 257, 6, 64), (2, 100, 2, 128)],
                         ids=lambda s: "x".join(map(str, s)))
def test_k1_and_the_half_stage_agree_bit_for_bit(cuda, shape):
    """The half's C entry point writes its qkv and attention workspaces into
    buffers the test owns; K1 on that qkv gives the same bits as the half's
    stage."""
    from eqxvision_tpu_torch import _native

    b, l, h, dh = shape
    d = h * dh
    x, (lnw, lnb, wqkv, bqkv, wproj, bproj) = _ah_inputs(cuda, b, l, d, torch.bfloat16)
    qkv = torch.empty(b, l, 3 * d, dtype=torch.bfloat16, device=cuda)
    attn = torch.empty(b, l, d, dtype=torch.bfloat16, device=cuda)
    stats = torch.empty(b * l, 2, dtype=torch.float32, device=cuda)
    out = torch.empty_like(x)
    err = _native.library().eqx_attention_half(
        x.data_ptr(), lnw.data_ptr(), lnb.data_ptr(), wqkv.data_ptr(), bqkv.data_ptr(), wproj.data_ptr(),
        bproj.data_ptr(), qkv.data_ptr(), attn.data_ptr(), stats.data_ptr(), out.data_ptr(), b, l, d, h, dh**-0.5,
        1e-6, 1, 1, torch.cuda.current_stream().cuda_stream)
    assert err == 0
    k1 = A.fused_qkv_attention(qkv, h, dh**-0.5)
    torch.cuda.synchronize()
    assert torch.equal(k1, attn)
    assert torch.equal(out, AH.fused_attention_half(x, lnw, lnb, wqkv, bqkv, wproj, bproj, h))


# Window attention: (B, nW, nW of the bias, L, H, Dh, v2). swin_t's stage-3
# shape with the shift mask, swin_v2_t's stage-1 shape, a shared bias, a
# window of 12 (L=144) with head dim 64, and an odd window count.
WINDOW_SHAPES = [
    (2, 4, 4, 49, 12, 32, False),
    (2, 4, 4, 64, 3, 32, True),
    (2, 1, 1, 49, 24, 32, False),
    (1, 2, 2, 144, 2, 64, True),
    (3, 3, 1, 25, 2, 32, False),
]


def _window_inputs(cuda, shape, dtype):
    b, nw, nwb, l, h, dh, v2 = shape
    gen = torch.Generator(cuda).manual_seed(3)
    qkv = torch.randn(b, nw, l, 3 * h * dh, device=cuda, generator=gen).to(dtype)
    bias = torch.randn(nwb, h, l, l, device=cuda, generator=gen)
    gs = torch.linspace(3.0, 100.0, h, device=cuda) if v2 else None
    return qkv, bias, (1.0 if v2 else dh**-0.5), gs


# bf16: the bounds of tests/test_hw_parity.py (0.02 v1, 0.12 v2, whose logit
# scale up to 100 amplifies q/k rounding). f32: kernel and plain version
# differ only in summation order and expf, ~1e-6 on outputs of size ~1.
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
@pytest.mark.parametrize("shape", WINDOW_SHAPES, ids=lambda s: "x".join(map(str, s[:6])) + ("-v2" if s[6] else ""))
def test_window_kernel_matches_plain(cuda, shape, dtype):
    qkv, bias, scale, gs = _window_inputs(cuda, shape, dtype)
    h = shape[4]
    before = A.window_qkv_attention.launches
    out = A.window_qkv_attention(qkv, bias, h, scale, gs)
    ref = A.window_qkv_attention_reference(qkv.float(), bias, h, scale, gs)
    torch.cuda.synchronize()
    assert A.window_qkv_attention.launches == before + 1
    assert out.dtype == dtype and out.shape == ref.shape
    bound = (0.12 if shape[6] else 0.02) if dtype == torch.bfloat16 else 1e-4
    assert float((out.float() - ref).abs().max()) < bound


@pytest.mark.parametrize("dtype,bound", [(torch.bfloat16, 0.02), (torch.float32, 1e-4)], ids=["bf16", "f32"])
def test_window_kernel_cross_head_spread(cuda, dtype, bound):
    qkv, bias, scale, gs = _window_inputs(cuda, WINDOW_SHAPES[0], dtype)
    bias[:, 1] -= 300.0
    out = A.window_qkv_attention(qkv, bias, 12, scale)
    ref = A.window_qkv_attention_reference(qkv.float(), bias, 12, scale)
    assert bool(torch.isfinite(out).all())
    assert float((out.float() - ref).abs().max()) < bound


def test_window_kernel_gradient_recomputes_plain(cuda):
    qkv, bias, scale, gs = _window_inputs(cuda, WINDOW_SHAPES[1], torch.float32)
    g = torch.randn(2, 4, 64, 96, device=cuda, generator=torch.Generator(cuda).manual_seed(4))
    t = qkv.clone().requires_grad_(True)
    A.window_qkv_attention(t, bias, 3, scale, gs).backward(g)
    r = qkv.clone().requires_grad_(True)
    A.window_qkv_attention_reference(r, bias, 3, scale, gs).backward(g)
    torch.testing.assert_close(t.grad, r.grad)


@pytest.mark.parametrize(
    "head_dim,dtype,error", [(128, torch.float32, ValueError), (32, torch.float16, TypeError)], ids=["hd128", "f16"]
)
def test_window_kernel_refuses(cuda, head_dim, dtype, error):
    with pytest.raises(error):
        A.window_qkv_attention(
            torch.zeros(1, 1, 4, 3 * head_dim, device=cuda, dtype=dtype), torch.zeros(1, 1, 4, 4, device=cuda), 1, 1.0
        )


def _window_f64(qkv, bias, h, scale, gs=None):
    """window_qkv_attention's function in f64 (the plain version computes in f32)."""
    b, nw, L, three_c = qkv.shape
    c = three_c // 3
    q, k, v = qkv.double().view(b, nw, L, 3, h, c // h).permute(3, 0, 1, 4, 2, 5).unbind(0)
    if gs is not None:
        q = torch.nn.functional.normalize(q, dim=-1, eps=1e-12) * gs.double().view(h, 1, 1)
        k = torch.nn.functional.normalize(k, dim=-1, eps=1e-12)
    s = q @ k.transpose(-1, -2) * scale + bias.double()
    return (torch.softmax(s, dim=-1) @ v).transpose(2, 3).reshape(b, nw, L, c)


def _window_plain(qkv, bias, h, scale, gs=None):
    """The plain version at the kernel's bound: f32 for bf16, f64 for f32."""
    if qkv.dtype == torch.float32:
        return _window_f64(qkv, bias, h, scale, gs)
    return A.window_qkv_attention_reference(qkv.float(), bias, h, scale, gs)


WINDOW_BOUND = {(torch.bfloat16, False): 0.02, (torch.bfloat16, True): 0.12, (torch.float32, False): 1e-4,
                (torch.float32, True): 1e-4}
# The window kernels at their edges: head dims 16, 48 and 64 at L = 49 and
# 64; a tile count (245 windows x 12 heads) that leaves the persistent
# blocks of the bf16 window stage a ragged last round; b1 at swin_t's stage
# 4. (B, nW, nW of the bias, L, H, Dh, v2); a bias a window carries the
# -100 shift mask.
WINDOW_EDGES = {
    "dh16-L49": (2, 4, 4, 49, 4, 16, False), "dh16-L64-v2": (2, 4, 4, 64, 4, 16, True),
    "dh48-L49": (2, 4, 1, 49, 2, 48, False), "dh48-L64-v2": (2, 4, 4, 64, 2, 48, True),
    "dh64-L49-v2": (2, 4, 4, 49, 2, 64, True), "dh64-L64": (2, 4, 1, 64, 2, 64, False),
    "ragged-tiles": (5, 49, 49, 49, 12, 32, False), "swin_t-s4-b1": (1, 1, 1, 49, 24, 32, False),
}


def _masked_window_inputs(cuda, shape, dtype):
    qkv, bias, scale, gs = _window_inputs(cuda, shape, dtype)
    if bias.shape[0] > 1:
        bias[:, :, : shape[3] // 2, shape[3] // 2:] -= 100.0
    return qkv, bias, scale, gs


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
@pytest.mark.parametrize("case", list(WINDOW_EDGES))
def test_window_kernel_edges(cuda, case, dtype):
    shape = WINDOW_EDGES[case]
    qkv, bias, scale, gs = _masked_window_inputs(cuda, shape, dtype)
    out = A.window_qkv_attention(qkv, bias, shape[4], scale, gs)
    ref = _window_plain(qkv, bias, shape[4], scale, gs)
    torch.cuda.synchronize()
    assert float((out.double() - ref.double()).abs().max()) < WINDOW_BOUND[dtype, shape[6]]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
@pytest.mark.parametrize("nwb", [1, 4], ids=["bias-shared", "bias-per-window"])
def test_window_kernel_shift_mask(cuda, nwb, dtype):
    """The -100 shift mask between a window's regions, through a bias
    shared by all windows (nWb = 1) and one a window (nWb = nW)."""
    qkv, bias, scale, _ = _window_inputs(cuda, (2, 4, nwb, 49, 12, 32, False), dtype)
    bias[:, :, :24, 24:] -= 100.0
    bias[:, :, 24:, :24] -= 100.0
    out = A.window_qkv_attention(qkv, bias, 12, scale)
    assert float((out.double() - _window_plain(qkv, bias, 12, scale).double()).abs().max()) < WINDOW_BOUND[dtype, False]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
def test_window_kernel_v2_logit_scale_100_and_far_head(cuda, dtype):
    """v2 with logit scales 100, 0.02 and 10 and one head 300 log-units below the others."""
    qkv, bias, scale, _ = _masked_window_inputs(cuda, (2, 4, 4, 64, 6, 32, True), dtype)
    gs = torch.tensor([100.0, 0.02, 10.0, 100.0, 0.02, 10.0], device=cuda)
    bias[:, 3] -= 300.0
    out = A.window_qkv_attention(qkv, bias, 6, scale, gs)
    assert bool(torch.isfinite(out).all())
    assert float((out.double() - _window_plain(qkv, bias, 6, scale, gs).double()).abs().max()) < WINDOW_BOUND[dtype, True]


@pytest.mark.parametrize("v2", [False, True], ids=["v1", "v2"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
def test_window_kernel_reads_no_row_past_the_windows(cuda, dtype, v2):
    """qkv as the front rows of a buffer whose later rows hold NaN: the
    output stays finite and equal to the plain version's."""
    shape = (2, 4, 4, 64 if v2 else 49, 3, 32, v2)
    qkv, bias, scale, gs = _masked_window_inputs(cuda, shape, dtype)
    rows = qkv.numel() // qkv.shape[-1]
    buf = torch.full((rows + 300, qkv.shape[-1]), float("nan"), device=cuda, dtype=dtype)
    buf[:rows] = qkv.view(rows, -1)
    out = A.window_qkv_attention(buf[:rows].view(qkv.shape), bias, 3, scale, gs)
    assert bool(torch.isfinite(out).all())
    assert float((out.double() - _window_plain(qkv, bias, 3, scale, gs).double()).abs().max()) < WINDOW_BOUND[dtype, v2]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
def test_window_kernel_qkv_off_16_bytes(cuda, dtype):
    """qkv 4 bytes past a 16-byte boundary: bf16 takes the CUDA-core kernel
    (TMA needs 16-byte aligned rows), f32 the stage's 4-byte loads; both
    equal the plain version."""
    qkv, bias, scale, _ = _masked_window_inputs(cuda, (2, 4, 4, 49, 3, 32, False), dtype)
    shift = 4 // qkv.element_size()
    buf = torch.empty(qkv.numel() + shift, dtype=dtype, device=cuda)
    off = buf[shift:].view(qkv.shape)
    off.copy_(qkv)
    assert off.data_ptr() % 16 == 4
    out = A.window_qkv_attention(off, bias, 3, scale)
    assert float((out.double() - _window_plain(qkv, bias, 3, scale).double()).abs().max()) < WINDOW_BOUND[dtype, False]


NON_FINITE_BF16_BITS = {"nan-7fffffff": 0x7FFF, "nan-7fc00000": 0x7FC0, "inf": 0x7F80}


def _plant_any(t, index, name):
    """NON_FINITE_BITS[name] into t (f32), or its bf16 counterpart."""
    if t.dtype == torch.float32:
        t.view(torch.int32)[index] = NON_FINITE_BITS[name]
    else:
        t.view(torch.int16)[index] = NON_FINITE_BF16_BITS[name]


def _keeps_non_finite_within(out, ref, reach, bound):
    """out is non-finite wherever the plain version is, finite outside
    ``reach`` (what the planted value can touch), and within ``bound`` of
    the plain version there."""
    bad, got = ~torch.isfinite(ref), ~torch.isfinite(out)
    assert bool(bad.any()), "the planted value reaches no output"
    assert bool(got[bad].all())
    assert not bool(got[~reach].any())
    assert float((out[~reach].double() - ref[~reach].double()).abs().max()) < bound


@pytest.mark.parametrize("operand", ["q", "k"])
@pytest.mark.parametrize("bits", ["nan-7fffffff", "nan-7fc00000", "inf"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
def test_window_kernel_keeps_non_finite_values(cuda, dtype, bits, operand):
    """Planted in one row of window (1, 2)'s q (reaching that row of head 1)
    or k (reaching all of window (1, 2), head 1): non-finite wherever the
    plain version is (an infinite key gives the plain version some -inf
    scores, hence finite rows, where the split makes NaN: non-finite there
    too, within the reach), every other output finite and within bound."""
    qkv, bias, scale, _ = _masked_window_inputs(cuda, (2, 4, 4, 49, 3, 32, False), dtype)
    _plant_any(qkv, (1, 2, 9, (0 if operand == "q" else 96) + 32 + 5), bits)
    out = A.window_qkv_attention(qkv, bias, 3, scale)
    ref = _window_plain(qkv, bias, 3, scale)
    torch.cuda.synchronize()
    reach = torch.zeros(out.shape, dtype=torch.bool, device=cuda)
    reach[1, 2, (9 if operand == "q" else slice(None)), 32:64] = True
    _keeps_non_finite_within(out, ref, reach, WINDOW_BOUND[dtype, False])


@pytest.mark.parametrize("dtype,bound", [(torch.bfloat16, 0.05), (torch.float32, 1e-4)], ids=["bf16", "f32"])
def test_window_attention_half_kernel_reads_no_row_past_the_windows(cuda, dtype, bound):
    """x as the front rows of a buffer whose later rows hold NaN."""
    x, params, bias, valid = _wh_inputs(cuda, 2, 14, 384, 12, dtype)
    rows = x.numel() // x.shape[-1]
    buf = torch.full((rows + 300, x.shape[-1]), float("nan"), device=cuda, dtype=dtype)
    buf[:rows] = x.view(rows, -1)
    out = WH.fused_window_attention_half(buf[:rows].view(x.shape), *params, bias, 12, None, 1e-5, valid)
    assert bool(torch.isfinite(out).all())
    assert float((out.double() - _wh_plain(x, params, bias, 12, valid).double()).abs().max()) < bound


@pytest.mark.parametrize("bits", ["nan-7fffffff", "nan-7fc00000", "inf"])
@pytest.mark.parametrize("dtype,bound", [(torch.bfloat16, 0.05), (torch.float32, 1e-4)], ids=["bf16", "f32"])
def test_window_attention_half_kernel_keeps_non_finite_values(cuda, dtype, bound, bits):
    """Planted in one token of window (1, 2): its LayerNorm row, then its q,
    k and v, reach every row of that window; every other window stays
    finite and within bound."""
    x, params, bias, valid = _wh_inputs(cuda, 2, 14, 384, 12, dtype)
    _plant_any(x, (1, 2, 9, 5), bits)
    out = WH.fused_window_attention_half(x, *params, bias, 12, None, 1e-5, valid)
    ref = _wh_plain(x, params, bias, 12, valid)
    torch.cuda.synchronize()
    reach = torch.zeros(out.shape, dtype=torch.bool, device=cuda)
    reach[1, 2] = True
    _keeps_non_finite_within(out, ref, reach, bound)


def _block_inputs(cuda, c, heads, n, nw, L, dtype, v2):
    gen = torch.Generator(cuda).manual_seed(c + L)

    def r(*shape, s=0.1, base=0.0):
        return base + s * torch.randn(*shape, device=cuda, generator=gen)

    hidden = 4 * c
    # weights at the models' init scale, 1/sqrt(fan_in) up to a constant
    p = W.SwinBlockParams(
        r(c, base=1.0), r(c), r(3 * c, c, s=c**-0.5).to(dtype), r(3 * c), r(c, c, s=c**-0.5).to(dtype), r(c),
        r(c, base=1.0), r(c), r(hidden, c, s=c**-0.5).to(dtype), r(hidden), r(c, hidden, s=hidden**-0.5).to(dtype), r(c),
    )
    x = r(n, nw, L, c, s=0.5).to(dtype)
    bias = r(nw, heads, L, L, s=1.0)
    gs = torch.full((heads,), 10.0, device=cuda) if v2 else None  # the init logit scale, as test_hw_parity.py
    return x, p, bias, gs


# (C, H, N, nW, L, v2): swin_t stage 1 and 2, swin_v2_t stage 1 and 2.
BLOCK_SHAPES = [(96, 3, 2, 64, 49, False), (192, 6, 2, 16, 49, False), (96, 3, 2, 64, 64, True), (192, 6, 2, 16, 64, True)]


# bf16: tests/test_hw_parity.py's whole-block bounds (0.05 v1, 0.12 v2).
# f32: four products of up to 768 terms and two LayerNorms, summed in
# another order than the plain version's; 1e-4 on outputs of size ~1.
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
@pytest.mark.parametrize("shape", BLOCK_SHAPES, ids=lambda s: "x".join(map(str, s[:5])) + ("-v2" if s[5] else ""))
def test_block_kernel_matches_plain(cuda, shape, dtype):
    c, heads, n, nw, L, v2 = shape
    x, p, bias, gs = _block_inputs(cuda, c, heads, n, nw, L, dtype, v2)
    scale = 1.0 if v2 else (c // heads) ** -0.5
    before = W.fused_swin_block.launches
    out = W.fused_swin_block(x, p, bias, heads, scale, 1e-5, v2, gs)
    ref = W.fused_swin_block_reference(x.float(), W.SwinBlockParams(*(t.float() for t in p)), bias, heads, scale,
                                       1e-5, v2, gs)
    torch.cuda.synchronize()
    assert W.fused_swin_block.launches == before + 1
    assert out.dtype == dtype and out.shape == x.shape
    bound = (0.12 if v2 else 0.05) if dtype == torch.bfloat16 else 1e-4
    assert float((out.float() - ref).abs().max()) < bound


def test_block_kernel_refuses_wide_blocks(cuda):
    x, p, bias, gs = _block_inputs(cuda, 256, 8, 1, 1, 49, torch.float32, False)
    with pytest.raises(ValueError):
        W.fused_swin_block(x, p, bias, 8, 0.1768)


# The NHWC entry, whose kernel reads the windows from the map itself:
# (C, heads, N, map (H, W), window, shift, v2). swin_t stages 1-2 shapes
# shifted and not; C = 128 on a 10 x 10 map padded to 14 x 14; a 20 x 6
# map of 3 windows (a ragged last group of the two-window blocks) whose
# width one window covers (no shift there); v2's 8 x 8 windows at C = 96
# and 192, and a single-window 8 x 8 map (shift zeroed) in 3 images.
MAP_CASES = {
    "c96-14-shifted": (96, 3, 2, (14, 14), 7, 3, False),
    "c96-14-unshifted": (96, 3, 1, (14, 14), 7, 0, False),
    "c128-10x10-padded": (128, 4, 3, (10, 10), 7, 3, False),
    "c192-14-shifted": (192, 6, 1, (14, 14), 7, 3, False),
    "c96-20x6-ragged": (96, 3, 1, (20, 6), 7, 3, False),
    "c96-16-v2": (96, 3, 1, (16, 16), 8, 4, True),
    "c192-16-v2": (192, 6, 1, (16, 16), 8, 4, True),
    "c128-8-v2-one-window": (128, 4, 3, (8, 8), 8, 4, True),
}


def _map_inputs(cuda, c, heads, n, hw, win, v2, dtype):
    gen = torch.Generator(cuda).manual_seed(c + hw[0] * hw[1] + win)

    def r(*shape, s=0.1, base=0.0):
        return base + s * torch.randn(*shape, device=cuda, generator=gen)

    hidden = 4 * c
    kw = dict(
        norm1_w=r(c, base=1.0), norm1_b=r(c), qkv_weight=r(3 * c, c, s=c**-0.5).to(dtype), qkv_bias=r(3 * c),
        proj_weight=r(c, c, s=c**-0.5).to(dtype), proj_bias=r(c), norm2_w=r(c, base=1.0), norm2_b=r(c),
        fc1_weight=r(hidden, c, s=c**-0.5).to(dtype), fc1_bias=r(hidden),
        fc2_weight=r(c, hidden, s=hidden**-0.5).to(dtype), fc2_bias=r(c),
        relative_position_bias=r(1, heads, win * win, win * win, s=1.0),
    )
    if v2:
        kw["qkv_bias"][c : 2 * c] = 0.0
        kw["logit_scale"] = torch.full((heads, 1, 1), float(torch.log(torch.tensor(10.0))), device=cuda)
    return r(n, *hw, c, s=0.5).to(dtype), kw


# bf16 against the f32 plain path on the CPU from the same bf16-rounded
# inputs: tests/test_hw_parity.py's whole-block bounds (0.05 v1, 0.12 v2);
# f32 card against CPU at 1e-4 (the windows entry's bound).
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
@pytest.mark.parametrize("case", list(MAP_CASES))
def test_block_kernel_on_the_map_matches_the_cpu(cuda, case, dtype):
    c, heads, n, hw, win, shift, v2 = MAP_CASES[case]
    x, kw = _map_inputs(cuda, c, heads, n, hw, win, v2, dtype)
    fn = W.fused_swin_block_v2 if v2 else W.fused_swin_block_v1
    geometry = dict(window_size=(win, win), shift_size=(shift, shift), num_heads=heads)
    before = W.fused_swin_block.launches
    with torch.no_grad():
        out = fn(x, **kw, **geometry)
        torch.cuda.synchronize()
        assert W.fused_swin_block.launches == before + 1
        ref = fn(x.float().cpu(), **{k: v.float().cpu() for k, v in kw.items()}, **geometry)
    assert out.dtype == dtype and out.shape == x.shape
    bound = (0.12 if v2 else 0.05) if dtype == torch.bfloat16 else 1e-4
    assert float((out.float().cpu() - ref).abs().max()) < bound


def test_block_kernel_on_the_map_refuses_wide_blocks(cuda):
    x, kw = _map_inputs(cuda, 256, 8, 1, (14, 14), 7, False, torch.bfloat16)
    with pytest.raises(ValueError, match="C <= 192"):
        W.fused_swin_block_v1(x, **kw, window_size=(7, 7), shift_size=(3, 3), num_heads=8)


def test_block_kernel_refused_launch_raises(cuda):
    """The C entry point refuses an x that is not 16-byte aligned with an
    error code and launches nothing; _native.check raises on the code."""
    from eqxvision_tpu_torch import _native

    c, heads = 96, 3
    x, kw = _map_inputs(cuda, c, heads, 1, (14, 14), 7, False, torch.bfloat16)
    unaligned = torch.empty(x.numel() + 8, dtype=x.dtype, device=cuda)[1 : 1 + x.numel()]
    unaligned.copy_(x.view(-1))
    out = torch.full_like(x, 7.0)
    mats = [kw[k] for k in ("qkv_weight", "proj_weight", "fc1_weight", "fc2_weight")]
    vecs = [kw[k] for k in ("norm1_w", "norm1_b", "qkv_bias", "proj_bias", "norm2_w", "norm2_b", "fc1_bias", "fc2_bias")]
    bias = kw["relative_position_bias"]
    err = _native.library().eqx_swin_block(
        unaligned.data_ptr(), out.data_ptr(), *(m.data_ptr() for m in mats), *(v.data_ptr() for v in vecs),
        bias.data_ptr(), None, 1, 14, 14, 14, 14, 7, 7, 3, 3, 1, c, 4 * c, heads, c**-0.5, 1e-5, 0, 1, 0, None,
        torch.cuda.current_stream().cuda_stream,
    )
    torch.cuda.synchronize()
    assert err != 0
    with pytest.raises(RuntimeError, match="CUDA error"):
        _native.check(err, "eqx_swin_block on an unaligned x")
    assert bool((out == 7.0).all())  # nothing ran


# The f32 kernel (split TF32 on wgmma) against the plain version in f64:
# (C, heads, images, windows per image, L, v2, n_bias). C 96, 128 and 192
# (proj widths 96, 128 and 192 at C = NC) and C 64 and 160 (C below the
# proj width), head dims 16, 32, 48 and 64; odd window counts (the last
# two-window group ragged); n_bias 1 and the windows per image.
F32_BLOCK_CASES = {
    "c96-v1-63-windows": (96, 3, 1, 63, 49, False, 63),
    "c96-v2-nbias1": (96, 3, 2, 16, 64, True, 1),
    "c128-v1-15-windows-nbias1": (128, 4, 3, 5, 49, False, 1),
    "c128-v2": (128, 4, 2, 9, 64, True, 9),
    "c192-v1-9-windows": (192, 6, 1, 9, 49, False, 9),
    "c192-v2-nbias1": (192, 6, 3, 3, 64, True, 1),
    "c64-dh16-v1": (64, 4, 1, 5, 49, False, 5),
    "c160-v2": (160, 5, 1, 7, 64, True, 7),
    "c96-dh48-v1": (96, 2, 2, 3, 49, False, 3),
    "c128-dh64-v2": (128, 2, 1, 5, 64, True, 1),
}


def _f32_block_reference(W, x, p, bias, heads, scale, v2, gs):
    return W.fused_swin_block_reference(x.double(), W.SwinBlockParams(*(t.double() for t in p)), bias.double(), heads,
                                        scale, 1e-5, v2, None if gs is None else gs.double())


@pytest.mark.parametrize("case", list(F32_BLOCK_CASES))
def test_f32_block_kernel_matches_plain_in_f64(cuda, case):
    c, heads, n, nw, L, v2, n_bias = F32_BLOCK_CASES[case]
    x, p, bias, gs = _block_inputs(cuda, c, heads, n, nw, L, torch.float32, v2)
    bias = bias[:n_bias].contiguous()
    scale = 1.0 if v2 else (c // heads) ** -0.5
    before = W.fused_swin_block.launches
    out = W.fused_swin_block(x, p, bias, heads, scale, 1e-5, v2, gs)
    ref = _f32_block_reference(W, x, p, bias, heads, scale, v2, gs)
    torch.cuda.synchronize()
    assert W.fused_swin_block.launches == before + 1
    assert out.dtype == torch.float32 and out.shape == x.shape and bool(torch.isfinite(out).all())
    assert float((out.double() - ref).abs().max()) < 1e-4


# The f32 kernel on the map against the plain NHWC path in f64: a 10 x 10
# map padded to 14 x 14 (padding tokens in the windows), shifted; v2 on a
# 12 x 12 map padded to 16 x 16; an unshifted 7 x 21 map of three windows.
F32_MAP_CASES = {
    "c96-10x10-padded": (96, 3, 2, (10, 10), 7, 3, False),
    "c160-12x12-padded-v2": (160, 5, 1, (12, 12), 8, 4, True),
    "c128-7x21-unshifted": (128, 4, 1, (7, 21), 7, 0, False),
}


@pytest.mark.parametrize("case", list(F32_MAP_CASES))
def test_f32_block_kernel_on_the_map_matches_plain_in_f64(cuda, case):
    c, heads, n, hw, win, shift, v2 = F32_MAP_CASES[case]
    x, kw = _map_inputs(cuda, c, heads, n, hw, win, v2, torch.float32)
    fn = W.fused_swin_block_v2 if v2 else W.fused_swin_block_v1
    geometry = dict(window_size=(win, win), shift_size=(shift, shift), num_heads=heads)
    with torch.no_grad():
        out = fn(x, **kw, **geometry)
        ref = fn(x.double().cpu(), **{k: v.double().cpu() for k, v in kw.items()}, **geometry)
    assert out.dtype == torch.float32 and out.shape == x.shape
    assert float((out.double().cpu() - ref).abs().max()) < 1e-4


@pytest.mark.parametrize("where", ["x", "fc2-weight"])
@pytest.mark.parametrize("bits", ["nan-7fffffff", "nan-7fc00000", "inf"])
@pytest.mark.parametrize("v2", [False, True], ids=["v1", "v2"])
def test_f32_block_kernel_keeps_non_finite_values(cuda, v2, bits, where):
    """Planted in one token of window 1, the value reaches that window's
    tokens and no other; planted in fc2's weight, it reaches one output
    column of every token (v1) or, through LN2, every output (v2)."""
    c, heads, L = 96, 3, 64 if v2 else 49
    x, p, bias, gs = _block_inputs(cuda, c, heads, 1, 3, L, torch.float32, v2)
    if where == "x":
        _plant(x, (0, 1, 10, 5), NON_FINITE_BITS[bits])
    else:
        _plant(p.fc2_w, (2, 7), NON_FINITE_BITS[bits])
    scale = 1.0 if v2 else (c // heads) ** -0.5
    out = W.fused_swin_block(x, p, bias, heads, scale, 1e-5, v2, gs)
    ref = _f32_block_reference(W, x, p, bias, heads, scale, v2, gs)
    torch.cuda.synchronize()
    clean = torch.isfinite(ref)
    if where == "x":
        assert not bool(clean[0, 1].any()) and bool(clean[0, 0].all()) and bool(clean[0, 2].all())
    bad = ~clean
    assert bool(bad.any()) and bool((~torch.isfinite(out))[bad].all())
    if bool(clean.any()):
        assert float((out.double() - ref)[clean].abs().max()) < 1e-4


# LayerNorm: (rows, D). The zoo's widths (96 at 4 lanes a row, 384, 768,
# 2048 = swin_b's widest merge), a 128-row classifier norm, and widths that
# take the one-warp-per-row kernel (100: rows not 16-byte multiples in
# bf16; 3072: wider than a lane's registers hold).
LN_SHAPES = [(4099, 96), (300, 384), (1000, 768), (128, 768), (33, 2048), (7, 100), (5, 3072)]


def _ln_inputs(cuda, shape, dtype, param_dtype=torch.float32, shift=0.0):
    """Weights in [0.5, 1] and biases of std 0.2 keep the outputs below 8,
    where one bf16 step is at most 2**-5."""
    gen = torch.Generator(cuda).manual_seed(shape[0] + shape[1])
    x = (shift + 2.0 * torch.randn(*shape, device=cuda, generator=gen)).to(dtype)
    w = (0.5 + 0.5 * torch.rand(shape[1], device=cuda, generator=gen)).to(param_dtype)
    b = (0.2 * torch.randn(shape[1], device=cuda, generator=gen)).to(param_dtype)
    return x, w, b


def _ln_plain(x, w, b, eps=1e-6):
    """The plain version on widened inputs: f64 for an f32 kernel (its own
    f32 sums are then the only error), f32 for a bf16 one."""
    wide = torch.float64 if x.dtype == torch.float32 else torch.float32
    return LN.layer_norm_reference(x.to(wide), None if w is None else w.to(wide), None if b is None else b.to(wide), eps)


# bf16: one rounding of outputs below 8 (at most 2**-6 off) against the f32
# plain version; the bound of the bf16 attention kernels, 0.02. f32: 1e-4,
# the f32 bound of the other kernels.
@pytest.mark.parametrize("affine", [True, False], ids=["affine", "no-affine"])
@pytest.mark.parametrize("dtype,bound", [(torch.bfloat16, 0.02), (torch.float32, 1e-4)], ids=["bf16", "f32"])
@pytest.mark.parametrize("shape", LN_SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_layer_norm_kernel_matches_plain(cuda, shape, dtype, bound, affine):
    x, w, b = _ln_inputs(cuda, shape, dtype)
    if not affine:
        w = b = None
    before = LN.layer_norm.launches
    out = LN.layer_norm(x, w, b, 1e-6)
    ref = _ln_plain(x, w, b)
    torch.cuda.synchronize()
    assert LN.layer_norm.launches == before + 1
    assert out.dtype == dtype and out.shape == x.shape
    assert float((out.double() - ref.double()).abs().max()) < bound


@pytest.mark.parametrize("dtype,bound", [(torch.bfloat16, 0.02), (torch.float32, 1e-4)], ids=["bf16", "f32"])
def test_layer_norm_kernel_centred_variance(cuda, dtype, bound):
    """Rows of 1e3 + N(0, 2): the mean is taken about the row's first value
    and the variance over centred values, so nothing cancels."""
    x, w, b = _ln_inputs(cuda, (2048, 768), dtype, shift=1e3)
    out = LN.layer_norm(x, w, b, 1e-6)
    assert float((out.double() - _ln_plain(x, w, b).double()).abs().max()) < bound


def test_layer_norm_kernel_bf16_parameters_and_unaligned_rows(cuda):
    x, w, b = _ln_inputs(cuda, (64, 96), torch.bfloat16, param_dtype=torch.bfloat16)
    out = LN.layer_norm(x, w, b, 1e-6)
    assert float((out.float() - _ln_plain(x, w, b).float()).abs().max()) < 0.02
    flat = torch.randn(65 * 96, device=cuda, generator=torch.Generator(cuda).manual_seed(5))
    xu = flat[1:1 + 64 * 97].view(64, 97)[:, :96]  # strided: the wrapper copies it
    xo = flat[1:64 * 96 + 1].view(64, 96)  # 4 bytes past a 16-byte boundary: the one-warp-per-row kernel
    for t in (xu, xo):
        got = LN.layer_norm(t, w.float(), b.float(), 1e-6)
        assert float((got.double() - _ln_plain(t, w.float(), b.float()).double()).abs().max()) < 1e-4


def test_layer_norm_kernel_gradient_recomputes_plain(cuda):
    x, w, b = _ln_inputs(cuda, (50, 96), torch.float32)
    g = torch.randn(50, 96, device=cuda, generator=torch.Generator(cuda).manual_seed(6))
    leaves = [t.clone().requires_grad_(True) for t in (x, w, b)]
    LN.layer_norm(*leaves, 1e-6).backward(g)
    refs = [t.clone().requires_grad_(True) for t in (x, w, b)]
    LN.layer_norm_reference(*refs, 1e-6).backward(g)
    for t, r in zip(leaves, refs):
        torch.testing.assert_close(t.grad, r.grad)


@pytest.mark.parametrize(
    "dtype,param_dtype", [(torch.float16, torch.float32), (torch.float32, torch.float16)], ids=["x-f16", "weight-f16"]
)
def test_layer_norm_kernel_refuses(cuda, dtype, param_dtype):
    x, w, b = _ln_inputs(cuda, (4, 96), dtype, param_dtype=param_dtype)
    with pytest.raises(TypeError):
        LN.layer_norm(x, w, b)


# Generic attention: (B, N, Dh, Bb or None). swin_t stage 1's shape through
# the public op and at the full slab count, 192 slabs over 3072 rows, which
# the window stage's grid does not divide (the window stage, one head a
# window, in both types); ViT-B/16's without a bias and with the per-head
# bias at ViT width (the attention stage's wgmma kernel, one pass); a ragged
# one with head dim 8 (the stage's CUDA-core kernel in both types); the
# window stage's limit N = 64 and just past it; one token a row, a bias a
# row; head dim 48 (a 64-column box over 48 columns, the rest read as
# zeros); no bias at head dim 64; head dim 128 at N = 33 (the wgmma stage);
# 577 tokens without and with a bias (two passes, K and V resident; the
# shape the CUDA-core design of before could not hold in shared memory);
# 1025 at head dim 128 (K and V loaded block by block); 300 (two blocks of
# 256 keys).
ATTN_SHAPES = [(24, 49, 32, 6), (6, 197, 64, None), (4, 17, 8, 2), (3, 64, 64, 1), (2, 65, 32, 2), (2, 33, 128, None),
               (24, 197, 64, 12), (6, 577, 64, None), (6, 577, 64, 3), (4, 1025, 128, 2), (4, 300, 64, 2),
               (3072, 49, 32, 192), (5, 1, 16, 5), (7, 64, 48, 7), (6, 64, 64, None)]


def _attn_inputs(cuda, shape, dtype):
    """q, k, v with lead dims (B // Bb, Bb), so that the (Bb, N, N) bias is
    their suffix and reaches the kernel compact."""
    b, n, dh, bb = shape
    gen = torch.Generator(cuda).manual_seed(n + dh)
    lead = (b,) if bb is None else (b // bb, bb)
    q, k, v = (torch.randn(*lead, n, dh, device=cuda, generator=gen).to(dtype) for _ in range(3))
    bias = None if bb is None else torch.randn(bb, n, n, device=cuda, generator=gen)
    return q, k, v, bias


@pytest.mark.parametrize("dtype,bound", [(torch.bfloat16, 0.02), (torch.float32, 1e-4)], ids=["bf16", "f32"])
@pytest.mark.parametrize("shape", ATTN_SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_attention_kernel_matches_plain(cuda, shape, dtype, bound):
    q, k, v, bias = _attn_inputs(cuda, shape, dtype)
    scale = shape[2] ** -0.5
    before = A.attention.launches
    out = A.attention(q, k, v, bias, scale)
    ref = A.attention_reference(q.float(), k.float(), v.float(), bias, scale)
    torch.cuda.synchronize()
    assert A.attention.launches == before + 1
    assert out.dtype == dtype and out.shape == q.shape
    assert float((out.float() - ref).abs().max()) < bound


@pytest.mark.parametrize("dtype,bound", [(torch.bfloat16, 0.02), (torch.float32, 1e-4)], ids=["bf16", "f32"])
def test_attention_kernel_row_far_below(cuda, dtype, bound):
    q, k, v, bias = _attn_inputs(cuda, ATTN_SHAPES[0], dtype)
    bias[1] -= 300.0
    out = A.attention(q, k, v, bias, 32**-0.5)
    ref = A.attention_reference(q.float(), k.float(), v.float(), bias, 32**-0.5)
    assert bool(torch.isfinite(out).all())
    assert float((out.float() - ref).abs().max()) < bound


@pytest.mark.parametrize("dtype,bound", [(torch.bfloat16, 0.02), (torch.float32, 1e-4)], ids=["bf16", "f32"])
def test_attention_kernel_minus_inf_bias_block(cuda, dtype, bound):
    """A bias of -inf on keys 0-255 of some rows, finite after them: the
    first block of the two-pass kernel holds no finite score for those rows,
    and the output must still be finite and equal to the plain version's.
    A row that is -inf everywhere is NaN in both."""
    q, k, v, bias = _attn_inputs(cuda, (4, 300, 64, 2), dtype)
    bias[1, :40, :256] = float("-inf")
    bias[0, 7, :] = float("-inf")
    out = A.attention(q, k, v, bias, 0.125).float()
    ref = A.attention_reference(q.float(), k.float(), v.float(), bias, 0.125)
    torch.cuda.synchronize()
    assert bool(torch.isnan(out[:, 0, 7]).all()) and bool(torch.isnan(ref[:, 0, 7]).all())
    out[:, 0, 7], ref[:, 0, 7] = 0.0, 0.0
    assert bool(torch.isfinite(out).all())
    assert float((out - ref).abs().max()) < bound


@pytest.mark.parametrize("shape", [(4, 197, 12, 64), (2, 577, 3, 64), (2, 300, 2, 32), (2, 100, 2, 128),
                                   (2, 65, 3, 16)], ids=lambda s: "x".join(map(str, s)))
def test_attention_k2_and_k1_agree_bit_for_bit(cuda, shape):
    """K2 on (q, k, v) with no bias, K2 with an all-zero compact bias, and K1
    on the same tensors packed as qkv with H heads run one stage and give the
    same bits in bf16."""
    b, n, h, dh = shape
    qkv = torch.randn(b, n, 3 * h * dh, device=cuda, generator=torch.Generator(cuda).manual_seed(n)).bfloat16()
    k1 = A.fused_qkv_attention(qkv, h, dh**-0.5)
    q, k, v = (t.reshape(b, n, h, dh).transpose(1, 2).contiguous() for t in qkv.split(h * dh, dim=-1))
    k2 = A.attention(q, k, v, None, dh**-0.5)
    k2_zero = A.attention(q, k, v, torch.zeros(h, n, n, device=cuda), dh**-0.5)
    torch.cuda.synchronize()
    assert torch.equal(k2.transpose(1, 2).reshape(b, n, h * dh), k1)
    assert torch.equal(k2_zero, k2)


@pytest.mark.parametrize("dtype,bound", [(torch.bfloat16, 0.02), (torch.float32, 1e-4)], ids=["bf16", "f32"])
def test_attention_kernel_takes_any_length(cuda, dtype, bound):
    """N = 4096 at head dim 64, with a compact bias: the stage loads K and V
    per block of 256 keys (bf16) or runs its CUDA-core kernel (f32)."""
    q, k, v, bias = _attn_inputs(cuda, (2, 4096, 64, 1), dtype)
    out = A.attention(q, k, v, bias)
    ref = A.attention_reference(q.float(), k.float(), v.float(), bias)
    torch.cuda.synchronize()
    assert float((out.float() - ref).abs().max()) < bound


# eqx_attention_config's path: 1 the bf16 window stage, 4 the f32 one, 2
# the attention stage's wgmma kernel, 3 its f32 kernel, 0 its CUDA-core one.
ATTN_PATHS = [((49, 32, 1, 1), 1), ((49, 32, 1, 0), 1), ((64, 48, 1, 1), 1), ((1, 16, 1, 1), 1), ((64, 64, 1, 0), 1),
              ((65, 32, 1, 1), 2), ((49, 8, 1, 1), 0), ((49, 80, 1, 1), 2), ((49, 32, 0, 1), 4), ((64, 16, 0, 0), 4),
              ((49, 64, 0, 1), 3), ((65, 32, 0, 1), 3)]


@pytest.mark.parametrize("args,path", ATTN_PATHS,
                         ids=[f"N{a[0]}-Dh{a[1]}-{'bf16' if a[2] else 'f32'}-{'bias' if a[3] else 'none'}"
                              for a, _ in ATTN_PATHS])
def test_attention_config_reports_the_window_stage_for_short_rows(cuda, args, path):
    """Rows of at most 64 tokens with a head dim the window stage takes (bf16
    16, 32, 48, 64; f32 16, 32) run it, with its design reported as
    eqx_window_attention_config reports it; N = 65 runs the attention stage."""
    lib = _native.library()
    n, dh, dtype, with_bias = args
    cfg = (ctypes.c_int * 6)()
    assert lib.eqx_attention_config(n, dh, dtype, with_bias, 24576, cfg) == 0
    assert cfg[0] == path
    if path in (1, 4):
        blocks_per_sm, smem, blocks, stages = cfg[1:5]
        sms = torch.cuda.get_device_properties(0).multi_processor_count
        assert blocks_per_sm >= 1 and blocks == min(24576, sms * blocks_per_sm)
        assert smem == lib.eqx_attention_smem_bytes(n, dh, 2 if dtype else 4) and stages == (2 if dtype else 1)


@pytest.mark.parametrize("with_bias", [True, False], ids=["bias", "no-bias"])
@pytest.mark.parametrize("dtype,bound", [(torch.bfloat16, 0.02), (torch.float32, 1e-4)], ids=["bf16", "f32"])
def test_attention_kernel_scale_zero(cuda, dtype, bound, with_bias):
    """Scale 0: every score is the bias (or 0). bf16 with a bias cannot take
    bias / scale onto the window stage and runs the attention stage;
    without a bias it stays on the window stage."""
    q, k, v, bias = _attn_inputs(cuda, (24, 49, 32, 6), dtype)
    bias = bias if with_bias else None
    out = A.attention(q, k, v, bias, 0.0)
    ref = A.attention_reference(q.float(), k.float(), v.float(), bias, 0.0)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(out).all())
    assert float((out.float() - ref).abs().max()) < bound


def test_attention_kernel_gradient_recomputes_plain(cuda):
    q, k, v, bias = _attn_inputs(cuda, ATTN_SHAPES[2], torch.float32)
    g = torch.randn_like(q)
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v, bias)]
    A.attention(*leaves, 0.3).backward(g)
    refs = [t.clone().requires_grad_(True) for t in (q, k, v, bias)]
    A.attention_reference(*refs, 0.3).backward(g)
    for t, r in zip(leaves, refs):
        torch.testing.assert_close(t.grad, r.grad)


@pytest.mark.parametrize(
    "shape,dtype,error",
    [((1, 8, 160), torch.float32, ValueError), ((1, 8, 64), torch.float16, TypeError)],
    ids=["head_dim-160", "float16"],
)
def test_attention_kernel_refuses(cuda, shape, dtype, error):
    q = torch.zeros(shape, device=cuda, dtype=dtype)
    with pytest.raises(error):
        A.attention(q, q, q)


# Fused MLP half: (rows, C, residual is x). C = 96 (convnext_tiny stage 1),
# 768 (vit_base, residual is x) and 1536 (convnext_large stage 4), each at a
# row count that the 128-row (bf16) and 64-row (f32) tiles do not divide,
# and one row.
MLP_SHAPES = [(300, 96, False), (130, 768, True), (200, 1536, False), (1, 96, False)]


def _mlp_inputs(cuda, rows, c, residual_is_x, dtype, shift=0.0):
    """Weights at the models' init scale, LayerNorm affine near (1, 0), a
    layer scale of 0.5 where the residual is not x (ConvNeXt)."""
    gen = torch.Generator(cuda).manual_seed(rows + c)

    def r(*shape, s=1.0, base=0.0):
        return (base + s * torch.randn(*shape, device=cuda, generator=gen)).to(dtype)

    x = r(rows, c, base=shift)
    residual = x if residual_is_x else r(rows, c)
    params = [r(c, s=0.1, base=1.0), r(c, s=0.1), r(4 * c, c, s=c**-0.5), r(4 * c, s=0.1),
              r(c, 4 * c, s=(4 * c) ** -0.5), r(c, s=0.1), None if residual_is_x else r(c, s=0.1, base=0.5)]
    return x, residual, params


def _mlp_plain(x, residual, params):
    """The plain version on widened inputs: f64 for an f32 kernel, f32 for a bf16 one."""
    wide = torch.float64 if x.dtype == torch.float32 else torch.float32
    return M.mlp_half_reference(x.to(wide), residual.to(wide), *(None if t is None else t.to(wide) for t in params))


# bf16: tests/test_hw_parity.py's whole-block v1 bound (0.05), which covers
# the same LayerNorm + MLP + residual chain. f32: 1e-4, the f32 bound of the
# other kernels, against the plain version in f64.
@pytest.mark.parametrize("dtype,bound", [(torch.bfloat16, 0.05), (torch.float32, 1e-4)], ids=["bf16", "f32"])
@pytest.mark.parametrize("shape", MLP_SHAPES, ids=lambda s: f"{s[0]}x{s[1]}" + ("-residual-x" if s[2] else ""))
def test_mlp_half_kernel_matches_plain(cuda, shape, dtype, bound):
    x, residual, params = _mlp_inputs(cuda, *shape, dtype)
    before = M.fused_mlp_half.launches
    out = M.fused_mlp_half(x, residual, *params)
    ref = _mlp_plain(x, residual, params)
    torch.cuda.synchronize()
    assert M.fused_mlp_half.launches == before + 1
    assert out.dtype == dtype and out.shape == x.shape
    assert float((out.double() - ref.double()).abs().max()) < bound


@pytest.mark.parametrize("dtype,bound", [(torch.bfloat16, 0.05), (torch.float32, 1e-4)], ids=["bf16", "f32"])
def test_mlp_half_kernel_shifted_rows_and_lead_dims(cuda, dtype, bound):
    """Rows of 1e3 + N(0, 1) keep their variance; lead dims (N, H, W)."""
    x, residual, params = _mlp_inputs(cuda, 2 * 7 * 9, 192, False, dtype, shift=1e3)
    x, residual = x.view(2, 7, 9, 192), residual.view(2, 7, 9, 192)
    out = M.fused_mlp_half(x, residual, *params)
    assert out.shape == x.shape
    assert float((out.double() - _mlp_plain(x, residual, params).double()).abs().max()) < bound


def test_mlp_half_kernel_bf16_vectors_with_f32_weights(cuda):
    """bf16 activations with f32 weights (cast per call) and mixed-type
    vectors (read in f32)."""
    x, residual, params = _mlp_inputs(cuda, 70, 96, False, torch.float32)
    params = [p.bfloat16() if i in (0, 1) else p for i, p in enumerate(params)]
    xb, rb = x.bfloat16(), residual.bfloat16()
    out = M.fused_mlp_half(xb, rb, *params)
    ref = M.mlp_half_reference(xb.float(), rb.float(), *(t.float() for t in params))
    assert float((out.float() - ref).abs().max()) < 0.05


def test_mlp_half_kernel_gradient_recomputes_plain(cuda):
    x, residual, params = _mlp_inputs(cuda, 40, 96, False, torch.float32)
    g = torch.randn(40, 96, device=cuda, generator=torch.Generator(cuda).manual_seed(8))
    leaves = [t.clone().requires_grad_(True) for t in (x, residual, *params)]
    M.fused_mlp_half(*leaves).backward(g)
    refs = [t.clone().requires_grad_(True) for t in (x, residual, *params)]
    M.mlp_half_reference(*refs).backward(g)
    for t, r in zip(leaves, refs):
        torch.testing.assert_close(t.grad, r.grad)


@pytest.mark.parametrize(
    "dtype,weight_dtype,c,error",
    [(torch.float16, torch.float16, 96, TypeError), (torch.float32, torch.float64, 96, TypeError),
     (torch.float32, torch.float32, 20, ValueError)],
    ids=["float16", "weight-float64", "C-20"],
)
def test_mlp_half_kernel_refuses(cuda, dtype, weight_dtype, c, error):
    x, residual, params = _mlp_inputs(cuda, 4, c, True, torch.float32)
    params = [None if t is None else t.to(weight_dtype) for t in params]
    with pytest.raises(error):
        M.fused_mlp_half(x.to(dtype), residual.to(dtype), *params)


# Fused attention half: (B, L, D, H). vit_base's block shape; a ragged L
# above 256 (five 64-key tiles); L = 577, vit_base at 384 px (K and V staged
# in two chunks at head dim 64); head dim 128 at L = 200 (two chunks); head
# dim 24 (bf16 on the CUDA-core stage); one token.
AH_SHAPES = [(2, 197, 768, 12), (2, 257, 384, 6), (1, 577, 768, 12), (2, 200, 256, 2), (2, 50, 96, 4), (1, 1, 64, 1)]


def _ah_inputs(cuda, b, l, d, dtype, shift=0.0, qkv_bias=True):
    """x of std 1 (plus ``shift``), LayerNorm affine near (1, 0), weights at
    the models' init scale, all in the input's type."""
    gen = torch.Generator(cuda).manual_seed(b * l + d)

    def r(*shape, s=1.0, base=0.0):
        return (base + s * torch.randn(*shape, device=cuda, generator=gen)).to(dtype)

    params = [r(d, s=0.1, base=1.0), r(d, s=0.1), r(3 * d, d, s=d**-0.5), r(3 * d, s=0.1) if qkv_bias else None,
              r(d, d, s=d**-0.5), r(d, s=0.1)]
    return r(b, l, d, base=shift), params


def _ah_plain(x, params, heads):
    """The plain version on widened inputs: f64 for an f32 kernel, f32 for a bf16 one."""
    wide = torch.float64 if x.dtype == torch.float32 else torch.float32
    return AH.attention_half_reference(x.to(wide), *(None if t is None else t.to(wide) for t in params), heads,
                                       (x.shape[-1] // heads) ** -0.5)


# bf16: tests/test_hw_parity.py's whole-block v1 bound (0.05): two products
# around an attention. f32: 1e-4 against the plain version in f64.
@pytest.mark.parametrize("dtype,bound", [(torch.bfloat16, 0.05), (torch.float32, 1e-4)], ids=["bf16", "f32"])
@pytest.mark.parametrize("shape", AH_SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_attention_half_kernel_matches_plain(cuda, shape, dtype, bound):
    b, l, d, heads = shape
    x, params = _ah_inputs(cuda, b, l, d, dtype)
    before = AH.fused_attention_half.launches
    out = AH.fused_attention_half(x, *params, heads)
    ref = _ah_plain(x, params, heads)
    torch.cuda.synchronize()
    assert AH.fused_attention_half.launches == before + 1
    assert out.dtype == dtype and out.shape == x.shape
    assert float((out.double() - ref.double()).abs().max()) < bound


@pytest.mark.parametrize("dtype,bound", [(torch.bfloat16, 0.05), (torch.float32, 1e-4)], ids=["bf16", "f32"])
def test_attention_half_kernel_without_qkv_bias(cuda, dtype, bound):
    x, params = _ah_inputs(cuda, 2, 197, 384, dtype, qkv_bias=False)
    out = AH.fused_attention_half(x, *params, 6)
    assert float((out.double() - _ah_plain(x, params, 6).double()).abs().max()) < bound


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
def test_attention_half_kernel_shifted_rows(cuda, dtype):
    """Rows of 1e3 + N(0, 1) keep their variance. The outputs are x plus the
    branch, near 1e3: bf16 rounds them to a step of 4, so its bound is half
    that step plus the bf16 bound; in f32 the step there is 6.1e-5, and the
    row mean itself rounds to it, so the bound is 2e-4."""
    x, params = _ah_inputs(cuda, 2, 197, 384, dtype, shift=1e3)
    out = AH.fused_attention_half(x, *params, 6)
    bound = 2.0 + 0.05 if dtype == torch.bfloat16 else 2e-4
    assert float((out.double() - _ah_plain(x, params, 6).double()).abs().max()) < bound


def test_attention_half_kernel_gradient_recomputes_plain(cuda):
    x, params = _ah_inputs(cuda, 2, 40, 64, torch.float32)
    g = torch.randn(2, 40, 64, device=cuda, generator=torch.Generator(cuda).manual_seed(9))
    leaves = [t.clone().requires_grad_(True) for t in (x, *params)]
    AH.fused_attention_half(*leaves, 4).backward(g)
    refs = [t.clone().requires_grad_(True) for t in (x, *params)]
    AH.attention_half_reference(*refs, 4, 16**-0.5).backward(g)
    for t, r in zip(leaves, refs):
        torch.testing.assert_close(t.grad, r.grad)


@pytest.mark.parametrize(
    "dtype,weight_dtype,d,heads,error",
    [(torch.float16, torch.float16, 64, 4, TypeError), (torch.float32, torch.float64, 64, 4, TypeError),
     (torch.float32, torch.float32, 20, 4, ValueError), (torch.float32, torch.float32, 320, 2, ValueError)],
    ids=["float16", "weight-float64", "D-20", "head_dim-160"],
)
def test_attention_half_kernel_refuses(cuda, dtype, weight_dtype, d, heads, error):
    x, params = _ah_inputs(cuda, 1, 4, d, torch.float32)
    params = [None if t is None else t.to(weight_dtype) for t in params]
    with pytest.raises(error):
        AH.fused_attention_half(x.to(dtype), *params, heads)


# Fused Swin v1 attention half: (B, map side, C, heads) with window 7 and
# shift 3: swin_t stage 3 and 4 widths, swin_b stage 2, a ragged map whose
# windows hold padding tokens, and head dim 16.
WH_SHAPES = [(2, 14, 384, 12), (2, 7, 768, 24), (1, 28, 256, 8), (2, 10, 384, 12), (2, 9, 64, 4)]


def _wh_inputs(cuda, b, side, c, heads, dtype, qkv_bias=True):
    """Windows of an NHWC map of std 1, the window bias, the padding flags,
    LayerNorm affine near (1, 0) and weights at the models' init scale, all
    in the input's type."""
    gen = torch.Generator(cuda).manual_seed(b * side + c)

    def r(*shape, s=1.0, base=0.0):
        return (base + s * torch.randn(*shape, device=cuda, generator=gen)).to(dtype)

    x, geo = W._to_windows(r(b, side, side, c), (7, 7), (3, 3))
    bias = W._window_bias(torch.randn(1, heads, 49, 49, device=cuda, generator=gen), (7, 7), heads, geo)
    params = [r(c, s=0.1, base=1.0), r(c, s=0.1), r(3 * c, c, s=c**-0.5), r(3 * c, s=0.1) if qkv_bias else None,
              r(c, c, s=c**-0.5), r(c, s=0.1)]
    return x.contiguous(), params, bias, WH._valid_rows_on(x.device, geo, 7, 7)


def _wh_plain(x, params, bias, heads, valid):
    """The plain version on widened inputs: f64 for an f32 kernel, f32 for a bf16 one."""
    wide = torch.float64 if x.dtype == torch.float32 else torch.float32
    return WH.window_attention_half_reference(x.to(wide), *(None if t is None else t.to(wide) for t in params), bias,
                                              heads, (x.shape[-1] // heads) ** -0.5, 1e-5, valid)


# bf16: tests/test_hw_parity.py's whole-block v1 bound (0.05): two products
# around an attention. f32: 1e-4 against the plain version in f64.
@pytest.mark.parametrize("dtype,bound", [(torch.bfloat16, 0.05), (torch.float32, 1e-4)], ids=["bf16", "f32"])
@pytest.mark.parametrize("shape", WH_SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_window_attention_half_kernel_matches_plain(cuda, shape, dtype, bound):
    b, side, c, heads = shape
    x, params, bias, valid = _wh_inputs(cuda, b, side, c, heads, dtype)
    before = WH.fused_window_attention_half.launches
    out = WH.fused_window_attention_half(x, *params, bias, heads, None, 1e-5, valid)
    ref = _wh_plain(x, params, bias, heads, valid)
    torch.cuda.synchronize()
    assert WH.fused_window_attention_half.launches == before + 1
    assert out.dtype == dtype and out.shape == x.shape
    assert float((out.double() - ref.double()).abs().max()) < bound


@pytest.mark.parametrize("dtype,bound", [(torch.bfloat16, 0.05), (torch.float32, 1e-4)], ids=["bf16", "f32"])
def test_window_attention_half_kernel_without_qkv_bias_or_mask(cuda, dtype, bound):
    x, params, bias, _ = _wh_inputs(cuda, 2, 14, 192, 6, dtype, qkv_bias=False)
    out = WH.fused_window_attention_half(x, *params, bias, 6)
    assert float((out.double() - _wh_plain(x, params, bias, 6, None).double()).abs().max()) < bound


def test_window_attention_half_kernel_padding_rows_are_zero_before_qkv(cuda):
    """On a ragged map the flags matter: the kernel with them matches the
    plain version with them, and not the plain version without them."""
    x, params, bias, valid = _wh_inputs(cuda, 2, 10, 128, 4, torch.float32)
    out = WH.fused_window_attention_half(x, *params, bias, 4, None, 1e-5, valid)
    assert float((out.double() - _wh_plain(x, params, bias, 4, valid)).abs().max()) < 1e-4
    assert float((out.double() - _wh_plain(x, params, bias, 4, None)).abs().max()) > 1e-2


def test_window_attention_half_kernel_gradient_recomputes_plain(cuda):
    x, params, bias, valid = _wh_inputs(cuda, 1, 10, 64, 4, torch.float32)
    g = torch.randn(*x.shape, device=cuda, generator=torch.Generator(cuda).manual_seed(9))
    leaves = [t.clone().requires_grad_(True) for t in (x, *params)]
    WH.fused_window_attention_half(*leaves, bias, 4, None, 1e-5, valid).backward(g)
    refs = [t.clone().requires_grad_(True) for t in (x, *params)]
    WH.window_attention_half_reference(*refs, bias, 4, 0.25, 1e-5, valid).backward(g)
    for t, r in zip(leaves, refs):
        torch.testing.assert_close(t.grad, r.grad)


@pytest.mark.parametrize(
    "dtype,weight_dtype,c,heads,error",
    [(torch.float16, torch.float16, 64, 4, TypeError), (torch.float32, torch.float64, 64, 4, TypeError),
     (torch.float32, torch.float32, 96, 4, ValueError), (torch.float32, torch.float32, 256, 2, ValueError)],
    ids=["float16", "weight-float64", "head_dim-24", "head_dim-128"],
)
def test_window_attention_half_kernel_refuses(cuda, dtype, weight_dtype, c, heads, error):
    x, params, bias, valid = _wh_inputs(cuda, 1, 7, c, heads, torch.float32)
    params = [None if t is None else t.to(weight_dtype) for t in params]
    with pytest.raises(error):
        WH.fused_window_attention_half(x.to(dtype), *params, bias, heads, None, 1e-5, valid)


# The bf16 GEMM of csrc/gemm_bf16.cuh (TMA-fed wgmma) at its edges, driven
# through the three ops that run it: (op, shape). MLP half (rows, C,
# residual is x): fc1 takes the LayerNorm on A and gelu (N = 4C, K = C),
# fc2 the residual (N = C, K = 4C). Attention half (B, L, D, heads): qkv
# takes the LayerNorm and the bias-only epilogue, proj the residual. Swin
# attention half (B, map side, C, heads): qkv takes the LayerNorm, the
# rounded bias and, on a ragged map, the padding rows read as zeros.
GEMM_EDGES = {
    "M-100-below-one-row-tile": ("mlp", (100, 384, False)),
    "M-392-convnext_large-b8-stage4": ("mlp", (392, 1536, False)),
    "one-row": ("mlp", (1, 96, False)),
    "N-96-K-96": ("mlp", (1000, 96, False)),  # fc2 N = 96, fc1 K = 96: one and a half k-tiles
    "N-192": ("mlp", (777, 192, False)),
    "K-3072": ("mlp", (300, 768, True)),  # fc2 of vit_base
    "f32-vectors": ("mlp-f32-vectors", (250, 192, False)),
    "rows-shifted-by-1e3": ("mlp-shifted", (260, 384, False)),
    "bias-epilogue-N-2304": ("attention", (2, 197, 768, 12)),
    "bias-epilogue-N-1152-ragged": ("attention", (3, 45, 384, 6)),
    "rounded-bias-masked-rows": ("window", (2, 10, 384, 12)),
    "rounded-bias-N-768": ("window", (1, 14, 256, 8)),
}


# bf16: the halves' bound, tests/test_hw_parity.py's whole-block v1 bound
# (0.05), against the plain versions in f32.
@pytest.mark.parametrize("edge", list(GEMM_EDGES))
def test_bf16_gemm_edges_through_the_ops(cuda, edge):
    kind, shape = GEMM_EDGES[edge]
    if kind.startswith("mlp"):
        x, residual, params = _mlp_inputs(cuda, *shape, torch.bfloat16, shift=1e3 if kind == "mlp-shifted" else 0.0)
        if kind == "mlp-f32-vectors":
            params = [t if t is None or t.ndim == 2 else t.float() for t in params]
        out = M.fused_mlp_half(x, residual, *params)
        ref = _mlp_plain(x, residual, params)
    elif kind == "attention":
        b, l, d, heads = shape
        x, params = _ah_inputs(cuda, b, l, d, torch.bfloat16)
        out = AH.fused_attention_half(x, *params, heads)
        ref = _ah_plain(x, params, heads)
    else:
        b, side, c, heads = shape
        x, params, bias, valid = _wh_inputs(cuda, b, side, c, heads, torch.bfloat16)
        assert (valid is not None) == (side % 7 != 0)
        out = WH.fused_window_attention_half(x, *params, bias, heads, None, 1e-5, valid)
        ref = _wh_plain(x, params, bias, heads, valid)
    torch.cuda.synchronize()
    assert out.dtype == torch.bfloat16 and out.shape == x.shape
    assert float((out.float() - ref.float()).abs().max()) < 0.05


def test_refused_launch_raises_and_does_not_fall_back(cuda):
    """The C entry point refuses an x that is not 16-byte aligned (the Python
    wrappers copy such tensors first) with an error code, launches nothing,
    and _native.check raises on the code."""
    from eqxvision_tpu_torch import _native

    rows, c = 64, 96
    x, residual, params = _mlp_inputs(cuda, rows, c, False, torch.bfloat16)
    ln_w, ln_b, w1, b1, w2, b2, scale = params
    unaligned = torch.empty(rows * c + 8, dtype=torch.bfloat16, device=cuda)[1:1 + rows * c]
    unaligned.copy_(x.view(-1))
    assert unaligned.data_ptr() % 16 != 0
    hidden = torch.empty(rows, 4 * c, dtype=torch.bfloat16, device=cuda)
    stats = torch.empty(rows, 2, dtype=torch.float32, device=cuda)
    out = torch.full((rows, c), 7.0, dtype=torch.bfloat16, device=cuda)
    err = _native.library().eqx_mlp_half(
        unaligned.data_ptr(), residual.data_ptr(), ln_w.data_ptr(), ln_b.data_ptr(), w1.data_ptr(), b1.data_ptr(),
        w2.data_ptr(), b2.data_ptr(), scale.data_ptr(), hidden.data_ptr(), stats.data_ptr(), out.data_ptr(), rows, c,
        4 * c, 1e-6, 1, 1, torch.cuda.current_stream().cuda_stream,
    )
    torch.cuda.synchronize()
    assert err != 0
    with pytest.raises(RuntimeError, match="CUDA error"):
        _native.check(err, "eqx_mlp_half on an unaligned x")
    assert bool((out == 7.0).all())  # nothing ran


def test_swin_t_blocks_above_192_channels_run_the_fused_halves(cuda):
    """A swin_t at inference launches the attention half and the MLP half
    once per C > 192 block, and no window-attention kernel."""
    from eqxvision_tpu_torch.models import create_model

    model = create_model("swin_t", depths=(2, 2, 2, 2), num_classes=10, generator=torch.Generator().manual_seed(0),
                         device=cuda).eval()
    counters = (WH.fused_window_attention_half, M.fused_mlp_half, A.window_qkv_attention, W.fused_swin_block)
    before = [fn.launches for fn in counters]
    x = torch.randn(2, 112, 112, 3, device=cuda, generator=torch.Generator(cuda).manual_seed(1))
    with torch.no_grad():
        out = model(x)
    torch.cuda.synchronize()
    assert [fn.launches - n for fn, n in zip(counters, before)] == [4, 4, 0, 4]
    cpu = create_model("swin_t", depths=(2, 2, 2, 2), num_classes=10, generator=torch.Generator().manual_seed(0),
                       device="cpu").eval()
    cpu.load_state_dict(model.state_dict())
    with torch.no_grad():
        ref = cpu(x.cpu())
    torch.testing.assert_close(out.cpu(), ref, atol=1e-4, rtol=1e-4)


def _gen():
    return torch.Generator().manual_seed(0)


# Modules whose bf16 input meets Linear.preactivation: the f32 accumulator
# that the card computes with torch.mm's out_dtype where no gradient is
# taken. ViT's training MLP, a Swin block with C > 192 in training (its MLP,
# and the window-attention kernel under the qkv), and a Linear with f32
# parameters.
GRAD_CASES = {
    "mlp-bf16": (lambda: MlpProjection(96, 384, generator=_gen()).to(torch.bfloat16), (2, 50, 96)),
    "swin-block-c256-bf16-train": (
        lambda: S._SwinTransformerBlock(256, 8, [7, 7], [3, 3], generator=_gen()).to(torch.bfloat16).train(),
        (2, 14, 14, 256),
    ),
    "linear-f32-params": (lambda: Linear(96, 160, generator=_gen()), (3, 7, 96)),
}


def _rel(a, b):
    a, b = a.detach().double(), b.detach().double()
    return float((a - b).norm() / b.norm())


@pytest.mark.parametrize("name", list(GRAD_CASES))
def test_bf16_input_gradients_on_the_card_match_the_cpu(cuda, name):
    """A backward through a bf16 input on the card: the output and every
    gradient against the same module on the CPU. bf16 outputs and input
    gradients round differently on the two devices, by a step or so, so
    the error is taken relative to each tensor's norm."""
    build, shape = GRAD_CASES[name]
    cpu = build()
    card = copy.deepcopy(cpu).to(cuda)
    x = torch.randn(*shape, generator=torch.Generator().manual_seed(1)).bfloat16()
    results = []
    for module, dev in ((cpu, "cpu"), (card, cuda)):
        xi = x.clone().to(dev).requires_grad_(True)
        y = module(xi)
        g = torch.randn(*y.shape, generator=torch.Generator().manual_seed(2)).to(y.dtype)
        y.backward(g.to(dev))
        results.append([y, xi.grad] + [p.grad for p in module.parameters()])
    assert results[1][0].dtype == torch.bfloat16
    for ref, out in zip(*results):
        assert out is not None and ref is not None
        assert torch.isfinite(out).all()
        assert _rel(out.cpu(), ref) < 2e-2


# The f32 GEMM of csrc/gemm_bf16.cuh (split TF32 on TMA-fed wgmma) through
# the three ops that run it, against their plain versions in f64 at 1e-4:
# each of its four epilogues (bias + gelu and bias + layer scale + residual
# in the MLP half, the bias alone and bias + residual in the attention
# half, the rounded bias in the Swin attention half), the LayerNorm on A
# with rows shifted by 1e3, masked padding rows, bf16 LayerNorm parameters
# and biases, and ragged M, N and K (C = 40: K = 40 and N = 40 are not
# multiples of the 32-float k-tile or of either column tile).
F32_GEMM_EDGES = {
    "gelu-and-residual-ragged-M": ("mlp", (300, 96, False)),
    "residual-is-x-K-3072": ("mlp", (130, 768, True)),
    "ragged-N-and-K-40": ("mlp", (77, 40, False)),
    "one-row": ("mlp", (1, 96, False)),
    "rows-shifted-by-1e3": ("mlp-shifted", (260, 384, False)),
    "bf16-parameters": ("mlp-bf16-vectors", (250, 192, False)),
    "bias-and-residual-N-2304": ("attention", (2, 197, 768, 12)),
    "bias-and-residual-ragged": ("attention", (3, 45, 384, 6)),
    "rounded-bias-masked-rows": ("window", (2, 10, 384, 12)),
    "rounded-bias-N-768": ("window", (1, 14, 256, 8)),
}


@pytest.mark.parametrize("edge", list(F32_GEMM_EDGES))
def test_f32_gemm_edges_through_the_ops(cuda, edge):
    kind, shape = F32_GEMM_EDGES[edge]
    f32 = torch.float32
    if kind.startswith("mlp"):
        x, residual, params = _mlp_inputs(cuda, *shape, f32, shift=1e3 if kind == "mlp-shifted" else 0.0)
        if kind == "mlp-bf16-vectors":
            params = [t if t is None or t.ndim == 2 else t.bfloat16() for t in params]
        out = M.fused_mlp_half(x, residual, *params)
        ref = _mlp_plain(x, residual, params)
    elif kind == "attention":
        b, l, d, heads = shape
        x, params = _ah_inputs(cuda, b, l, d, f32)
        out = AH.fused_attention_half(x, *params, heads)
        ref = _ah_plain(x, params, heads)
    else:
        b, side, c, heads = shape
        x, params, bias, valid = _wh_inputs(cuda, b, side, c, heads, f32)
        assert (valid is not None) == (side % 7 != 0)
        out = WH.fused_window_attention_half(x, *params, bias, heads, None, 1e-5, valid)
        ref = _wh_plain(x, params, bias, heads, valid)
    torch.cuda.synchronize()
    assert out.dtype == f32 and out.shape == x.shape
    assert float((out.double() - ref.double()).abs().max()) < 1e-4


# The f32 attention stage (split TF32 on mma.sync, one pass) through K1's
# entry and K2's: lengths 1, 49, 197, 257, 577 and 1024 (one key group, a
# ragged chunk, vit_base's tokens, a chunk and one key, 384 px, long rows)
# at head dims 16, 48, 64, 80 and 128 (rounded up to 16 or not, one and
# two key chunk sizes).
F32_STAGE_SHAPES = [(2, 1, 3, 64), (3, 49, 2, 48), (2, 197, 12, 64), (2, 257, 2, 80), (1, 577, 2, 16),
                    (1, 1024, 2, 128), (2, 197, 2, 128), (2, 49, 4, 16)]


@pytest.mark.parametrize("shape", F32_STAGE_SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_f32_stage_through_k1_and_k2(cuda, shape):
    b, l, h, dh = shape
    qkv = torch.randn(b, l, 3 * h * dh, device=cuda, generator=torch.Generator(cuda).manual_seed(l + dh))
    k1 = A.fused_qkv_attention(qkv, h)
    ref = A.attention_stage_reference(qkv.double(), h, dh**-0.5)
    q, k, v = (t.reshape(b, l, h, dh).transpose(1, 2).contiguous() for t in qkv.split(h * dh, dim=-1))
    bias = torch.randn(h, l, l, device=cuda, generator=torch.Generator(cuda).manual_seed(1))
    k2 = A.attention(q, k, v, bias, dh**-0.5)
    k2_ref = A.attention_reference(q.double(), k.double(), v.double(), bias.double(), dh**-0.5)
    torch.cuda.synchronize()
    assert float((k1.double() - ref).abs().max()) < 1e-4
    assert float((k2.double() - k2_ref).abs().max()) < 1e-4


@pytest.mark.parametrize("case", ["head-300-down", "minus-inf-block"])
def test_f32_stage_far_and_infinite_biases(cuda, case):
    """A head biased 300 log-units down, and -inf over the first 256 keys of
    some rows (finite after them): finite, and equal to the plain version
    in f64 within 1e-4."""
    q, k, v, bias = _attn_inputs(cuda, (6, 49, 32, 3) if case == "head-300-down" else (4, 300, 64, 2), torch.float32)
    if case == "head-300-down":
        bias[1] -= 300.0
    else:
        bias[1, :40, :256] = float("-inf")
    out = A.attention(q, k, v, bias, 0.125)
    ref = A.attention_reference(q.double(), k.double(), v.double(), bias.double(), 0.125)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(out).all())
    assert float((out.double() - ref).abs().max()) < 1e-4


def test_f32_stage_is_the_split_tf32_kernel(cuda):
    """K1, K2 and the attention half in f32 launch attention_stage_f32, and
    no CUDA-core stage kernel."""
    from torch.profiler import ProfilerActivity, profile

    qkv = torch.randn(2, 197, 3 * 128, device=cuda, generator=torch.Generator(cuda).manual_seed(4))
    q = torch.randn(4, 197, 64, device=cuda, generator=torch.Generator(cuda).manual_seed(5))
    x, params = _ah_inputs(cuda, 2, 197, 128, torch.float32)
    for fn in (lambda: A.fused_qkv_attention(qkv, 2), lambda: A.attention(q, q, q),
               lambda: AH.fused_attention_half(x, *params, 2)):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        names = [e.key for e in prof.key_averages() if "attention_stage" in e.key]
        assert names and all("attention_stage_f32" in n for n in names), names


@pytest.mark.parametrize("dh", [8, 24, 40])
def test_bf16_stage_off_multiples_of_16_stays_two_pass(cuda, dh):
    """bf16 with Dh % 16 != 0 keeps the two-pass CUDA-core stage, whose p is
    rounded to bf16 before P V: the profiler names attention_stage_fma, two
    calls give the same bits, and it holds the bf16 bound against the plain
    version."""
    from torch.profiler import ProfilerActivity, profile

    qkv = torch.randn(2, 70, 3 * 2 * dh, device=cuda, generator=torch.Generator(cuda).manual_seed(dh)).bfloat16()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        out = A.fused_qkv_attention(qkv, 2)
        torch.cuda.synchronize()
    names = [e.key for e in prof.key_averages() if "attention_stage" in e.key]
    assert names and all("attention_stage_fma" in n for n in names), names
    again = A.fused_qkv_attention(qkv, 2)
    ref = A.fused_qkv_attention_reference(qkv.float(), 2, dh**-0.5)
    torch.cuda.synchronize()
    assert torch.equal(out, again)
    assert float((out.float() - ref).abs().max()) < 0.02


@pytest.mark.parametrize("conv", [(3, 96, 4, 4, 0, 1), (96, 96, 3, 1, 1, 1), (96, 96, 7, 1, 3, 96)],
                         ids=["stem-4x4-stride-4", "3x3", "depthwise-7x7"])
def test_bf16_conv_with_f32_parameters_rounds_once_on_the_card(cuda, conv):
    """A bf16 input through Conv2d with f32 parameters: each output is the
    f32 accumulator plus the bias rounded once, within half a bf16 step
    (taken at magnitude 1 below it) of the f64 value. (With bf16 parameters
    cuDNN rounds twice, a standing choice: ROADMAP C.9.)"""
    from eqxvision_tpu_torch.nn import Conv2d

    cin, cout, k, stride, pad, groups = conv
    layer = Conv2d(cin, cout, k, stride, pad, groups=groups, generator=torch.Generator().manual_seed(0), device=cuda)
    with torch.no_grad():
        layer.bias.mul_(64.0)
    x = torch.randn(2, 28, 28, cin, device=cuda, generator=torch.Generator(cuda).manual_seed(1)).bfloat16()
    with torch.no_grad():
        out = layer(x)
        ref = torch.nn.functional.conv2d(x.double().permute(0, 3, 1, 2), layer.weight.bfloat16().double(),
                                         layer.bias.double(), stride, pad, 1, groups).permute(0, 2, 3, 1)
    step = torch.exp2(torch.floor(torch.log2(ref.abs().clamp_min(1.0))) - 7)
    assert out.dtype == torch.bfloat16
    assert float(((out.double() - ref).abs() / step).max()) <= 0.51


# Non-finite values through the split-TF32 kernels. Every value the kernels
# split passes through tf32 rounding; a NaN or an infinity must come out as
# one. Three bit patterns: the card's canonical NaN (what its arithmetic
# makes, so what a LayerNorm of a non-finite row or a gelu of a NaN
# produces), the CPU's NaN and an infinity.
NON_FINITE_BITS = {"nan-7fffffff": 0x7FFFFFFF, "nan-7fc00000": 0x7FC00000, "inf": 0x7F800000}


def _plant(t, index, bits):
    t.view(torch.int32)[index] = bits


def _keeps_non_finite(out, ref, clean):
    """out is non-finite wherever the f64 plain version is, and within 1e-4
    of it on the entries ``clean`` that the planted value cannot reach."""
    bad = ~torch.isfinite(ref)
    assert bool(bad.any()), "the planted value reaches no output"
    assert bool((~torch.isfinite(out))[bad].all())
    assert float((out[clean].double() - ref[clean].double()).abs().max()) < 1e-4


@pytest.mark.parametrize("where", ["x", "fc2-weight"])
@pytest.mark.parametrize("bits", list(NON_FINITE_BITS))
def test_f32_mlp_half_keeps_non_finite_values(cuda, bits, where):
    """Planted in x, it reaches fc1's GEMM through the LayerNorm on A and
    fc2's as gelu's NaN (A without a LayerNorm); planted in fc2's weight, it
    is split as W."""
    x, residual, params = _mlp_inputs(cuda, 130, 96, False, torch.float32)
    if where == "x":
        _plant(x, (5, 3), NON_FINITE_BITS[bits])
    else:
        _plant(params[4], (2, 7), NON_FINITE_BITS[bits])
    out = M.fused_mlp_half(x, residual, *params)
    ref = _mlp_plain(x, residual, params)
    torch.cuda.synchronize()
    _keeps_non_finite(out, ref, torch.isfinite(ref))


@pytest.mark.parametrize("bits", list(NON_FINITE_BITS))
def test_f32_attention_half_keeps_non_finite_values(cuda, bits):
    """Planted in one token of image 1: its LayerNorm row, then its keys and
    values, reach every query of that image; images 0 and 2 stay as they were."""
    x, params = _ah_inputs(cuda, 3, 50, 128, torch.float32)
    _plant(x, (1, 10, 5), NON_FINITE_BITS[bits])
    out = AH.fused_attention_half(x, *params, 2)
    ref = _ah_plain(x, params, 2)
    torch.cuda.synchronize()
    _keeps_non_finite(out, ref, [0, 2])


@pytest.mark.parametrize("operand", ["q", "k", "v"])
@pytest.mark.parametrize("bits", list(NON_FINITE_BITS))
def test_f32_attention_keeps_non_finite_values(cuda, bits, operand):
    """K2 with a compact bias and K1 on the same heads, the value planted in
    one head of the second image: the other image stays as it was. (An
    infinite key gives the plain version -inf scores, hence finite rows, where
    the split makes it a NaN: non-finite there too, a stricter answer.)"""
    q, k, v, bias = _attn_inputs(cuda, (4, 197, 64, 2), torch.float32)
    _plant(dict(q=q, k=k, v=v)[operand], (1, 0, 20, 9), NON_FINITE_BITS[bits])
    out = A.attention(q, k, v, bias, 0.125)
    ref = A.attention_reference(q.double(), k.double(), v.double(), bias.double(), 0.125)
    qkv = torch.cat([t.permute(0, 2, 1, 3).reshape(2, 197, 128) for t in (q, k, v)], dim=-1)
    k1 = A.fused_qkv_attention(qkv, 2)
    k1_ref = A.attention_stage_reference(qkv.double(), 2, 0.125)
    torch.cuda.synchronize()
    _keeps_non_finite(out, ref, [0])
    _keeps_non_finite(k1, k1_ref, [0])
