"""The error model of split TF32 ("3xTF32"), emulated in torch on the CPU.

The port's f32 GEMM (``csrc/gemm_bf16.cuh``, under the three fused halves),
its f32 attention stage (``csrc/attention_stage.cuh``, under K1, K2 and
the ViT attention half) and its f32 whole-block Swin kernel
(``csrc/swin_block.cu``, K5) multiply f32 operands on the tensor cores by
splitting each into hi = tf32(x) and lo = tf32(x - hi), both rounded to
nearest (``cvt.rna.tf32.f32``: the low 13 of the 23 mantissa bits, ties
away from zero), and summing hi hi + hi lo + lo hi in f32. The card is
needed to run those kernels; this file emulates the same arithmetic with
torch's f32 products on the CPU and holds it against f64 within
``F32_BOUND`` (1e-4, chip_smoke.py's bound for every f32 kernel) at small
versions of the GEMM and attention cases the card checks, including rows
shifted by 1e3 before a LayerNorm, a head biased 300 log-units down and a
-inf bias over a whole block of keys; and it holds that a NaN or an
infinity among the operands gives non-finite outputs where f64 does. The
whole block is emulated as K5's f32 kernel computes it (each 32-deep
k-tile's products summed on their own, rows taken about a pivot) and held
against the port's plain version run in f64.
"""
import math

import numpy as np
import pytest
import torch
import torch.nn.functional as F

F32_BOUND = 1e-4


def _from_bits(*patterns):
    return torch.from_numpy(np.array(patterns, dtype=np.uint32).view(np.int32)).view(torch.float32)


def tf32_rna(x):
    """f32 rounded to TF32 to nearest, ties away from zero (sign-magnitude
    bits: adding half of the dropped unit to the magnitude rounds it up).
    For a finite x: a NaN's carry runs on into its sign."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def split(x):
    """hi = tf32(x), lo = tf32(x - hi); a NaN or an infinity is kept in hi
    as it is, as the kernels keep it. The card's arithmetic makes every NaN
    0x7FFFFFFF, which rounds to -0: so does x - hi here."""
    hi = torch.where(torch.isfinite(x), tf32_rna(x), x)
    rest = x - hi
    rest = torch.where(torch.isnan(rest), _from_bits(0x7FFFFFFF), rest)
    return hi, tf32_rna(rest)


def split_matmul(a, b):
    """a @ b in split TF32: the two small products first, then hi hi, each
    exact in f32 (11 by 11 significant bits) and summed in f32."""
    ah, al = split(a)
    bh, bl = split(b)
    return ah @ bl + al @ bh + ah @ bh


def _rand(rng, *shape, scale=1.0, shift=0.0):
    return torch.from_numpy((shift + scale * rng.standard_normal(shape)).astype(np.float32))


@pytest.mark.parametrize("magnitude", [1e-30, 1e-3, 1.0, 3e5, 1e30])
def test_split_holds_22_bits(magnitude):
    """x - hi - lo is at most 2^-22 |x|, hi and lo are TF32 values (low 13
    bits zero), and |lo| is at most half a TF32 unit of x."""
    x = _rand(np.random.default_rng(0), 4096, scale=magnitude)
    hi, lo = split(x)
    assert int((hi.view(torch.int32) & 0x1FFF).abs().max()) == 0
    assert int((lo.view(torch.int32) & 0x1FFF).abs().max()) == 0
    x64 = x.double()
    rest = (x64 - hi.double() - lo.double()).abs()
    assert bool((rest <= 2.0**-22 * x64.abs()).all())
    assert bool((lo.double().abs() <= 2.0**-11 * x64.abs()).all())


def test_rounding_is_to_nearest_ties_away():
    one = 1.0 + 2.0**-10  # a TF32 value: the unit of 1 is 2^-10
    x = torch.tensor([1.0 + 2.0**-11, -(1.0 + 2.0**-11), 1.0 + 2.0**-11 - 2.0**-20, one + 2.0**-11], dtype=torch.float32)
    assert tf32_rna(x).tolist() == [one, -one, 1.0, one + 2.0**-10]


# f32 bit patterns with the exponent all ones: the card's canonical NaN, the
# CPU's, a negative NaN, a NaN whose payload is only in the dropped bits,
# and both infinities
NON_FINITE_BITS = {"nan-7fffffff": 0x7FFFFFFF, "nan-7fc00000": 0x7FC00000, "nan-ffffffff": 0xFFFFFFFF,
                   "nan-7f800001": 0x7F800001, "inf": 0x7F800000, "minus-inf": 0xFF800000}


@pytest.mark.parametrize("name", list(NON_FINITE_BITS))
def test_split_keeps_non_finite_values(name):
    """A NaN or an infinity keeps its bits in hi, so its split product with
    any finite w (TF32-exact or not, zero or not) is non-finite. Rounded
    without that check, the card's NaN 0x7FFFFFFF carries through its
    exponent into 0x80000000, -0, and the product would be finite."""
    bits = NON_FINITE_BITS[name]
    x = _from_bits(bits)
    hi, _ = split(x)
    assert hi.view(torch.int32).numpy().view(np.uint32).tolist() == [bits]
    w = torch.tensor([[1.0, -3.0, 0.1, 1e-20, 0.0]])
    assert not bool(torch.isfinite(split_matmul(x.view(1, 1), w)).any())
    if name == "nan-7fffffff":
        assert tf32_rna(x).view(torch.int32).numpy().view(np.uint32).tolist() == [0x80000000]


@pytest.mark.parametrize("name", list(NON_FINITE_BITS))
def test_split_gemm_keeps_non_finite_rows(name):
    """A non-finite value planted in A, before and after a LayerNorm, makes
    the split product's row non-finite wherever the f64 product's is, and
    leaves every other row finite."""
    rng = np.random.default_rng(7)
    x = _rand(rng, 8, 64)
    w = _rand(rng, 32, 64, scale=0.125)
    lnw, lnb = _rand(rng, 64, scale=0.1, shift=1.0), _rand(rng, 64, scale=0.1)
    x[3, 5] = _from_bits(NON_FINITE_BITS[name])[0]
    for norm in (False, True):
        a = _layer_norm(x, lnw, lnb) if norm else x
        a64 = _layer_norm(x.double(), lnw.double(), lnb.double()) if norm else x.double()
        out, ref = split_matmul(a, w.t()), a64 @ w.double().t()
        assert torch.equal(torch.isfinite(out), torch.isfinite(ref))
        assert not bool(torch.isfinite(out[3]).any()) and bool(torch.isfinite(out[[0, 1, 2, 4, 5, 6, 7]]).all())


def _layer_norm(x, w, b, eps=1e-6):
    """The kernels' row statistics: the mean taken about the row's first
    value, the variance over the centred values."""
    pivot = x[..., :1]
    mean = pivot + (x - pivot).mean(-1, keepdim=True)
    var = ((x - mean) ** 2).mean(-1, keepdim=True)
    return (x - mean) / torch.sqrt(var + eps) * w + b


# (rows, K, N, shift of the rows, LayerNorm on A, epilogue): small versions
# of the fused halves' GEMMs at vit_base's widths (fc1 + gelu, fc2 +
# residual, qkv, proj) and convnext_tiny stage 1's (K = 96), with rows
# shifted by 1e3 before the LayerNorm.
GEMM_CASES = {
    "fc1-gelu-K768": (64, 768, 512, 0.0, True, "gelu"),
    "fc2-residual-K3072": (64, 3072, 256, 0.0, False, "residual"),
    "qkv-K768": (48, 768, 384, 0.0, True, "bias"),
    "proj-residual-K768": (48, 768, 256, 0.0, False, "residual"),
    "fc1-K96-shifted-1e3": (96, 96, 384, 1e3, True, "gelu"),
}


@pytest.mark.parametrize("case", list(GEMM_CASES))
def test_split_gemm_within_f32_bound(case):
    rows, k, n, shift, norm, epi = GEMM_CASES[case]
    rng = np.random.default_rng(k + n)
    x = _rand(rng, rows, k, shift=shift)
    w = _rand(rng, n, k, scale=k**-0.5)
    bias = _rand(rng, n, scale=0.1)
    residual = _rand(rng, rows, n)
    lnw, lnb = _rand(rng, k, scale=0.1, shift=1.0), _rand(rng, k, scale=0.1)

    def run(x, w, bias, residual, lnw, lnb, matmul):
        a = _layer_norm(x, lnw, lnb) if norm else x
        y = matmul(a, w.t()) + bias
        if epi == "gelu":
            return F.gelu(y)
        return residual + y if epi == "residual" else y

    # the LayerNorm in f32 on the card (the same here), then the split products
    out = run(x, w, bias, residual, lnw, lnb, split_matmul)
    ref = run(*(t.double() for t in (x, w, bias, residual, lnw, lnb)), torch.matmul)
    err = float((out.double() - ref).abs().max())
    assert err < F32_BOUND, err
    # and hi hi alone (plain TF32) would not hold it: the split is what the bound needs
    tf32 = run(x, w, bias, residual, lnw, lnb, lambda a, b: tf32_rna(a) @ tf32_rna(b))
    assert float((tf32.double() - ref).abs().max()) > F32_BOUND


def split_attention(q, k, v, bias, scale, chunk=64):
    """The f32 stage's arithmetic: S and P V in split TF32 over chunks of
    keys, an online softmax in f32 (a row whose keys so far are all -inf is
    exponentiated against 0), O divided by the row sum at the end."""
    b, n, _ = q.shape
    o = torch.zeros_like(q)
    m = torch.full((b, n, 1), -math.inf)
    l = torch.zeros(b, n, 1)
    for j0 in range(0, n, chunk):
        kc, vc = k[:, j0:j0 + chunk], v[:, j0:j0 + chunk]
        s = split_matmul(q, kc.transpose(1, 2)) * scale
        if bias is not None:
            s = s + bias[:, :, j0:j0 + chunk]
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        m_ref = torch.where(m_new == -math.inf, torch.zeros_like(m_new), m_new)
        alpha = torch.exp(m - m_ref)
        p = torch.exp(s - m_ref)
        l = l * alpha + p.sum(-1, keepdim=True)
        o = o * alpha + split_matmul(p, vc)
        m = m_new
    return o / l


def _attention_f64(q, k, v, bias, scale):
    s = q.double() @ k.double().transpose(1, 2) * scale
    if bias is not None:
        s = s + bias.double()
    return torch.softmax(s, -1) @ v.double()


# (B, L, Dh, bias): vit_base's 197 tokens at head dim 64 (K1, the half), a
# length past one chunk at head dims 16 and 128, a compact bias (K2), a head
# biased 300 log-units down, and -inf over the first 256 keys of some rows.
ATTN_CASES = {"L197-Dh64": (4, 197, 64, None), "L257-Dh16": (2, 257, 16, None), "L100-Dh128": (2, 100, 128, None),
              "L197-Dh64-bias": (4, 197, 64, "bias"), "L49-Dh32-head-300-down": (6, 49, 32, "low"),
              "L300-Dh64-minus-inf-block": (2, 300, 64, "inf")}


@pytest.mark.parametrize("case", list(ATTN_CASES))
def test_split_attention_within_f32_bound(case):
    b, n, dh, kind = ATTN_CASES[case]
    rng = np.random.default_rng(n + dh)
    q, k, v = (_rand(rng, b, n, dh) for _ in range(3))
    bias = None if kind is None else _rand(rng, b, n, n)
    if kind == "low":
        bias[1] -= 300.0
    elif kind == "inf":
        bias[1, :40, :256] = -math.inf
    scale = dh**-0.5
    out = split_attention(q, k, v, bias, scale)
    ref = _attention_f64(q, k, v, bias, scale)
    assert bool(torch.isfinite(out).all())
    err = float((out.double() - ref).abs().max())
    assert err < F32_BOUND, err


# ---- the whole Swin block (K5's f32 kernel, csrc/swin_block.cu) ----


def split_linear(a, w, k_tile=32, matmul=split_matmul):
    """a @ w.T as the f32 block kernel computes its four products: split
    TF32, each 32-deep k-tile's three products summed on their own (on the
    card the tensor cores' accumulator, which rounds toward zero), then added
    to the running sum in f32."""
    out = None
    for k0 in range(0, a.shape[-1], k_tile):
        part = matmul(a[..., k0:k0 + k_tile], w[:, k0:k0 + k_tile].t())
        out = part if out is None else out + part
    return out


def _stats(d, eps):
    """A row's mean, then its rstd from the variance over the centred values."""
    mean = d.mean(-1, keepdim=True)
    return mean, torch.rsqrt(((d - mean) ** 2).mean(-1, keepdim=True) + eps)


def split_swin_block(xw, p, bias, heads, scale, eps, postnorm, gs, matmul=split_matmul):
    """The f32 block kernel's arithmetic on (N, nW, L, C) windows, in f32.
    Each row is taken about a pivot, its first value: LN1 of x and LN2 of h
    centre x - pivot and h - pivot (so a row of 1e3 + N(0, 1) keeps its
    variance and its mean to f32's precision of an O(1) value), h is kept
    as h - pivot, and the pivot is added back once, to the output. The four
    products by split_linear with their biases added in f32; per head S and
    P V by split_matmul, s (v2: times gs / |q| and 1 / |k|) times the scale
    plus the bias, e = exp(s - max) unnormalised and O divided by the row
    sum; fc2 summed from zero; gelu exact."""
    n, nw, length, c = xw.shape
    dh = c // heads
    pivot = xw[..., :1]

    def norm(d, w, b):
        mean, rstd = _stats(d, eps)
        return (d - mean) * rstd * w + b

    a = xw if postnorm else norm(xw - pivot, p.norm1_w, p.norm1_b)
    qkv = split_linear(a, p.qkv_w, matmul=matmul) + p.qkv_b
    q, k, v = (t.reshape(n, nw, length, heads, dh).transpose(2, 3) for t in qkv.split(c, dim=-1))
    s = matmul(q, k.transpose(-1, -2))
    if gs is not None:
        q_scale = gs.reshape(heads, 1, 1) * scale / q.norm(dim=-1, keepdim=True).clamp_min(1e-12)
        k_inv = 1.0 / k.norm(dim=-1, keepdim=True).clamp_min(1e-12)
        s = s * q_scale * k_inv.transpose(-1, -2) + bias
    else:
        s = s * scale + bias
    e = torch.exp(s - s.amax(-1, keepdim=True))
    o = matmul(e, v) / e.sum(-1, keepdim=True)
    o = o.transpose(2, 3).reshape(n, nw, length, c)
    r = split_linear(o, p.proj_w, matmul=matmul) + p.proj_b
    h_rel = (xw - pivot) + (norm(r, p.norm1_w, p.norm1_b) if postnorm else r)  # h - pivot
    mlp_in = pivot + h_rel if postnorm else norm(h_rel, p.norm2_w, p.norm2_b)
    hidden = F.gelu(split_linear(mlp_in, p.fc1_w, matmul=matmul) + p.fc1_b)
    y = split_linear(hidden, p.fc2_w, matmul=matmul) + p.fc2_b
    return pivot + (h_rel + (norm(y, p.norm2_w, p.norm2_b) if postnorm else y))


# (C, heads, windows, L, v2, what): small blocks at head dims 32 and 16, L 49
# and 64; a padding token (a zero row of x, as the map's padding reads); a
# head biased 300 log-units down; rows shifted by 1e3 before LN1; NaN and
# inf planted in one token of the second window.
BLOCK_CASES = {
    "v1-C96-Dh32-L49": (96, 3, 3, 49, False, None),
    "v2-C64-Dh16-L64": (64, 4, 2, 64, True, None),
    "v1-C32-Dh16-L64-padding-token": (32, 2, 4, 64, False, "padding"),
    "v2-C96-Dh32-L49-padding-token": (96, 3, 2, 49, True, "padding"),
    "v1-C64-Dh32-L49-head-300-down": (64, 2, 3, 49, False, "low"),
    "v1-C96-Dh32-L49-shifted-1e3": (96, 3, 2, 49, False, "shift"),
    "v1-C64-Dh16-L49-nan-in-x": (64, 4, 3, 49, False, "nan"),
    "v2-C64-Dh32-L64-inf-in-x": (64, 2, 3, 64, True, "inf"),
}


@pytest.mark.parametrize("case", list(BLOCK_CASES))
def test_split_swin_block_within_f32_bound(case):
    from eqxvision_tpu_torch.ops import window_attention as W

    c, heads, nw, length, v2, what = BLOCK_CASES[case]
    rng = np.random.default_rng(c + length + nw)
    hidden = 4 * c
    p = W.SwinBlockParams(
        _rand(rng, c, scale=0.1, shift=1.0), _rand(rng, c, scale=0.1), _rand(rng, 3 * c, c, scale=c**-0.5),
        _rand(rng, 3 * c, scale=0.1), _rand(rng, c, c, scale=c**-0.5), _rand(rng, c, scale=0.1),
        _rand(rng, c, scale=0.1, shift=1.0), _rand(rng, c, scale=0.1), _rand(rng, hidden, c, scale=c**-0.5),
        _rand(rng, hidden, scale=0.1), _rand(rng, c, hidden, scale=hidden**-0.5), _rand(rng, c, scale=0.1),
    )
    xw = _rand(rng, 1, nw, length, c, scale=0.5, shift=1e3 if what == "shift" else 0.0)
    bias = _rand(rng, nw, heads, length, length)
    gs = torch.full((heads,), 10.0) if v2 else None
    scale = 1.0 if v2 else (c // heads) ** -0.5
    if what == "padding":
        xw[0, 1, length - 3:] = 0.0
    elif what == "low":
        bias[:, 1] -= 300.0
    elif what in ("nan", "inf"):
        xw[0, 1, 7, 5] = math.nan if what == "nan" else math.inf

    out = split_swin_block(xw, p, bias, heads, scale, 1e-5, v2, gs)
    ref = W.fused_swin_block_reference(xw.double(), W.SwinBlockParams(*(t.double() for t in p)), bias.double(),
                                       heads, scale, 1e-5, v2, None if gs is None else gs.double())
    assert out.dtype == torch.float32 and out.shape == xw.shape
    finite = torch.isfinite(ref)
    if what in ("nan", "inf"):
        # the planted value reaches every token of its window and no other
        assert not bool(finite[0, 1].any()) and bool(finite[0, [0, 2]].all())
        assert torch.equal(torch.isfinite(out), finite)
    else:
        assert bool(finite.all()) and bool(torch.isfinite(out).all())
    err = float((out.double() - ref)[finite].abs().max())
    assert err < F32_BOUND, err
    # and one TF32 product (hi hi) in place of the split would not hold it
    tf32 = split_swin_block(xw, p, bias, heads, scale, 1e-5, v2, gs, matmul=lambda a, b: tf32_rna(a) @ tf32_rna(b))
    assert float((tf32.double() - ref)[finite].abs().max()) > F32_BOUND
