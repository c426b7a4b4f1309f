"""The port's CUDA kernels against their plain torch versions, on the card.

Every test here needs a CUDA card and skips without one. On the card, run
``python -m pytest --noconftest -m cuda tests/test_torch_kernels_cuda.py``
(``--noconftest``: the suite's conftest imports JAX, which the port's
machine need not have). This file imports only torch and the port.
"""
import pytest
import torch

from eqxvision_tpu_torch.ops import attention as A
from eqxvision_tpu_torch.ops import window_attention as W

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
        ((1, 4096, 3 * 64), 1, torch.bfloat16, RuntimeError),
    ],
    ids=["float16", "head_dim-160", "too-long-for-shared-memory"],
)
def test_fused_qkv_kernel_refuses(cuda, shape, heads, dtype, error):
    with pytest.raises(error):
        A.fused_qkv_attention(torch.zeros(shape, device=cuda, dtype=dtype), heads)


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
