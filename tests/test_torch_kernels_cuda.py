"""The port's CUDA kernels against their plain torch versions, on the card.

Every test here needs a CUDA card and skips without one. On the card, run
``python -m pytest --noconftest -m cuda tests/test_torch_kernels_cuda.py``
(``--noconftest``: the suite's conftest imports JAX, which the port's
machine need not have). This file imports only torch and the port.
"""
import pytest
import torch

from eqxvision_tpu_torch.ops import attention as A

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
