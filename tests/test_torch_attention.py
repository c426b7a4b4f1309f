"""Fused-qkv attention in the PyTorch port against the JAX package.

The same seeded numpy inputs go through the JAX reference
(``_fused_qkv_reference``), the JAX Pallas kernels in interpret mode (K1
``_qkv_attn_kernel`` and K1p ``_qkv_attn_kernel_pair``) and the port's
public wrapper, which on a CPU tensor runs the plain torch version. f32
throughout, at the tolerance of the JAX kernel's own interpret-mode test.
The CUDA kernel itself is compared with the plain version in
tests/test_torch_kernels_cuda.py, on the card.
"""
import importlib
import os
from unittest import mock

import jax
import jax.experimental.pallas as pl
import jax.numpy as jnp
import numpy as np
import pytest
import torch

A = importlib.import_module("eqxvision_tpu.ops.attention")
T = importlib.import_module("eqxvision_tpu_torch.ops.attention")

CASES = [(b, l, heads) for b in (4, 3) for l in (197, 49) for heads in (3, 4)]


def _qkv(b, l, heads, seed, head_dim=64):
    return np.random.RandomState(seed).randn(b, l, 3 * heads * head_dim).astype(np.float32)


def _interpret(orig):
    def wrapper(*args, **kwargs):
        kwargs["interpret"] = True
        return orig(*args, **kwargs)

    return wrapper


@pytest.mark.parametrize("b,l,heads", CASES)
def test_plain_matches_jax_reference(b, l, heads):
    x = _qkv(b, l, heads, seed=b * 1000 + l * 10 + heads)
    ref = np.asarray(A._fused_qkv_reference(jnp.asarray(x), heads, 0.125))
    out = T.fused_qkv_attention_reference(torch.from_numpy(x), heads, 0.125).numpy()
    np.testing.assert_allclose(out, ref, atol=2e-5)


@pytest.mark.parametrize("pair", ["0", "1"], ids=["K1", "K1p"])
@pytest.mark.parametrize("b,l,heads", CASES)
def test_wrapper_matches_jax_kernel_interpret(b, l, heads, pair):
    x = _qkv(b, l, heads, seed=b * 1000 + l * 10 + heads)
    with mock.patch.object(pl, "pallas_call", _interpret(pl.pallas_call)), mock.patch.object(
        A, "_use_pallas", lambda *a: True
    ), mock.patch.dict(os.environ, {"EQXVISION_TPU_VIT_PAIR": pair}):
        kern = np.asarray(A._fused_qkv_attention(jnp.asarray(x), heads, 0.125))
    out = T.fused_qkv_attention(torch.from_numpy(x), heads, 0.125).numpy()
    np.testing.assert_allclose(out, kern, atol=2e-5)


def test_default_scale_matches_jax():
    x = _qkv(2, 49, 3, seed=5)
    ref = np.asarray(A.fused_qkv_attention(jnp.asarray(x), 3))
    out = T.fused_qkv_attention(torch.from_numpy(x), 3).numpy()
    np.testing.assert_allclose(out, ref, atol=2e-5)


@pytest.mark.parametrize("b,l,heads", [(2, 49, 3), (3, 197, 4)])
def test_backward_matches_jax_vjp(b, l, heads):
    x = _qkv(b, l, heads, seed=11 + heads)
    g = np.random.RandomState(12).randn(b, l, heads * 64).astype(np.float32)
    _, vjp = jax.vjp(lambda t: A._fused_qkv_reference(t, heads, 0.125), jnp.asarray(x))
    (ref,) = vjp(jnp.asarray(g))
    t = torch.from_numpy(x).requires_grad_(True)
    T.fused_qkv_attention(t, heads, 0.125).backward(torch.from_numpy(g))
    np.testing.assert_allclose(t.grad.numpy(), np.asarray(ref), atol=1e-5)


def test_cpu_path_launches_no_kernel():
    before = T.fused_qkv_attention.launches
    T.fused_qkv_attention(torch.zeros(1, 5, 3 * 128), 2)
    assert T.fused_qkv_attention.launches == before


@pytest.mark.parametrize(
    "shape,heads,device",
    [((2, 5, 100), 2, "cpu"), ((2, 5, 3 * 10), 3, "cpu"), ((5, 3 * 64), 1, "cpu"), ((1, 5, 3 * 64), 1, "meta")],
    ids=["not-3D", "D-not-divisible", "rank-2", "meta-device"],
)
def test_wrapper_rejects(shape, heads, device):
    with pytest.raises(ValueError):
        T.fused_qkv_attention(torch.zeros(shape, device=device), heads)
