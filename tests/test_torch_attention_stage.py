"""The attention stage's plain version against the JAX package.

K1's entry (``ops.fused_qkv_attention``) and the fused attention half run
one CUDA stage (``csrc/attention_stage.cuh``), and their plain versions run
one function, ``attention_stage_reference``. The same seeded numpy qkv goes
through the JAX reference (``_fused_qkv_reference``), the JAX Pallas
kernels in interpret mode (K1 ``_qkv_attn_kernel`` and, at head dim 64, K1p
``_qkv_attn_kernel_pair``) and the port's plain version, at the lengths
where the CUDA stage changes branch: one key; a 64-key piece less one,
exactly, more one; 200 and 256 (one pass); 257 (two blocks of 256 keys: two
passes); 577 (vit_base at 384 px). Head dims 16, 64 and 128.

Tolerances. f32: 2e-5, as tests/test_torch_attention.py (both sides in
f32, summed in another order). bf16: both sides round p and the output to
bf16 at the same points, but sum in another order, which can carry a value
across a rounding midpoint: one bf16 step of the output (2^-7 relative),
plus 2^-9 for outputs near zero, where a p that flips by one step moves
the sum by far less. The CUDA stage itself is held against the plain
version in tests/test_torch_kernels_cuda.py, on the card.
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
from eqxvision_tpu_torch.ops import attention_half as AH  # noqa: E402

LENGTHS = (1, 63, 64, 65, 200, 256, 257, 577)
HEAD_DIMS = (16, 64, 128)
HEADS = 2
TOL = {"f32": dict(atol=2e-5, rtol=0.0), "bf16": dict(atol=2**-9, rtol=2**-7)}


def _qkv(l, dh, dtype):
    x = np.random.RandomState(l * 1000 + dh).randn(1, l, 3 * HEADS * dh).astype(np.float32)
    if dtype == "f32":
        return jnp.asarray(x), torch.from_numpy(x)
    return jnp.asarray(x).astype(jnp.bfloat16), torch.from_numpy(x).bfloat16()


def _interpret(orig):
    def wrapper(*args, **kwargs):
        kwargs["interpret"] = True
        return orig(*args, **kwargs)

    return wrapper


def _np(a):
    return np.asarray(a.astype(jnp.float32)) if isinstance(a, jnp.ndarray) else a.float().numpy()


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("dh", HEAD_DIMS)
@pytest.mark.parametrize("l", LENGTHS)
def test_stage_reference_matches_jax_reference_and_k1(l, dh, dtype):
    jx, tx = _qkv(l, dh, dtype)
    scale = dh**-0.5
    out = _np(T.attention_stage_reference(tx, HEADS, scale))
    ref = _np(A._fused_qkv_reference(jx, HEADS, scale))
    np.testing.assert_allclose(out, ref, **TOL[dtype])
    with mock.patch.object(pl, "pallas_call", _interpret(pl.pallas_call)), mock.patch.object(
        A, "_use_pallas", lambda *a: True
    ), mock.patch.dict("os.environ", {"EQXVISION_TPU_VIT_PAIR": "0"}):  # K1, also at head dim 64
        kern = _np(A._fused_qkv_attention(jx, HEADS, scale))
    np.testing.assert_allclose(out, kern, **TOL[dtype])


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("l", LENGTHS)
def test_stage_reference_matches_k1p_interpret(l, dtype):
    """The pair kernel K1p (two 64-wide heads a 128-lane slab), the JAX
    package's default at head dim 64."""
    jx, tx = _qkv(l, 64, dtype)
    out = _np(T.attention_stage_reference(tx, HEADS, 0.125))
    with mock.patch.object(pl, "pallas_call", _interpret(pl.pallas_call)), mock.patch.object(
        A, "_use_pallas", lambda *a: True
    ), mock.patch.dict("os.environ", {"EQXVISION_TPU_VIT_PAIR": "1"}):
        kern = _np(A._fused_qkv_attention(jx, HEADS, 0.125))
    np.testing.assert_allclose(out, kern, **TOL[dtype])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("l", [197, 257])
def test_half_and_k1_plain_versions_agree_bit_for_bit(monkeypatch, l, dtype):
    """The attention half's plain version computes its stage with the same
    function as K1's: the qkv it hands the stage gives the same bits through
    ``fused_qkv_attention_reference``."""
    d, heads = 96, 6
    rng = np.random.RandomState(l)
    x = torch.from_numpy(rng.randn(2, l, d).astype(np.float32)).to(dtype)
    params = [torch.from_numpy(a.astype(np.float32)).to(dtype) for a in (
        1 + 0.1 * rng.randn(d), 0.1 * rng.randn(d), rng.randn(3 * d, d) * d**-0.5, 0.1 * rng.randn(3 * d),
        rng.randn(d, d) * d**-0.5, 0.1 * rng.randn(d))]
    seen = []

    def recording(qkv, num_heads, scale):
        o = T.attention_stage_reference(qkv, num_heads, scale)
        seen.append((qkv, o))
        return o

    monkeypatch.setattr(AH, "attention_stage_reference", recording)
    AH.attention_half_reference(x, *params, heads, 0.25)
    (qkv, o), = seen
    assert qkv.dtype == dtype and qkv.shape == (2, l, 3 * d)
    assert torch.equal(T.fused_qkv_attention_reference(qkv, heads, 0.25), o)
    assert torch.equal(T.fused_qkv_attention(qkv, heads, 0.25), o)  # on the CPU the op runs its plain version
