"""The public ``ops.attention`` of the PyTorch port against the JAX package.

The same seeded numpy inputs go through the JAX reference
(``attention_reference``), the JAX Pallas kernels behind its public
``attention`` (``_attn_kernel`` and ``kernel4`` via ``_attention_pallas``)
in interpret mode, and the port's ``ops.attention``, which on a CPU tensor
runs its plain torch version. f32 at atol 2e-5, the tolerance of the JAX
kernel's own interpret-mode test (tests/test_ops.py). Also: gradients
against ``jax.vjp`` of the reference, the compact bias reaching the op
uncopied, and long rows (N 65 to 577, the lengths where the CUDA kernel
runs the attention stage in one pass or two) in f32 and bf16 with and
without a bias, and a bias of -inf over the first 256 keys of some rows.
bf16: atol 2^-9 and rtol 2^-7, as tests/test_torch_attention_stage.py
states them: both sides round p and the output to bf16 at the same points
but sum in another order, which can carry a value across a rounding
midpoint (one bf16 step, 2^-7 relative), and outputs near zero move by far
less. The CUDA kernel is compared with the plain version in
tests/test_torch_kernels_cuda.py, on the card.
"""
import contextlib
import importlib
from unittest import mock

import jax
import jax.experimental.pallas as pl
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eqxvision_tpu_torch import ops

A = importlib.import_module("eqxvision_tpu.ops.attention")
T = importlib.import_module("eqxvision_tpu_torch.ops.attention")


def _rand(*shape, seed):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _interpret(orig, calls):
    def wrapper(*args, **kwargs):
        calls.append(1)
        kwargs["interpret"] = True
        return orig(*args, **kwargs)

    return wrapper


@contextlib.contextmanager
def _jax_kernels(calls):
    with mock.patch.object(pl, "pallas_call", _interpret(pl.pallas_call, calls)), mock.patch.object(
        A, "_use_pallas", lambda *a: True
    ):
        yield


@pytest.mark.parametrize("jax_path", ["reference", "pallas-interpret"])
def test_compact_bias_case_of_the_jax_kernel_test(jax_path):
    """tests/test_ops.py's kernel case: (6, 49, 32), bias (3, 49, 49) shared
    over two batch repeats, scale 0.17; the port takes it with lead dims
    (2, 3), so the bias stays (3, 49, 49)."""
    q, k, v = (_rand(6, 49, 32, seed=s) for s in (1, 2, 3))
    bias = _rand(3, 49, 49, seed=4)
    if jax_path == "pallas-interpret":
        calls = []
        with _jax_kernels(calls):
            ref = np.asarray(A._attention_pallas(*map(jnp.asarray, (q, k, v, bias)), scale=0.17))
        assert len(calls) == 1
    else:
        lead = [jnp.asarray(t.reshape(2, 3, 49, 32)) for t in (q, k, v)]
        ref = np.asarray(A.attention_reference(*lead, jnp.asarray(bias), 0.17)).reshape(6, 49, 32)
    out = ops.attention(
        *(torch.from_numpy(t.reshape(2, 3, 49, 32)) for t in (q, k, v)), torch.from_numpy(bias), 0.17
    ).reshape(6, 49, 32)
    np.testing.assert_allclose(out.numpy(), ref, atol=2e-5)


BIASES = {"3x17x17": (3, 17, 17), "1x3x17x17": (1, 3, 17, 17), "2x3x17x17": (2, 3, 17, 17), "none": None}


@pytest.mark.parametrize("jax_path", ["reference", "pallas-interpret"])
@pytest.mark.parametrize("bias_shape", list(BIASES.values()), ids=list(BIASES))
def test_lead_dims_match_jax(bias_shape, jax_path):
    q, k, v = (_rand(2, 3, 17, 8, seed=s) for s in (5, 6, 7))
    bias = None if bias_shape is None else _rand(*bias_shape, seed=8)
    jargs = [jnp.asarray(t) for t in (q, k, v)] + [None if bias is None else jnp.asarray(bias)]
    calls = []
    if jax_path == "pallas-interpret":
        with _jax_kernels(calls):
            ref = np.asarray(A.attention(*jargs, 0.3))
        assert len(calls) == 1
    else:
        ref = np.asarray(A.attention_reference(*jargs, 0.3))
    out = ops.attention(*(torch.from_numpy(t) for t in (q, k, v)), None if bias is None else torch.from_numpy(bias), 0.3)
    assert out.shape == (2, 3, 17, 8)
    np.testing.assert_allclose(out.numpy(), ref, atol=2e-5)


LONG_N = (65, 197, 256, 257, 577)
LONG_HEAD_DIMS = (16, 64, 128)
TOL = {"f32": dict(atol=2e-5, rtol=0.0), "bf16": dict(atol=2**-9, rtol=2**-7)}


def _long_inputs(n, dh, with_bias, dtype, bias_rows=None):
    """q, k, v (2, 3, n, dh) from seeded numpy, in dtype for both frameworks,
    and a compact f32 bias (3, n, n) or None; bias_rows, if given, sets the
    bias of those rows of head 1 to -inf over keys 0-255."""
    q, k, v = (_rand(2, 3, n, dh, seed=n * 1000 + dh * 10 + s) for s in range(3))
    bias = _rand(3, n, n, seed=n * 1000 + dh * 10 + 3) if with_bias else None
    if bias_rows is not None:
        bias[1, bias_rows, :256] = -np.inf
    jdt, tdt = (jnp.float32, torch.float32) if dtype == "f32" else (jnp.bfloat16, torch.bfloat16)
    jx = [jnp.asarray(t).astype(jdt) for t in (q, k, v)] + [None if bias is None else jnp.asarray(bias)]
    tx = [torch.from_numpy(t).to(tdt) for t in (q, k, v)] + [None if bias is None else torch.from_numpy(bias)]
    return jx, tx


def _np(a):
    return np.asarray(a.astype(jnp.float32)) if isinstance(a, jnp.ndarray) else a.float().numpy()


def _jax_pallas(q, k, v, bias, scale):
    """The JAX Pallas kernels behind ``attention`` on (B, N, Dh), in interpret mode."""
    calls = []
    with _jax_kernels(calls):
        out = A._attention_pallas(*(t.reshape(6, *t.shape[2:]) for t in (q, k, v)), bias, scale)
    assert len(calls) == 1
    return out.reshape(q.shape)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("with_bias", [True, False], ids=["compact-bias", "no-bias"])
@pytest.mark.parametrize("dh", LONG_HEAD_DIMS)
@pytest.mark.parametrize("n", LONG_N)
def test_long_rows_match_jax_reference_and_kernels(n, dh, with_bias, dtype):
    """Lead dims (2, 3), so that a (3, N, N) bias reaches the op compact."""
    (jq, jk, jv, jb), (tq, tk, tv, tb) = _long_inputs(n, dh, with_bias, dtype)
    scale = dh**-0.5
    out = _np(ops.attention(tq, tk, tv, tb, scale))
    np.testing.assert_allclose(out, _np(A.attention_reference(jq, jk, jv, jb, scale)), **TOL[dtype])
    np.testing.assert_allclose(out, _np(_jax_pallas(jq, jk, jv, jb, scale)), **TOL[dtype])


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_minus_inf_bias_over_the_first_block(dtype):
    """N = 300 with a bias of -inf on keys 0-255 of some rows and finite
    after them: every such row still has finite scores, so the output is
    finite and equals the reference's."""
    (jq, jk, jv, jb), (tq, tk, tv, tb) = _long_inputs(300, 64, True, dtype, bias_rows=slice(0, 40))
    out = _np(ops.attention(tq, tk, tv, tb, 0.125))
    assert np.isfinite(out).all()
    np.testing.assert_allclose(out, _np(A.attention_reference(jq, jk, jv, jb, 0.125)), **TOL[dtype])
    np.testing.assert_allclose(out, _np(_jax_pallas(jq, jk, jv, jb, 0.125)), **TOL[dtype])


def test_plain_matches_jax_reference_default_scale():
    q, k, v = (_rand(4, 9, 16, seed=s) for s in (9, 10, 11))
    bias = _rand(9, 9, seed=12)
    ref = np.asarray(A.attention_reference(*map(jnp.asarray, (q, k, v, bias))))
    np.testing.assert_allclose(ops.attention_reference(*map(torch.from_numpy, (q, k, v, bias))).numpy(), ref, atol=2e-5)
    np.testing.assert_allclose(ops.attention(*map(torch.from_numpy, (q, k, v, bias))).numpy(), ref, atol=2e-5)


@pytest.mark.parametrize("bias_shape", [(3, 17, 17), None], ids=["compact-bias", "no-bias"])
def test_backward_matches_jax_vjp(bias_shape):
    arrays = [_rand(2, 3, 17, 8, seed=s) for s in (13, 14, 15)]
    if bias_shape is not None:
        arrays.append(_rand(*bias_shape, seed=16))
    g = _rand(2, 3, 17, 8, seed=17)

    def ref_fn(q, k, v, bias=None):
        return A.attention_reference(q, k, v, bias, 0.25)

    _, vjp = jax.vjp(ref_fn, *map(jnp.asarray, arrays))
    refs = vjp(jnp.asarray(g))
    leaves = [torch.from_numpy(a).requires_grad_(True) for a in arrays]
    args = leaves if bias_shape is not None else leaves + [None]
    ops.attention(*args, 0.25).backward(torch.from_numpy(g))
    for t, ref in zip(leaves, refs):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(ref), atol=1e-5)


@pytest.mark.parametrize(
    "bias_shape,flat_shape",
    [((3, 17, 17), (3, 17, 17)), ((1, 1, 3, 17, 17), (3, 17, 17)), ((17, 17), (1, 17, 17)),
     ((2, 1, 17, 17), (6, 17, 17)), ((1, 17), (1, 17, 17))],
    ids=["suffix", "leading-ones", "shared", "not-a-suffix", "row-broadcast"],
)
def test_bias_reaches_the_op_compact(bias_shape, flat_shape, monkeypatch):
    """A bias whose lead dims are a suffix of q's reaches the op as (Bb, N, N);
    any other is expanded to (B, N, N), as in the JAX package."""
    seen = []

    def record(q, k, v, bias, scale):
        seen.append(tuple(bias.shape))
        return T._attention_flat_reference(q, k, v, bias, scale)

    monkeypatch.setattr(T, "_attention_forward", record)
    q = torch.zeros(2, 3, 17, 8)
    ops.attention(q, q, q, torch.zeros(bias_shape))
    assert seen == [flat_shape]


def test_cpu_path_launches_no_kernel():
    before = T.attention.launches
    q = torch.zeros(2, 5, 8)
    ops.attention(q, q, q, torch.zeros(2, 5, 5))
    assert T.attention.launches == before


@pytest.mark.parametrize(
    "q_shape,k_shape,device",
    [((2, 5, 8), (2, 6, 8), "cpu"), ((8,), (8,), "cpu"), ((2, 5, 8), (2, 5, 8), "meta")],
    ids=["k-longer", "rank-1", "meta-device"],
)
def test_wrapper_rejects(q_shape, k_shape, device):
    q, k = torch.zeros(q_shape, device=device), torch.zeros(k_shape, device=device)
    with pytest.raises(ValueError):
        ops.attention(q, k, k)
