"""The fused attention half of the PyTorch port against the JAX prototypes.

The port's ``ops.fused_attention_half`` (on a CPU tensor its plain version,
``attention_half_reference``) takes the same seeded numpy inputs as the
Pallas prototypes it ports, run in interpret mode with ``pl.pallas_call``
patched to pass ``interpret=True``; the scripts are imported as they are:

- P2 ``attn_fused`` (scripts/ablate_vit2.py), one and two images a program;
- P4 ``attn_half_fused`` (scripts/ablate_vit4.py), the same body.

The scripts fix 12 heads and a scale of 0.125 (their D = 768), so the
small cases take D = 192 (head dim 16) and pass that scale to the port;
one case runs at the full width, D = 768 and L = 197. L = 17 is ragged.
f32 at atol and rtol 2e-5: both sides take the LayerNorm statistics, the
scores and softmax and all products in f32, in another order. The JAX
weights are (in, out) and go to the port transposed, as its ``Linear``
stores them. Also: the bf16 rounding choice (the projection, its bias and
the residual summed in f32 and rounded once, as the prototype does),
``bqkv=None``, the gradient, and the refusals. The CUDA kernel itself is
compared with the plain version in tests/test_torch_kernels_cuda.py.
"""
import functools
import importlib
import importlib.util
import os

import jax.experimental.pallas as pl
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from eqxvision_tpu_torch.ops import attention_half as T

A = importlib.import_module("eqxvision_tpu_torch.ops.attention")
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = dict(atol=2e-5, rtol=2e-5)
HEADS = 12  # the scripts' H
SCALE = 0.125  # the scripts' SCALE, (768 // 12) ** -0.5


@functools.lru_cache(maxsize=None)
def _script(name):
    spec = importlib.util.spec_from_file_location(name, os.path.join(REPO, "scripts", f"{name}.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture
def interpret(monkeypatch):
    calls = []
    orig = pl.pallas_call

    def wrapper(*args, **kwargs):
        calls.append(1)
        kwargs["interpret"] = True
        return orig(*args, **kwargs)

    monkeypatch.setattr(pl, "pallas_call", wrapper)
    return calls


def _params(d, seed):
    """LayerNorm affine, qkv and proj (JAX layout, (in, out)) at the models'
    scales, f32."""
    rng = np.random.RandomState(seed)
    p = dict(
        ln1w=1.0 + 0.3 * rng.randn(d), ln1b=0.2 * rng.randn(d),
        wqkv=rng.randn(d, 3 * d) * d**-0.5, bqkv=0.2 * rng.randn(3 * d),
        wproj=rng.randn(d, d) * d**-0.5, bproj=0.2 * rng.randn(d),
    )
    return {k: v.astype(np.float32) for k, v in p.items()}


def _torch_args(p, weight_dtype=torch.float32):
    """The op's arguments after x: weights transposed to (out, in), the
    LayerNorm affine and weights in ``weight_dtype``, the biases in f32."""
    t = {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in p.items()}
    w = lambda k: t[k].T.contiguous().to(weight_dtype)  # noqa: E731
    return [t["ln1w"].to(weight_dtype), t["ln1b"].to(weight_dtype), w("wqkv"), t["bqkv"], w("wproj"), t["bproj"]]


def _port(x, p, dtype=torch.float32, weight_dtype=torch.float32):
    return T.fused_attention_half(torch.from_numpy(x).to(dtype), *_torch_args(p, weight_dtype), HEADS, SCALE)


def _jax(p):
    return {k: jnp.asarray(v) for k, v in p.items()}


CASES = {  # (script, function, images per program, (B, L, D))
    "P2-g1-L17": ("ablate_vit2", "attn_fused", 1, (2, 17, 192)),
    "P2-g2-L17": ("ablate_vit2", "attn_fused", 2, (4, 17, 192)),
    "P4-L17": ("ablate_vit4", "attn_half_fused", 1, (2, 17, 192)),
    "P2-g1-vit_base-width": ("ablate_vit2", "attn_fused", 1, (1, 197, 768)),
}


@pytest.mark.parametrize("case", list(CASES))
def test_matches_prototype_interpret(case, interpret):
    script, fn, g, (b, l, d) = CASES[case]
    x = np.random.RandomState(b * l).randn(b, l, d).astype(np.float32)
    p = _params(d, seed=d)
    ref = np.asarray(getattr(_script(script), fn)(jnp.asarray(x), _jax(p), g))
    assert len(interpret) == 1
    out = _port(x, p)
    assert out.shape == (b, l, d) and out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), ref, **TOL)


def test_without_qkv_bias_matches_zero_bias_prototype(interpret):
    x = np.random.RandomState(1).randn(2, 17, 192).astype(np.float32)
    p = _params(192, seed=2)
    p["bqkv"] = np.zeros_like(p["bqkv"])
    ref = np.asarray(_script("ablate_vit2").attn_fused(jnp.asarray(x), _jax(p), 1))
    args = _torch_args(p)
    args[3] = None
    out = T.fused_attention_half(torch.from_numpy(x), *args, HEADS, SCALE)
    np.testing.assert_allclose(out.numpy(), ref, **TOL)


def _bf16_case():
    """bf16 x, LayerNorm affine and weights as the prototype takes them
    (values rounded to bf16); the biases in f32."""
    rng = np.random.RandomState(3)
    x = rng.randn(2, 33, 192).astype(np.float32)
    p = _params(192, seed=4)
    bf = lambda a: np.array(jnp.asarray(a, jnp.bfloat16).astype(jnp.float32))  # noqa: E731
    x = bf(x)
    p.update({k: bf(p[k]) for k in ("ln1w", "ln1b", "wqkv", "wproj")})
    ref = np.asarray(_script("ablate_vit2").attn_fused(jnp.asarray(x, jnp.bfloat16), _jax(p), 1).astype(jnp.float32))
    return x, p, ref


def test_bf16_matches_p2_interpret(interpret):
    x, p, ref = _bf16_case()
    out = _port(x, p, torch.bfloat16, torch.bfloat16)
    assert out.dtype == torch.bfloat16
    np.testing.assert_allclose(out.float().numpy(), ref, atol=2e-2, rtol=2e-2)


def test_bf16_rounding_follows_prototype(interpret):
    """In bf16 the op rounds where the prototype does: the projection, its
    bias and the residual are summed in f32 and rounded once. Its output is
    within one bf16 step of the prototype's, in a small share of outputs
    (0.37% here). The unfused composition, which rounds the projection's
    output and then adds the residual in bf16, is off in a far larger share
    (33% here), also by up to one step."""
    x, p, ref = _bf16_case()
    lnw, lnb, wqkv, bqkv, wproj, bproj = _torch_args(p, torch.bfloat16)
    xb = torch.from_numpy(x).bfloat16()
    new = T.fused_attention_half(xb, lnw, lnb, wqkv, bqkv, wproj, bproj, HEADS, SCALE).float().numpy()
    # the old composition: LayerNorm, qkv, attention, proj, each rounded to bf16, then the add in bf16
    a = T.layer_norm_reference(xb, lnw, lnb, 1e-6)
    o = A.fused_qkv_attention_reference(F.linear(a, wqkv, bqkv.bfloat16()), HEADS, SCALE)
    old = (xb + F.linear(o, wproj, bproj.bfloat16())).float().numpy()
    # one bf16 step at each output's magnitude, taken at 1 for the smaller ones
    step = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(ref), 1.0))) - 7)
    new_off, old_off = np.abs(new - ref) / step, np.abs(old - ref) / step
    new_share, old_share = float((new_off > 0).mean()), float((old_off > 0).mean())
    print(f"outputs off the bf16 prototype: op {new_share:.2%} (max {new_off.max():.2f} steps), "
          f"unfused composition {old_share:.2%} (max {old_off.max():.2f} steps)")
    assert new_off.max() <= 1.0  # an f32 sum in another order may flip one rounding
    assert new_share < 0.02
    assert old_share > 0.1
    assert old_share > 20 * new_share


def test_default_scale_and_head_count():
    """scale=None is 1/sqrt(head_dim); heads split D in order."""
    rng = np.random.RandomState(5)
    x = torch.from_numpy(rng.randn(2, 9, 64).astype(np.float32))
    args = _torch_args(_params(64, seed=6))
    out = T.fused_attention_half(x, *args, 4)
    torch.testing.assert_close(out, T.attention_half_reference(x, *args, 4, 16**-0.5))
    assert not torch.allclose(out, T.fused_attention_half(x, *args, 2))


def test_gradient_matches_autograd_through_reference():
    rng = np.random.RandomState(7)
    p = _params(32, seed=8)
    x, g = (rng.randn(2, 5, 32).astype(np.float32) for _ in range(2))
    inputs = [x, *(a.numpy() for a in _torch_args(p))]
    leaves = [torch.tensor(a, requires_grad=True) for a in inputs]
    T.fused_attention_half(*leaves, 4, 0.3).backward(torch.from_numpy(g))
    refs = [torch.tensor(a, dtype=torch.float64, requires_grad=True) for a in inputs]
    T.attention_half_reference(*refs, 4, 0.3).backward(torch.from_numpy(g).double())
    for t, r in zip(leaves, refs):
        np.testing.assert_allclose(t.grad.numpy(), r.grad.numpy(), atol=1e-5, rtol=1e-5)
    # without a qkv bias the other gradients stay
    leaves[4] = None
    for t in leaves:
        if t is not None:
            t.grad = None
    T.fused_attention_half(*leaves, 4, 0.3).backward(torch.from_numpy(g))
    assert all(t.grad is not None for t in leaves if t is not None)


def test_cpu_path_launches_no_kernel():
    before = T.fused_attention_half.launches
    T.fused_attention_half(torch.zeros(1, 4, 32), *_torch_args(_params(32, seed=9)), 2)
    assert T.fused_attention_half.launches == before


@pytest.mark.parametrize(
    "change",
    ["heads-do-not-divide", "head_dim-160", "wqkv-not-transposed", "wproj-shape", "bqkv-width", "ln-width",
     "x-2d", "meta-device"],
)
def test_refusals(change):
    d, heads = 48, 4
    device = "meta" if change == "meta-device" else "cpu"
    args = [a.to(device) for a in _torch_args(_params(d, seed=10))]
    x = torch.zeros(1, 4, d, device=device)
    if change == "heads-do-not-divide":
        heads = 5
    elif change == "head_dim-160":
        d, heads = 160, 1
        x = torch.zeros(1, 4, d)
        args = _torch_args(_params(d, seed=11))
    elif change == "wqkv-not-transposed":
        args[2] = args[2].T
    elif change == "wproj-shape":
        args[4] = args[4][:, :-8]
    elif change == "bqkv-width":
        args[3] = args[3][:d]
    elif change == "ln-width":
        args[0] = args[0][:-1]
    elif change == "x-2d":
        x = x[0]
    with pytest.raises(ValueError):
        T.fused_attention_half(x, *args, heads)
