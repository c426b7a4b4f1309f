"""The fused MLP half of the PyTorch port against the JAX prototypes.

The port's ``ops.fused_mlp_half`` (on a CPU tensor its plain version,
``mlp_half_reference``) takes the same seeded numpy inputs as the Pallas
prototypes it ports, run in interpret mode with ``pl.pallas_call`` patched
to pass ``interpret=True``; the scripts are imported as they are:

- P11 ``cn_mlp_fused`` (scripts/ablate_convnext2.py): ConvNeXt's MLP half,
  with a layer scale and a residual that is not the LayerNorm's input;
- P1 ``mlp_fused`` (scripts/ablate_vit2.py), with one and two hidden chunks;
- P5 ``mlp_half_fused`` (scripts/ablate_vit4.py), rows flattened; its
  hidden width is the module's constant F = 3072. P3, the row-flattened
  closure inside ``ablate_vit3.main()``, cannot be imported; its body is
  P5's.

f32 at atol and rtol 2e-5: both sides take the LayerNorm statistics and
accumulate both products in f32, in another order, and the prototypes'
erf is a polynomial within 1.5e-7 of the exact one. The JAX weights are
(in, out) and go to the port transposed, as its ``Linear`` stores them.
Also: a bf16 case, the bf16 rounding fault of the old unfused composition
(gelu on fc1's rounded output), ``residual is x``, ``layer_scale=None``, a
ragged row count, the gradient, and the refusals. The CUDA kernel itself is
compared with the plain version in tests/test_torch_kernels_cuda.py.
"""
import functools
import importlib.util
import os

import jax.experimental.pallas as pl
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from eqxvision_tpu_torch.ops import mlp_half as T

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = dict(atol=2e-5, rtol=2e-5)


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


def _params(c, hidden, seed, layer_scale=True):
    """LayerNorm affine, fc1, fc2 (JAX layout, (in, out)) and the layer
    scale at the models' scales, f32."""
    rng = np.random.RandomState(seed)
    p = dict(
        lnw=1.0 + 0.3 * rng.randn(c), lnb=0.2 * rng.randn(c),
        w1=rng.randn(c, hidden) * c**-0.5, b1=0.2 * rng.randn(hidden),
        w2=rng.randn(hidden, c) * hidden**-0.5, b2=0.2 * rng.randn(c),
    )
    if layer_scale:
        p["ls"] = 0.5 + 0.2 * rng.randn(c)
    return {k: v.astype(np.float32) for k, v in p.items()}


def _torch(p):
    return {k: torch.from_numpy(np.array(v)) for k, v in p.items()}


def _port(x, residual, p, dtype=torch.float32):
    """fused_mlp_half on the CPU with the JAX weights transposed to (out, in)."""
    t = _torch(p)
    xt = torch.from_numpy(x).to(dtype)
    res = xt if residual is x else torch.from_numpy(residual).to(dtype)
    ls = t.get("ls")
    return T.fused_mlp_half(xt, res, t["lnw"], t["lnb"], t["w1"].T, t["b1"], t["w2"].T, t["b2"], ls, 1e-6)


def _p11(x, residual, p, dtype=jnp.float32):
    P11 = _script("ablate_convnext2")
    j = {k: jnp.asarray(v) for k, v in p.items()}
    return P11.cn_mlp_fused(jnp.asarray(x, dtype), jnp.asarray(residual, dtype), j["lnw"], j["lnb"], j["w1"], j["b1"],
                            j["w2"], j["b2"], j["ls"], eps=1e-6)


def _vit_weights(p):
    return dict(ln2w=p["lnw"], ln2b=p["lnb"], w1=p["w1"], b1=p["b1"], w2=p["w2"], b2=p["b2"])


@pytest.mark.parametrize("shape", [(2, 4, 4, 128), (3, 1, 5, 128)], ids=["2x4x4x128", "ragged-15-rows"])
def test_matches_p11_convnext_interpret(shape, interpret):
    """ConvNeXt: x is the depthwise conv's output, the residual the block's
    input; 15 rows are a multiple of no tile the kernel uses."""
    rng = np.random.RandomState(sum(shape))
    x, residual = rng.randn(*shape).astype(np.float32), rng.randn(*shape).astype(np.float32)
    p = _params(128, 512, seed=1)
    ref = np.asarray(_p11(x, residual, p))
    assert len(interpret) == 1
    np.testing.assert_allclose(_port(x, residual, p).numpy(), ref, **TOL)


@pytest.mark.parametrize("fchunks", [1, 2])
def test_matches_p1_vit_interpret(fchunks, interpret):
    """ViT: the residual is the LayerNorm's input, no layer scale."""
    x = np.random.RandomState(2).randn(2, 5, 128).astype(np.float32)
    p = _params(128, 512, seed=3, layer_scale=False)
    ref = np.asarray(_script("ablate_vit2").mlp_fused(jnp.asarray(x), _vit_weights(p), 1, fchunks))
    assert len(interpret) == 1
    np.testing.assert_allclose(_port(x, x, p).numpy(), ref, **TOL)


def test_matches_p5_vit_rows_flattened_interpret(interpret):
    P5 = _script("ablate_vit4")
    x = np.random.RandomState(4).randn(2, 5, 128).astype(np.float32)
    p = _params(128, P5.F, seed=5, layer_scale=False)
    ref = np.asarray(P5.mlp_half_fused(jnp.asarray(x), _vit_weights(p), r=5))
    assert len(interpret) == 1
    np.testing.assert_allclose(_port(x, x, p).numpy(), ref, **TOL)


def _bf16_case():
    """bf16 inputs, LayerNorm affine and weights as the prototype takes them
    (it rounds them to x's type); b1, b2 and the layer scale in f32."""
    rng = np.random.RandomState(6)
    shape = (2, 4, 4, 128)
    x, residual = rng.randn(*shape).astype(np.float32), rng.randn(*shape).astype(np.float32)
    p = _params(128, 512, seed=7)
    bf = lambda a: np.array(jnp.asarray(a, jnp.bfloat16).astype(jnp.float32))  # noqa: E731
    x, residual = bf(x), bf(residual)
    p.update({k: bf(p[k]) for k in ("lnw", "lnb", "w1", "w2")})
    ref = np.asarray(_p11(x, residual, p, jnp.bfloat16).astype(jnp.float32))
    return x, residual, p, ref


def test_bf16_matches_p11_interpret(interpret):
    x, residual, p, ref = _bf16_case()
    t = _torch(p)
    t.update({k: t[k].bfloat16() for k in ("lnw", "lnb", "w1", "w2")})
    out = T.fused_mlp_half(torch.from_numpy(x).bfloat16(), torch.from_numpy(residual).bfloat16(), t["lnw"], t["lnb"],
                           t["w1"].T, t["b1"], t["w2"].T, t["b2"], t["ls"])
    assert out.dtype == torch.bfloat16
    np.testing.assert_allclose(out.float().numpy(), ref, atol=1e-2, rtol=1e-2)


def test_bf16_rounding_fault_closed(interpret):
    """In bf16 the port's MLP half now rounds where the JAX prototype does:
    gelu on fc1's f32 accumulator, one rounding of h. Its output is within
    one bf16 rounding of the prototype's. The old unfused composition, fc1
    rounded to bf16 before gelu and each later step rounded again, is not."""
    x, residual, p, ref = _bf16_case()
    t = _torch(p)
    t.update({k: t[k].bfloat16() for k in ("lnw", "lnb", "w1", "w2")})
    xb, rb = torch.from_numpy(x).bfloat16(), torch.from_numpy(residual).bfloat16()
    new = T.fused_mlp_half(xb, rb, t["lnw"], t["lnb"], t["w1"].T, t["b1"], t["w2"].T, t["b2"], t["ls"]).float()
    # the old composition: each Linear's output, gelu's, the scaled branch and the sum rounded to bf16
    a = T.layer_norm_reference(xb, t["lnw"], t["lnb"], 1e-6)
    h = F.gelu(F.linear(a, t["w1"].T, t["b1"].bfloat16()))
    old = (rb + F.linear(h, t["w2"].T, t["b2"].bfloat16()) * t["ls"].bfloat16()).float()
    # one bf16 step at each output's magnitude, taken at 1 for the smaller
    # ones (the residual and the branch are of order 1 where they cancel)
    step = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(ref), 1.0))) - 7)
    new_off, old_off = np.abs(new.numpy() - ref) / step, np.abs(old.numpy() - ref) / step
    assert new_off.max() <= 1.0  # an f32 sum in another order may flip one rounding
    assert float((new_off > 0).mean()) < 0.01
    assert old_off.max() > 1.0
    assert float((old_off > 0).mean()) > 0.1


def test_residual_is_x_and_layer_scale_none():
    rng = np.random.RandomState(8)
    x = torch.from_numpy(rng.randn(3, 7, 64).astype(np.float32))
    p = _torch(_params(64, 256, seed=9, layer_scale=False))
    args = (p["lnw"], p["lnb"], p["w1"].T, p["b1"], p["w2"].T, p["b2"])
    same = T.fused_mlp_half(x, x, *args)
    torch.testing.assert_close(same, T.fused_mlp_half(x, x.clone(), *args, torch.ones(64)))
    torch.testing.assert_close(same, T.mlp_half_reference(x.clone(), x.clone(), *args))


def test_gradient_matches_autograd_through_reference():
    rng = np.random.RandomState(10)
    p = _params(32, 128, seed=11)
    x, residual, g = (rng.randn(5, 32).astype(np.float32) for _ in range(3))
    inputs = [x, residual, p["lnw"], p["lnb"], p["w1"].T, p["b1"], p["w2"].T, p["b2"], p["ls"]]
    leaves = [torch.tensor(np.ascontiguousarray(a), requires_grad=True) for a in inputs]
    T.fused_mlp_half(*leaves).backward(torch.from_numpy(g))
    refs = [torch.tensor(np.ascontiguousarray(a), dtype=torch.float64, requires_grad=True) for a in inputs]
    T.mlp_half_reference(*refs).backward(torch.from_numpy(g).double())
    for t, r in zip(leaves, refs):
        np.testing.assert_allclose(t.grad.numpy(), r.grad.numpy(), atol=1e-5, rtol=1e-5)
    # residual is x: the two paths' gradients add up on the one tensor
    xs = torch.tensor(x, requires_grad=True)
    T.fused_mlp_half(xs, xs, *leaves[2:]).backward(torch.from_numpy(g))
    torch.testing.assert_close(xs.grad, leaves[0].grad + leaves[1].grad)


def test_cpu_path_launches_no_kernel():
    p = _torch(_params(16, 64, seed=12))
    before = T.fused_mlp_half.launches
    T.fused_mlp_half(torch.zeros(4, 16), torch.zeros(4, 16), p["lnw"], p["lnb"], p["w1"].T, p["b1"], p["w2"].T, p["b2"])
    assert T.fused_mlp_half.launches == before


@pytest.mark.parametrize(
    "change,device",
    [("w1", "cpu"), ("w2", "cpu"), ("b1", "cpu"), ("residual", "cpu"), ("ls", "cpu"), (None, "meta")],
    ids=["w1-not-transposed", "w2-not-transposed", "b1-width", "residual-shape", "layer-scale-width", "meta-device"],
)
def test_refusals(change, device):
    c, hidden = 16, 64
    t = {k: torch.from_numpy(np.ascontiguousarray(v)).to(device) for k, v in _params(c, hidden, seed=13).items()}
    args = dict(x=torch.zeros(4, c, device=device), residual=torch.zeros(4, c, device=device), ln_weight=t["lnw"],
                ln_bias=t["lnb"], w1=t["w1"].T, b1=t["b1"], w2=t["w2"].T, b2=t["b2"], layer_scale=t["ls"])
    wrong = {"w1": t["w1"], "w2": t["w2"], "b1": t["b1"][:c], "residual": torch.zeros(4, c + 1), "ls": t["ls"][:8]}
    if change is not None:
        args[{"ls": "layer_scale"}.get(change, change)] = wrong[change]
    with pytest.raises(ValueError):
        T.fused_mlp_half(**args)
