"""LayerNorm in the PyTorch port against the JAX package.

The same seeded numpy inputs go through the JAX reference
(``layer_norm_reference``), the JAX Pallas kernel ``_ln_kernel`` in
interpret mode, and the port's ``ops.layer_norm``, which on a CPU tensor runs
its plain torch version. f32 at atol 1e-5 (both sides take the mean and the
centred variance in f32, summed in another order). Also: gradients through
the port's autograd Function against ``jax.vjp`` of the reference, the
repaired rounding of f32 affine parameters on a bf16 input, and the number
of LayerNorms each model runs per forward through the op. The CUDA kernel
itself is compared with the plain version in
tests/test_torch_kernels_cuda.py, on the card.
"""
import importlib

import jax
import jax.experimental.pallas as pl
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

import eqxvision_tpu_torch.nn.norm as TN
from eqxvision_tpu_torch.models import create_model
from eqxvision_tpu_torch.ops import layernorm as T

J = importlib.import_module("eqxvision_tpu.ops.layernorm")


def _inputs(shape, seed, affine=True):
    rng = np.random.RandomState(seed)
    x = (rng.randn(*shape) * 2.0 + 0.5).astype(np.float32)
    d = shape[-1]
    if not affine:
        return x, None, None
    return x, (1.0 + 0.3 * rng.randn(d)).astype(np.float32), (0.2 * rng.randn(d)).astype(np.float32)


def _jax(a):
    return None if a is None else jnp.asarray(a)


def _torch(a):
    return None if a is None else torch.from_numpy(a)


@pytest.mark.parametrize("affine", [True, False], ids=["affine", "no-affine"])
@pytest.mark.parametrize("shape", [(6, 96), (2, 7, 7, 96), (64, 256)], ids=lambda s: "x".join(map(str, s)))
def test_plain_matches_jax_reference(shape, affine):
    x, w, b = _inputs(shape, seed=sum(shape), affine=affine)
    ref = np.asarray(J.layer_norm_reference(jnp.asarray(x), _jax(w), _jax(b), 1e-6))
    out = T.layer_norm(torch.from_numpy(x), _torch(w), _torch(b), 1e-6).numpy()
    assert out.shape == ref.shape
    np.testing.assert_allclose(out, ref, atol=1e-5)


def _interpret(orig, calls):
    def wrapper(*args, **kwargs):
        calls.append(1)
        kwargs["interpret"] = True
        return orig(*args, **kwargs)

    return wrapper


@pytest.mark.parametrize("affine", [True, False], ids=["affine", "no-affine"])
@pytest.mark.parametrize("shape", [(64, 256), (2, 8, 8, 128), (16, 384)], ids=lambda s: "x".join(map(str, s)))
def test_wrapper_matches_jax_kernel_interpret(shape, affine, monkeypatch):
    """The JAX layer_norm as on the TPU with EQXVISION_TPU_LN_PALLAS=1: its
    Pallas kernel, here in interpret mode (widths are multiples of 128 and
    row counts multiples of 8, so the kernel and not its fall-back runs)."""
    x, w, b = _inputs(shape, seed=3 + sum(shape), affine=affine)
    calls = []
    monkeypatch.setenv("EQXVISION_TPU_LN_PALLAS", "1")
    monkeypatch.setattr(pl, "pallas_call", _interpret(pl.pallas_call, calls))
    monkeypatch.setattr(J, "_use_pallas", lambda: True)
    kern = np.asarray(J.layer_norm(jnp.asarray(x), _jax(w), _jax(b), 1e-5))
    assert len(calls) == 1
    out = T.layer_norm(torch.from_numpy(x), _torch(w), _torch(b), 1e-5).numpy()
    np.testing.assert_allclose(out, kern, atol=1e-5)


@pytest.mark.parametrize("affine", [True, False], ids=["affine", "no-affine"])
def test_backward_matches_jax_vjp(affine):
    x, w, b = _inputs((6, 96), seed=7, affine=affine)
    g = np.random.RandomState(8).randn(6, 96).astype(np.float32)
    if affine:
        _, vjp = jax.vjp(lambda *a: J.layer_norm_reference(*a, 1e-6), *map(jnp.asarray, (x, w, b)))
    else:
        _, vjp = jax.vjp(lambda a: J.layer_norm_reference(a, None, None, 1e-6), jnp.asarray(x))
    refs = vjp(jnp.asarray(g))
    leaves = [torch.from_numpy(a).requires_grad_(True) for a in ((x, w, b) if affine else (x,))]
    args = leaves if affine else [leaves[0], None, None]
    T.layer_norm(*args, 1e-6).backward(torch.from_numpy(g))
    for t, ref in zip(leaves, refs):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(ref), atol=1e-5)


def test_bf16_input_keeps_f32_affine():
    """A bf16 input with f32 affine parameters: the port's LayerNorm applies
    the f32 weight and bias to the f32 normalised values and rounds once, as
    the JAX reference does; rounding the affine to bf16 first (F.layer_norm
    on bf16 parameters, the layer's earlier behaviour) moves about a third
    of the outputs by a bf16 step."""
    x, w, b = _inputs((2, 7, 7, 96), seed=11)
    xb = torch.from_numpy(x).to(torch.bfloat16)
    layer = TN.LayerNorm(96, eps=1e-6, device="cpu")
    with torch.no_grad():
        layer.weight.copy_(torch.from_numpy(w))
        layer.bias.copy_(torch.from_numpy(b))
        out = layer(xb)
        early = F.layer_norm(xb, (96,), layer.weight.to(xb.dtype), layer.bias.to(xb.dtype), 1e-6)
    ref = torch.from_numpy(
        np.array(J.layer_norm_reference(jnp.asarray(xb.float().numpy()).astype(jnp.bfloat16), jnp.asarray(w),
                                          jnp.asarray(b), 1e-6).astype(jnp.float32))
    )
    assert out.dtype == torch.bfloat16
    step = 2.0**-7 * ref.abs().clamp_min(1.0)  # one bf16 step at these magnitudes, at most
    assert bool(((out.float() - ref).abs() <= step).all())
    assert float((out.float() != ref).float().mean()) < 1e-3  # f32 sums in another order may flip a rounding
    assert float((early.float() != ref).float().mean()) > 0.1


def test_layer_without_affine_has_no_parameters():
    layer = TN.LayerNorm(8, elementwise_affine=False, device="cpu")
    assert list(layer.state_dict()) == []
    x = torch.randn(3, 8, generator=torch.Generator().manual_seed(0))
    np.testing.assert_allclose(
        layer(x).numpy(), np.asarray(J.layer_norm_reference(jnp.asarray(x.numpy()), None, None, 1e-5)), atol=1e-6
    )


def test_cpu_path_launches_no_kernel():
    before = T.layer_norm.launches
    T.layer_norm(torch.zeros(4, 32), torch.ones(32), torch.zeros(32))
    assert T.layer_norm.launches == before


@pytest.mark.parametrize(
    "x,weight,bias,device",
    [((4, 8), (8,), None, "cpu"), ((4, 8), (4,), (4,), "cpu"), ((), None, None, "cpu"), ((4, 8), None, None, "meta")],
    ids=["weight-without-bias", "wrong-width", "scalar", "meta-device"],
)
def test_wrapper_rejects(x, weight, bias, device):
    def t(shape):
        return None if shape is None else torch.zeros(shape, device=device)

    with pytest.raises(ValueError):
        T.layer_norm(t(x), t(weight), t(bias))


# (model, kwargs, image size, LayerNorms per forward). ConvNeXt: stem, one
# per downsampling, classifier (each block's norm is inside the fused MLP
# half). ViT: the final norm (norm1 and norm2 are inside the fused attention
# and MLP halves). Swin: stem, one per patch merging, final norm; v2 also two
# per block that does not take the whole-block op (C > 192: stages 3 and 4),
# whose norms v1 runs inside its fused attention and MLP halves.
PER_FORWARD = [
    ("convnext_tiny", {}, 32, 5),
    ("vit_base", dict(img_size=32), 32, 1),
    ("swin_t", {}, 64, 5),
    ("swin_v2_t", {}, 64, 21),
]


@pytest.mark.parametrize("name,kwargs,size,expected", PER_FORWARD, ids=[p[0] for p in PER_FORWARD])
def test_layer_norms_per_forward(name, kwargs, size, expected, monkeypatch):
    """Every LayerNorm of the model goes through ``ops.layer_norm``, the
    counts chip_smoke.py asserts on the card for the full-size models."""
    calls = []

    def counted(*args, **kw):
        calls.append(args[0].shape[-1])
        return T.layer_norm(*args, **kw)

    monkeypatch.setattr(TN, "layer_norm", counted)
    model = create_model(name, device="cpu", **kwargs).eval()
    with torch.no_grad():
        model(torch.zeros(1, size, size, 3))
    assert len(calls) == expected
