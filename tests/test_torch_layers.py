"""Layers of the PyTorch port against their JAX counterparts.

Each case builds the JAX layer, fills its parameters with seeded random
values, carries them into the port's layer with ``weights.from_jax``, and
feeds both the same seeded numpy input. f32, atol 1e-5.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import eqxvision_tpu.layers as JL
import eqxvision_tpu.nn as JN
from eqxvision_tpu.weights.serialize import _flatten_with_paths
import eqxvision_tpu_torch.layers as TL
import eqxvision_tpu_torch.nn as TN
from eqxvision_tpu_torch.core import init
from eqxvision_tpu_torch.weights import load_jax_params


def _gen():
    return torch.Generator().manual_seed(0)


def _randomized(module, seed):
    rng = np.random.RandomState(seed)
    return jax.tree_util.tree_map(lambda a: jnp.asarray(rng.randn(*a.shape).astype(np.float32) * 0.1), module)


def _pair(jax_module, torch_module):
    jax_module = _randomized(jax_module, seed=1)
    params = {k: np.asarray(v) for k, v in _flatten_with_paths(jax_module)}
    return jax_module, load_jax_params(torch_module, params)


def _case_linear():
    return _pair(JN.Linear(24, 40, key=jax.random.PRNGKey(0)), TN.Linear(24, 40, generator=_gen())), (3, 7, 24)


def _case_linear_no_bias():
    return _pair(
        JN.Linear(24, 40, use_bias=False, key=jax.random.PRNGKey(0)), TN.Linear(24, 40, use_bias=False, generator=_gen())
    ), (5, 24)


def _case_layernorm():
    return _pair(JN.LayerNorm(32, eps=1e-6), TN.LayerNorm(32, eps=1e-6)), (3, 7, 32)


def _case_gelu():
    return (JN.gelu, TN.gelu), (4, 50)


def _case_conv2d():
    return _pair(
        JN.Conv2d(5, 8, 3, stride=2, key=jax.random.PRNGKey(0)),
        TN.Conv2d(5, 8, 3, stride=2, generator=_gen()),
    ), (2, 9, 9, 5)


def _conv_case(cin, cout, k, **kw):
    def case():
        return _pair(
            JN.Conv2d(cin, cout, k, key=jax.random.PRNGKey(0), **kw), TN.Conv2d(cin, cout, k, generator=_gen(), **kw)
        ), (2, 9, 10, cin)

    return case


def _case_layernorm2d():
    return _pair(JL.LayerNorm2d(24, eps=1e-6), TL.LayerNorm2d(24, eps=1e-6)), (2, 5, 5, 24)


def _case_linear2d():
    return _pair(JL.Linear2d(24, 16, key=jax.random.PRNGKey(0)), TL.Linear2d(24, 16, generator=_gen())), (2, 5, 5, 24)


def _case_patch_embed():
    return _pair(
        JL.PatchEmbed(32, 8, 3, 48, key=jax.random.PRNGKey(0)), TL.PatchEmbed(32, 8, 3, 48, generator=_gen())
    ), (2, 32, 32, 3)


def _case_mlp():
    return _pair(
        JL.MlpProjection(32, 64, 32, JN.gelu, key=jax.random.PRNGKey(0)),
        TL.MlpProjection(32, 64, 32, TN.gelu, generator=_gen()),
    ), (2, 9, 32)


CASES = {
    "linear": _case_linear,
    "linear-no-bias": _case_linear_no_bias,
    "layernorm": _case_layernorm,
    "gelu": _case_gelu,
    "conv2d": _case_conv2d,
    "conv2d-padding-int": _conv_case(5, 8, 3, padding=1),
    "conv2d-padding-pair": _conv_case(5, 8, (3, 5), stride=2, padding=(1, 2)),
    "conv2d-padding-per-side": _conv_case(5, 8, 3, padding=((0, 2), (1, 0))),
    "conv2d-depthwise": _conv_case(6, 6, 7, padding=3, groups=6),
    "conv2d-groups-2": _conv_case(6, 4, 3, groups=2, use_bias=False),
    "conv2d-dilation-2": _conv_case(5, 8, 3, padding=2, dilation=2),
    "layernorm2d": _case_layernorm2d,
    "linear2d": _case_linear2d,
    "patch_embed": _case_patch_embed,
    "mlp": _case_mlp,
}


@pytest.mark.parametrize("name", list(CASES))
def test_layer_matches_jax(name):
    (jax_layer, torch_layer), shape = CASES[name]()
    x = np.random.RandomState(2).randn(*shape).astype(np.float32)
    ref = np.asarray(jax_layer(jnp.asarray(x)))
    if isinstance(torch_layer, torch.nn.Module):
        torch_layer.eval()
    with torch.no_grad():
        out = torch_layer(torch.from_numpy(x)).numpy()
    assert out.shape == ref.shape
    np.testing.assert_allclose(out, ref, atol=1e-5)


# Layers whose bias meets the f32 accumulator: f32 parameters on a bf16 input.
BIAS_CASES = {
    "linear": (_case_linear, (4, 9, 24)),
    "conv2d": (_conv_case(5, 8, 3, padding=1), (2, 9, 10, 5)),
    "conv2d-strided": (_case_conv2d, (2, 9, 9, 5)),
    "conv2d-depthwise": (_conv_case(6, 6, 7, padding=3, groups=6), (2, 9, 10, 6)),
}


@pytest.mark.parametrize("name", list(BIAS_CASES))
def test_bias_meets_f32_accumulator_as_jax(name):
    """f32 parameters and a bf16 input: the JAX layer adds the f32 bias to
    the f32 accumulator and rounds once, and so does the port's; it rounded
    the bias to bf16 first. The biases are drawn large beside the products,
    where rounding them first moves most outputs. The outputs are equal."""
    case, shape = BIAS_CASES[name]
    jax_layer, torch_layer = case()[0]
    rng = np.random.RandomState(3)
    bias = (3.0 * rng.randn(*jax_layer.bias.shape)).astype(np.float32)
    jax_layer = jax.tree_util.tree_map(lambda a: jnp.asarray(bias) if a.shape == bias.shape else a, jax_layer)
    with torch.no_grad():
        torch_layer.bias.copy_(torch.from_numpy(bias))
    x = jnp.asarray(rng.randn(*shape), jnp.bfloat16)
    ref = np.asarray(jax_layer(x).astype(jnp.float32))
    with torch.no_grad():
        out = torch_layer(torch.from_numpy(np.asarray(x.astype(jnp.float32))).bfloat16())
    assert out.dtype == torch.bfloat16 and torch_layer.bias.dtype == torch.float32
    np.testing.assert_array_equal(out.float().numpy(), ref)


@pytest.mark.parametrize("name", [n for n in BIAS_CASES if n.startswith("conv2d")])
def test_bf16_conv_bias_meets_f32_accumulator_as_jax(name):
    """bf16 parameters and a bf16 input on the CPU: the JAX layer adds the
    bf16 bias to the f32 accumulator and rounds once, and so does the port's
    one torch call here (on the card cuDNN rounds twice: ROADMAP C.9).
    Outputs are equal."""
    case, shape = BIAS_CASES[name]
    jax_layer, torch_layer = case()[0]
    rng = np.random.RandomState(4)
    bias = (3.0 * rng.randn(*jax_layer.bias.shape)).astype(np.float32)
    jax_layer = jax.tree_util.tree_map(lambda a: jnp.asarray(bias) if a.shape == bias.shape else a, jax_layer)
    jax_layer = jax.tree_util.tree_map(lambda a: a.astype(jnp.bfloat16) if isinstance(a, jax.Array) else a, jax_layer)
    with torch.no_grad():
        torch_layer.bias.copy_(torch.from_numpy(bias))
    torch_layer = torch_layer.to(torch.bfloat16)
    x = jnp.asarray(rng.randn(*shape), jnp.bfloat16)
    ref = np.asarray(jax_layer(x).astype(jnp.float32))
    with torch.no_grad():
        out = torch_layer(torch.from_numpy(np.asarray(x.astype(jnp.float32))).bfloat16())
    assert out.dtype == torch.bfloat16 and torch_layer.bias.dtype == torch.bfloat16
    np.testing.assert_array_equal(out.float().numpy(), ref)


def test_drop_path_drops_whole_samples():
    layer = TL.DropPath(0.5).train()
    x = torch.ones(64, 3, 4)
    y = layer(x)
    per_sample = y.reshape(64, -1)
    assert all(set(row.tolist()) <= {0.0} or set(row.tolist()) == {2.0} for row in per_sample)
    assert 0 < int((per_sample[:, 0] == 0).sum()) < 64
    assert torch.equal(layer.eval()(x), x)


@pytest.mark.parametrize("device", ["cpu", "meta"])
def test_init_seeded_and_bounded(device):
    a = init.kaiming_uniform((64, 48), 48, generator=_gen(), device=device)
    t = init.trunc_normal((4096,), generator=_gen(), std=0.02, device=device)
    assert a.device.type == device and t.device.type == device
    if device == "meta":
        return
    b = init.kaiming_uniform((64, 48), 48, generator=_gen())
    assert torch.equal(a, b)
    assert float(a.abs().max()) <= 1.0 / np.sqrt(48)
    assert float(t.abs().max()) <= 0.04 + 1e-7
    assert 0.015 < float(t.std()) < 0.02
    bias = init.uniform_fan_in((1000,), 16, generator=_gen())
    assert float(bias.abs().max()) <= 0.25
