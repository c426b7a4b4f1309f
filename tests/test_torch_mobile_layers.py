"""The mobile families' layers of the PyTorch port against the JAX package:
``_make_divisible``, the activations (f32, and ROADMAP C.13's bound in
bf16), ``SqueezeExcitation``, ``ConvNormActivation`` (padding, bias,
torchvision's indices, forward), ``BatchNorm`` on an f64 input (C.11), and
the weight-name mapping that these families need (a ConvNormActivation's
``conv``/``norm`` onto 0/1, RegNet's stages, both at once). Seeded numpy
inputs; f32 at atol 1e-5 unless a case says otherwise.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

import eqxvision_tpu.nn as JN
import eqxvision_tpu_torch.nn as TN
from eqxvision_tpu.core import tree_inference
from eqxvision_tpu.core.state import init_state
from eqxvision_tpu.layers import ConvNormActivation as JaxCNA
from eqxvision_tpu.layers import SqueezeExcitation as JaxSE
from eqxvision_tpu.utils import _make_divisible as jax_make_divisible
from eqxvision_tpu_torch.layers import ConvNormActivation, SqueezeExcitation
from eqxvision_tpu_torch.utils import _make_divisible
from eqxvision_tpu_torch.weights import load_jax_params
from eqxvision_tpu_torch.weights.from_jax import _torch_name
from test_torch_conv_layers import _bn_pair
from test_torch_resnet import jax_to_port, randomized_jax_bn

ACTIVATIONS = ["relu", "relu6", "sigmoid", "tanh", "silu", "hard_sigmoid", "hard_swish"]
# bf16: the most bf16 steps by which torch's one rounding may differ from the
# JAX function's rounding after each op, on 1e5 samples of N(0, 16)
BF16_STEPS = {"relu": 0, "relu6": 0, "tanh": 0, "hard_sigmoid": 1, "sigmoid": 2, "silu": 2, "hard_swish": 2}


def _samples(seed=0):
    return (4.0 * np.random.RandomState(seed).randn(100_000)).astype(np.float32)


def test_make_divisible_matches_jax():
    for v in np.linspace(0.5, 3000.0, 997):
        for divisor in (1, 4, 8, 16, 24):
            for min_value in (None, 16):
                assert _make_divisible(v, divisor, min_value) == jax_make_divisible(v, divisor, min_value)


@pytest.mark.parametrize("name", ACTIVATIONS)
def test_activation_f32_matches_jax(name):
    x = _samples()
    ref = np.asarray(getattr(JN, name)(jnp.asarray(x)))
    out = getattr(TN, name)(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(out, ref, atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("name", ACTIVATIONS)
def test_activation_bf16_rounds_once_within_bound_of_jax(name):
    """C.13: the port's bf16 activation is its f32 value rounded once; the
    JAX function rounds after each op. The two differ by at most
    ``BF16_STEPS`` steps (the step of the larger magnitude)."""
    xb = torch.from_numpy(_samples(1)).to(torch.bfloat16)
    fn = getattr(TN, name)
    out = fn(xb)
    assert out.dtype == torch.bfloat16
    torch.testing.assert_close(out, fn(xb.float()).to(torch.bfloat16), atol=0, rtol=0)
    ref = np.asarray(getattr(JN, name)(jnp.asarray(xb.float().numpy(), jnp.bfloat16)), np.float32)
    got = out.float().numpy()
    mag = np.maximum(np.maximum(np.abs(ref), np.abs(got)), np.finfo(np.float32).tiny)
    steps = np.abs(got - ref) / np.exp2(np.floor(np.log2(mag)) - 7)
    assert steps.max() <= BF16_STEPS[name]


@pytest.mark.parametrize("acts", [("relu", "sigmoid"), ("silu", "sigmoid"), ("relu", "hard_sigmoid")], ids="-".join)
def test_squeeze_excitation_matches_jax(acts):
    act, gate = acts
    jse = JaxSE(24, 8, activation=getattr(JN, act), scale_activation=getattr(JN, gate), key=jax.random.PRNGKey(1))
    se = SqueezeExcitation(24, 8, activation=getattr(TN, act), scale_activation=getattr(TN, gate),
                           generator=torch.Generator().manual_seed(0), device="cpu")
    load_jax_params(se, {".fc1.weight": jse.fc1.weight, ".fc1.bias": jse.fc1.bias,
                         ".fc2.weight": jse.fc2.weight, ".fc2.bias": jse.fc2.bias})
    x = (1.0 + np.random.RandomState(2).randn(2, 5, 7, 24)).astype(np.float32)
    with torch.no_grad():
        out = se(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(out, np.asarray(jse(jnp.asarray(x))), atol=1e-5, rtol=1e-5)


CNA_CASES = {  # name: (arguments of both, the JAX norm and activation, the port's)
    "3x3": (dict(kernel_size=3), (JN.BatchNorm, JN.relu), (TN.BatchNorm, TN.relu)),
    "5x5 depthwise dilated": (dict(kernel_size=5, groups=16, dilation=2),
                              (functools.partial(JN.BatchNorm, eps=1e-3), JN.hard_swish),
                              (functools.partial(TN.BatchNorm, eps=1e-3), TN.hard_swish)),
    "strided no activation": (dict(kernel_size=3, stride=2), (JN.BatchNorm, None), (TN.BatchNorm, None)),
    "no norm": (dict(kernel_size=1), (None, JN.silu), (None, TN.silu)),
}


@pytest.mark.parametrize("case", list(CNA_CASES))
def test_conv_norm_activation_matches_jax(case):
    """Padding (k - 1) // 2 * dilation, a bias only without a norm,
    torchvision's indices (without a norm the activation moves up to 1),
    and the forward against the JAX layer with randomised statistics."""
    kwargs, (jnorm, jact), (norm, act) = CNA_CASES[case]
    jcna = JaxCNA(16, 16, norm_layer=jnorm, activation_layer=jact, key=jax.random.PRNGKey(3), **kwargs)
    jcna, state = randomized_jax_bn(jcna, init_state(jcna), seed=4)
    jcna = tree_inference(jcna, True)
    cna = ConvNormActivation(16, 16, norm_layer=norm, activation_layer=act,
                             generator=torch.Generator().manual_seed(0), device="cpu", **kwargs)
    k, d = kwargs["kernel_size"], kwargs.get("dilation", 1)
    assert cna[0].padding == (((k - 1) // 2 * d,) * 2,) * 2
    assert (cna[0].bias is None) == (norm is not None)
    kinds = [type(m) for m in cna]
    assert kinds == [TN.Conv2d] + ([TN.BatchNorm] if norm else []) + ([TN.Lambda] if act else [])
    assert cna.out_channels == 16
    jax_to_port(jcna, state, cna)
    x = np.random.RandomState(5).randn(2, 11, 9, 16).astype(np.float32)
    ref, _ = jcna(jnp.asarray(x), state)
    with torch.no_grad():
        out = cna(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(out, np.asarray(ref), atol=1e-5, rtol=1e-5)


def test_batchnorm_eval_f64_computes_in_f32():
    """C.11: an f64 input in eval computes in f32, as the JAX layer does,
    and comes back f64; the statistics stay f32."""
    jbn, state, bn = _bn_pair(8, seed=6)
    bn = bn.eval().double()
    assert bn.running_mean.dtype == torch.float32 and bn.weight.dtype == torch.float64
    x = (3.0 + 2.0 * np.random.RandomState(7).randn(2, 4, 4, 8)).astype(np.float32)
    ref, _ = tree_inference(jbn, True)(jnp.asarray(x), state)
    with torch.no_grad():
        out = bn(torch.from_numpy(x).double())
    assert out.dtype == torch.float64
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5, rtol=1e-5)
    with torch.no_grad():
        np.testing.assert_array_equal(out.numpy(), bn(torch.from_numpy(x)).double().numpy())


def test_weight_names_compose_and_stay_exact():
    """A RegNet trunk path takes two renames at once; a CNA's ``norm`` does
    not fall to ConvNeXt's bare ``.norm.`` rename, nor MobileNetV2's block
    field ``conv`` to the CNA's; a path that two renames map onto two names
    of the model raises; one that maps nowhere keeps its plain name."""
    names = {"trunk_output.block2.block2-1.f.a.1.running_var", "features.1.0.block.0.1.weight",
             "features.1.0.block.2.weight", "features.2.conv.0.0.weight", "features.2.conv.2.weight"}
    assert (_torch_name(".trunk_output.layers[1].layers[1].f.a.norm.running_var", names)
            == "trunk_output.block2.block2-1.f.a.1.running_var")
    assert _torch_name(".features.layers[1].layers[0].block.layers[0].norm.weight", names) == \
        "features.1.0.block.0.1.weight"
    assert _torch_name(".features.layers[2].conv.layers[0].conv.weight", names) == "features.2.conv.0.0.weight"
    assert _torch_name(".features.layers[2].conv.layers[2].weight", names) == "features.2.conv.2.weight"
    assert _torch_name(".stem.conv.weight", names) == "stem.conv.weight"
    with pytest.raises(ValueError, match="several names"):
        _torch_name(".x.norm.weight", {"x.1.weight", "x.block.2.weight"})


def test_load_jax_params_into_a_root_cna():
    """A ConvNormActivation loaded on its own (paths ``.conv.weight``,
    ``.norm``): names at the root map too."""
    jcna = JaxCNA(4, 8, key=jax.random.PRNGKey(0))
    jcna, state = randomized_jax_bn(jcna, init_state(jcna), seed=1)
    cna = ConvNormActivation(4, 8, generator=torch.Generator().manual_seed(0), device="cpu")
    jax_to_port(tree_inference(jcna, True), state, cna)
    (mean, var), = state.values()
    np.testing.assert_array_equal(cna[1].running_mean.numpy(), np.asarray(mean))
    np.testing.assert_array_equal(cna[0].weight.detach().numpy(), np.asarray(jcna.conv.weight).transpose(3, 2, 0, 1))
    assert isinstance(cna, nn.Sequential)
