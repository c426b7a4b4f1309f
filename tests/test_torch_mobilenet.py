"""MobileNetV2 and V3 of the PyTorch port against the JAX package, end to end.

Small models built on both sides from the JAX classes' own arguments, 10
classes, 32 x 32 input: MobileNetV2 at ``width_mult`` 0.5 with a short
inverted-residual setting; a large-style V3 (ReLU and hard-swish blocks,
squeeze-excitation, 3x3 and 5x5 depthwise) at a short setting; and the
whole small table at ``width_mult`` 0.25 with ``reduced_tail`` and
``dilated`` (its last three blocks dilated, stride 1). Every BatchNorm's
affine and running statistics are randomised away from (0, 1) first. JAX ->
port with ``weights.load_jax_params`` (``state=``), port -> JAX through
``eqxvision_tpu.weights.import_torch_weights``; f32 logits at atol 1e-4,
rtol 1e-4; the JAX forward is jitted once per model structure (eagerly,
each op would compile on its own). Also the three factories' state-dict names, shapes and order
against the vendored torchvision manifests.
"""
import functools
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eqxvision_tpu.core import tree_inference
from eqxvision_tpu.core.state import init_state
from eqxvision_tpu.models.classification import mobilenetv2 as JM2
from eqxvision_tpu.models.classification import mobilenetv3 as JM3
from eqxvision_tpu_torch.models import create_model
from eqxvision_tpu_torch.models.classification import mobilenetv2 as M2
from eqxvision_tpu_torch.models.classification import mobilenetv3 as M3
from test_torch_resnet import _port_logits, jax_to_port, port_to_jax, randomize_port_bn, randomized_jax_bn

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
V2_SETTING = [[1, 16, 1, 1], [6, 24, 2, 2], [6, 32, 1, 2]]
# (input, kernel, expanded, out, SE, activation, stride, dilation)
V3_LARGE_STYLE = [(16, 3, 16, 16, False, "RE", 1, 1), (16, 3, 64, 24, False, "RE", 2, 1),
                  (24, 5, 72, 40, True, "RE", 2, 1), (40, 3, 240, 80, False, "HS", 2, 1),
                  (80, 3, 480, 112, True, "HS", 1, 1), (112, 5, 672, 112, True, "HS", 1, 1)]


_jax_forward = jax.jit(lambda model, state, x: model(x, state)[0])


def jax_logits(model, state, x):
    return np.asarray(_jax_forward(model, state, jnp.asarray(x)))


def _v3_large_style(module):
    return [module._InvertedResidualConfig(*c, width_mult=0.5) for c in V3_LARGE_STYLE], 128


def _v3_small_dilated(module):
    return module._mobilenet_v3_conf("mobilenet_v3_small", width_mult=0.25, reduced_tail=True, dilated=True)


CONFIGS = {  # name: (JAX model from a key, port model from a generator)
    "v2": (lambda key: JM2.MobileNetV2(num_classes=10, width_mult=0.5, inverted_residual_setting=V2_SETTING, key=key),
           lambda g: M2.MobileNetV2(num_classes=10, width_mult=0.5, inverted_residual_setting=V2_SETTING,
                                    generator=g, device="cpu")),
    "v3_large_style": (lambda key: JM3.MobileNetV3(*_v3_large_style(JM3), num_classes=10, key=key),
                       lambda g: M3.MobileNetV3(*_v3_large_style(M3), num_classes=10, generator=g, device="cpu")),
    "v3_small_dilated_reduced": (
        lambda key: JM3.MobileNetV3(*_v3_small_dilated(JM3), num_classes=10, key=key),
        lambda g: M3.MobileNetV3(*_v3_small_dilated(M3), num_classes=10, generator=g, device="cpu")),
}


@functools.lru_cache(maxsize=None)
def _jax(name):
    model = CONFIGS[name][0](jax.random.PRNGKey(0))
    model, state = randomized_jax_bn(model, init_state(model), seed=3)
    return tree_inference(model, True), state


def _port(name, seed=0):
    return CONFIGS[name][1](torch.Generator().manual_seed(seed))


def _input(seed):
    return np.random.RandomState(seed).randn(2, 32, 32, 3).astype(np.float32)


def test_configs_cover_se_hard_swish_dilation_and_reduced_tail():
    large, small = _port("v3_large_style"), _port("v3_small_dilated_reduced")
    assert any(c.use_se for c in _v3_large_style(M3)[0]) and any(c.use_hs for c in _v3_large_style(M3)[0])
    setting, _ = _v3_small_dilated(M3)
    assert [c.dilation for c in setting[-3:]] == [2, 2, 2]
    assert setting[-1].out_channels == M3._InvertedResidualConfig.adjust_channels(96 // 2, 0.25)
    dilated = small.features[-4].block[1][0]  # the first dilated block's depthwise conv: stride 1, dilation 2
    assert dilated.stride == (1, 1) and dilated.dilation == (2, 2) and dilated.padding == ((4, 4), (4, 4))
    assert large.features[0][1].eps == 1e-3 and large.features[0][1].momentum == 0.01


@pytest.mark.parametrize("name", list(CONFIGS))
def test_logits_match_jax(name):
    model, state = _jax(name)
    port = jax_to_port(model, state, _port(name))
    x = _input(0)
    out = _port_logits(port, x)
    assert out.shape == (2, 10)
    np.testing.assert_allclose(out, jax_logits(model, state, x), atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("name", list(CONFIGS))
def test_jax_imports_port_state_dict(name):
    """The north star's direction: the port's own weights (a second seed)
    and randomised statistics, imported by the JAX package by name and
    order, give the port's logits."""
    port = randomize_port_bn(_port(name, seed=7), seed=8).eval()
    model, state = port_to_jax(port, *_jax(name))
    x = _input(1)
    np.testing.assert_allclose(jax_logits(model, state, x), _port_logits(port, x), atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("name", ["mobilenet_v2", "mobilenet_v3_large", "mobilenet_v3_small"])
def test_state_dict_matches_manifest(name):
    with open(os.path.join(REPO, "tests", "manifests", f"{name}.json")) as f:
        doc = json.load(f)
    model = create_model(doc["model"], device=torch.device("meta"), **doc.get("kwargs", {}))
    got = [[k, list(v.shape)] for k, v in model.state_dict().items()]
    assert got == doc["entries"]
