"""RegNet of the PyTorch port against the JAX package, end to end.

The width schedule of all fifteen published configurations against the JAX
``BlockParams`` (pure Python). Two small models built on both sides from
the JAX classes' own arguments, 10 classes, 32 x 32 input, stem width 16: a
Y with squeeze-excitation (depth 4, w_0 8, w_a 8, w_m 2, group width 8:
stages of 8, 16 and 32 channels, grouped 3x3s of 1, 2 and 4 groups) and an
X (depth 5, w_0 16, w_a 12, w_m 1.8: 16, 32 and 48 channels, three blocks
in the last stage). Every BatchNorm's affine and running statistics are
randomised away from (0, 1) first. JAX -> port with
``weights.load_jax_params`` (``state=``; each trunk path takes the stage
rename and the ConvNormActivation rename together), port -> JAX through
``eqxvision_tpu.weights.import_torch_weights``; f32 logits at atol 1e-4,
rtol 1e-4. Also the fifteen factories' state-dict names, shapes and order
against the vendored torchvision manifests.
"""
import functools
import json
import os

import jax
import numpy as np
import pytest
import torch

from eqxvision_tpu.core import tree_inference
from eqxvision_tpu.core.state import init_state
from eqxvision_tpu.models.classification import regnet as JR
from eqxvision_tpu_torch.models import create_model
from eqxvision_tpu_torch.models.classification import regnet as R
from test_torch_mobilenet import jax_logits
from test_torch_resnet import _port_logits, jax_to_port, port_to_jax, randomize_port_bn, randomized_jax_bn

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = {"y": (4, 8, 8, 2.0, 8, 0.25), "x": (5, 16, 12, 1.8, 8, None)}  # depth, w_0, w_a, w_m, group width, SE


def _params(module, name):
    *args, se_ratio = CONFIGS[name]
    return module.BlockParams.from_init_params(*args, se_ratio=se_ratio)


@functools.lru_cache(maxsize=None)
def _jax(name):
    model = JR.RegNet(_params(JR, name), num_classes=10, stem_width=16, key=jax.random.PRNGKey(0))
    model, state = randomized_jax_bn(model, init_state(model), seed=3)
    return tree_inference(model, True), state


def _port(name, seed=0):
    return R.RegNet(_params(R, name), num_classes=10, stem_width=16, generator=torch.Generator().manual_seed(seed),
                    device="cpu")


def _input(seed):
    return np.random.RandomState(seed).randn(2, 32, 32, 3).astype(np.float32)


def _params_of_jax(name):
    depth, w_0, w_a, w_m, group_width, se_ratio = JR._CONFIGS[name]
    return JR.BlockParams.from_init_params(depth, w_0, w_a, w_m, group_width, se_ratio=se_ratio)


@pytest.mark.parametrize("name", list(R._CONFIGS))
def test_block_params_match_jax(name):
    assert R._CONFIGS[name] == JR._CONFIGS[name]
    port, ref = R.block_params(name), _params_of_jax(name)
    for field in ("depths", "widths", "group_widths", "bottleneck_multipliers", "strides", "se_ratio"):
        assert getattr(port, field) == getattr(ref, field), field
    assert all(type(w) is int for w in port.widths + port.group_widths + port.depths)


def test_small_configs_shape():
    y, x = _port("y"), _port("x")
    assert [len(s) for s in y.trunk_output] == [1, 1, 2] and [len(s) for s in x.trunk_output] == [1, 1, 3]
    assert [s[0].f.b[0].groups for s in y.trunk_output] == [1, 2, 4]
    assert hasattr(y.trunk_output.block1[0].f, "se") and not hasattr(x.trunk_output.block1[0].f, "se")
    assert x.trunk_output.block3[1].proj is None


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
    port = randomize_port_bn(_port(name, seed=7), seed=8).eval()
    model, state = port_to_jax(port, *_jax(name))
    x = _input(1)
    np.testing.assert_allclose(jax_logits(model, state, x), _port_logits(port, x), atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("name", list(R._CONFIGS))
def test_state_dict_matches_manifest(name):
    with open(os.path.join(REPO, "tests", "manifests", f"{name}.json")) as f:
        doc = json.load(f)
    model = create_model(doc["model"], device=torch.device("meta"), **doc.get("kwargs", {}))
    got = [[k, list(v.shape)] for k, v in model.state_dict().items()]
    assert got == doc["entries"]
