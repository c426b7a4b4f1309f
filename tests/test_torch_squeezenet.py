"""SqueezeNet 1.0 and 1.1 of the PyTorch port against the JAX package, end to end.

Both versions at 10 classes, 64 x 64 input. The JAX model's structure comes
from ``jax.eval_shape`` of its constructor and its parameters from a numpy
seed (``seeded_jax``; built eagerly, every distinct initialiser shape would
compile on its own, tens of seconds for GoogLeNet). JAX -> port with
``weights.load_jax_params``, port -> JAX through
``eqxvision_tpu.weights.import_torch_weights``; f32 logits at atol 1e-4,
rtol 1e-4, the JAX forward jitted once per model structure. Also the two
factories' state-dict names, shapes and order against the vendored
torchvision manifests. ``seeded_jax``, ``check_jax_to_port``,
``check_port_to_jax`` and ``folded_convs_match_jax`` serve the other
model-zoo tests (DenseNet, ShuffleNetV2, GoogLeNet, the segmentation
models).
"""
import functools
import json
import math
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eqxvision_tpu.core import tree_inference
from eqxvision_tpu.core.state import init_state
from eqxvision_tpu.models.classification import squeezenet as JS
from eqxvision_tpu.weights.serialize import _flatten_with_paths
from eqxvision_tpu_torch.models import create_model
from eqxvision_tpu_torch.models.classification import squeezenet as S
from eqxvision_tpu_torch.nn import Conv2d
from test_torch_mobilenet import jax_logits
from test_torch_resnet import _port_logits, jax_to_port, port_to_jax, randomize_port_bn, randomized_jax_bn

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def seeded_jax(build, seed=0, bn_seed=3):
    """``build(key)``'s JAX model in inference mode and its state: the
    structure from ``jax.eval_shape``, every array leaf uniform in +-1 /
    sqrt(fan in) from a numpy seed (fan in: the product of all axes but the
    last, HWI of an HWIO conv weight, 100 for a vector), and every
    BatchNorm's affine and running statistics randomised away from (0, 1)."""
    rng = np.random.RandomState(seed)

    def fill(leaf):
        if not isinstance(leaf, jax.ShapeDtypeStruct):
            return leaf
        fan_in = math.prod(leaf.shape[:-1]) if len(leaf.shape) > 1 else 100
        return jnp.asarray(rng.uniform(-1.0, 1.0, leaf.shape) / math.sqrt(fan_in), leaf.dtype)

    model = jax.tree_util.tree_map(fill, jax.eval_shape(build, jax.random.PRNGKey(seed)))
    model, state = randomized_jax_bn(model, init_state(model), seed=bn_seed)
    return tree_inference(model, True), state


def check_jax_to_port(jax_model, state, make_port, x, forward_jax=jax_logits, forward_port=_port_logits):
    """The JAX model's parameters and statistics into the port
    (``load_jax_params``), each output at atol 1e-4, rtol 1e-4; returns
    the port."""
    port = jax_to_port(jax_model, state, make_port(torch.Generator().manual_seed(0)))
    for got, want in zip(_leaves(forward_port(port, x)), _leaves(forward_jax(jax_model, state, x))):
        np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4)
    return port


def check_port_to_jax(jax_model, state, make_port, x, forward_jax=jax_logits, forward_port=_port_logits):
    """The north star's direction: the port's own weights (a second seed)
    and randomised statistics, imported by the JAX package by name and
    order (``import_torch_weights``), give the port's outputs."""
    own = randomize_port_bn(make_port(torch.Generator().manual_seed(7)), seed=8).eval()
    imported, imported_state = port_to_jax(own, jax_model, state)
    for got, want in zip(_leaves(forward_jax(imported, imported_state, x)), _leaves(forward_port(own, x))):
        np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4)


def _leaves(out):
    return list(out) if isinstance(out, (tuple, list)) else [out]


def check_manifest(name):
    with open(os.path.join(REPO, "tests", "manifests", f"{name}.json")) as f:
        doc = json.load(f)
    model = create_model(doc["model"], device=torch.device("meta"), **doc.get("kwargs", {}))
    assert [[k, list(v.shape)] for k, v in model.state_dict().items()] == doc["entries"]


def folded_convs_match_jax(folded, jax_folded):
    """The folded convs' weights (OIHW) and biases, in module order, equal
    the JAX fold's conv leaves (HWIO) in tree order. The JAX fold drops a
    folded BatchNorm from its Sequential, the port keeps an ``Identity`` in
    its slot, so the indices differ and the order is compared."""
    leaves = [np.asarray(v) for _, v in _flatten_with_paths(jax_folded)]
    want = [(w.transpose(3, 2, 0, 1), b) for w, b in zip(leaves, leaves[1:]) if w.ndim == 4]
    got = [(m.weight.detach().numpy(), m.bias.detach().numpy()) for m in folded.modules() if isinstance(m, Conv2d)]
    assert len(got) == len(want)
    for (gw, gb), (ww, wb) in zip(got, want):
        np.testing.assert_allclose(gw, ww, rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(gb, wb, rtol=1e-6, atol=1e-6)


def _input(seed, size=64):
    return np.random.RandomState(seed).randn(2, size, size, 3).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _jax(version):
    return seeded_jax(lambda key: JS.SqueezeNet(version, num_classes=10, key=key))


def _port(version):
    return lambda g: S.SqueezeNet(version, num_classes=10, generator=g, device="cpu")


@pytest.mark.parametrize("version", ["1_0", "1_1"])
def test_logits_match_jax(version):
    port = check_jax_to_port(*_jax(version), _port(version), _input(0))
    assert _port_logits(port, _input(1)).shape == (2, 10)


@pytest.mark.parametrize("version", ["1_0", "1_1"])
def test_jax_imports_port_state_dict(version):
    check_port_to_jax(*_jax(version), _port(version), _input(2))


def test_fire_concatenates_expand_branches_on_the_channel_axis():
    fire = S._Fire(8, 4, 6, 10, generator=torch.Generator().manual_seed(0), device="cpu")
    x = torch.randn(2, 5, 5, 8)
    y = fire(x)
    s = torch.relu(fire.squeeze(x))
    assert y.shape == (2, 5, 5, 16)
    torch.testing.assert_close(y[..., :6], torch.relu(fire.expand1x1(s)))
    torch.testing.assert_close(y[..., 6:], torch.relu(fire.expand3x3(s)))


def test_pools_are_ceil_mode_and_final_conv_takes_the_default_init():
    model = S.SqueezeNet("1_0", generator=torch.Generator().manual_seed(0), device="cpu")
    pools = [m for m in model.features if isinstance(m, S.MaxPool2d)]
    assert len(pools) == 3 and all(p.use_ceil for p in pools)
    final = model.classifier[1]
    bound = 1.0 / math.sqrt(512)  # kaiming_uniform(a=sqrt(5)) over fan in 512: sqrt(6 / (6 * 512))
    assert final.weight.abs().max() <= bound and final.weight.abs().max() > 0.9 * bound
    # 224 px: 13 x 13 maps before the pool, as torchvision's ceil-mode pools give
    with torch.no_grad():
        assert model.features(torch.zeros(1, 224, 224, 3)).shape == (1, 13, 13, 512)


@pytest.mark.parametrize("name", ["squeezenet1_0", "squeezenet1_1"])
def test_state_dict_matches_manifest(name):
    check_manifest(name)
