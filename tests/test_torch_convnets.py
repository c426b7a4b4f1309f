"""AlexNet and VGG of the PyTorch port against the JAX package, end to end.

Full-size models, each built once: AlexNet at 64 x 64 (its features end at
1 x 1, so the adaptive pool to 6 x 6 takes its non-uniform path), ``vgg11``
and ``vgg11_bn`` at 32 x 32. ``vgg11_bn``'s BatchNorm statistics and affine
are randomised away from (0, 1) first. Parameters go JAX -> port with
``weights.load_jax_params`` (running statistics included), and port -> JAX
through ``eqxvision_tpu.weights.import_torch_weights`` (the torchvision
names and order that ``torch_weights=`` relies on); f32 logits at atol
1e-4, rtol 1e-4. Also the nine factories' state-dict names, shapes and
order against the vendored torchvision manifests, and the classifier's
CHW-ordered input.
"""
import functools
import importlib
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eqxvision_tpu.core import tree_inference
from eqxvision_tpu.core.state import init_state
from eqxvision_tpu.models.classification import vgg as JV
from eqxvision_tpu_torch.models import create_model
from eqxvision_tpu_torch.models.classification.alexnet import AlexNet
from eqxvision_tpu_torch.models.classification.vgg import VGG
from test_torch_resnet import jax_to_port, port_to_jax, randomize_port_bn, randomized_jax_bn

JA = importlib.import_module("eqxvision_tpu.models.classification.alexnet")  # the package exports a function of that name
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MODELS = {  # name: (JAX constructor, port constructor, input size)
    "alexnet": (lambda: JA.AlexNet(key=jax.random.PRNGKey(0)), lambda g: AlexNet(generator=g, device="cpu"), 64),
    "vgg11": (lambda: JV.VGG("A", False, key=jax.random.PRNGKey(0)),
              lambda g: VGG("A", False, generator=g, device="cpu"), 32),
    "vgg11_bn": (lambda: JV.VGG("A", True, key=jax.random.PRNGKey(0)),
                 lambda g: VGG("A", True, generator=g, device="cpu"), 32),
}


@functools.lru_cache(maxsize=None)
def _pair(name):
    """(JAX model, its state, the port loaded from it)."""
    build_jax, build_port, _ = MODELS[name]
    model = build_jax()
    model, state = randomized_jax_bn(model, init_state(model), seed=3)
    model = tree_inference(model, True)
    return model, state, jax_to_port(model, state, build_port(torch.Generator().manual_seed(0)))


def _input(name, seed):
    return np.random.RandomState(seed).randn(2, MODELS[name][2], MODELS[name][2], 3).astype(np.float32)


def _logits(model, state, port, x):
    ref, _ = model(jnp.asarray(x), state)
    with torch.no_grad():
        out = port(torch.from_numpy(x)).numpy()
    return np.asarray(ref), out


@pytest.mark.parametrize("name", list(MODELS))
def test_logits_match_jax(name):
    model, state, port = _pair(name)
    ref, out = _logits(model, state, port, _input(name, 0))
    assert out.shape == (2, 1000)
    np.testing.assert_allclose(out, ref, atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("name", list(MODELS))
def test_jax_imports_port_state_dict(name):
    """The north star's direction. The port's own weights (a second seed)
    and randomised statistics go into the JAX model through the importer;
    the logits are the port's."""
    _, build_port, _ = MODELS[name]
    model, state, _ = _pair(name)
    port = randomize_port_bn(build_port(torch.Generator().manual_seed(1)), seed=4).eval()
    model, state = port_to_jax(port, model, state)
    ref, out = _logits(model, state, port, _input(name, 1))
    np.testing.assert_allclose(ref, out, atol=1e-4, rtol=1e-4)


def test_classifier_reads_chw_order():
    """The flatten before the classifier is CHW-ordered: permuting the
    first Linear's input columns to HWC order would change the logits."""
    _, _, port = _pair("alexnet")
    x = torch.from_numpy(_input("alexnet", 2))
    with torch.no_grad():
        feats = port.avgpool(port.features(x))
        chw = port.classifier(feats.permute(0, 3, 1, 2).reshape(2, -1))
        hwc = port.classifier(feats.reshape(2, -1))
        torch.testing.assert_close(port(x), chw)
    assert not torch.allclose(chw, hwc)


FACTORIES = ["alexnet", "vgg11", "vgg11_bn", "vgg13", "vgg13_bn", "vgg16", "vgg16_bn", "vgg19", "vgg19_bn"]


@pytest.mark.parametrize("name", FACTORIES)
def test_state_dict_matches_manifest(name):
    with open(os.path.join(REPO, "tests", "manifests", f"{name}.json")) as f:
        doc = json.load(f)
    model = create_model(doc["model"], device=torch.device("meta"), **doc.get("kwargs", {}))
    got = [[k, list(v.shape)] for k, v in model.state_dict().items()]
    assert got == doc["entries"]
