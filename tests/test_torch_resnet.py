"""The ResNet slice of the PyTorch port against the JAX package, end to end.

Four small ResNets are built on both sides from the JAX classes' arguments:
BasicBlock and Bottleneck with one block a stage, a ResNeXt-style
Bottleneck (``groups=2, width_per_group=8``) and a Bottleneck with
``replace_stride_with_dilation=[False, True, True]``, 10 classes, 32 x 32
input. Every BatchNorm's running statistics and affine are randomised away
from (0, 1) first: a fresh BatchNorm is nearly an identity and the
comparison would be blind to it. Parameters and statistics go JAX -> port
with ``weights.load_jax_params`` (``state=``), and port -> JAX through
``eqxvision_tpu.weights.import_torch_weights`` (the names and order that
``torch_weights=`` relies on); f32 logits at atol 1e-4, rtol 1e-4. Also:
``fold_batchnorm`` against the JAX fold, in f32 and bf16; the nine
factories' state-dict names, shapes and order against the vendored
torchvision manifests; ``entry()``.
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
from eqxvision_tpu.core.module import _map_module_tree, replace
from eqxvision_tpu.core.state import init_state
from eqxvision_tpu.models.classification import resnet as JR
from eqxvision_tpu.nn import Conv2d as JaxConv2d
from eqxvision_tpu.nn import Sequential as JaxSequential
from eqxvision_tpu.nn.norm import BatchNorm as JaxBatchNorm
from eqxvision_tpu.ops.fold_bn import fold_batchnorm as jax_fold_batchnorm
from eqxvision_tpu.weights.serialize import _flatten_with_paths, state_to_paths
from eqxvision_tpu.weights.torch_import import import_torch_weights
from eqxvision_tpu_torch.entry import entry
from eqxvision_tpu_torch.models import create_model
from eqxvision_tpu_torch.models.classification.resnet import BasicBlock, Bottleneck, ResNet
from eqxvision_tpu_torch.nn import BatchNorm, Conv2d
from eqxvision_tpu_torch.ops import fold_batchnorm
from eqxvision_tpu_torch.weights import load_jax_params, state_dict_from_jax

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = {
    "basic": (JR.BasicBlock, BasicBlock, {}),
    "bottleneck": (JR.Bottleneck, Bottleneck, {}),
    "grouped": (JR.Bottleneck, Bottleneck, {"groups": 2, "width_per_group": 8}),
    "dilated": (JR.Bottleneck, Bottleneck, {"replace_stride_with_dilation": [False, True, True]}),
}


def randomized_jax_bn(model, state, seed):
    """Every BatchNorm's affine and running statistics away from (0, 1)."""
    rng = np.random.RandomState(seed)
    state = dict(state)

    def fn(m):
        if isinstance(m, JaxBatchNorm):
            c = m.num_features
            state[m.index] = (jnp.asarray(0.5 * rng.randn(c), jnp.float32),
                              jnp.asarray(rng.uniform(0.5, 2.0, c), jnp.float32))
            return replace(m, weight=jnp.asarray(1.0 + 0.3 * rng.randn(c), m.weight.dtype),
                           bias=jnp.asarray(0.2 * rng.randn(c), m.bias.dtype))
        return m

    return _map_module_tree(fn, model), state


def randomize_port_bn(model, seed):
    rng = np.random.RandomState(seed)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, BatchNorm):
                c = m.num_features
                m.running_mean.copy_(torch.from_numpy(0.5 * rng.randn(c)))
                m.running_var.copy_(torch.from_numpy(rng.uniform(0.5, 2.0, c)))
                m.weight.copy_(torch.from_numpy(1.0 + 0.3 * rng.randn(c)))
                m.bias.copy_(torch.from_numpy(0.2 * rng.randn(c)))
    return model


def jax_to_port(model, state, port):
    """``load_jax_params`` with the running statistics, as a user carries a
    JAX (model, state) across."""
    params = {k: np.asarray(v) for k, v in _flatten_with_paths(model)}
    stats = {k: (np.asarray(m), np.asarray(v)) for k, (m, v) in state_to_paths(model, state).items()}
    return load_jax_params(port, params, stats).eval()


def port_to_jax(port, model, state):
    sd = {k: v.detach().numpy() for k, v in port.state_dict().items()}
    model, state = import_torch_weights(model, sd, state, strict=True)
    return tree_inference(model, True), state


@functools.lru_cache(maxsize=None)
def _jax(config):
    jblock, _, kwargs = CONFIGS[config]
    model = JR.ResNet(jblock, [1, 1, 1, 1], num_classes=10, key=jax.random.PRNGKey(0), **kwargs)
    model, state = randomized_jax_bn(model, init_state(model), seed=3)
    return tree_inference(model, True), state


def _port(config, seed=0):
    _, block, kwargs = CONFIGS[config]
    return ResNet(block, [1, 1, 1, 1], num_classes=10, generator=torch.Generator().manual_seed(seed), device="cpu",
                  **kwargs)


def _input(seed=0, batch=2):
    return np.random.RandomState(seed).randn(batch, 32, 32, 3).astype(np.float32)


def _jax_logits(model, state, x):
    out, _ = model(jnp.asarray(x), state)
    return np.asarray(out)


def _port_logits(port, x):
    with torch.no_grad():
        return port(torch.from_numpy(x)).numpy()


@pytest.mark.parametrize("config", list(CONFIGS))
def test_logits_match_jax(config):
    model, state = _jax(config)
    port = jax_to_port(model, state, _port(config))
    x = _input()
    out = _port_logits(port, x)
    assert out.shape == (2, 10)
    np.testing.assert_allclose(out, _jax_logits(model, state, x), atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("config", list(CONFIGS))
def test_jax_imports_port_state_dict(config):
    """The north star's direction: the port's ``state_dict()`` (its own
    weights and randomised statistics) imported by the JAX package gives
    the port's logits."""
    port = randomize_port_bn(_port(config, seed=7), seed=8).eval()
    model, state = port_to_jax(port, *_jax(config))
    x = _input(1)
    np.testing.assert_allclose(_jax_logits(model, state, x), _port_logits(port, x), atol=1e-4, rtol=1e-4)


def test_running_stats_reach_the_logits():
    """The statistics load: zeroing one BatchNorm's running mean moves the
    logits."""
    model, state = _jax("bottleneck")
    port = jax_to_port(model, state, _port("bottleneck"))
    x = _input(2)
    before = _port_logits(port, x)
    with torch.no_grad():
        saved = port.layer2[0].bn2.running_mean.clone()
        port.layer2[0].bn2.running_mean.zero_()
        moved = np.abs(_port_logits(port, x) - before).max()
        port.layer2[0].bn2.running_mean.copy_(saved)
    assert moved > 1e-2


def test_load_jax_params_raises_on_a_stray_state_path():
    model, state = _jax("basic")
    params = {k: np.asarray(v) for k, v in _flatten_with_paths(model)}
    stats = {k: (np.asarray(m), np.asarray(v)) for k, (m, v) in state_to_paths(model, state).items()}
    stats[".layer1.layers[0].conv1"] = stats.pop(".layer1.layers[0].bn1")
    with pytest.raises(KeyError, match="names no BatchNorm"):
        load_jax_params(_port("basic"), params, stats)


@pytest.mark.parametrize("config", ["basic", "grouped"])
def test_fold_batchnorm_matches_jax_fold_f32(config):
    """Every conv + BatchNorm pair folds (the stem's and the blocks' named
    pairs, the downsample Sequential), the folded weights equal the JAX
    fold's, and the folded model's logits equal the JAX folded model's."""
    model, state = _jax(config)
    port = jax_to_port(model, state, _port(config))
    folded = fold_batchnorm(port)
    assert not any(isinstance(m, BatchNorm) for m in folded.modules())
    assert any(isinstance(m, BatchNorm) for m in port.modules())  # the original is left as it was
    jax_folded = jax_fold_batchnorm(model, state)
    want = state_dict_from_jax(folded, {k: np.asarray(v) for k, v in _flatten_with_paths(jax_folded)})
    got = folded.state_dict()
    convs = [n for n, m in folded.named_modules() if isinstance(m, Conv2d)]
    assert convs and all(f"{n}.bias" in want for n in convs)
    for name, value in want.items():
        np.testing.assert_allclose(got[name].numpy(), value.numpy(), rtol=1e-6, atol=1e-6, err_msg=name)
    x = _input(3)
    np.testing.assert_allclose(_port_logits(folded, x), _jax_logits(jax_folded, state, x), atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(_port_logits(folded, x), _port_logits(port, x), atol=1e-4, rtol=1e-4)


def test_fold_batchnorm_bf16_within_one_step_of_jax():
    """A bf16 conv + BatchNorm pair (ResNeXt's grouped 3x3) folded on both
    sides: the folded bf16 weights and bias, each the f32 value rounded
    once, equal the JAX fold's bit for bit, and the folded conv's bf16
    outputs on one bf16 input are within one bf16 step of the JAX folded
    conv's. Share of outputs a step off, measured here (torch's CPU conv):
    0 (the bound allows 1%)."""
    rng = np.random.RandomState(4)
    jconv = JaxConv2d(64, 64, 3, padding=1, groups=32, use_bias=False, key=jax.random.PRNGKey(1))
    jseq = JaxSequential([jconv, JaxBatchNorm(64)])
    jseq, state = randomized_jax_bn(jseq, init_state(jseq), seed=5)
    state = {k: (8.0 * m, v) for k, (m, v) in state.items()}  # a folded bias large beside the products
    jseq = tree_inference(jseq, True)
    cast = lambda t: jnp.asarray(t, jnp.bfloat16) if t.dtype == jnp.float32 else t  # noqa: E731
    jseq_bf16 = jax.tree_util.tree_map(cast, jseq)
    jfold = jax_fold_batchnorm(jseq_bf16, state).layers[0]

    port = torch.nn.Sequential(Conv2d(64, 64, 3, padding=1, groups=32, use_bias=False,
                                      generator=torch.Generator().manual_seed(0), device="cpu"),
                               BatchNorm(64, device="cpu"))
    params = {k: np.asarray(v) for k, v in _flatten_with_paths(jseq)}
    stats = {k: (np.asarray(m), np.asarray(v)) for k, (m, v) in state_to_paths(jseq, state).items()}
    load_jax_params(port, params, stats).eval()
    fold = fold_batchnorm(port.to(torch.bfloat16))[0]
    assert fold.weight.dtype == fold.bias.dtype == torch.bfloat16
    w = fold.weight.detach().float().numpy().transpose(2, 3, 1, 0)
    np.testing.assert_array_equal(w, np.asarray(jfold.weight, np.float32))
    np.testing.assert_array_equal(fold.bias.detach().float().numpy(), np.asarray(jfold.bias, np.float32))

    x = rng.randn(2, 12, 12, 64).astype(np.float32)
    ref = np.asarray(jfold(jnp.asarray(x, jnp.bfloat16)), np.float32)
    with torch.no_grad():
        out = fold(torch.from_numpy(x).to(torch.bfloat16)).float().numpy()
    step = np.exp2(np.floor(np.log2(np.maximum(np.abs(ref), 1e-30))) - 7)
    steps = np.abs(out - ref) / step
    assert steps.max() <= 1.0
    assert (out != ref).mean() <= 0.01


# torchvision's factories; the manifests hold their state-dict names, shapes and order
FACTORIES = ["resnet18", "resnet34", "resnet50", "resnet101", "resnet152", "resnext50_32x4d", "resnext101_32x8d",
             "wide_resnet50_2", "wide_resnet101_2"]


@pytest.mark.parametrize("name", FACTORIES)
def test_state_dict_matches_manifest(name):
    with open(os.path.join(REPO, "tests", "manifests", f"{name}.json")) as f:
        doc = json.load(f)
    model = create_model(doc["model"], device=torch.device("meta"), **doc.get("kwargs", {}))
    got = [[k, list(v.shape)] for k, v in model.state_dict().items()]
    assert got == doc["entries"]


def test_entry_on_the_cpu():
    forward, (model, x) = entry(device="cpu")
    assert x.shape == (8, 224, 224, 3) and x.dtype == torch.float32
    assert not model.training
    logits = forward(model, x[:1])
    assert logits.shape == (1, 1000) and bool(torch.isfinite(logits).all())


def test_entry_needs_the_card_by_default():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="no CUDA card"):
        entry()
