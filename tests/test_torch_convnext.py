"""The ConvNeXt slice of the PyTorch port against the JAX package, end to end.

A small ConvNeXt (two stages, C = 128 -> 256, one block each, 10 classes,
32 x 32 input) is built on both sides from the same block setting; the JAX
parameters are carried into the port with ``weights.from_jax`` and the
logits compared in f32 at atol 1e-4, rtol 1e-4 (the repo's logit-parity
bound), with the JAX model on its plain path and on its Pallas LayerNorm
kernel in interpret mode (every width is a multiple of 128, so every norm
reaches the kernel there). ``layer_scale`` and every LayerNorm affine are
randomised first: at the default layer scale of 1e-6 every block is an
identity and the comparison would be blind to the blocks. Also: the
full-size models' parameter names, shapes and order against the vendored
torchvision manifests, their parameter counts, and the training path with
an active stochastic depth, which runs the block's layers one by one.
"""
import functools
import importlib
import json
import os

import jax
import jax.experimental.pallas as pl
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eqxvision_tpu.core import tree_inference
from eqxvision_tpu.core.module import _map_module_tree, replace
from eqxvision_tpu.core.state import init_state
from eqxvision_tpu.models.classification import convnext as JC
from eqxvision_tpu.nn.norm import LayerNorm as JaxLayerNorm
from eqxvision_tpu.weights.serialize import _flatten_with_paths
from eqxvision_tpu_torch.models import create_model
from eqxvision_tpu_torch.models.classification import convnext as convnext_module
from eqxvision_tpu_torch.models.classification.convnext import CNBlockConfig, ConvNeXt
from eqxvision_tpu_torch.weights import load_jax_params

jax_layernorm = importlib.import_module("eqxvision_tpu.ops.layernorm")
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BATCH = 8  # the classifier norm's 8 rows also reach the JAX kernel (it takes row counts that 8 divides)


def _randomized(model, seed):
    rng = np.random.RandomState(seed)

    def fn(m):
        if isinstance(m, JaxLayerNorm) and m.weight is not None:
            w = jnp.asarray(1.0 + 0.3 * rng.randn(*m.weight.shape), m.weight.dtype)
            return replace(m, weight=w, bias=jnp.asarray(0.2 * rng.randn(*m.bias.shape), m.bias.dtype))
        if isinstance(m, JC.CNBlock):
            return replace(m, layer_scale=jnp.asarray(0.5 + 0.2 * rng.randn(*m.layer_scale.shape), jnp.float32))
        return m

    return _map_module_tree(fn, model)


@functools.lru_cache(maxsize=None)
def _pair():
    setting = [JC._CNBlockConfig(128, 256, 1), JC._CNBlockConfig(256, None, 1)]
    model = JC.ConvNeXt(setting, num_classes=10, key=jax.random.PRNGKey(0))
    model = _randomized(tree_inference(model, True), seed=5)
    params = {k: np.asarray(v) for k, v in _flatten_with_paths(model)}
    port = ConvNeXt([CNBlockConfig(128, 256, 1), CNBlockConfig(256, None, 1)], num_classes=10, device="cpu")
    return model, init_state(model), load_jax_params(port, params).eval()


def _interpret(orig, calls):
    def wrapper(*args, **kwargs):
        calls.append(1)
        kwargs["interpret"] = True
        return orig(*args, **kwargs)

    return wrapper


@pytest.mark.parametrize("jax_path", ["plain", "pallas-interpret"])
def test_logits_match_jax(jax_path, monkeypatch):
    model, state, port = _pair()
    x = np.random.RandomState(0).randn(BATCH, 32, 32, 3).astype(np.float32)
    calls = []
    if jax_path == "pallas-interpret":
        monkeypatch.setenv("EQXVISION_TPU_LN_PALLAS", "1")
        monkeypatch.setattr(pl, "pallas_call", _interpret(pl.pallas_call, calls))
        monkeypatch.setattr(jax_layernorm, "_use_pallas", lambda: True)
    ref, _ = jax.jit(lambda m, t, s: m(t, s))(model, jnp.asarray(x), state)
    # stem, two blocks, one downsampling and the classifier norm
    assert len(calls) == (5 if jax_path == "pallas-interpret" else 0)
    with torch.no_grad():
        out = port(torch.from_numpy(x)).numpy()
    assert out.shape == (BATCH, 10)
    np.testing.assert_allclose(out, np.asarray(ref), atol=1e-4, rtol=1e-4)


def test_layer_scale_moves_the_logits():
    """The randomised layer scale reaches the port as (C, 1, 1) and matters."""
    _, _, port = _pair()
    block = port.features[1][0]
    assert tuple(block.layer_scale.shape) == (128, 1, 1)
    x = torch.from_numpy(np.random.RandomState(1).randn(2, 32, 32, 3).astype(np.float32))
    with torch.no_grad():
        out = port(x)
        saved = block.layer_scale.clone()
        block.layer_scale.zero_()
        moved = float((port(x) - out).abs().max())
        block.layer_scale.copy_(saved)
    assert moved > 1e-2


def test_single_chw_sample_matches_batch():
    _, _, port = _pair()
    x = torch.from_numpy(np.random.RandomState(2).randn(3, 32, 32).astype(np.float32))
    with torch.no_grad():
        single = port(x)
        batched = port(x.permute(1, 2, 0)[None])
    assert single.shape == (10,)
    torch.testing.assert_close(single, batched[0])


# torchvision's parameter counts; tests/test_param_counts.py holds the JAX
# package to the tiny and large ones.
PARAM_COUNTS = {
    "convnext_tiny": 28_589_128,
    "convnext_small": 50_223_688,
    "convnext_base": 88_591_464,
    "convnext_large": 197_767_336,
}


@pytest.mark.parametrize("name", list(PARAM_COUNTS))
def test_state_dict_matches_manifest(name):
    with open(os.path.join(REPO, "tests", "manifests", f"{name}.json")) as f:
        doc = json.load(f)
    model = create_model(doc["model"], device=torch.device("meta"), **doc.get("kwargs", {}))
    got = [[k, list(v.shape)] for k, v in model.state_dict().items()]
    assert got == doc["entries"]
    assert sum(p.numel() for p in model.parameters()) == PARAM_COUNTS[name]


def test_training_with_drop_path_runs_unfused_and_draws(monkeypatch):
    """At inference every block is one fused MLP-half call. In training, a
    block with an active stochastic depth runs its layers one by one, the
    branch dropped before the residual add, and each forward draws anew;
    the first block (drop probability 0) stays fused."""
    fused = []
    orig = convnext_module.fused_mlp_half

    def counted(*args, **kwargs):
        fused.append(1)
        return orig(*args, **kwargs)

    monkeypatch.setattr(convnext_module, "fused_mlp_half", counted)
    model = ConvNeXt([CNBlockConfig(32, None, 2)], stochastic_depth_prob=0.5, layer_scale=0.5, num_classes=4,
                     generator=torch.Generator().manual_seed(0), device="cpu")
    assert [b.stochastic_depth.p for b in model.features[1]] == [0.0, 0.5]
    x = torch.from_numpy(np.random.RandomState(3).randn(16, 8, 8, 3).astype(np.float32))
    with torch.no_grad():
        model.eval()
        ref = model(x)
        assert len(fused) == 2
        model.train()
        torch.manual_seed(0)
        a = model(x)
        torch.manual_seed(1)
        b = model(x)
    assert len(fused) == 4
    assert not torch.allclose(a, b)
    assert not torch.allclose(a, ref)


def test_jax_imports_port_state_dict():
    """The north star's direction: the port's ``state_dict()`` (its own
    weights, another seed, layer scale 0.5 so that the blocks count) goes
    into the JAX model through ``eqxvision_tpu.weights.import_torch_weights``,
    as a torchvision file would, and the JAX logits equal the port's."""
    from eqxvision_tpu.weights.torch_import import import_torch_weights

    setting = [CNBlockConfig(128, 256, 1), CNBlockConfig(256, None, 1)]
    port = ConvNeXt(setting, layer_scale=0.5, num_classes=10, generator=torch.Generator().manual_seed(3),
                    device="cpu").eval()
    model, _, _ = _pair()
    sd = {k: v.detach().numpy() for k, v in port.state_dict().items()}
    model, state = import_torch_weights(model, sd, init_state(model), strict=True)
    x = np.random.RandomState(4).randn(BATCH, 32, 32, 3).astype(np.float32)
    ref, _ = jax.jit(lambda m, t, s: m(t, s))(tree_inference(model, True), jnp.asarray(x), state)
    with torch.no_grad():
        out = port(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(np.asarray(ref), out, atol=1e-4, rtol=1e-4)
