"""The Swin slice of the PyTorch port against the JAX package, end to end.

Both packages build the model through ``create_model``; the JAX parameters
are carried into the port with ``weights.from_jax`` and the logits compared
in f32 at atol 1e-4, rtol 1e-4 (the repo's logit-parity bound), with the
JAX model on its plain path and on its Pallas kernels in interpret mode.
The small configs reach each of the port's paths: C <= 192 blocks take the
whole-block op, the others the fused attention and MLP halves (v1) or the
window-attention op (v2), and the last stage's input is padded up to the
window. Also: the full-width ``swin_t`` and
``swin_v2_t`` parameter names and shapes against the vendored manifests.
"""
import contextlib
import functools
import importlib
import json
import os
from unittest import mock

import jax
import jax.experimental.pallas as pl
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eqxvision_tpu.core import tree_inference
from eqxvision_tpu.models import create_model as jax_create_model
from eqxvision_tpu.weights.serialize import _flatten_with_paths
from eqxvision_tpu_torch.models import create_model
from eqxvision_tpu_torch.ops import window_attention as TW
from eqxvision_tpu_torch.ops import window_attention_half as TWH
from eqxvision_tpu_torch.weights import load_jax_params

jax_attention = importlib.import_module("eqxvision_tpu.ops.attention")
T = importlib.import_module("eqxvision_tpu_torch.ops.attention")
jax_window = importlib.import_module("eqxvision_tpu.ops.window_attention")
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SMALL = dict(embed_dim=32, num_heads=(1, 2, 4, 8), depths=(2, 2, 2, 2), num_classes=10, stochastic_depth_prob=0.1)
# name -> (image size, kwargs, JAX Pallas calls per forward in interpret mode)
CONFIGS = {
    "swin_t-small-112px": ("swin_t", 112, SMALL, 8),  # 6 whole blocks (C <= 192) + 2 window attention
    "swin_v2_t-small-128px": ("swin_v2_t", 128, SMALL, 8),
}


@functools.lru_cache(maxsize=None)
def _jax_model(name):
    _, size, kwargs, _ = CONFIGS[name]
    model, state = jax_create_model(CONFIGS[name][0], **kwargs)
    return tree_inference(model, True), state


def _port(name):
    model, _ = _jax_model(name)
    params = {k: np.asarray(v) for k, v in _flatten_with_paths(model)}
    port = create_model(CONFIGS[name][0], device="cpu", **CONFIGS[name][2])
    return load_jax_params(port, params).eval()


def _interpret(orig, calls):
    def wrapper(*args, **kwargs):
        calls.append(1)
        kwargs["interpret"] = True
        return orig(*args, **kwargs)

    return wrapper


@pytest.mark.parametrize("jax_path", ["plain", "pallas-interpret"])
@pytest.mark.parametrize("config", list(CONFIGS))
def test_logits_match_jax(config, jax_path):
    _, size, _, n_kernels = CONFIGS[config]
    model, state = _jax_model(config)
    port = _port(config)
    x = np.random.RandomState(0).randn(2, size, size, 3).astype(np.float32)
    calls = []
    with contextlib.ExitStack() as stack:
        if jax_path == "pallas-interpret":
            stack.enter_context(mock.patch.object(pl, "pallas_call", _interpret(pl.pallas_call, calls)))
            stack.enter_context(mock.patch.object(jax_attention, "_use_pallas", lambda *a: True))
            stack.enter_context(mock.patch.object(jax_window, "_swin_use_pallas", lambda *a: True))
        ref, _ = jax.jit(lambda m, t, s: m(t, s))(model, jnp.asarray(x), state)
    assert len(calls) == (n_kernels if jax_path == "pallas-interpret" else 0)
    counters = (T.window_qkv_attention, TW.fused_swin_block, TWH.fused_window_attention_half)
    before = [fn.launches for fn in counters]
    with torch.no_grad():
        out = port(torch.from_numpy(x)).numpy()
    assert [fn.launches for fn in counters] == before  # CPU: plain versions
    assert out.shape == (2, 10)
    np.testing.assert_allclose(out, np.asarray(ref), atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("config", list(CONFIGS))
def test_port_routes_blocks_as_jax(config, monkeypatch):
    """Stages 1-3 (C <= 192 here) take the whole-block op, as in the JAX
    package; stage 4 takes the fused attention half (v1) or the
    window-attention op (v2), once per block. Training takes the
    window-attention op everywhere."""
    port = _port(config)
    size = CONFIGS[config][1]
    calls = {"block": 0, "window": 0, "half": 0}

    def count(key, fn):
        def wrapper(*args, **kwargs):
            calls[key] += 1
            return fn(*args, **kwargs)

        return wrapper

    monkeypatch.setattr(TW, "fused_swin_block", count("block", TW.fused_swin_block))
    monkeypatch.setattr(TW, "window_qkv_attention", count("window", TW.window_qkv_attention))
    monkeypatch.setattr(TWH, "fused_window_attention_half", count("half", TWH.fused_window_attention_half))
    with torch.no_grad():
        port(torch.zeros(1, size, size, 3))
    v2 = CONFIGS[config][0].startswith("swin_v2")
    assert calls == {"block": 6, "window": 2 if v2 else 0, "half": 0 if v2 else 2}
    port.train()
    calls.update(block=0, window=0, half=0)
    port(torch.zeros(1, size, size, 3))
    assert calls == {"block": 0, "window": 8, "half": 0}  # training: drop-path is live, no fused op


@pytest.mark.parametrize("name", ["swin_t", "swin_v2_t"])
def test_state_dict_matches_manifest(name):
    with open(os.path.join(REPO, "tests", "manifests", f"{name}.json")) as f:
        doc = json.load(f)
    model = create_model(doc["model"], device=torch.device("meta"), **doc.get("kwargs", {}))
    got = [[k, list(v.shape)] for k, v in model.state_dict().items()]
    assert got == doc["entries"]


@pytest.mark.parametrize("config", list(CONFIGS))
def test_jax_imports_port_state_dict(config):
    """The north star's direction: the port's ``state_dict()`` (its own
    weights, another seed) goes into the JAX model through
    ``eqxvision_tpu.weights.import_torch_weights``, the computed buffers
    skipped as for a torchvision file, and the JAX logits equal the port's."""
    from eqxvision_tpu.weights.torch_import import import_torch_weights

    name, size, kwargs, _ = CONFIGS[config]
    port = create_model(name, generator=torch.Generator().manual_seed(3), device="cpu", **kwargs).eval()
    model, state = _jax_model(config)
    sd = {k: v.detach().numpy() for k, v in port.state_dict().items()}
    model, state = import_torch_weights(
        model, sd, state, strict=True,
        skip_patterns=(r"relative_position_index", r"relative_coords_table", r"attn_mask"),
    )
    x = np.random.RandomState(4).randn(2, size, size, 3).astype(np.float32)
    ref, _ = jax.jit(lambda m, t, s: m(t, s))(model, jnp.asarray(x), state)
    with torch.no_grad():
        out = port(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(np.asarray(ref), out, atol=1e-4, rtol=1e-4)
