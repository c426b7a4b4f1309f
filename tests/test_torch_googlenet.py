"""GoogLeNet of the PyTorch port against the JAX package, end to end.

GoogLeNet at its full width with the aux heads and ``transform_input``, 10
classes, 64 x 64 input (the aux heads' 4 x 4 pool sees a 4 x 4 map): eval
logits in both directions of weight transfer with randomised BatchNorm
statistics at atol 1e-4 (the helpers of ``test_torch_squeezenet``); in
training mode (batch statistics, dropout 0) the ``(logits, aux2, aux1)``
tuple in that order on both sides; the BN
fold of ``BasicConv2d``'s ``conv``/``bn`` against the JAX fold in f32;
``googlenet(torch_weights=...)``'s defaults; the manifest.
"""
import functools
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import torch

from eqxvision_tpu.core import tree_inference
from eqxvision_tpu.ops.fold_bn import fold_batchnorm as jax_fold_batchnorm
from eqxvision_tpu_torch.nn import BatchNorm
from eqxvision_tpu_torch.ops import fold_batchnorm
from test_torch_mobilenet import jax_logits
from test_torch_resnet import _port_logits, jax_to_port
from test_torch_squeezenet import (check_jax_to_port, check_manifest, check_port_to_jax, folded_convs_match_jax,
                                   seeded_jax)

JG = importlib.import_module("eqxvision_tpu.models.classification.googlenet")
G = importlib.import_module("eqxvision_tpu_torch.models.classification.googlenet")
KW = dict(num_classes=10, transform_input=True, dropout=0.0, dropout_aux=0.0)


def _jax(key):
    return JG.GoogLeNet(**KW, key=key)


def _port(g):
    return G.GoogLeNet(**KW, generator=g, device="cpu")


def _input(seed):
    return np.random.RandomState(seed).randn(2, 64, 64, 3).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _jax_model():
    return seeded_jax(_jax)


def test_logits_match_jax():
    port = check_jax_to_port(*_jax_model(), _port, _input(0))
    assert _port_logits(port, _input(1)).shape == (2, 10)


def test_jax_imports_port_state_dict():
    check_port_to_jax(*_jax_model(), _port, _input(6))


_jax_train_forward = jax.jit(lambda model, state, x: model(x, state)[0])


def test_training_mode_returns_logits_aux2_aux1():
    """Training mode on both sides (BatchNorm on batch statistics, dropout
    0): three outputs, the main logits, then aux2's, then aux1's, each
    equal to the JAX model's; the running statistics move on both."""
    model, state = _jax_model()
    port = jax_to_port(model, state, _port(torch.Generator())).train()
    x = _input(2)
    with torch.no_grad():
        got = port(torch.from_numpy(x))
    want = _jax_train_forward(tree_inference(model, False), state, jnp.asarray(x))
    assert isinstance(got, tuple) and len(got) == 3 and all(g.shape == (2, 10) for g in got)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-4, rtol=1e-4)
    assert not torch.allclose(got[1], got[2])  # two heads, aux2 on inception4d, aux1 on inception4a
    assert port.conv1.bn.num_batches_tracked.item() == 1


def test_eval_mode_returns_logits_alone_and_aux_off_builds_no_heads():
    port = _port(torch.Generator()).eval()
    with torch.no_grad():
        out = port(torch.from_numpy(_input(3)))
    assert isinstance(out, torch.Tensor) and out.shape == (2, 10)
    plain = G.GoogLeNet(num_classes=10, aux_logits=False, generator=torch.Generator(), device="cpu").train()
    assert plain.aux1 is None and plain.aux2 is None
    with torch.no_grad():
        assert plain(torch.from_numpy(_input(3))).shape == (2, 10)


def test_fold_batchnorm_matches_jax_fold_f32():
    """Every ``BasicConv2d`` pair (fields ``conv`` and ``bn``), the aux heads'
    too, folds: the folded weights equal the JAX fold's (jitted), the
    folded logits the JAX model's."""
    model, state = _jax_model()
    port = jax_to_port(model, state, _port(torch.Generator()))
    folded = fold_batchnorm(port)
    assert not any(isinstance(m, BatchNorm) for m in folded.modules())
    folded_convs_match_jax(folded, jax.jit(jax_fold_batchnorm)(model, state))
    x = _input(4)
    np.testing.assert_allclose(_port_logits(folded, x), jax_logits(model, state, x), atol=1e-4, rtol=1e-4)


def test_torch_weights_turn_on_aux_logits_and_transform_input(tmp_path):
    source = G.googlenet(generator=torch.Generator().manual_seed(0), device="cpu")
    assert source.aux_logits and not source.transform_input  # torchvision's defaults
    path = tmp_path / "googlenet.pt"
    torch.save(source.state_dict(), path)
    loaded = G.googlenet(torch_weights=str(path), device="cpu")
    assert loaded.aux_logits and loaded.transform_input
    torch.testing.assert_close(loaded.fc.weight, source.fc.weight)


def test_transform_input_works_on_the_channel_axis():
    x = np.random.RandomState(5).randn(2, 4, 4, 3).astype(np.float32)
    want = np.asarray(JG.GoogLeNet._transform_input(None, jnp.asarray(x)))
    np.testing.assert_allclose(G.GoogLeNet._transform_input(torch.from_numpy(x)).numpy(), want, atol=1e-6)


def test_state_dict_matches_manifest():
    check_manifest("googlenet")
