"""DenseNet of the PyTorch port against the JAX package, end to end.

A small DenseNet on both sides (``block_config=(2, 2)``, growth 8, 16 stem
features, 10 classes, 32 x 32 input): both directions of weight transfer
with randomised BatchNorm statistics at atol 1e-4 (the helpers of
``test_torch_squeezenet``). Also the JAX
paths' renames (``features.layers[i]`` onto ``conv0``/``norm0``/
``denseblock{k}``/``transition{k}``/``norm5``, a transition's ``norm``
kept), the BN fold (ROADMAP C.14: the port folds the stem pair alone, the
JAX fold raises on every DenseNet) and the four manifests.
"""
import functools

import jax
import numpy as np
import pytest
import torch

from eqxvision_tpu.models.classification import densenet as JD
from eqxvision_tpu.ops.fold_bn import fold_batchnorm as jax_fold_batchnorm
from eqxvision_tpu.weights.serialize import _flatten_with_paths, state_to_paths
from eqxvision_tpu_torch.models.classification import densenet as D
from eqxvision_tpu_torch.nn import BatchNorm
from eqxvision_tpu_torch.ops import fold_batchnorm
from eqxvision_tpu_torch.weights.from_jax import _torch_name
from test_torch_resnet import _port_logits, jax_to_port
from test_torch_squeezenet import check_jax_to_port, check_manifest, check_port_to_jax, seeded_jax


def _jax_small(key):
    return JD.DenseNet(8, (2, 2), 16, num_classes=10, key=key)


def _port_small(g):
    return D.DenseNet(8, (2, 2), 16, num_classes=10, generator=g, device="cpu")


def _input(seed):
    return np.random.RandomState(seed).randn(2, 32, 32, 3).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _jax():
    return seeded_jax(_jax_small)


def test_logits_match_jax():
    port = check_jax_to_port(*_jax(), _port_small, _input(0))
    assert _port_logits(port, _input(1)).shape == (2, 10)


def test_jax_imports_port_state_dict():
    check_port_to_jax(*_jax(), _port_small, _input(3))


def test_jax_paths_map_onto_torchvision_names():
    """Every parameter path and every BatchNorm's state path of the JAX
    model names one entry of the port's, the transition's ``norm`` onto
    ``transitionK.norm`` (not the ConvNormActivation or ConvNeXt renames
    of ``norm``)."""
    model, state = _jax()
    names = set(_port_small(torch.Generator()).state_dict())
    mapped = {_torch_name(p, names) for p, _ in _flatten_with_paths(model)}
    mapped |= {_torch_name(p + leaf, names) for p in state_to_paths(model, state)
               for leaf in (".running_mean", ".running_var")}
    assert mapped == {n for n in names if not n.endswith("num_batches_tracked")}
    assert _torch_name(".features.layers[5].norm.weight", names) == "features.transition1.norm.weight"
    assert _torch_name(".features.layers[5].conv.weight", names) == "features.transition1.conv.weight"
    assert _torch_name(".features.layers[6].layers[1].norm2.running_mean", names) == \
        "features.denseblock2.denselayer2.norm2.running_mean"
    assert _torch_name(".features.layers[7].bias", names) == "features.norm5.bias"


def test_block_concatenates_every_earlier_map():
    block = D._DenseBlock(3, 16, 4, 8, generator=torch.Generator().manual_seed(0), device="cpu").eval()
    x = torch.randn(2, 6, 6, 16)
    with torch.no_grad():
        y = block(x)
        first = block.denselayer1(x)
        second = block.denselayer2(torch.cat([x, first], -1))
    assert y.shape == (2, 6, 6, 16 + 3 * 8)
    torch.testing.assert_close(y[..., :16], x)
    torch.testing.assert_close(y[..., 16:24], first)
    torch.testing.assert_close(y[..., 24:32], second)


def test_fold_batchnorm_folds_the_stem_pair_alone():
    """ROADMAP C.14: each BatchNorm of a dense layer or a transition comes
    before its ReLU and conv and cannot fold into it; the port folds
    ``norm0`` into ``conv0`` and nothing else, and the folded logits stay
    within the fold tests' bound of the unfolded ones. The JAX fold pairs
    ``_Transition``'s fields ``conv`` and ``norm`` and raises."""
    model, state = _jax()
    port = jax_to_port(model, state, _port_small(torch.Generator()))
    folded = fold_batchnorm(port)
    kept = [n for n, m in folded.named_modules() if isinstance(m, BatchNorm)]
    assert [n for n, m in port.named_modules() if isinstance(m, BatchNorm) and n not in kept] == ["features.norm0"]
    assert isinstance(folded.features.norm0, torch.nn.Identity) and folded.features.conv0.bias is not None
    assert isinstance(folded.features.transition1.norm, BatchNorm)
    x = _input(2)
    np.testing.assert_allclose(_port_logits(folded, x), _port_logits(port, x), atol=1e-4, rtol=1e-4)
    with pytest.raises(Exception, match="Incompatible shapes for broadcasting"):
        jax_fold_batchnorm(model, state)


@pytest.mark.parametrize("name", ["densenet121", "densenet161", "densenet169", "densenet201"])
def test_state_dict_matches_manifest(name):
    check_manifest(name)


def test_jax_model_is_built_from_its_own_constructor():
    """``seeded_jax`` keeps the JAX constructor's structure: the same
    leaves, shapes and dtypes as an eagerly built model."""
    eager = _jax_small(jax.random.PRNGKey(0))
    traced, _ = seeded_jax(_jax_small)
    shapes = lambda m: [(p, np.shape(v), np.asarray(v).dtype) for p, v in _flatten_with_paths(m)]  # noqa: E731
    assert shapes(traced) == shapes(eager)
