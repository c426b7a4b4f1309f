"""EfficientNet of the PyTorch port against the JAX package, end to end.

Two small models built on both sides from the JAX classes' own arguments,
10 classes, 32 x 32 input, every BatchNorm at eps 1e-3: MBConv blocks at
``width_mult`` 0.5 with B5-B7's BatchNorm (momentum 0.01), and a V2-style
trunk of FusedMBConv blocks (with and without expansion) then MBConv.
Every BatchNorm's affine and running statistics are randomised away from
(0, 1) first. JAX -> port with ``weights.load_jax_params`` (``state=``),
port -> JAX through ``eqxvision_tpu.weights.import_torch_weights``; f32
logits at atol 1e-4, rtol 1e-4. Also ``fold_batchnorm`` against the JAX
fold, the stochastic-depth probabilities block by block, and the eleven
factories' state-dict names, shapes and order against the vendored
torchvision manifests, with each variant's dropout and BatchNorm.
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
from eqxvision_tpu.models.classification import efficientnet as JE
from eqxvision_tpu.nn import BatchNorm as JaxBatchNorm
from eqxvision_tpu.ops.fold_bn import fold_batchnorm as jax_fold_batchnorm
from eqxvision_tpu.weights.serialize import _flatten_with_paths
from eqxvision_tpu_torch.models import create_model
from eqxvision_tpu_torch.models.classification import efficientnet as E
from eqxvision_tpu_torch.nn import BatchNorm, Conv2d
from eqxvision_tpu_torch.ops import fold_batchnorm
from eqxvision_tpu_torch.weights import state_dict_from_jax
from test_torch_mobilenet import jax_logits
from test_torch_resnet import _port_logits, jax_to_port, port_to_jax, randomize_port_bn, randomized_jax_bn

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _mbconv_setting(m):
    return [m._mbconf(1, 3, 1, 32, 16, 1, width_mult=0.5), m._mbconf(6, 3, 2, 16, 24, 2, width_mult=0.5),
            m._mbconf(6, 5, 2, 24, 40, 2, width_mult=0.5)]


def _fused_setting(m):
    return [m._fusedconf(1, 3, 1, 16, 16, 2), m._fusedconf(4, 3, 2, 16, 24, 2), m._mbconf(4, 3, 2, 24, 32, 1),
            m._mbconf(6, 3, 1, 32, 40, 2)]


CONFIGS = {  # name: (setting from the module, extra arguments, the norm's arguments)
    "mbconv": (_mbconv_setting, {}, {"eps": 1e-3, "momentum": 0.01}),
    "fused": (_fused_setting, {"last_channel": 64}, {"eps": 1e-3}),
}


@functools.lru_cache(maxsize=None)
def _jax(name):
    setting, kwargs, norm = CONFIGS[name]
    model = JE.EfficientNet(setting(JE), 0.2, num_classes=10, norm_layer=functools.partial(JaxBatchNorm, **norm),
                            key=jax.random.PRNGKey(0), **kwargs)
    model, state = randomized_jax_bn(model, init_state(model), seed=3)
    return tree_inference(model, True), state


def _port(name, seed=0):
    setting, kwargs, norm = CONFIGS[name]
    return E.EfficientNet(setting(E), 0.2, num_classes=10, norm_layer=functools.partial(BatchNorm, **norm),
                          generator=torch.Generator().manual_seed(seed), device="cpu", **kwargs)


def _input(seed):
    return np.random.RandomState(seed).randn(2, 32, 32, 3).astype(np.float32)


def test_fused_config_has_both_block_kinds():
    port = _port("fused")
    blocks = [b for stage in port.features[1:-1] for b in stage]
    assert {type(b) for b in blocks} == {E._FusedMBConv, E._MBConv}
    assert len(blocks[0].block) == 1 and len(blocks[2].block) == 2  # fused without and with expansion
    assert all(m.eps == 1e-3 for m in port.modules() if isinstance(m, BatchNorm))


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


def test_stochastic_depth_grows_linearly_as_in_jax():
    """p * block_id / total_blocks, block by block, in the global mode."""
    model, _ = _jax("fused")
    jax_p = [b.stochastic_depth.p for stage in model.features.layers[1:-1] for b in stage.layers]
    port_p = [b.stochastic_depth.p for stage in _port("fused").features[1:-1] for b in stage]
    assert port_p == jax_p == [0.2 * i / 7 for i in range(7)]
    assert all(b.stochastic_depth.mode == "global" for stage in model.features.layers[1:-1] for b in stage.layers)


def test_fold_batchnorm_matches_jax_fold():
    """Every ConvNormActivation's conv + BatchNorm folds (the port's
    Sequential pair, the JAX fields ``conv``/``norm``); folded weights equal
    the JAX fold's and the folded logits the JAX folded model's."""
    model, state = _jax("mbconv")
    port = jax_to_port(model, state, _port("mbconv"))
    folded = fold_batchnorm(port)
    assert not any(isinstance(m, BatchNorm) for m in folded.modules())
    jax_folded = jax_fold_batchnorm(model, state)
    want = state_dict_from_jax(folded, {k: np.asarray(v) for k, v in _flatten_with_paths(jax_folded)})
    got = folded.state_dict()
    convs = [n for n, m in folded.named_modules() if isinstance(m, Conv2d)]
    assert convs and all(f"{n}.bias" in want for n in convs)
    for name, value in want.items():
        np.testing.assert_allclose(got[name].numpy(), value.numpy(), rtol=1e-6, atol=1e-6, err_msg=name)
    x = _input(3)
    np.testing.assert_allclose(_port_logits(folded, x), jax_logits(jax_folded, state, x), atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(_port_logits(folded, x), _port_logits(port, x), atol=1e-4, rtol=1e-4)


FACTORIES = [f"efficientnet_b{i}" for i in range(8)] + [f"efficientnet_v2_{s}" for s in "sml"]


@pytest.mark.parametrize("name", FACTORIES)
def test_state_dict_matches_manifest(name):
    """Names, shapes and order; and the variant's dropout and BatchNorm
    (``efficientnet.py``'s ``_DROPOUT`` and per-variant ``norm_layer``)."""
    with open(os.path.join(REPO, "tests", "manifests", f"{name}.json")) as f:
        doc = json.load(f)
    model = create_model(doc["model"], device=torch.device("meta"), **doc.get("kwargs", {}))
    got = [[k, list(v.shape)] for k, v in model.state_dict().items()]
    assert got == doc["entries"]
    assert model.classifier[0].p == JE._DROPOUT[name]
    eps, momentum = {"efficientnet_b5": (1e-3, 0.01), "efficientnet_b6": (1e-3, 0.01),
                     "efficientnet_b7": (1e-3, 0.01)}.get(name, (1e-3 if "v2" in name else 1e-5, 0.1))
    assert {(m.eps, m.momentum) for m in model.modules() if isinstance(m, BatchNorm)} == {(eps, momentum)}
