"""ShuffleNetV2 of the PyTorch port against the JAX package, end to end.

x0.5's stage table (repeats 4, 8, 4; channels 24, 48, 96, 192, 1024) at 10
classes and 64 x 64 input: both directions of weight transfer with
randomised BatchNorm statistics at atol 1e-4 (the helpers of
``test_torch_squeezenet``); the channel
shuffle on the last axis against the JAX function; the BN fold of the
branch Sequentials against the JAX fold in f32; the four manifests.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eqxvision_tpu.models.classification import shufflenetv2 as JSh
from eqxvision_tpu.ops.fold_bn import fold_batchnorm as jax_fold_batchnorm
from eqxvision_tpu_torch.models.classification import shufflenetv2 as Sh
from eqxvision_tpu_torch.nn import BatchNorm
from eqxvision_tpu_torch.ops import fold_batchnorm
from test_torch_mobilenet import jax_logits
from test_torch_resnet import _port_logits, jax_to_port
from test_torch_squeezenet import (check_jax_to_port, check_manifest, check_port_to_jax, folded_convs_match_jax,
                                   seeded_jax)

X0_5 = ([4, 8, 4], [24, 48, 96, 192, 1024])


def _jax(key):
    return JSh.ShuffleNetV2(*X0_5, num_classes=10, key=key)


def _port(g):
    return Sh.ShuffleNetV2(*X0_5, num_classes=10, generator=g, device="cpu")


def _input(seed):
    return np.random.RandomState(seed).randn(2, 64, 64, 3).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _jax_model():
    return seeded_jax(_jax)


def test_logits_match_jax():
    port = check_jax_to_port(*_jax_model(), _port, _input(0))
    assert _port_logits(port, _input(1)).shape == (2, 10)


def test_jax_imports_port_state_dict():
    check_port_to_jax(*_jax_model(), _port, _input(2))


@pytest.mark.parametrize("channels", [4, 48, 116])
def test_channel_shuffle_matches_jax(channels):
    x = np.random.RandomState(channels).randn(2, 3, 5, channels).astype(np.float32)
    want = np.asarray(JSh.channel_shuffle(jnp.asarray(x), 2))
    np.testing.assert_array_equal(Sh.channel_shuffle(torch.from_numpy(x), 2).numpy(), want)


def test_stride_one_block_keeps_the_first_half():
    """A stride-1 block passes ``x1`` through untouched: after the shuffle
    it sits on the even channels."""
    block = Sh._InvertedResidual(16, 16, 1, generator=torch.Generator().manual_seed(0), device="cpu").eval()
    x = torch.randn(2, 4, 4, 16)
    with torch.no_grad():
        y = block(x)
    torch.testing.assert_close(y[..., 0::2], x[..., :8])
    assert block.branch1 is not None and len(block.branch1) == 0


def test_fold_batchnorm_matches_jax_fold_f32():
    """Every conv + BatchNorm pair of the branch Sequentials, the stem and
    conv5 folds: the folded weights equal the JAX fold's (jitted), the
    folded logits the JAX model's."""
    model, state = _jax_model()
    port = jax_to_port(model, state, _port(torch.Generator()))
    folded = fold_batchnorm(port)
    assert not any(isinstance(m, BatchNorm) for m in folded.modules())
    folded_convs_match_jax(folded, jax.jit(jax_fold_batchnorm)(model, state))
    x = _input(3)
    np.testing.assert_allclose(_port_logits(folded, x), jax_logits(model, state, x), atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("name", ["shufflenet_v2_x0_5", "shufflenet_v2_x1_0", "shufflenet_v2_x1_5",
                                  "shufflenet_v2_x2_0"])
def test_state_dict_matches_manifest(name):
    check_manifest(name)
