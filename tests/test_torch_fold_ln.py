"""The port's LayerNorm fold (``ops.fold_layernorm``) against the JAX package's.

A ViT (vit_tiny widths, depth 2, 32 px, with and without a qkv bias) and a
small ConvNeXt (C = 128 -> 256, one block a stage, 32 px) are built on the
JAX side from a numpy seed (``seeded_jax``) with every LayerNorm affine (and
ConvNeXt's layer scale) drawn away from 1 and 0, carried into the port with ``weights.load_jax_params``, and
folded on both sides: the folded f32 logits agree with the JAX folded
model's and with the port's unfolded ones within 1e-4, and each folded
weight with the JAX one within 1e-5 relative. The fused halves take a
LayerNorm without affine (unit vectors on the card); Swin raises.
"""
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eqxvision_tpu.core.module import _map_module_tree, replace
from eqxvision_tpu.core.state import init_state
from eqxvision_tpu.models.classification import convnext as JC
from eqxvision_tpu.models.classification import vit as JV
from eqxvision_tpu.nn.norm import LayerNorm as JaxLayerNorm
from eqxvision_tpu.ops.fold_ln import fold_layernorm as jax_fold_layernorm
from eqxvision_tpu.weights.serialize import _flatten_with_paths
from eqxvision_tpu_torch.models import create_model
from eqxvision_tpu_torch.models.classification.convnext import CNBlockConfig, ConvNeXt
from eqxvision_tpu_torch.ops import fold_layernorm
from eqxvision_tpu_torch.ops.attention_half import attention_half_reference, fused_attention_half
from eqxvision_tpu_torch.ops.mlp_half import fused_mlp_half, mlp_half_reference
from eqxvision_tpu_torch.weights import load_jax_params
from test_torch_mobilenet import jax_logits
from test_torch_squeezenet import seeded_jax

LOGIT_TOL = 1e-4


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


def _port(model, port):
    return load_jax_params(port, {k: np.asarray(v) for k, v in _flatten_with_paths(model)}).eval()


@functools.lru_cache(maxsize=None)
def _vit(qkv_bias):
    kwargs = dict(img_size=32, depth=2, num_classes=10, qkv_bias=qkv_bias, embed_dim=192, num_heads=3)
    model, _ = seeded_jax(lambda key: JV.VisionTransformer(key=key, **kwargs))
    model = _randomized(model, seed=3)
    return model, _port(model, create_model("vit_tiny", device="cpu", **kwargs))


@functools.lru_cache(maxsize=None)
def _convnext():
    model, _ = seeded_jax(lambda key: JC.ConvNeXt(
        [JC._CNBlockConfig(128, 256, 1), JC._CNBlockConfig(256, None, 1)], num_classes=10, key=key))
    model = _randomized(model, seed=4)
    port = ConvNeXt([CNBlockConfig(128, 256, 1), CNBlockConfig(256, None, 1)], num_classes=10, device="cpu")
    return model, _port(model, port)


def _jax_logits(model, x):
    return jax_logits(model, init_state(model), x)


@pytest.mark.parametrize("family", ["vit-qkv_bias", "vit-no_qkv_bias", "convnext"])
def test_folded_logits_match_jax_and_unfolded(family):
    model, port = _convnext() if family == "convnext" else _vit(family == "vit-qkv_bias")
    x = np.random.RandomState(0).randn(4, 32, 32, 3).astype(np.float32)
    ref = _jax_logits(jax_fold_layernorm(model), x)
    folded = fold_layernorm(port)
    with torch.no_grad():
        out, unfolded = folded(torch.from_numpy(x)).numpy(), port(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(out, ref, atol=LOGIT_TOL, rtol=LOGIT_TOL)
    np.testing.assert_allclose(out, unfolded, atol=LOGIT_TOL, rtol=LOGIT_TOL)
    norms = [m for m in folded.modules() if type(m).__name__ in ("LayerNorm", "LayerNorm2d")]
    assert sum(m.weight is None for m in norms) == (5 if family != "convnext" else 4)
    assert all(m.weight is not None for m in port.modules() if type(m).__name__ in ("LayerNorm", "LayerNorm2d"))


@pytest.mark.parametrize("qkv_bias", [True, False])
def test_folded_vit_weights_match_jax(qkv_bias):
    """Each folded Linear (torch's (out, in) against the JAX (in, out)),
    the bias the fold creates where qkv had none included."""
    model, port = _vit(qkv_bias)
    jf, pf = jax_fold_layernorm(model), fold_layernorm(port)
    for jb, pb in zip(jf.blocks, pf.blocks):
        for jl, pl_ in ((jb.attn.qkv, pb.attn.qkv), (jb.mlp.fc1, pb.mlp.fc1)):
            np.testing.assert_allclose(pl_.weight.detach().numpy().T, np.asarray(jl.weight), rtol=1e-5, atol=1e-7)
            np.testing.assert_allclose(pl_.bias.detach().numpy(), np.asarray(jl.bias), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(pf.head.weight.detach().numpy().T, np.asarray(jf.head.weight), rtol=1e-5, atol=1e-7)


def test_swin_and_others_raise():
    swin = create_model("swin_t", embed_dim=32, depths=(1, 1), num_heads=(2, 2), num_classes=4, device="cpu")
    with pytest.raises(TypeError, match="Swin"):
        fold_layernorm(swin)
    with pytest.raises(TypeError):
        fold_layernorm(create_model("resnet18", num_classes=4, device="cpu"))


def test_fused_halves_take_a_norm_without_affine():
    """``ln_weight``/``ln_bias`` None: the plain versions normalise without
    affine (on the card the kernels read exact unit vectors); one without
    the other raises."""
    rng = np.random.RandomState(5)
    t = lambda *s: torch.from_numpy(rng.randn(*s).astype(np.float32))  # noqa: E731
    x, wqkv, bqkv, wproj, bproj = t(2, 17, 64), t(192, 64), t(192), t(64, 64), t(64)
    ones, zeros = torch.ones(64), torch.zeros(64)
    torch.testing.assert_close(fused_attention_half(x, None, None, wqkv, bqkv, wproj, bproj, 4),
                               attention_half_reference(x, ones, zeros, wqkv, bqkv, wproj, bproj, 4, 16 ** -0.5))
    w1, b1, w2, b2 = t(128, 64), t(128), t(64, 128), t(64)
    torch.testing.assert_close(fused_mlp_half(x, x, None, None, w1, b1, w2, b2),
                               mlp_half_reference(x, x, ones, zeros, w1, b1, w2, b2))
    with pytest.raises(ValueError, match="both"):
        fused_attention_half(x, ones, None, wqkv, bqkv, wproj, bproj, 4)
    with pytest.raises(ValueError, match="both"):
        fused_mlp_half(x, x, None, zeros, w1, b1, w2, b2)
