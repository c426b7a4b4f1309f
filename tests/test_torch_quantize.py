"""The port's int8 quantization (``quantize``) against the JAX package's.

Layers: the int8 weights of ``quantize_linear`` / ``quantize_conv2d`` equal
the JAX quantizer's exactly (torch's (out, in) and OIHW layouts against the
JAX (in, out) and HWIO; half-way values round to even; a zero channel gets
scale 1), the scales agree within 1e-5 relative, and the f32 outputs of
``QuantLinear``, ``QuantConv2d`` and ``DynActInt8Linear`` agree with the
JAX layers' within 1e-5 relative; the w8a8 int32 products are equal, and
the product is int8 x int8 -> int32 (``aten._int_mm``). Models, each built
from a numpy seed on the JAX side (``seeded_jax``) and carried into the port
with ``weights.load_jax_params``: resnet18 (BatchNorm folded, convolutions
and the fc quantized), a ViT (depth 2, 32 px) and a small ConvNeXt, their
int8 logits within 1e-4 of the JAX int8 models'; the int8 ViT block calls
its quantized layers (LayerNorm -> qkv -> fused-qkv attention -> proj, then
LayerNorm -> MLP), never a fused half. A Swin reads the dequantized
weights; the scales stay f32 through a bf16 cast.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from eqxvision_tpu import quantize as JQ
from eqxvision_tpu.core.module import replace
from eqxvision_tpu.models.classification import convnext as JC
from eqxvision_tpu.models.classification import resnet as JR
from eqxvision_tpu.models.classification import vit as JV
from eqxvision_tpu.nn.conv import Conv2d as JaxConv2d
from eqxvision_tpu.nn.linear import Linear as JaxLinear
from eqxvision_tpu.ops.fold_bn import fold_batchnorm as jax_fold_batchnorm
from eqxvision_tpu_torch import quantize as Q
from eqxvision_tpu_torch.models import create_model
from eqxvision_tpu_torch.models.classification import vit as vit_module
from eqxvision_tpu_torch.models.classification.convnext import CNBlockConfig, ConvNeXt
from eqxvision_tpu_torch.models.classification.resnet import BasicBlock, ResNet
from eqxvision_tpu_torch.nn import Conv2d, Linear
from eqxvision_tpu_torch.ops import fold_batchnorm
from test_torch_mobilenet import jax_logits
from test_torch_resnet import jax_to_port
from test_torch_squeezenet import seeded_jax

LOGIT_TOL = 1e-4


def _linear_pair(d_in, d_out, seed, zero_channel=False):
    w = np.random.RandomState(seed).randn(d_out, d_in).astype(np.float32)
    if zero_channel:
        w[1] = 0.0
    w[0, :4] = [127.0, 2.5, -3.5, 0.5]  # scale 1 in channel 0: half-way values round to even
    b = np.random.RandomState(seed + 1).randn(d_out).astype(np.float32)
    lin = Linear(d_in, d_out, generator=torch.Generator().manual_seed(0), device="cpu")
    with torch.no_grad():
        lin.weight.copy_(torch.from_numpy(w))
        lin.bias.copy_(torch.from_numpy(b))
    jlin = jax.eval_shape(lambda key: JaxLinear(d_in, d_out, key=key), jax.random.PRNGKey(0))
    return lin, replace(jlin, weight=jnp.asarray(w.T), bias=jnp.asarray(b))


def _conv_pair(cin, cout, k, stride, padding, groups, seed):
    w = np.random.RandomState(seed).randn(cout, cin // groups, k, k).astype(np.float32)
    w[2] = 0.0
    b = np.random.RandomState(seed + 1).randn(cout).astype(np.float32)
    conv = Conv2d(cin, cout, k, stride=stride, padding=padding, groups=groups,
                  generator=torch.Generator().manual_seed(0), device="cpu")
    with torch.no_grad():
        conv.weight.copy_(torch.from_numpy(w))
        conv.bias.copy_(torch.from_numpy(b))
    jconv = jax.eval_shape(lambda key: JaxConv2d(cin, cout, k, stride=stride, padding=padding, groups=groups, key=key),
                           jax.random.PRNGKey(0))
    return conv, replace(jconv, weight=jnp.asarray(w.transpose(2, 3, 1, 0)), bias=jnp.asarray(b))


@pytest.mark.parametrize("zero_channel", [False, True])
def test_quantize_linear_matches_jax(zero_channel):
    lin, jlin = _linear_pair(96, 48, 0, zero_channel)
    q, jq = Q.quantize_linear(lin), jax.jit(JQ.quantize_linear)(jlin)
    assert q.qweight.dtype == torch.int8 and q.scale.dtype == torch.float32
    np.testing.assert_array_equal(q.qweight.numpy().T, np.asarray(jq.qweight))
    np.testing.assert_allclose(q.scale.numpy(), np.asarray(jq.scale), rtol=1e-5, atol=0)
    assert q.qweight[0, :4].tolist() == [127, 2, -4, 0]
    if zero_channel:
        assert q.scale[1].item() == 1.0 and not q.qweight[1].any()
    np.testing.assert_allclose(q.weight.numpy().T, np.asarray(jq.weight), rtol=1e-6, atol=0)
    x = np.random.RandomState(2).randn(2, 5, 96).astype(np.float32)
    want = np.asarray(jax.jit(jq.__call__)(jnp.asarray(x)))
    got = q(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5 * np.abs(want).max())


@pytest.mark.parametrize("case", ["7x7-s2-stem", "3x3-grouped", "1x1"])
def test_quantize_conv2d_matches_jax(case):
    cin, cout, k, stride, padding, groups = {"7x7-s2-stem": (3, 16, 7, 2, 3, 1), "3x3-grouped": (16, 16, 3, 1, 1, 4),
                                             "1x1": (16, 24, 1, 1, 0, 1)}[case]
    conv, jconv = _conv_pair(cin, cout, k, stride, padding, groups, 3)
    q, jq = Q.quantize_conv2d(conv), jax.jit(JQ.quantize_conv2d)(jconv)
    np.testing.assert_array_equal(q.qweight.numpy().transpose(2, 3, 1, 0), np.asarray(jq.qweight))
    np.testing.assert_allclose(q.scale.numpy(), np.asarray(jq.scale), rtol=1e-5, atol=0)
    assert q.scale[2].item() == 1.0
    x = np.random.RandomState(4).randn(2, 12, 12, cin).astype(np.float32)
    # f32, and a bf16 input: the f32 accumulation scaled and rounded once, as the JAX layer
    want, want_bf16 = (np.asarray(o) for o in jax.jit(
        lambda t: (jq(t), jq(t.astype(jnp.bfloat16)).astype(jnp.float32)))(jnp.asarray(x)))
    got = q(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5 * np.abs(want).max())
    want = want_bf16
    got = q(torch.from_numpy(x).to(torch.bfloat16)).float().numpy()
    np.testing.assert_allclose(got, want, rtol=2 ** -7, atol=1e-6)


class _Ops(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.calls = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        self.calls.append((func, [a.dtype for a in args if isinstance(a, torch.Tensor)], out.dtype))
        return out


def test_dynamic_int8_linear_matches_jax_and_is_an_int8_product():
    lin, jlin = _linear_pair(96, 40, 5)
    q = Q.quantize_dynamic_int8(torch.nn.Sequential(lin))[0]
    jq = jax.jit(JQ.quantize_dynamic_int8)(jlin)
    assert isinstance(q, Q.DynActInt8Linear)
    x = np.random.RandomState(6).randn(3, 7, 96).astype(np.float32)
    np.testing.assert_allclose(q(torch.from_numpy(x)).numpy(), np.asarray(jax.jit(jq.__call__)(jnp.asarray(x))),
                               rtol=1e-5, atol=1e-5)
    # the int32 product itself, on the same int8 activations, equals the JAX dot_general's
    xq = np.random.RandomState(7).randint(-127, 128, (21, 96)).astype(np.int8)
    want = jax.lax.dot_general(jnp.asarray(xq), jq.qweight, (((1,), (0,)), ((), ())), preferred_element_type=jnp.int32)
    with _Ops() as ops:
        got = Q.int8_matmul(torch.from_numpy(xq), q.qweight)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert [(f.__name__, dts, out) for f, dts, out in ops.calls if "mm" in f.__name__] == \
        [("_int_mm.default", [torch.int8, torch.int8], torch.int32)]
    with _Ops() as ops:
        q(torch.from_numpy(x))
    assert any(f.__name__ == "_int_mm.default" for f, _, _ in ops.calls)
    assert not any(f.__name__ in ("mm.default", "addmm.default", "bmm.default") for f, _, _ in ops.calls)


@functools.lru_cache(maxsize=None)
def _models(family):
    """(JAX model and state, port) from one numpy seed."""
    if family == "resnet18":
        model, state = seeded_jax(lambda key: JR.ResNet(JR.BasicBlock, [1, 1, 1, 1], num_classes=10, key=key))
        port = ResNet(BasicBlock, [1, 1, 1, 1], num_classes=10, device="cpu")
    elif family == "vit":
        kwargs = dict(img_size=32, depth=2, num_classes=10, embed_dim=192, num_heads=3)
        model, state = seeded_jax(lambda key: JV.VisionTransformer(key=key, **kwargs))
        port = create_model("vit_tiny", device="cpu", **kwargs)
    else:
        setting = [JC._CNBlockConfig(128, 256, 1), JC._CNBlockConfig(256, None, 1)]
        model, state = seeded_jax(lambda key: JC.ConvNeXt(setting, num_classes=10, layer_scale=0.5, key=key))
        port = ConvNeXt([CNBlockConfig(128, 256, 1), CNBlockConfig(256, None, 1)], num_classes=10, device="cpu")
    return model, state, jax_to_port(model, state, port)


@pytest.mark.parametrize("family", ["resnet18", "vit", "convnext"])
def test_int8_models_match_jax(family):
    model, state, port = _models(family)
    if family == "resnet18":
        jq = jax.jit(lambda m, st: JQ.quantize_weights_int8(jax_fold_batchnorm(m, st), convs=True))(model, state)
        q = Q.quantize_weights_int8(fold_batchnorm(port), convs=True)
        kinds = {type(m).__name__ for m in q.modules()}
        assert "QuantConv2d" in kinds and "Conv2d" not in kinds and "BatchNorm" not in kinds
    else:
        jq, q = jax.jit(JQ.quantize_weights_int8)(model), Q.quantize_weights_int8(port)
        assert not any(isinstance(m, Linear) for m in q.modules())
    x = np.random.RandomState(8).randn(4, 32, 32, 3).astype(np.float32)
    with torch.no_grad():
        got = q(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, jax_logits(jq, state, x), atol=LOGIT_TOL, rtol=LOGIT_TOL)
    assert any(isinstance(m, Linear) for m in port.modules())  # the input model is left as it was


def test_int8_vit_block_calls_its_quantized_layers(monkeypatch):
    _, _, port = _models("vit")
    q = Q.quantize_weights_int8(port)
    calls = []

    def counted(name, fn):
        def wrapper(*args, **kwargs):
            calls.append(name)
            return fn(*args, **kwargs)
        return wrapper

    for name in ("fused_attention_half", "fused_mlp_half", "fused_qkv_attention"):
        monkeypatch.setattr(vit_module, name, counted(name, getattr(vit_module, name)))
    with torch.no_grad():
        q(torch.zeros(1, 32, 32, 3))
    assert calls == ["fused_qkv_attention"] * 2


def test_swin_reads_dequantized_weights_and_scales_stay_f32():
    """A quantized Swin's fused paths read ``QuantLinear.weight`` (q * s in
    f32): the same function as the plain model with those weights, save the
    layers it calls, which scale the accumulator (within 1e-5)."""
    kw = dict(embed_dim=32, depths=(2, 2), num_heads=(2, 4), num_classes=5, device="cpu")
    swin = create_model("swin_t", generator=torch.Generator().manual_seed(1), **kw).eval()
    q = Q.quantize_weights_int8(swin)
    deq = create_model("swin_t", **kw).eval()
    with torch.no_grad():
        for name, m in q.named_modules():
            if isinstance(m, Q.QuantLinear):
                target = deq.get_submodule(name)
                target.weight.copy_(m.weight)
        for name, p in swin.named_parameters():
            if not isinstance(q.get_submodule(name.rsplit(".", 1)[0]), Q.QuantLinear) or name.endswith("bias"):
                deq.get_parameter(name).copy_(p)
    x = torch.from_numpy(np.random.RandomState(9).randn(2, 64, 64, 3).astype(np.float32))
    with torch.no_grad():
        torch.testing.assert_close(q(x), deq(x), rtol=1e-5, atol=1e-5)
    qb = q.to(torch.bfloat16)
    assert all(m.scale.dtype == torch.float32 and m.qweight.dtype == torch.int8
               for m in qb.modules() if isinstance(m, Q.QuantLinear))
    with torch.no_grad():
        assert bool(torch.isfinite(qb(x.to(torch.bfloat16)).float()).all())


def test_weights_quantizer_skips_quantized_layers():
    _, _, port = _models("vit")
    both = Q.quantize_weights_int8(Q.quantize_dynamic_int8(port), convs=True)
    linears = [m for m in both.modules() if isinstance(m, Q.QuantLinear)]
    assert len(linears) == 9 and all(isinstance(m, Q.DynActInt8Linear) for m in linears)
    assert isinstance(both.patch_embed.proj, Q.QuantConv2d)
    big = Q.quantize_weights_int8(port, predicate=lambda m: m.weight.numel() >= 192 * 576)
    assert isinstance(big.blocks[0].attn.qkv, Q.QuantLinear) and isinstance(big.blocks[0].attn.proj, Linear)
