"""The segmentation models and the feature taps of the PyTorch port against the
JAX package.

``resize_bilinear`` against the JAX function in f32 (up by 4, up by a
non-integer ratio, down with the JAX antialiasing) and in bf16 (ROADMAP
C.15's two-step bound). FCN and DeepLabV3, each with its aux head, on a
shallow dilated Bottleneck ResNet (``[1, 1, 1, 1]``, output stride 8, the
default 2048/1024 channels) and LR-ASPP on a dilated MobileNetV3-Large at
width 0.5, 5 classes, 64 x 64 input: both directions of weight transfer
with randomised BatchNorm statistics at atol 1e-4 (the helpers of
``test_torch_squeezenet``). DeepLabV3's BN
fold (ASPP's and the heads' Sequentials, ``ASPPPooling``) against the JAX
fold in f32. The factory contract (``ValueError`` on a tap count that does
not fit the aux head; the ``fc`` silenced), the getter's taps and shapes,
two getters in two threads, the three manifests, the registry's 74 names
against the JAX registry's, and ``device="cuda"`` raising without a card
for every factory this slice adds.
"""
import functools
import importlib
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eqxvision_tpu.models.classification import mobilenetv3 as JM3
from eqxvision_tpu.models.classification import resnet as JR
from eqxvision_tpu.models.registry import list_models as jax_list_models
from eqxvision_tpu.models.segmentation._utils import resize_bilinear as jax_resize_bilinear
from eqxvision_tpu.ops.fold_bn import fold_batchnorm as jax_fold_batchnorm
from eqxvision_tpu_torch.experimental import intermediate_layer_getter
from eqxvision_tpu_torch.models import create_model, list_models
from eqxvision_tpu_torch.models.classification.mobilenetv3 import mobilenet_v3_large
from eqxvision_tpu_torch.models.classification.resnet import Bottleneck, ResNet, resnet18
from eqxvision_tpu_torch.models.segmentation import deeplabv3, fcn, lraspp_mobilenet_v3_large, resize_bilinear
from eqxvision_tpu_torch.nn import BatchNorm
from eqxvision_tpu_torch.ops import fold_batchnorm
from test_torch_resnet import jax_to_port
from test_torch_squeezenet import (check_jax_to_port, check_manifest, check_port_to_jax, folded_convs_match_jax,
                                   seeded_jax)

J_FCN = importlib.import_module("eqxvision_tpu.models.segmentation.fcn")
J_DEEPLAB = importlib.import_module("eqxvision_tpu.models.segmentation.deeplabv3")
J_LRASPP = importlib.import_module("eqxvision_tpu.models.segmentation.lraspp")
DILATED = [False, True, True]
NEW_FACTORIES = ["squeezenet1_0", "squeezenet1_1", "densenet121", "densenet161", "densenet169", "densenet201",
                 "shufflenet_v2_x0_5", "shufflenet_v2_x1_0", "shufflenet_v2_x1_5", "shufflenet_v2_x2_0", "googlenet",
                 "fcn", "deeplabv3", "lraspp_mobilenet_v3_large"]


def _jax_simple(factory):
    def build(key):
        kb, kh = jax.random.split(key)
        backbone = JR.ResNet(JR.Bottleneck, [1, 1, 1, 1], replace_stride_with_dilation=DILATED, key=kb)
        return factory(num_classes=5, backbone=backbone, aux_in_channels=1024, key=kh)[0]
    return build


def _port_simple(factory):
    def build(g):
        backbone = ResNet(Bottleneck, [1, 1, 1, 1], replace_stride_with_dilation=DILATED, generator=g, device="cpu")
        return factory(num_classes=5, backbone=backbone, aux_in_channels=1024, generator=g, device="cpu")
    return build


def _jax_lraspp(key):
    kb, kh = jax.random.split(key)
    backbone = JM3.mobilenet_v3_large(width_mult=0.5, dilated=True, key=kb)[0]
    return J_LRASPP.lraspp_mobilenet_v3_large(num_classes=5, backbone=backbone, key=kh)[0]


def _port_lraspp(g):
    backbone = mobilenet_v3_large(width_mult=0.5, dilated=True, generator=g, device="cpu")
    return lraspp_mobilenet_v3_large(num_classes=5, backbone=backbone, generator=g, device="cpu")


MODELS = {  # name: (JAX model from a key, port model from a generator)
    "fcn": (_jax_simple(J_FCN.fcn), _port_simple(fcn)),
    "deeplabv3": (_jax_simple(J_DEEPLAB.deeplabv3), _port_simple(deeplabv3)),
    "lraspp": (_jax_lraspp, _port_lraspp),
}

_jax_forward = jax.jit(lambda model, state, x: model(x, state)[0])


def jax_maps(model, state, x):
    out = _jax_forward(model, state, jnp.asarray(x))
    return [np.asarray(o) for o in out] if isinstance(out, tuple) else np.asarray(out)


def port_maps(port, x):
    with torch.no_grad():
        out = port(torch.from_numpy(x))
    return [o.numpy() for o in out] if isinstance(out, tuple) else out.numpy()


def _input(seed, size=64):
    return np.random.RandomState(seed).randn(2, size, size, 3).astype(np.float32)


RESIZES = {"up 13->52": ((13, 16), (52, 64)), "up 33->65": ((33, 33), (65, 65)), "down 52->13": ((52, 55), (13, 14))}


@pytest.mark.parametrize("case", list(RESIZES))
def test_resize_bilinear_matches_jax_f32(case):
    (h, w), (oh, ow) = RESIZES[case]
    x = np.random.RandomState(0).randn(2, h, w, 5).astype(np.float32)
    want = np.asarray(jax_resize_bilinear(jnp.asarray(x), oh, ow))
    got = resize_bilinear(torch.from_numpy(x), oh, ow).numpy()
    assert got.shape == want.shape == (2, oh, ow, 5)
    np.testing.assert_allclose(got, want, atol=1e-5)


@pytest.mark.parametrize("case", list(RESIZES))
def test_resize_bilinear_bf16_within_two_steps_of_jax(case):
    """C.15: the port's bf16 resize is its f32 resize of the same input
    rounded once; the JAX one rounds inside its bf16 arithmetic. A step is
    the bf16 step of the output's scale, the resize of |x| (a weighted sum
    errs in proportion to its terms' magnitudes): the port stays within
    half a step of the exact value, and the two differ by at most two steps
    (on 28-50% of outputs, measured on the CPU)."""
    (h, w), (oh, ow) = RESIZES[case]
    xb = torch.from_numpy(np.random.RandomState(1).randn(2, h, w, 5).astype(np.float32)).to(torch.bfloat16)
    got = resize_bilinear(xb, oh, ow)
    assert got.dtype == torch.bfloat16
    exact = resize_bilinear(xb.float(), oh, ow)
    torch.testing.assert_close(got, exact.to(torch.bfloat16), atol=0, rtol=0)
    ref = np.asarray(jax_resize_bilinear(jnp.asarray(xb.float().numpy(), jnp.bfloat16), oh, ow), np.float32)
    step = np.exp2(np.floor(np.log2(resize_bilinear(xb.float().abs(), oh, ow).numpy())) - 7)
    got = got.float().numpy()
    assert (np.abs(got - exact.numpy()) / step).max() <= 0.5
    assert (np.abs(got - ref) / step).max() <= 2.0


@functools.lru_cache(maxsize=None)
def _jax(name):
    return seeded_jax(MODELS[name][0])


@pytest.mark.parametrize("name", list(MODELS))
def test_maps_match_jax(name):
    port = check_jax_to_port(*_jax(name), MODELS[name][1], _input(0), forward_jax=jax_maps, forward_port=port_maps)
    out = port_maps(port, _input(1))
    if name == "lraspp":
        assert out.shape == (2, 64, 64, 5)
    else:
        assert [o.shape for o in out] == [(2, 64, 64, 5)] * 2


@pytest.mark.parametrize("name", list(MODELS))
def test_jax_imports_port_state_dict(name):
    check_port_to_jax(*_jax(name), MODELS[name][1], _input(4), forward_jax=jax_maps, forward_port=port_maps)


def test_deeplabv3_fold_matches_jax_fold_f32():
    """The backbone's pairs, ASPP's branches and projection, ``ASPPPooling``
    (the JAX module's fields ``conv``/``bn``, the port's Sequential) and
    both heads fold: the folded weights equal the JAX fold's (jitted), the
    folded maps the JAX model's; the taps survive the fold's copy."""
    model, state = _jax("deeplabv3")
    port = jax_to_port(model, state, MODELS["deeplabv3"][1](torch.Generator()))
    folded = fold_batchnorm(port)
    assert not any(isinstance(m, BatchNorm) for m in folded.modules())
    assert isinstance(folded.classifier[0].convs[4][2], torch.nn.Identity)
    folded_convs_match_jax(folded, jax.jit(jax_fold_batchnorm)(model, state))
    x = _input(2)
    for got, want in zip(port_maps(folded, x), jax_maps(model, state, x)):
        np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4)


def test_factory_contract():
    meta = dict(device="meta")
    with pytest.raises(ValueError, match="expected number of layers is 1"):
        fcn(**meta)  # the default taps are two, and no aux head: the JAX factory raises too
    with pytest.raises(ValueError, match="exactly 2 layers"):
        deeplabv3(intermediate_layers=lambda m: [m.layer4], aux_in_channels=1024, **meta)
    model = fcn(intermediate_layers=lambda m: [m.layer4], **meta)
    assert model.aux_classifier is None and isinstance(model.backbone.fc, torch.nn.Identity)
    model = deeplabv3(aux_in_channels=1024, silence_layers=lambda m: m.avgpool, **meta)
    assert isinstance(model.backbone.avgpool, torch.nn.Identity) and not isinstance(model.backbone.fc, torch.nn.Identity)
    model = lraspp_mobilenet_v3_large(**meta)
    assert (model.classifier.low_classifier.in_channels, model.classifier.cbr[0].in_channels) == (40, 960)


def test_basic_block_refuses_dilation_on_both_sides():
    with pytest.raises(NotImplementedError, match="Dilation"):
        resnet18(replace_stride_with_dilation=DILATED, device="meta")
    with pytest.raises(NotImplementedError, match="Dilation"):
        jax.eval_shape(lambda k: JR.ResNet(JR.BasicBlock, [1, 1, 1, 1], replace_stride_with_dilation=DILATED, key=k),
                       jax.random.PRNGKey(0))


@pytest.fixture(scope="module")
def resnet18_cpu():
    return resnet18(generator=torch.Generator().manual_seed(0), device="cpu").eval()


def test_intermediate_layer_getter_taps_and_shapes(resnet18_cpu):
    """The JAX test's case: taps in ``where``'s order, the whole model run,
    and the getter's names the model's own."""
    wrapped = intermediate_layer_getter(resnet18_cpu, lambda m: [m.layer2, m.layer4])
    with torch.no_grad():
        final, taps = wrapped(torch.zeros(1, 64, 64, 3))
        want = resnet18_cpu.layer2(resnet18_cpu.layer1(resnet18_cpu.maxpool(torch.relu(
            resnet18_cpu.bn1(resnet18_cpu.conv1(torch.zeros(1, 64, 64, 3)))))))
    assert [t.shape for t in taps] == [(1, 8, 8, 128), (1, 2, 2, 512)] and final.shape == (1, 1000)
    torch.testing.assert_close(taps[0], want, atol=0, rtol=0)
    assert list(wrapped.state_dict()) == list(resnet18_cpu.state_dict())
    with torch.no_grad():  # outside the getter's call the taps do nothing
        assert resnet18_cpu(torch.zeros(1, 64, 64, 3)).shape == (1, 1000)
    sequential = intermediate_layer_getter(torch.nn.Sequential(torch.nn.ReLU(), torch.nn.Tanh()), lambda m: [1, 0])
    _, (t1, t0) = sequential(torch.tensor([-1.0, 2.0]))
    torch.testing.assert_close(t0, torch.tensor([0.0, 2.0]))
    torch.testing.assert_close(t1, torch.tanh(t0))
    with pytest.raises(ValueError, match="Sequential"):
        intermediate_layer_getter(resnet18_cpu, lambda m: [1])


def test_intermediate_layer_getter_concurrent_calls(resnet18_cpu):
    """Two getters over the same modules, called in two threads: each call
    sees its own taps (a contextvars stack, each tap writing into its own
    getter's collection)."""
    w24 = intermediate_layer_getter(resnet18_cpu, lambda m: [m.layer2, m.layer4])
    w13 = intermediate_layer_getter(resnet18_cpu, lambda m: [m.layer1, m.layer3])
    x = torch.from_numpy(_input(3, size=64)[:1])
    with torch.no_grad():
        expect = {"w24": [t.clone() for t in w24(x)[1]], "w13": [t.clone() for t in w13(x)[1]]}
    seen, errors = {"w24": [], "w13": []}, []

    def run(name, wrapped):
        try:
            for _ in range(4):
                with torch.no_grad():
                    seen[name].append(wrapped(x)[1])
        except Exception as e:  # pragma: no cover
            errors.append((name, e))

    threads = [threading.Thread(target=run, args=("w24", w24)), threading.Thread(target=run, args=("w13", w13))]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not errors, errors
    for name, calls in seen.items():
        assert len(calls) == 4
        for taps in calls:
            for got, want in zip(taps, expect[name]):
                torch.testing.assert_close(got, want, atol=0, rtol=0)


@pytest.mark.parametrize("name", ["fcn", "deeplabv3", "lraspp_mobilenet_v3_large"])
def test_state_dict_matches_manifest(name):
    check_manifest(name)


def test_registry_matches_the_jax_registry():
    assert list_models() == jax_list_models() and len(list_models()) == 74


@pytest.mark.parametrize("name", NEW_FACTORIES)
def test_cuda_without_a_card_raises(name):
    """No quiet fallback: without a card, the default ``device="cuda"``
    raises instead of building on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: device='cuda' builds there")
    with pytest.raises(RuntimeError, match="no CUDA card"):
        create_model(name, device="cuda")
