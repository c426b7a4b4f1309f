"""The ViT slice of the PyTorch port against the JAX package, end to end.

Both packages build the model through ``create_model``; the JAX parameters
are carried into the port with ``weights.from_jax`` and the logits compared
in f32 at atol 1e-4, rtol 1e-4 (the repo's logit-parity bound), with the
JAX model on its plain attention and on its Pallas kernel (interpret
mode). Also: the port's full-width ``vit_base`` parameter names and shapes
against the vendored manifest, the port never importing JAX,
``chip_smoke.py`` refusing to run without a card, and the training path
with an active drop path or dropout, which runs the attention half's and
the MLP half's layers one by one.
"""
import contextlib
import importlib
import json
import os
import subprocess
import sys
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
from eqxvision_tpu_torch.models import create_model, list_models
from eqxvision_tpu_torch.models.classification import vit as vit_module
from eqxvision_tpu_torch.weights import load_jax_params

jax_attention = importlib.import_module("eqxvision_tpu.ops.attention")
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

CONFIGS = {
    "vit_tiny-depth2": ("vit_tiny", dict(img_size=32, depth=2, num_classes=10)),
    "width128-2heads": ("vit_tiny", dict(img_size=32, depth=2, num_classes=10, embed_dim=128, num_heads=2)),
}


def _build_pair(name, kwargs):
    model, _ = jax_create_model(name, **kwargs)
    model = tree_inference(model, True)
    params = {k: np.asarray(v) for k, v in _flatten_with_paths(model)}
    port = load_jax_params(create_model(name, device="cpu", **kwargs), params).eval()
    return model, port


def _interpret(orig, calls):
    def wrapper(*args, **kwargs):
        calls.append(1)
        kwargs["interpret"] = True
        return orig(*args, **kwargs)

    return wrapper


@pytest.mark.parametrize("jax_path", ["reference", "pallas-interpret"])
@pytest.mark.parametrize("config", list(CONFIGS))
def test_logits_match_jax(config, jax_path):
    """The JAX model runs either its plain attention (its CPU dispatch) or,
    as on the TPU, its Pallas kernel, here in interpret mode."""
    name, kwargs = CONFIGS[config]
    model, port = _build_pair(name, kwargs)
    x = np.random.RandomState(0).randn(3, 32, 32, 3).astype(np.float32) * 0.5
    calls = []
    with contextlib.ExitStack() as stack:
        if jax_path == "pallas-interpret":
            stack.enter_context(mock.patch.object(pl, "pallas_call", _interpret(pl.pallas_call, calls)))
            stack.enter_context(mock.patch.object(jax_attention, "_use_pallas", lambda *a: True))
        ref, _ = jax.jit(model.__call__)(jnp.asarray(x))
    assert len(calls) == (2 if jax_path == "pallas-interpret" else 0)  # one kernel per block
    with torch.no_grad():
        out = port(torch.from_numpy(x)).numpy()
    assert out.shape == (3, 10)
    np.testing.assert_allclose(out, np.asarray(ref), atol=1e-4, rtol=1e-4)


def test_single_chw_sample_matches_jax():
    model, port = _build_pair(*CONFIGS["vit_tiny-depth2"])
    x = np.random.RandomState(1).randn(3, 32, 32).astype(np.float32) * 0.5
    ref, _ = model(jnp.asarray(x))
    with torch.no_grad():
        out = port(torch.from_numpy(x)).numpy()
    assert out.shape == (10,)
    np.testing.assert_allclose(out, np.asarray(ref), atol=1e-4, rtol=1e-4)


def test_vit_base_state_dict_matches_manifest():
    with open(os.path.join(REPO, "tests", "manifests", "vit_base.json")) as f:
        doc = json.load(f)
    model = create_model(doc["model"], device=torch.device("meta"), **doc["kwargs"])
    got = [[k, list(v.shape)] for k, v in model.state_dict().items()]
    assert got == doc["entries"]


def test_same_seed_same_weights_and_registry(monkeypatch):
    a = create_model("vit_tiny", img_size=32, depth=1, generator=torch.Generator().manual_seed(3), device="cpu")
    b = create_model("vit_tiny", img_size=32, depth=1, generator=torch.Generator().manual_seed(3), device="cpu")
    assert all(torch.equal(x, y) for x, y in zip(a.state_dict().values(), b.state_dict().values()))
    assert list_models() == [
        "alexnet", "convnext_base", "convnext_large", "convnext_small", "convnext_tiny", "deeplabv3",
        "densenet121", "densenet161", "densenet169", "densenet201",
        "efficientnet_b0", "efficientnet_b1", "efficientnet_b2", "efficientnet_b3", "efficientnet_b4",
        "efficientnet_b5", "efficientnet_b6", "efficientnet_b7", "efficientnet_v2_l", "efficientnet_v2_m",
        "efficientnet_v2_s", "fcn", "googlenet", "lraspp_mobilenet_v3_large",
        "mobilenet_v2", "mobilenet_v3_large", "mobilenet_v3_small",
        "regnet_x_16gf", "regnet_x_1_6gf", "regnet_x_32gf", "regnet_x_3_2gf", "regnet_x_400mf", "regnet_x_800mf",
        "regnet_x_8gf", "regnet_y_128gf", "regnet_y_16gf", "regnet_y_1_6gf", "regnet_y_32gf", "regnet_y_3_2gf",
        "regnet_y_400mf", "regnet_y_800mf", "regnet_y_8gf",
        "resnet101", "resnet152", "resnet18", "resnet34", "resnet50", "resnext101_32x8d", "resnext50_32x4d",
        "shufflenet_v2_x0_5", "shufflenet_v2_x1_0", "shufflenet_v2_x1_5", "shufflenet_v2_x2_0",
        "squeezenet1_0", "squeezenet1_1",
        "swin_b", "swin_s", "swin_t", "swin_v2_b", "swin_v2_s", "swin_v2_t",
        "vgg11", "vgg11_bn", "vgg13", "vgg13_bn", "vgg16", "vgg16_bn", "vgg19", "vgg19_bn",
        "vit_base", "vit_small", "vit_tiny", "wide_resnet101_2", "wide_resnet50_2",
    ]
    # pretrained=True takes the DINO checkpoint's URL and fetches it through torch.hub, stubbed here (no test
    # fetches a URL); the headless checkpoint means num_classes 0
    fetched = []

    def fetch(url, **kwargs):
        fetched.append(url)
        return {k: v for k, v in create_model("vit_base", depth=1, num_classes=0, device="cpu").state_dict().items()}

    monkeypatch.setattr(torch.hub, "load_state_dict_from_url", fetch)
    model = create_model("vit_base", pretrained=True, depth=1, device="cpu")
    assert fetched == ["https://dl.fbaipublicfiles.com/dino/dino_vitbase16_pretrain/dino_vitbase16_pretrain.pth"]
    assert isinstance(model.head, torch.nn.Identity)
    with pytest.raises(ValueError):
        create_model("no_such_model")


def test_torch_weights_file_round_trip(tmp_path):
    a = create_model(
        "vit_tiny", img_size=32, depth=1, num_classes=4, generator=torch.Generator().manual_seed(1), device="cpu"
    )
    path = tmp_path / "vit.pt"
    torch.save(a.state_dict(), path)
    b = create_model("vit_tiny", img_size=32, depth=1, num_classes=4, torch_weights=str(path), device="cpu")
    assert all(torch.equal(x, y) for x, y in zip(a.state_dict().values(), b.state_dict().values()))


def test_default_device_is_the_card():
    """Without ``device=`` a model builds on the card; where there is none,
    building raises rather than quietly using the CPU."""
    if torch.cuda.is_available():
        model = create_model("vit_tiny", img_size=32, depth=1)
        assert next(model.parameters()).device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="no CUDA card"):
        create_model("vit_tiny", img_size=32, depth=1)


def test_import_leaves_jax_out():
    """Importing every module of the port, and chip_smoke.py, loads no JAX
    and nothing of the JAX package."""
    code = (
        "import importlib, pkgutil, sys, eqxvision_tpu_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "import chip_smoke\n"
        "bad = [n for n in sys.modules if n == 'jax' or n.startswith(('jax.', 'eqxvision_tpu.'))"
        " or n == 'eqxvision_tpu']\n"
        "sys.exit(1 if bad else 0)"
    )
    env = dict(os.environ, PYTHONPATH=REPO)
    assert subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env, timeout=120).returncode == 0


def test_chip_smoke_refuses_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present; chip_smoke.py would run")
    proc = subprocess.run(
        [sys.executable, "chip_smoke.py"], cwd=REPO, capture_output=True, text=True, timeout=120
    )
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout


def test_training_with_drop_path_runs_unfused_and_draws(monkeypatch):
    """At inference every block's MLP half is one fused call. In training, a
    block with an active drop path runs norm2 and the MLP one by one and
    each forward draws anew; the first block (drop path 0) stays fused."""
    fused = []
    orig = vit_module.fused_mlp_half

    def counted(*args, **kwargs):
        fused.append(1)
        return orig(*args, **kwargs)

    monkeypatch.setattr(vit_module, "fused_mlp_half", counted)
    model = create_model("vit_tiny", img_size=32, depth=2, num_classes=4, drop_path_rate=0.5,
                         generator=torch.Generator().manual_seed(0), device="cpu")
    assert [blk.drop_path.p for blk in model.blocks] == [0.0, 0.5]
    x = torch.from_numpy(np.random.RandomState(3).randn(16, 32, 32, 3).astype(np.float32))
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


@pytest.mark.parametrize(
    "kwargs,fused_in_training,k1_in_training",
    [(dict(drop_path_rate=0.5), 1, 1), (dict(drop_rate=0.1), 0, 2), (dict(attn_drop_rate=0.1), 0, 0)],
    ids=["drop-path", "proj-dropout", "attention-dropout"],
)
def test_attention_half_fused_at_eval_and_unfused_in_training(monkeypatch, kwargs, fused_in_training, k1_in_training):
    """At inference every block's attention half is one fused call. In
    training, a block with an active drop path, proj dropout or attention
    dropout runs norm1, qkv, the attention and proj one by one (the
    attention on the fused-qkv op unless attention dropout needs the
    probabilities) and each forward draws anew; with drop path alone the
    first block (drop path 0) stays fused."""
    calls = {"fused_attention_half": [], "fused_qkv_attention": []}

    def counting(fn, seen):
        def counted(*args, **kw):
            seen.append(1)
            return fn(*args, **kw)

        return counted

    for name, seen in calls.items():
        monkeypatch.setattr(vit_module, name, counting(getattr(vit_module, name), seen))
    model = create_model("vit_tiny", img_size=32, depth=2, num_classes=4, generator=torch.Generator().manual_seed(0),
                         device="cpu", **kwargs)
    x = torch.from_numpy(np.random.RandomState(4).randn(16, 32, 32, 3).astype(np.float32))
    with torch.no_grad():
        model.eval()
        ref = model(x)
        assert (len(calls["fused_attention_half"]), len(calls["fused_qkv_attention"])) == (2, 0)
        model.train()
        torch.manual_seed(0)
        a = model(x)
        torch.manual_seed(1)
        b = model(x)
    assert len(calls["fused_attention_half"]) == 2 + 2 * fused_in_training
    assert len(calls["fused_qkv_attention"]) == 2 * k1_in_training
    assert not torch.allclose(a, b)
    assert not torch.allclose(a, ref)


@pytest.mark.parametrize("config", list(CONFIGS))
def test_jax_imports_port_state_dict(config):
    """The north star's direction: the port's ``state_dict()`` (its own
    weights, another seed) goes into the JAX model through
    ``eqxvision_tpu.weights.import_torch_weights``, as a torchvision file
    would, and the JAX logits equal the port's."""
    from eqxvision_tpu.weights.torch_import import import_torch_weights

    name, kwargs = CONFIGS[config]
    port = create_model(name, generator=torch.Generator().manual_seed(3), device="cpu", **kwargs).eval()
    model, state = jax_create_model(name, **kwargs)
    sd = {k: v.detach().numpy() for k, v in port.state_dict().items()}
    model, _ = import_torch_weights(model, sd, state, strict=True)
    x = np.random.RandomState(4).randn(2, 32, 32, 3).astype(np.float32) * 0.5
    ref, _ = jax.jit(tree_inference(model, True).__call__)(jnp.asarray(x))
    with torch.no_grad():
        out = port(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(np.asarray(ref), out, atol=1e-4, rtol=1e-4)
