"""ViT extras, the space-to-depth stem, observability and the URL table of
the port, against the JAX package where it has a counterpart.

A ViT (vit_tiny widths, patch 8, depth 2, 32 px) built from a numpy seed on
the JAX side (``seeded_jax``) and carried into the port: ``resize_pos_embed``
up (32 -> 48 px) and down (32 -> 16 px, antialiased) gives the JAX
``pos_embed`` within 1e-5 (``jax.image.resize``'s bicubic, a = -0.5) and
logits within 1e-4 at the new size; ``get_last_self_attention`` gives the
JAX maps within 1e-5, and raises in training. ``remat_blocks`` recomputes
each ViT and Swin block with the forward's drop-path masks: the gradients
equal those without remat. ``ops.space_to_depth`` equals the direct f32
convolution within 1e-5 (and ``EQXVISION_TPU_S2D_STEM=1`` routes
``nn.Conv2d`` there); ``observability.checked_call`` names the module with
a planted NaN and ``trace`` writes a trace; ``weights.urls`` is the JAX
table, and a torchvision Swin checkpoint's derived buffers are skipped on a
strict load, and nothing else.
"""
import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eqxvision_tpu.models.classification import vit as JV
from eqxvision_tpu.weights import urls as jax_urls
from eqxvision_tpu_torch import observability
from eqxvision_tpu_torch.models import create_model
from eqxvision_tpu_torch.models.classification import resize_pos_embed
from eqxvision_tpu_torch.nn import Conv2d
from eqxvision_tpu_torch.ops import space_to_depth as s2d
from eqxvision_tpu_torch.weights import urls
from test_torch_mobilenet import jax_logits
from test_torch_resnet import jax_to_port
from test_torch_squeezenet import seeded_jax

KWARGS = dict(img_size=32, patch_size=8, depth=2, num_classes=10, embed_dim=192, num_heads=3)


@functools.lru_cache(maxsize=None)
def _pair():
    model, state = seeded_jax(lambda key: JV.VisionTransformer(key=key, **KWARGS))
    return model, state, jax_to_port(model, state, create_model("vit_tiny", device="cpu", **KWARGS))


@pytest.mark.parametrize("size", [48, 16])
def test_resize_pos_embed_matches_jax(size):
    model, state, port = _pair()
    jr, pr = JV.resize_pos_embed(model, size), resize_pos_embed(port, size)
    assert tuple(pr.pos_embed.shape) == (1, (size // 8) ** 2 + 1, 192) and pr.patch_embed.img_size == (size, size)
    np.testing.assert_allclose(pr.pos_embed.detach().numpy(), np.asarray(jr.pos_embed), atol=1e-5, rtol=1e-5)
    assert port.patch_embed.img_size == (32, 32) and port.pos_embed.shape[1] == 17  # the input model stays
    x = np.random.RandomState(0).randn(2, size, size, 3).astype(np.float32)
    with torch.no_grad():
        got = pr(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, jax_logits(jr, state, x), atol=1e-4, rtol=1e-4)
    assert resize_pos_embed(port, 32) is port


def test_get_last_self_attention_matches_jax():
    model, _, port = _pair()
    x = np.random.RandomState(1).randn(3, 32, 32, 3).astype(np.float32)
    want = np.asarray(jax.jit(model.get_last_self_attention)(jnp.asarray(x)))
    with torch.no_grad():
        got = port.get_last_self_attention(torch.from_numpy(x))
        single = port.get_last_self_attention(torch.from_numpy(x[0].transpose(2, 0, 1)))
    assert got.shape == (3, 3, 17, 17) and got.dtype == torch.float32 and single.shape == (3, 17, 17)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(single, got[0], atol=1e-6, rtol=1e-6)
    port.train()
    try:
        with pytest.raises(ValueError, match="eval"):
            port.get_last_self_attention(torch.from_numpy(x))
    finally:
        port.eval()


@pytest.mark.parametrize("family", ["vit", "swin"])
def test_remat_blocks_replays_drop_path(family):
    def build(remat):
        if family == "vit":
            return create_model("vit_tiny", img_size=32, patch_size=8, depth=2, num_classes=4, drop_path_rate=0.5,
                                remat_blocks=remat, generator=torch.Generator().manual_seed(2), device="cpu")
        return create_model("swin_t", embed_dim=32, depths=(2, 2), num_heads=(2, 4), num_classes=4,
                            stochastic_depth_prob=0.5, remat_blocks=remat, generator=torch.Generator().manual_seed(2),
                            device="cpu")

    x = torch.from_numpy(np.random.RandomState(3).randn(4, 32, 32, 3).astype(np.float32))
    grads = []
    for remat in (False, True):
        model = build(remat).train()
        torch.manual_seed(5)
        model(x).square().sum().backward()
        grads.append({n: p.grad for n, p in model.named_parameters() if p.grad is not None})
    assert grads[0].keys() == grads[1].keys()
    for name, g in grads[0].items():
        torch.testing.assert_close(grads[1][name], g, rtol=1e-5, atol=1e-6, msg=name)


@pytest.mark.parametrize("case", ["7x7-pad3", "7x7-pad3-odd", "4x4-pad1-4ch", "3x3-pad0"])
def test_space_to_depth_equals_direct_conv(case, monkeypatch):
    cin, k, pad, side = {"7x7-pad3": (3, 7, 3, 32), "7x7-pad3-odd": (3, 7, 3, 29), "4x4-pad1-4ch": (4, 4, 1, 18),
                         "3x3-pad0": (3, 3, 0, 17)}[case]
    conv = Conv2d(cin, 16, k, stride=2, padding=pad, generator=torch.Generator().manual_seed(4), device="cpu")
    assert s2d.applicable(cin, conv.stride, conv.kernel_size, conv.padding)
    x = torch.from_numpy(np.random.RandomState(5).randn(2, side, side, cin).astype(np.float32))
    with torch.no_grad():
        direct = conv(x)
        got = s2d.conv2d_stride2_s2d(x, conv.weight, conv.bias, conv.padding)
        monkeypatch.setenv("EQXVISION_TPU_S2D_STEM", "1")
        routed = conv(x)
    assert got.shape == direct.shape
    torch.testing.assert_close(got, direct, atol=1e-5, rtol=1e-5)
    assert torch.equal(routed, got)
    assert not s2d.applicable(8, (2, 2), (3, 3), ((1, 1), (1, 1)))
    assert not s2d.applicable(3, (1, 1), (3, 3), ((1, 1), (1, 1)))
    assert not s2d.applicable(3, (2, 2), (3, 3), ((0, 1), (0, 1)))


def test_checked_call_names_the_module_and_trace_writes(tmp_path):
    model = create_model("resnet18", num_classes=4, device="cpu").eval()
    x = torch.randn(1, 32, 32, 3, generator=torch.Generator().manual_seed(6))
    with torch.no_grad():
        assert torch.equal(observability.checked_call(model, x), model(x))
        model.layer3[0].conv2.weight[0, 0, 0, 0] = float("inf")
        with pytest.raises(FloatingPointError, match=r"layer3\.0\.conv2 \(Conv2d\)"):
            observability.checked_call(model, x)
        with observability.trace(str(tmp_path)) as logdir, observability.annotate("request"):
            model(x)
    assert logdir == str(tmp_path) and any(name.endswith(".json") for name in os.listdir(tmp_path))


def test_url_table_and_derived_buffers(tmp_path):
    assert urls.CLASSIFICATION_URLS == jax_urls.CLASSIFICATION_URLS
    assert urls.SEGMENTATION_URLS == jax_urls.SEGMENTATION_URLS
    assert urls.CLASSIFICATION_URLS["swin_b"] == urls.CLASSIFICATION_URLS["sim_b"]
    kw = dict(embed_dim=32, depths=(1, 1), num_heads=(2, 4), num_classes=4, device="cpu")
    swin = create_model("swin_v2_t", generator=torch.Generator().manual_seed(7), **kw)
    sd = dict(swin.state_dict())
    derived = [k for k in sd if k.rsplit(".", 1)[-1] in ("relative_position_index", "relative_coords_table")]
    assert derived
    for k in derived:  # a torchvision checkpoint's own copies, which the load leaves alone
        sd[k] = torch.zeros_like(sd[k])
    sd["features.1.0.attn.attn_mask"] = torch.zeros(4, 64, 64)
    path = tmp_path / "swin.pth"
    torch.save(sd, path)
    loaded = create_model("swin_v2_t", torch_weights=str(path), **kw)
    for k, v in loaded.state_dict().items():
        assert torch.equal(v, swin.state_dict()[k]), k
    sd["features.1.0.attn.unknown"] = torch.zeros(1)
    torch.save(sd, path)
    with pytest.raises(RuntimeError, match="unexpected keys"):
        create_model("swin_v2_t", torch_weights=str(path), **kw)
    del sd["features.1.0.attn.unknown"], sd["head.bias"]
    torch.save(sd, path)
    with pytest.raises(RuntimeError, match="missing keys"):
        create_model("swin_v2_t", torch_weights=str(path), **kw)
