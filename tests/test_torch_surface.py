"""The rest of the port's public surface against the JAX package.

``nn.GroupNorm``, ``layers.PatchEmbed``'s ``norm_layer`` and ``flatten``,
ResNet's ``norm_layer``, ``DropPath``'s modes, pools padded past half the
kernel, ``ops.resize_shorter_side(antialias=False)``,
``ops.conv2d_stride2_s2d``, ``core.init``'s distributions and the checkpoint
surface (``weights.load_torch_weights``, ``load_torch_state_dict``,
``resolve_torch_checkpoint``, the ``utils`` re-exports): the same seeded
numpy inputs and weights on both sides, f32 outputs at atol 1e-5 unless a
test says otherwise. No test touches the network.
"""
import functools
import math
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import eqxvision_tpu.nn as JN
import eqxvision_tpu_torch.nn as TN
from eqxvision_tpu.core.init import kaiming_normal as jax_kaiming_normal
from eqxvision_tpu.core.init import normal as jax_normal
from eqxvision_tpu.core.init import ones as jax_ones
from eqxvision_tpu.core.init import zeros as jax_zeros
from eqxvision_tpu.core.module import replace
from eqxvision_tpu.layers import PatchEmbed as JaxPatchEmbed
from eqxvision_tpu.layers import SqueezeExcitation as JaxSqueezeExcitation
from eqxvision_tpu.models.classification import resnet as JR
from eqxvision_tpu.ops import preprocessing as JP
from eqxvision_tpu.ops.space_to_depth import conv2d_stride2_s2d as jax_s2d
from eqxvision_tpu.weights import load_torch_weights as jax_load_torch_weights
from eqxvision_tpu_torch import ops, utils, weights
from eqxvision_tpu_torch.core import init
from eqxvision_tpu_torch.layers import DropPath, PatchEmbed, SqueezeExcitation
from eqxvision_tpu_torch.models import create_model
from eqxvision_tpu_torch.models.classification.resnet import BasicBlock, Bottleneck, ResNet
from eqxvision_tpu_torch.ops import preprocessing as P
from test_torch_resnet import _input, randomize_port_bn
from test_torch_squeezenet import check_port_to_jax, seeded_jax

ATOL = 1e-5


def _t(a):
    return torch.from_numpy(np.asarray(a).copy())


# --------------------------------------------------------------------
# nn.GroupNorm
# --------------------------------------------------------------------


@pytest.mark.parametrize("shape, groups, affine", [((2, 5, 6, 12), 3, True), ((3, 7, 8), 4, True),
                                                   ((2, 4, 4, 6), 6, False), ((2, 3, 3, 8), 1, True)])
def test_group_norm_matches_jax(shape, groups, affine):
    rng = np.random.RandomState(0)
    c = shape[-1]
    x = (3.0 + 2.0 * rng.randn(*shape)).astype(np.float32)
    jax_gn = JN.GroupNorm(groups, c, eps=1e-4, affine=affine)
    port = TN.GroupNorm(groups, c, eps=1e-4, affine=affine, device="cpu")
    if affine:
        w, b = rng.uniform(0.5, 1.5, c).astype(np.float32), rng.randn(c).astype(np.float32)
        jax_gn = replace(jax_gn, weight=jnp.asarray(w), bias=jnp.asarray(b))
        with torch.no_grad():
            port.weight.copy_(_t(w))
            port.bias.copy_(_t(b))
    else:
        assert port.weight is None and list(port.state_dict()) == []
    want = np.asarray(jax_gn(jnp.asarray(x)))
    np.testing.assert_allclose(port(_t(x)).detach().numpy(), want, rtol=0, atol=ATOL)


def test_group_norm_bf16_and_refusals():
    """bf16 in, f32 statistics, one rounding to bf16: within one bf16 step
    of the JAX layer on the same bf16 input."""
    x = np.random.RandomState(1).randn(2, 4, 4, 16).astype(np.float32)
    xb = jnp.asarray(x, jnp.bfloat16)
    want = np.asarray(JN.GroupNorm(4, 16)(xb).astype(jnp.float32))
    got = TN.GroupNorm(4, 16, device="cpu")(_t(np.asarray(xb.astype(jnp.float32))).to(torch.bfloat16))
    assert got.dtype == torch.bfloat16
    step = np.exp2(np.floor(np.log2(np.maximum(np.abs(want), 1e-30))) - 7)
    assert (np.abs(got.float().detach().numpy() - want) / step).max() <= 1.0
    with pytest.raises(ValueError, match="must divide"):
        TN.GroupNorm(3, 16)
    assert TN.GroupNorm is TN.norm.GroupNorm and "GroupNorm" in TN.__all__


# --------------------------------------------------------------------
# layers
# --------------------------------------------------------------------


@pytest.mark.parametrize("flatten", [True, False])
def test_patch_embed_norm_and_flatten_match_jax(flatten):
    port = PatchEmbed(16, 4, 3, 8, norm_layer=functools.partial(TN.LayerNorm, eps=1e-6), flatten=flatten,
                      generator=torch.Generator().manual_seed(0), device="cpu")
    rng = np.random.RandomState(2)
    with torch.no_grad():
        port.norm.weight.copy_(_t(rng.uniform(0.5, 1.5, 8).astype(np.float32)))
        port.norm.bias.copy_(_t(rng.randn(8).astype(np.float32)))
    jax_pe = JaxPatchEmbed(16, 4, 3, 8, norm_layer=functools.partial(JN.LayerNorm, eps=1e-6), flatten=flatten,
                           key=jax.random.PRNGKey(0))
    sd = {k: v.detach().numpy() for k, v in port.state_dict().items()}
    jax_pe = replace(jax_pe, proj=replace(jax_pe.proj, weight=jnp.asarray(sd["proj.weight"].transpose(2, 3, 1, 0)),
                                          bias=jnp.asarray(sd["proj.bias"])),
                     norm=replace(jax_pe.norm, weight=jnp.asarray(sd["norm.weight"]),
                                  bias=jnp.asarray(sd["norm.bias"])))
    x = rng.randn(2, 16, 16, 3).astype(np.float32)
    got = port(_t(x)).detach().numpy()
    assert got.shape == ((2, 16, 8) if flatten else (2, 4, 4, 8))
    np.testing.assert_allclose(got, np.asarray(jax_pe(jnp.asarray(x))), rtol=0, atol=ATOL)


def test_patch_embed_defaults_keep_the_state_dict():
    """No norm: an identity without parameters, the ViT's names unchanged."""
    pe = PatchEmbed(16, 4, 3, 8, generator=torch.Generator().manual_seed(0), device="cpu")
    assert isinstance(pe.norm, torch.nn.Identity) and sorted(pe.state_dict()) == ["proj.bias", "proj.weight"]


RESNET_CASES = {"basic": (JR.BasicBlock, BasicBlock), "bottleneck": (JR.Bottleneck, Bottleneck)}


@pytest.mark.parametrize("config", list(RESNET_CASES))
def test_resnet_norm_layer_matches_jax(config):
    """``norm_layer=partial(BatchNorm, eps=1e-3)`` in every block, the stem
    and the downsamples: the port's weights and randomised statistics
    imported by the JAX package give the port's logits. (The JAX ResNet
    calls its norm as a stateful layer, so a JAX GroupNorm cannot stand
    in.)"""
    jblock, block = RESNET_CASES[config]
    jax_bn, port_bn = functools.partial(JN.BatchNorm, eps=1e-3), functools.partial(TN.BatchNorm, eps=1e-3)
    model, state = seeded_jax(lambda k: JR.ResNet(jblock, [1, 1, 1, 1], num_classes=10, norm_layer=jax_bn, key=k))

    def make_port(generator):
        port = ResNet(block, [1, 1, 1, 1], num_classes=10, norm_layer=port_bn, generator=generator, device="cpu")
        assert all(m.eps == 1e-3 for m in port.modules() if isinstance(m, TN.BatchNorm))
        return port

    check_port_to_jax(model, state, make_port, _input(6, batch=2)[:, :16, :16])


def test_resnet_norm_layer_through_create_model():
    """``create_model`` passes ``norm_layer`` through; a GroupNorm ResNet
    has no BatchNorm and no running statistics, and trains."""
    m = create_model("resnet18", num_classes=5, norm_layer=functools.partial(TN.GroupNorm, 8), device="cpu",
                     generator=torch.Generator().manual_seed(0))
    assert not any(isinstance(mod, TN.BatchNorm) for mod in m.modules())
    assert sum(isinstance(mod, TN.GroupNorm) for mod in m.modules()) == 20
    assert not any("running" in k for k in m.state_dict())
    out = m.train()(torch.randn(2, 32, 32, 3, generator=torch.Generator().manual_seed(1)))
    out.sum().backward()
    assert out.shape == (2, 5) and bool(torch.isfinite(m.conv1.weight.grad).all())


@pytest.mark.parametrize("mode", ["local", "per_channel"])
def test_drop_path_per_channel_mask(mode):
    """One draw per (sample, channel), shared over the spatial axes, kept
    at rate 1 - p and scaled by 1 / (1 - p), as the JAX layer's mask of
    shape (N, 1, ..., C)."""
    p, n, c = 0.3, 64, 48
    layer = DropPath(p, mode=mode).train()
    x = torch.ones(n, 5, 6, c)
    torch.manual_seed(0)
    out = layer(x)
    assert torch.equal(out, out[:, :1, :1].expand_as(out))  # one value a (sample, channel)
    kept = out[:, 0, 0] != 0
    assert set(out.unique().tolist()) <= {0.0, np.float32(1 / (1 - p)).item()}
    assert abs(kept.float().mean().item() - (1 - p)) < 5 * math.sqrt(p * (1 - p) / (n * c))
    assert 0 < kept.sum(1).min() and kept.sum(1).max() < c  # channels of a sample differ
    assert torch.equal(layer.eval()(x), x)
    tokens = DropPath(p, mode=mode).train()(torch.ones(n, 7, c))
    assert torch.equal(tokens, tokens[:, :1].expand_as(tokens))


def test_drop_path_global_mode_unchanged():
    """``mode="global"`` (the default) keeps its draw: one Bernoulli a
    sample from the default generator, the same numbers as before the
    modes came; an unknown mode raises."""
    x = torch.randn(16, 3, 4, 5, generator=torch.Generator().manual_seed(2))
    torch.manual_seed(7)
    out = DropPath(0.25).train()(x)
    torch.manual_seed(7)
    mask = torch.empty((16, 1, 1, 1)).bernoulli_(0.75)
    assert torch.equal(out, torch.where(mask.bool(), x / 0.75, torch.zeros_like(x)))
    with pytest.raises(ValueError, match="not one of"):
        DropPath(0.1, mode="row")


# --------------------------------------------------------------------
# pools past half the kernel, resize without antialias, the S2D stem
# --------------------------------------------------------------------

# (kernel, stride, padding, dilation, ceil mode, input H x W)
WIDE_MAX_POOLS = {
    "k3 s1 p2": (3, 1, 2, 1, False, (7, 6)),
    "k2 s2 p2, ceil": (2, 2, 2, 1, True, (7, 8)),
    "k3 s2 p3 dilated, ceil": (3, 2, 3, 2, True, (9, 10)),
    "k1 s1 p1": (1, 1, 1, 1, False, (4, 5)),
}


@pytest.mark.parametrize("name", list(WIDE_MAX_POOLS))
def test_wide_max_pool_matches_jax(name):
    k, s, p, d, ceil, (h, w) = WIDE_MAX_POOLS[name]
    x = np.random.RandomState(8).randn(2, h, w, 5).astype(np.float32)
    want = np.asarray(JN.MaxPool2d(k, s, p, d, use_ceil=ceil)(jnp.asarray(x)))
    got = TN.MaxPool2d(k, s, p, d, use_ceil=ceil)(_t(x)).numpy()
    assert got.shape == want.shape
    np.testing.assert_array_equal(got, want)


# (kernel, stride, padding, ceil mode, input H x W); the ceil cases' last
# windows reach past the declared padding, where the divisor shrinks
WIDE_AVG_POOLS = {
    "k3 s1 p2": (3, 1, 2, False, (6, 7)),
    "k2 s2 p2": (2, 2, 2, False, (8, 8)),
    "k3 s2 p2, ceil divisor": (3, 2, 2, True, (8, 9)),
    "k2 s3 p2, ceil": (2, 3, 2, True, (10, 7)),
}


@pytest.mark.parametrize("name", list(WIDE_AVG_POOLS))
def test_wide_avg_pool_matches_jax(name):
    k, s, p, ceil, (h, w) = WIDE_AVG_POOLS[name]
    x = np.random.RandomState(9).randn(2, h, w, 5).astype(np.float32)
    want = np.asarray(JN.AvgPool2d(k, s, p, use_ceil=ceil)(jnp.asarray(x)))
    got = TN.AvgPool2d(k, s, p, ceil_mode=ceil)(_t(x))
    assert tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)
    bf16 = TN.AvgPool2d(k, s, p, ceil_mode=ceil)(_t(x).to(torch.bfloat16))
    assert bf16.dtype == torch.bfloat16


@pytest.mark.parametrize("shape, size", [((2, 20, 28, 3), 12), ((2, 28, 20, 3), 40), ((2, 33, 33, 3), 16),
                                         ((1, 31, 17, 3), 7)])
def test_resize_shorter_side_without_antialias_matches_jax(shape, size):
    """Down by 5/3, up by 2, down by about 2, down by about 2.4: pixel
    values in [0, 255] at atol 1e-3, as ``test_torch_augment.py``'s."""
    x = np.random.RandomState(0).uniform(0, 255, shape).astype(np.float32)
    want = np.asarray(JP.resize_shorter_side(jnp.asarray(x), size, antialias=False))
    got = P.resize_shorter_side(_t(x), size, antialias=False).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-3)
    if min(shape[1:3]) > size:  # shrinking: antialias makes a difference
        assert np.abs(P.resize_shorter_side(_t(x), size).numpy() - got).max() > 1.0


def test_conv2d_stride2_s2d_is_exported_and_matches_jax():
    rng = np.random.RandomState(3)
    x = rng.randn(2, 15, 14, 3).astype(np.float32)
    w = rng.randn(8, 3, 7, 7).astype(np.float32) * 0.1  # OIHW
    b = rng.randn(8).astype(np.float32)
    pad = ((3, 3), (3, 3))
    want = np.asarray(jax_s2d(jnp.asarray(x), jnp.asarray(w.transpose(2, 3, 1, 0)), jnp.asarray(b), pad))
    got = ops.conv2d_stride2_s2d(_t(x), _t(w), _t(b), pad).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)
    assert "conv2d_stride2_s2d" in ops.__all__


# --------------------------------------------------------------------
# core.init
# --------------------------------------------------------------------


@pytest.mark.parametrize("nonlinearity", ["relu", "linear"])
def test_kaiming_normal_matches_the_jax_distribution(nonlinearity):
    """The port's and the JAX initializer's draws: mean 0, the same
    standard deviation gain / sqrt(fan) within sampling error."""
    shape, fan = (64, 32, 3, 3), 288
    got = init.kaiming_normal(shape, fan, generator=torch.Generator().manual_seed(0), nonlinearity=nonlinearity)
    want = np.asarray(jax_kaiming_normal(jax.random.PRNGKey(0), shape, fan, nonlinearity=nonlinearity))
    std = (math.sqrt(2.0) if nonlinearity == "relu" else 1.0) / math.sqrt(fan)
    n = got.numel()
    assert got.shape == shape and got.dtype == torch.float32
    for sample in (got.numpy(), want):
        assert abs(sample.mean()) < 5 * std / math.sqrt(n) and abs(sample.std() / std - 1) < 0.02
    again = init.kaiming_normal(shape, fan, generator=torch.Generator().manual_seed(0), nonlinearity=nonlinearity)
    assert torch.equal(got, again)


def test_normal_zeros_ones_match_jax():
    got = init.normal((200, 100), generator=torch.Generator().manual_seed(1), std=0.02)
    want = np.asarray(jax_normal(jax.random.PRNGKey(1), (200, 100), std=0.02))
    for sample in (got.numpy(), want):
        assert abs(sample.std() / 0.02 - 1) < 0.02 and abs(sample.mean()) < 5 * 0.02 / math.sqrt(2e4)
    g = torch.Generator().manual_seed(0)
    for port_fn, jax_fn in ((init.zeros, jax_zeros), (init.ones, jax_ones)):
        np.testing.assert_array_equal(port_fn((3, 4)).numpy(), np.asarray(jax_fn((3, 4))))
        assert port_fn((2,), torch.bfloat16, generator=g).dtype == torch.bfloat16
        assert port_fn((2,), device="meta").is_meta
    assert init.normal((2, 2), generator=g, device="meta").is_meta


# --------------------------------------------------------------------
# checkpoints
# --------------------------------------------------------------------


def _se_pair():
    port = SqueezeExcitation(12, 4, generator=torch.Generator().manual_seed(0), device="cpu")
    jax_se = JaxSqueezeExcitation(12, 4, key=jax.random.PRNGKey(0))
    return port, jax_se


def _se_checkpoint(path, seed, extra=True, nest="state_dict"):
    """A trainer-style checkpoint: the weights of a squeeze-excitation
    nested under ``nest``, an extra head entry and non-tensor metadata."""
    rng = np.random.RandomState(seed)
    sd = {"fc1.weight": rng.randn(4, 12, 1, 1), "fc1.bias": rng.randn(4), "fc2.weight": rng.randn(12, 4, 1, 1),
          "fc2.bias": rng.randn(12)}
    sd = {k: torch.from_numpy(v.astype(np.float32)) for k, v in sd.items()}
    if extra:
        sd["head.weight"] = torch.zeros(3)
    torch.save({nest: sd, "epoch": 7, "args": {"lr": 0.1}}, path)
    return sd


@pytest.mark.parametrize("nest", ["state_dict", "model"])
def test_load_torch_weights_nested_with_skip_patterns_matches_jax(tmp_path, nest):
    path = str(tmp_path / "ckpt.pth")
    sd = _se_checkpoint(path, 0, nest=nest)
    port, jax_se = _se_pair()
    assert weights.load_torch_weights(port, path, skip_patterns=(r"^head\.",)) is port
    jax_se, _ = jax_load_torch_weights(jax_se, path, skip_patterns=(r"^head\.",))
    assert torch.equal(port.fc1.weight, sd["fc1.weight"]) and torch.equal(port.fc2.bias, sd["fc2.bias"])
    x = np.random.RandomState(1).rand(2, 5, 5, 12).astype(np.float32)
    with torch.no_grad():
        got = port(_t(x)).numpy()
    np.testing.assert_allclose(got, np.asarray(jax_se(jnp.asarray(x))), rtol=0, atol=ATOL)
    loaded = weights.load_torch_state_dict(path)
    assert list(loaded) == list(sd) and all(torch.equal(loaded[k], sd[k]) for k in sd)


def test_load_torch_weights_strict(tmp_path):
    """An entry the model lacks raises under ``strict`` on both sides and
    is ignored without it; a missing one raises on both sides."""
    path = str(tmp_path / "ckpt.pth")
    _se_checkpoint(path, 2)
    port, jax_se = _se_pair()
    with pytest.raises(ValueError, match="not consumed"):
        jax_load_torch_weights(jax_se, path)
    with pytest.raises(RuntimeError, match="unexpected keys"):
        weights.load_torch_weights(port, path)
    jax_se, _ = jax_load_torch_weights(jax_se, path, strict=False)
    port, _ = _se_pair()
    weights.load_torch_weights(port, path, strict=False)
    x = np.random.RandomState(3).rand(1, 4, 4, 12).astype(np.float32)
    with torch.no_grad():
        np.testing.assert_allclose(port(_t(x)).numpy(), np.asarray(jax_se(jnp.asarray(x))), rtol=0, atol=ATOL)
    short = str(tmp_path / "short.pth")
    kept = {k: v for k, v in torch.load(path)["state_dict"].items() if k not in ("fc2.bias", "head.weight")}
    torch.save(kept, short)
    with pytest.raises(ValueError, match="exhausted"):
        jax_load_torch_weights(_se_pair()[1], short, strict=False)
    with pytest.raises(RuntimeError, match="missing keys"):
        weights.load_torch_weights(_se_pair()[0], short, strict=False)
    with pytest.raises(ValueError, match="cannot be empty"):
        weights.load_torch_weights(port, None)


def test_nested_checkpoint_through_create_model(tmp_path):
    """A ``{"model": state_dict}`` checkpoint (without
    ``num_batches_tracked``, which the JAX importer never reads) loads
    through ``create_model(torch_weights=...)``."""
    src = create_model("resnet18", num_classes=7, generator=torch.Generator().manual_seed(1), device="cpu")
    randomize_port_bn(src, seed=2)
    path = str(tmp_path / "trainer.pth")
    torch.save({"model": {k: v for k, v in src.state_dict().items() if "num_batches" not in k}, "step": 10}, path)
    m = create_model("resnet18", num_classes=7, torch_weights=path, generator=torch.Generator().manual_seed(9),
                     device="cpu")
    for k, v in src.state_dict().items():
        assert torch.equal(m.state_dict()[k], v), k


def test_resolve_torch_checkpoint(tmp_path, monkeypatch):
    """A local path as it is; a URL's file name found in torch's hub cache
    without a fetch; a missing local path raises."""
    local = tmp_path / "a.pth"
    local.write_bytes(b"x")
    assert weights.resolve_torch_checkpoint(str(local)) == str(local)
    hub = tmp_path / "hub"
    (hub / "checkpoints").mkdir(parents=True)
    cached = hub / "checkpoints" / "resnet18-f37072fd.pth"
    cached.write_bytes(b"x")
    monkeypatch.setattr(torch.hub, "get_dir", lambda: str(hub))

    def no_fetch(*args, **kwargs):
        raise AssertionError("fetched")

    monkeypatch.setattr(torch.hub, "download_url_to_file", no_fetch)
    url = "https://download.pytorch.org/models/resnet18-f37072fd.pth"
    assert weights.resolve_torch_checkpoint(url) == str(cached)
    with pytest.raises(FileNotFoundError):
        weights.resolve_torch_checkpoint(str(tmp_path / "missing.pth"))
    assert not os.path.exists(hub / "checkpoints" / "missing.pth")


def test_utils_and_weights_reexports():
    from eqxvision_tpu import utils as jax_utils

    assert utils.load_torch_weights is weights.load_torch_weights
    assert utils.CLASSIFICATION_URLS is weights.CLASSIFICATION_URLS
    assert utils.SEGMENTATION_URLS == jax_utils.SEGMENTATION_URLS
    assert utils.CLASSIFICATION_URLS == jax_utils.CLASSIFICATION_URLS
    assert set(jax_utils.__all__) == set(utils.__all__)
