"""The conv families' layers of the PyTorch port against the JAX package:
BatchNorm (eval and training, with the running-statistics update held
against the JAX ``State``; bf16; statistics kept f32 under a cast), the
pools (padding, dilation, ceil mode and its divisor, non-uniform adaptive
bins), ``flatten_chw``, and ``ops.window_partition``/``window_unpartition``.
Seeded numpy inputs; f32 at atol 1e-5 unless a case says otherwise.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import eqxvision_tpu.nn as JN
import eqxvision_tpu_torch.nn as TN
from eqxvision_tpu.core import tree_inference
from eqxvision_tpu.core.module import replace
from eqxvision_tpu.ops import window_partition as jax_window_partition
from eqxvision_tpu.ops import window_unpartition as jax_window_unpartition
from eqxvision_tpu_torch import ops


def _bn_pair(c, seed, affine=True):
    """A JAX BatchNorm and the port's with the same affine and running
    statistics, both away from (0, 1)."""
    rng = np.random.RandomState(seed)
    mean, var = (0.5 * rng.randn(c)).astype(np.float32), rng.uniform(0.5, 2.0, c).astype(np.float32)
    w, b = (1.0 + 0.3 * rng.randn(c)).astype(np.float32), (0.2 * rng.randn(c)).astype(np.float32)
    jbn = JN.BatchNorm(c, affine=affine)
    state = {jbn.index: (jnp.asarray(mean), jnp.asarray(var))}
    bn = TN.BatchNorm(c, affine=affine, device="cpu")
    with torch.no_grad():
        bn.running_mean.copy_(torch.from_numpy(mean))
        bn.running_var.copy_(torch.from_numpy(var))
        if affine:
            jbn = replace(jbn, weight=jnp.asarray(w), bias=jnp.asarray(b))
            bn.weight.copy_(torch.from_numpy(w))
            bn.bias.copy_(torch.from_numpy(b))
    return jbn, state, bn


def _jax_eval(jbn):
    return tree_inference(jbn, True)


@pytest.mark.parametrize("shape", [(2, 5, 7, 16), (6, 16)], ids=["nhwc", "rows"])
@pytest.mark.parametrize("affine", [True, False])
def test_batchnorm_eval_matches_jax(shape, affine):
    jbn, state, bn = _bn_pair(shape[-1], seed=0, affine=affine)
    x = (3.0 + 2.0 * np.random.RandomState(1).randn(*shape)).astype(np.float32)
    ref, _ = _jax_eval(jbn)(jnp.asarray(x), state)
    with torch.no_grad():
        out = bn.eval()(torch.from_numpy(x))
    assert out.shape == shape and out.is_contiguous()
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("offset", [0.0, 1000.0], ids=["centred", "offset-1e3"])
def test_batchnorm_train_matches_jax_and_updates_stats(offset):
    """Training mode: normalise with the batch's biased variance and move the
    running statistics towards its mean and unbiased variance at
    ``momentum``, as the JAX layer moves its ``State``; a channel offset by
    1e3 keeps its variance (the sums are taken about the first element)."""
    jbn, state, bn = _bn_pair(16, seed=2)
    x = (offset + 2.0 * np.random.RandomState(3).randn(4, 6, 5, 16)).astype(np.float32)
    ref, new_state = jbn(jnp.asarray(x), state)
    bn.train()
    out = bn(torch.from_numpy(x))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref), atol=1e-4, rtol=1e-4)
    mean, var = new_state[jbn.index]
    np.testing.assert_allclose(bn.running_mean.numpy(), np.asarray(mean), rtol=1e-6, atol=1e-6 * (1 + offset))
    np.testing.assert_allclose(bn.running_var.numpy(), np.asarray(var), rtol=1e-4, atol=1e-5)
    assert int(bn.num_batches_tracked) == 1
    assert bn.running_mean.dtype == bn.running_var.dtype == torch.float32


def test_batchnorm_train_gradient_flows():
    _, _, bn = _bn_pair(8, seed=4)
    x = torch.from_numpy(np.random.RandomState(5).randn(3, 4, 4, 8).astype(np.float32)).requires_grad_()
    bn.train()(x).square().sum().backward()
    assert x.grad is not None and bool(torch.isfinite(x.grad).all())
    assert bn.weight.grad is not None and bn.bias.grad is not None


def test_batchnorm_bf16_within_one_step_of_jax():
    """A bf16 model (affine in bf16, statistics f32) on a bf16 input: the
    port's one ``F.batch_norm`` call computes (x - mean) rsqrt(var + eps) w
    + b in f32 where the JAX layer computes x scale + shift, then both round
    once. On torch's CPU kernel the two agree on every output (its
    channels-last kernel takes the JAX order); the bound allows one bf16
    step on at most 1% of outputs and none two steps off."""
    jbn, state, bn = _bn_pair(32, seed=6)
    jbn = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.bfloat16), jbn)
    bn = bn.to(torch.bfloat16).eval()
    assert bn.weight.dtype == torch.bfloat16
    x = (1.0 + 3.0 * np.random.RandomState(7).randn(4, 9, 9, 32)).astype(np.float32)
    xb = jnp.asarray(x, jnp.bfloat16)
    ref, _ = _jax_eval(jbn)(xb, state)
    ref = np.asarray(ref, np.float32)
    with torch.no_grad():
        out = bn(torch.from_numpy(np.asarray(xb, np.float32)).to(torch.bfloat16))
    assert out.dtype == torch.bfloat16
    out = out.float().numpy()
    step = np.exp2(np.floor(np.log2(np.maximum(np.abs(ref), 1e-30))) - 7)
    assert (np.abs(out - ref) / step).max() <= 1.0
    assert (out != ref).mean() <= 0.01


def test_batchnorm_stats_stay_f32_under_a_cast():
    bn = TN.BatchNorm(8, device="cpu")
    with torch.no_grad():
        bn.running_mean.copy_(torch.linspace(-1, 1, 8) / 3)  # values that bf16 cannot hold
    saved = bn.running_mean.clone()
    model = torch.nn.Sequential(TN.Conv2d(3, 8, 1, generator=torch.Generator().manual_seed(0)), bn)
    model = model.to(torch.bfloat16)
    assert model[0].weight.dtype == bn.weight.dtype == bn.bias.dtype == torch.bfloat16
    assert bn.running_mean.dtype == bn.running_var.dtype == torch.float32
    assert torch.equal(bn.running_mean, saved)  # not rounded through bf16 on the way
    assert bn.num_batches_tracked.dtype == torch.long
    model = model.half().float()
    assert bn.weight.dtype == torch.float32 and torch.equal(bn.running_mean, saved)


# (kernel, stride, padding, dilation, ceil mode, input H x W)
MAX_POOL_CASES = {
    "resnet stem": (3, 2, 1, 1, False, (13, 13)),
    "no padding": (3, 2, 0, 1, False, (14, 11)),
    "dilated": (3, 1, 1, 2, False, (9, 10)),
    "dilated, ceil mode": (3, 2, 1, 2, True, (12, 11)),
    "ceil mode": (3, 2, 0, 1, True, (14, 14)),
    "ceil mode, stride 1 (googlenet)": (3, 1, 1, 1, True, (7, 7)),
    "ceil mode 2x2 (googlenet)": (2, 2, 0, 1, True, (7, 7)),
    "ceil mode, last window dropped": (2, 2, 1, 1, True, (5, 5)),
    "ceil mode, padding": (3, 2, 1, 1, True, (12, 9)),
}


@pytest.mark.parametrize("name", list(MAX_POOL_CASES))
def test_max_pool_matches_jax(name):
    k, s, p, d, ceil, (h, w) = MAX_POOL_CASES[name]
    x = np.random.RandomState(8).randn(2, h, w, 5).astype(np.float32)
    ref = JN.MaxPool2d(k, s, p, d, use_ceil=ceil)(jnp.asarray(x))
    out = TN.MaxPool2d(k, s, p, d, use_ceil=ceil)(torch.from_numpy(x))
    assert tuple(out.shape) == ref.shape
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))


@pytest.mark.parametrize("layer", [TN.MaxPool2d, TN.AvgPool2d])
def test_pool_padding_past_half_the_kernel_raises(layer):
    with pytest.raises(ValueError, match="exceeds half the kernel"):
        layer(3, 1, 2)


# (kernel, stride, padding, ceil mode, input H x W); the ceil cases' last
# windows reach past the declared padding, where the divisor shrinks
AVG_POOL_CASES = {
    "plain": (2, 2, 0, False, (8, 8)),
    "padding": (3, 2, 1, False, (9, 10)),
    "ceil mode divisor": (3, 2, 0, True, (14, 11)),
    "ceil mode divisor, padding": (3, 2, 1, True, (12, 9)),
    "ceil mode, last window dropped": (2, 2, 1, True, (5, 5)),
}


@pytest.mark.parametrize("name", list(AVG_POOL_CASES))
def test_avg_pool_matches_jax(name):
    k, s, p, ceil, (h, w) = AVG_POOL_CASES[name]
    x = np.random.RandomState(9).randn(2, h, w, 5).astype(np.float32)
    ref = JN.AvgPool2d(k, s, p, use_ceil=ceil)(jnp.asarray(x))
    out = TN.AvgPool2d(k, s, p, ceil_mode=ceil)(torch.from_numpy(x))
    assert tuple(out.shape) == ref.shape
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-6, rtol=1e-6)


# (input H x W, output size): uniform bins, then bins of unequal width that overlap
ADAPTIVE_CASES = {"uniform": ((14, 14), (7, 7)), "to 1x1": ((7, 5), (1, 1)),
                  "non-uniform": ((10, 7), (6, 6)), "upsampling 1x1": ((1, 1), (6, 6))}


@pytest.mark.parametrize("name", list(ADAPTIVE_CASES))
@pytest.mark.parametrize("kind", ["avg", "max"])
def test_adaptive_pool_matches_jax(name, kind):
    (h, w), size = ADAPTIVE_CASES[name]
    x = np.random.RandomState(10).randn(3, h, w, 4).astype(np.float32)
    jax_layer, port_layer = (JN.AdaptiveAvgPool2d, TN.AdaptiveAvgPool2d) if kind == "avg" else (
        JN.AdaptiveMaxPool2d, TN.AdaptiveMaxPool2d)
    ref = jax_layer(size)(jnp.asarray(x))
    out = port_layer(size)(torch.from_numpy(x))
    assert tuple(out.shape) == ref.shape
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-6, rtol=1e-6)


def test_adaptive_avg_pool_bf16_accumulates_in_f32():
    """Non-uniform bins of a bf16 input: summed in f32 and rounded once on
    both sides; equal but for a bf16 step where the f32 sums differ in
    order."""
    x = np.random.RandomState(11).randn(2, 10, 7, 16).astype(np.float32)
    xb = jnp.asarray(x, jnp.bfloat16)
    ref = np.asarray(JN.adaptive_avg_pool2d(xb, (6, 6)), np.float32)
    out = TN.adaptive_avg_pool2d(torch.from_numpy(np.asarray(xb, np.float32)).to(torch.bfloat16), (6, 6))
    assert out.dtype == torch.bfloat16
    step = np.exp2(np.floor(np.log2(np.maximum(np.abs(ref), 1e-30))) - 7)
    assert (np.abs(out.float().numpy() - ref) / step).max() <= 1.0


def test_flatten_chw_matches_jax():
    x = np.random.RandomState(12).randn(2, 3, 4, 5).astype(np.float32)
    ref = JN.flatten_chw(jnp.asarray(x))
    out = TN.flatten_chw(torch.from_numpy(x))
    assert tuple(out.shape) == (2, 60)
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))
    np.testing.assert_array_equal(TN.FlattenCHW()(torch.from_numpy(x)).numpy(), np.asarray(ref))


def test_window_partition_matches_jax():
    x = np.random.RandomState(13).randn(2, 14, 21, 6).astype(np.float32)
    ref = jax_window_partition(jnp.asarray(x), 7, 7)
    out = ops.window_partition(torch.from_numpy(x), 7, 7)
    assert tuple(out.shape) == ref.shape == (2, 6, 49, 6)
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))


def test_window_unpartition_matches_jax():
    w = np.random.RandomState(14).randn(2, 6, 49, 6).astype(np.float32)
    ref = jax_window_unpartition(jnp.asarray(w), 14, 21, 7, 7)
    out = ops.window_unpartition(torch.from_numpy(w), 14, 21, 7, 7)
    assert tuple(out.shape) == ref.shape == (2, 14, 21, 6)
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))
