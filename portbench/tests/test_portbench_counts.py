"""The benchmark's counts: each model's multiply-adds against the published
GMACs, each kernel's operations and bytes against the shapes of a plain
composition of what it computes, and each kernel's sizes from the input
shapes that the trace records of each of its launches."""
from __future__ import annotations

import json
from types import SimpleNamespace

import pytest
import torch
import torch.nn.functional as F
from torch.utils.flop_counter import FlopCounterMode

from portbench.families import swin as swin_family
from portbench.families import vit as vit_family
from portbench.harness import roofline, spec


def _config(name):
    return json.loads((spec.HERE / "configs" / f"{name}.json").read_text())


@pytest.mark.parametrize("name,family", [("vit_base", vit_family), ("swin_t", swin_family)])
def test_macs_match_the_published_count(name, family):
    cfg = _config(name)
    assert family.forward_macs(cfg) / 1e9 == pytest.approx(cfg["published_gmacs"], rel=2e-3)


def _flops(fn, *args):
    with FlopCounterMode(display=False) as counter:
        fn(*args)
    return counter.get_total_flops()


def _nbytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors)


def _rand(*shape):
    return torch.randn(*shape, dtype=torch.bfloat16)


def test_attention_half_counts():
    n, l, d, heads = 2, 17, 32, 4
    x, w_qkv, b_qkv, w_p, b_p, g, b = _rand(n, l, d), _rand(3 * d, d), _rand(3 * d), _rand(d, d), _rand(d), _rand(d), _rand(d)

    def half(x):
        h = F.layer_norm(x, (d,), g, b)
        q, k, v = F.linear(h, w_qkv, b_qkv).reshape(n, l, 3, heads, d // heads).permute(2, 0, 3, 1, 4)
        a = torch.softmax(q @ k.transpose(-1, -2), -1) @ v
        return x + F.linear(a.transpose(1, 2).reshape(n, l, d), w_p, b_p)

    out = half(x)
    assert roofline.attention_half(n, l, d) == (_flops(half, x), _nbytes(x, w_qkv, b_qkv, w_p, b_p, g, b, out))


def test_mlp_half_counts():
    rows, d, hidden = 10, 16, 64
    x, w1, b1, w2, b2, g, b = _rand(rows, d), _rand(hidden, d), _rand(hidden), _rand(d, hidden), _rand(d), _rand(d), _rand(d)

    def half(x):
        return x + F.linear(F.gelu(F.linear(F.layer_norm(x, (d,), g, b), w1, b1)), w2, b2)

    out = half(x)
    assert roofline.mlp_half(rows, d, hidden) == (_flops(half, x), _nbytes(x, w1, b1, w2, b2, g, b, out))


def _window_half(x, w_qkv, b_qkv, w_p, b_p, g, b, bias, heads, win):
    t, d = x.shape
    h = F.layer_norm(x, (d,), g, b)
    q, k, v = F.linear(h, w_qkv, b_qkv).reshape(t // win, win, 3, heads, d // heads).permute(2, 0, 3, 1, 4)
    a = torch.softmax(q @ k.transpose(-1, -2) + bias, -1) @ v
    return x + F.linear(a.transpose(1, 2).reshape(t, d), w_p, b_p)


def test_window_attention_half_and_swin_block_counts():
    t, d, heads, win, hidden = 2 * 49, 24, 3, 49, 96
    args = (_rand(t, d), _rand(3 * d, d), _rand(3 * d), _rand(d, d), _rand(d), _rand(d), _rand(d), _rand(heads, win, win))
    out = _window_half(*args, heads, win)
    assert roofline.window_attention_half(t, d, heads, win) == (
        _flops(_window_half, *args, heads, win), _nbytes(*args, out))
    mlp = (_rand(hidden, d), _rand(hidden), _rand(d, hidden), _rand(d), _rand(d), _rand(d))

    def block(*a):
        h = _window_half(*a, heads, win)
        w1, b1, w2, b2, g, b = mlp
        return h + F.linear(F.gelu(F.linear(F.layer_norm(h, (d,), g, b), w1, b1)), w2, b2)

    out = block(*args)
    assert roofline.swin_block(t, d, heads, win, hidden) == (_flops(block, *args), _nbytes(*args, *mlp, out))


def test_qkv_attention_and_layer_norm_counts():
    n, l, d, heads = 2, 9, 16, 2
    qkv = _rand(n, l, 3 * d)

    def attn(qkv):
        q, k, v = qkv.reshape(n, l, 3, heads, d // heads).permute(2, 0, 3, 1, 4)
        return (torch.softmax(q @ k.transpose(-1, -2), -1) @ v).transpose(1, 2).reshape(n, l, d)

    assert roofline.qkv_attention(n, l, d) == (_flops(attn, qkv), _nbytes(qkv, attn(qkv)))
    x, g, b = _rand(12, d), _rand(d), _rand(d)
    assert roofline.layer_norm(12, d)[1] == _nbytes(x, g, b, F.layer_norm(x, (d,), g, b))


def test_bound_takes_the_larger_of_the_two():
    assert roofline.bound_s((989e12, 0.0)) == pytest.approx(1.0)
    assert roofline.bound_s((0.0, 3.35e12)) == pytest.approx(1.0)


TINY_VIT = {"image_size": 32, "patch_size": 8, "in_chans": 3, "embed_dim": 32, "depth": 3, "num_heads": 2,
            "mlp_ratio": 4.0, "num_classes": 10, "qkv_bias": True, "ln_eps": 1e-6, "factory": "vit_base"}
TINY_SWIN = {"image_size": 56, "patch_size": 4, "in_chans": 3, "embed_dim": 96, "depths": [2, 2, 1],
             "num_heads": [3, 6, 12], "window_size": 7, "mlp_ratio": 4.0, "num_classes": 10, "factory": "swin_t"}

# Each kernel's sizes at a ViT b2 (17 tokens, width 32, 4 x 32 hidden) and at a Swin's first stage (b2, 14 x 14
# map, width 96, 3 heads, 7 x 7 windows) and third (width 384, 12 heads, one 7 x 7 window), from the inputs of its
# Function's forward in order; None and numbers take a slot with no shape.
ARGS_OF_SHAPES = [
    ("attention_half", [[2, 17, 32], [32], [32], [96, 32], [96], [32, 32], [32], [], [], []], (2, 17, 32)),
    ("mlp_half", [[2, 17, 32], [2, 17, 32], [32], [32], [128, 32], [128], [32, 128], [32], [], []], (34, 32, 128)),
    ("window_attention_half", [[2, 1, 49, 384], [384], [384], [1152, 384], [1152], [384, 384], [384],
                               [1, 12, 49, 49], [], [], [], []], (98, 384, 12, 49)),
    ("swin_block", [[2, 14, 14, 96], [4, 3, 49, 49], [], [96], [96], [288, 96], [288], [96, 96], [96], [96], [96],
                    [384, 96], [384], [96, 384], [96], [], [], [], [], [], []], (392, 96, 3, 49, 384)),
    ("qkv_attention", [[2, 17, 96], [], []], (2, 17, 32)),
    ("layer_norm", [[2, 17, 32], [32], [32], []], (34, 32)),
]


@pytest.mark.parametrize("kernel,shapes,args", ARGS_OF_SHAPES)
def test_kernel_sizes_from_its_launchs_input_shapes(kernel, shapes, args):
    assert roofline.KERNELS[kernel][3](shapes) == args
    assert roofline.launch_bound_s(kernel, shapes) == roofline.bound_s(
        roofline.KERNELS[kernel][0](*args), roofline.KERNELS[kernel][1])


def test_shapes_that_give_no_sizes_are_an_error():
    with pytest.raises(RuntimeError, match="_FusedMlpHalf"):
        roofline.launch_bound_s("mlp_half", [])


TINY_VIT = {"image_size": 32, "patch_size": 8, "in_chans": 3, "embed_dim": 32, "depth": 3, "num_heads": 2,
            "mlp_ratio": 4.0, "num_classes": 10, "qkv_bias": True, "ln_eps": 1e-6, "factory": "vit_base"}
TINY_SWIN = {"image_size": 56, "patch_size": 4, "in_chans": 3, "embed_dim": 96, "depths": [2, 2, 1],
             "num_heads": [3, 6, 12], "window_size": 7, "mlp_ratio": 4.0, "num_classes": 10, "factory": "swin_t"}


# the program's module of each kernel's autograd Function
FUNCTIONS = {"_FusedAttentionHalf": "attention_half", "_FusedMlpHalf": "mlp_half",
             "_FusedWindowAttentionHalf": "window_attention_half", "_FusedSwinBlock": "window_attention",
             "_FusedQkvAttention": "attention", "_LayerNorm": "layernorm"}


def _shape(a):
    return list(a.shape) if isinstance(a, torch.Tensor) else []


@pytest.mark.parametrize("family,cfg,drop,train", [
    (vit_family, TINY_VIT, 0.0, False), (vit_family, TINY_VIT, 0.1, True),
    (swin_family, TINY_SWIN, 0.0, False), (swin_family, TINY_SWIN, 0.1, True)])
def test_probed_shapes_are_each_launchs_own(family, cfg, drop, train, monkeypatch):
    """The probe's input shapes of each kernel's op are those of the
    arguments its Function got, launch by launch, so that each launch's
    least time follows its own sizes, whatever blocks take the kernel; the
    reader gives the window's launches the least times of the probed ones."""
    import importlib

    from eqxvision_tpu_torch.models import create_model

    from portbench.harness import readers, trace as tr

    seen = {op: [] for op in roofline.KERNEL_OPS}
    for op, module in FUNCTIONS.items():
        fn = getattr(importlib.import_module(f"eqxvision_tpu_torch.ops.{module}"), op)
        apply = fn.apply

        def spy(*args, _op=op, _apply=apply):
            seen[_op].append([_shape(a) for a in args])
            return _apply(*args)

        monkeypatch.setattr(fn, "apply", spy)
    model = create_model(cfg["factory"], device="cpu", generator=torch.Generator().manual_seed(0),
                         **family.model_kwargs(cfg, drop)).train(train)
    x = torch.randn(2, cfg["image_size"], cfg["image_size"], 3)
    with torch.set_grad_enabled(train), tr.shapes_probe(True, roofline.KERNEL_OPS) as shapes:
        model(x)
    assert sum(seen.values(), [])
    for kernel, (_, _, op, args_of) in roofline.KERNELS.items():
        assert shapes.get(op, []) == seen[op], kernel
        for launch in seen[op]:
            assert all(n > 0 for n in args_of(launch)), (kernel, launch)
    # the window's launches (here: 3 iterations of the probed one) each take the bound of their op's launches
    window = {op: 3 * len(seen[op]) for op in seen}
    trace = SimpleNamespace(count_ops=window.get, device_ns=lambda under: 10**9)
    run = SimpleNamespace(trace=trace, shapes=shapes)
    for kernel, (_, _, op, _) in roofline.KERNELS.items():
        got = readers.roofline(run, kernel)
        if not seen[op]:
            assert got is None, kernel
            continue
        expected = 3 * sum(roofline.launch_bound_s(kernel, launch) for launch in seen[op])
        assert got == pytest.approx(100.0 * expected), kernel


@pytest.mark.parametrize("chips", [1, 4])
def test_mfu_is_a_share_of_the_peak_of_every_card_used(chips):
    from portbench.harness import readers

    # a window of 1 s in which every card did 989 TFLOP of forward products: 100%
    macs = roofline.PRODUCT_FLOPS / 2
    run = SimpleNamespace(trace=SimpleNamespace(window_ns=10**9), chips=chips, images=chips, macs_per_image=macs)
    assert readers.mfu(run, 1) == pytest.approx(100.0)
    assert readers.mfu(run, 3) == pytest.approx(300.0)
