"""``torch.export`` of the port (``export``), on the CPU.

Each kernel entry that inference reaches (K1 ``fused_qkv_attention``, K3/K4
``window_qkv_attention``, K5 ``fused_swin_block``, K6 ``layer_norm`` and the
three fused halves) stays one ``eqxvision::`` node in an exported program,
which runs its plain version on a CPU tensor (its kernel on a CUDA one) and
gives the eager output exactly after a save and load; the eager path does
not go through the op. ``export_inference`` round trips: an int8 ViT (K1
and K6 nodes), a LayerNorm-folded ViT (the fused halves) and resnet18
behind a baked uint8 preprocess, each equal to eager on the CPU. A
segmentation model's program returns its last output; ``platforms=``
raises, and so does ``mesh=`` with model ranks or a batch the data ranks
do not divide (tests/test_torch_parallel.py exports over four data
ranks). A ViT (depth 2, 32 px) built from a numpy seed on the
JAX side and carried into the port gives the same logits (1e-4) through the
two packages' ``export_inference`` programs.
"""
import functools

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from eqxvision_tpu import export as jax_export
from eqxvision_tpu.models.classification import vit as JV
from eqxvision_tpu_torch.export import export_inference, load_exported, save_exported
from eqxvision_tpu_torch.models import create_model
from eqxvision_tpu_torch.ops import (
    fold_layernorm,
    fused_attention_half,
    fused_mlp_half,
    fused_qkv_attention,
    fused_window_attention_half,
    imagenet_eval_pipeline,
    layer_norm,
    window_qkv_attention,
)
from eqxvision_tpu_torch.ops.window_attention import fused_swin_block_v1
from eqxvision_tpu_torch.quantize import quantize_weights_int8
from test_torch_resnet import jax_to_port
from test_torch_squeezenet import seeded_jax


def _t(rng, *shape, scale=1.0):
    return torch.from_numpy((rng.randn(*shape) * scale).astype(np.float32))


def _case(name):
    """(fn of tensors, tensor inputs) for one kernel entry at a small shape."""
    rng = np.random.RandomState(0)
    t = functools.partial(_t, rng)
    if name == "fused_qkv_attention":
        return lambda qkv: fused_qkv_attention(qkv, 2), [t(2, 9, 96)]
    if name == "layer_norm":
        return lambda x, w, b: layer_norm(x, w, b, 1e-6) + layer_norm(x), [t(2, 5, 16), t(16), t(16)]
    if name == "fused_attention_half":
        return (lambda x, *w: fused_attention_half(x, *w, 2),
                [t(2, 9, 32), t(32), t(32), t(96, 32, scale=0.2), t(96), t(32, 32, scale=0.2), t(32)])
    if name == "fused_mlp_half":
        return (lambda x, *w: fused_mlp_half(x, x, *w),
                [t(2, 9, 32), t(32), t(32), t(64, 32, scale=0.2), t(64), t(32, 64, scale=0.2), t(32), t(32)])
    if name == "window_qkv_attention":
        return lambda qkv, bias: window_qkv_attention(qkv, bias, 2, 0.25), [t(2, 4, 16, 96), t(4, 2, 16, 16)]
    if name == "fused_window_attention_half":
        return (lambda x, bias, *w: fused_window_attention_half(x, *w, bias, 2),
                [t(2, 4, 16, 32), t(1, 2, 16, 16), t(32), t(32), t(96, 32, scale=0.2), t(96),
                 t(32, 32, scale=0.2), t(32)])
    names = ("norm1_w", "norm1_b", "qkv_weight", "qkv_bias", "proj_weight", "proj_bias", "relative_position_bias",
             "norm2_w", "norm2_b", "fc1_weight", "fc1_bias", "fc2_weight", "fc2_bias")
    shapes = ((32,), (32,), (96, 32), (96,), (32, 32), (32,), (1, 2, 16, 16), (32,), (32,), (64, 32), (64,),
              (32, 64), (32,))
    return (lambda x, *w: fused_swin_block_v1(x, window_size=(4, 4), shift_size=(2, 2), num_heads=2,
                                             **dict(zip(names, w))),
            [t(2, 8, 8, 32)] + [t(*s, scale=0.2) for s in shapes])


class _Module(torch.nn.Module):
    def __init__(self, fn):
        super().__init__()
        self.fn = fn

    def forward(self, *args):
        return self.fn(*args)


class _Ops(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.names = set()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.names.add(str(func))
        return func(*args, **(kwargs or {}))


OPS = ["fused_qkv_attention", "window_qkv_attention", "fused_swin_block", "layer_norm", "fused_mlp_half",
       "fused_attention_half", "fused_window_attention_half"]


@pytest.mark.parametrize("name", OPS)
def test_kernel_entry_is_one_node_and_round_trips(name, tmp_path):
    fn, inputs = _case(name)
    with torch.no_grad():
        program = torch.export.export(_Module(fn), tuple(inputs))
        targets = [str(n.target) for n in program.graph.nodes if n.op == "call_function"]
        assert f"eqxvision.{name}.default" in targets
        save_exported(program, str(tmp_path / "op.pt2"))
        got = load_exported(str(tmp_path / "op.pt2")).module()(*inputs)
        with _Ops() as ops:
            want = fn(*inputs)
    assert torch.equal(got, want)
    assert not any(n.startswith("eqxvision.") for n in ops.names)  # eager calls the wrapper's function directly


def _vit():
    return create_model("vit_tiny", img_size=32, depth=2, num_classes=10, generator=torch.Generator().manual_seed(1),
                        device="cpu").eval()


@pytest.mark.parametrize("case", ["vit-int8", "vit-fold_ln", "resnet18-uint8"])
def test_export_inference_round_trip(case, tmp_path):
    rng = np.random.RandomState(2)
    if case == "resnet18-uint8":
        model = create_model("resnet18", num_classes=10, device="cpu").eval()
        pre = functools.partial(imagenet_eval_pipeline, resize_size=40, crop_size=32)
        program = export_inference(model, 2, 48, dtype=None, input_dtype=torch.uint8, preprocess_fn=pre)
        x = torch.from_numpy(rng.randint(0, 256, (2, 48, 48, 3)).astype(np.uint8))
        want_nodes = set()
        with torch.no_grad():
            want = model(pre(x))
    else:
        model = quantize_weights_int8(_vit()) if case == "vit-int8" else fold_layernorm(_vit())
        program = export_inference(model, 2, 32, dtype=None)
        x = torch.from_numpy(rng.randn(2, 32, 32, 3).astype(np.float32))
        want_nodes = ({"eqxvision.fused_qkv_attention.default", "eqxvision.layer_norm.default"} if case == "vit-int8"
                      else {"eqxvision.fused_attention_half.default", "eqxvision.fused_mlp_half.default"})
        with torch.no_grad():
            want = model(x)
    nodes = {str(n.target) for n in program.graph.nodes if str(n.target).startswith("eqxvision.")}
    assert want_nodes <= nodes
    save_exported(program, str(tmp_path / "model.pt2"))
    with torch.no_grad():
        got = load_exported(str(tmp_path / "model.pt2")).module()(x)
    assert got.shape == (2, 10) and torch.equal(got, want)


def test_segmentation_returns_last_output_and_unsupported_options_raise():
    class TwoMaps(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.scale = torch.nn.Parameter(torch.tensor(2.0))

        def forward(self, x):
            return x * 0.5, x * self.scale

    x = torch.ones(1, 4, 4, 3)
    program = export_inference(TwoMaps(), 1, 4, dtype=None)
    with torch.no_grad():
        assert torch.equal(program.module()(x), x * 2)
    from eqxvision_tpu_torch.nn.collectives import Group
    from eqxvision_tpu_torch.parallel import Mesh, make_mesh

    with pytest.raises(ValueError, match="model ranks"):
        export_inference(TwoMaps(), 4, 4, mesh=Mesh(2, 2, 0, Group([0]), Group([0])))
    with pytest.raises(ValueError, match="does not split"):
        export_inference(TwoMaps(), 3, 4, mesh=Mesh(2, 1, 0, Group([0]), Group([0])))
    program = export_inference(TwoMaps(), 1, 4, dtype=None, mesh=make_mesh())
    with torch.no_grad():
        assert torch.equal(program.module()(x), x * 2)
    with pytest.raises(ValueError, match="device"):
        export_inference(TwoMaps(), 1, 4, platforms=["cuda"])


def test_programs_match_jax_export():
    kwargs = dict(img_size=32, depth=2, num_classes=10, embed_dim=192, num_heads=3)
    model, state = seeded_jax(lambda key: JV.VisionTransformer(key=key, **kwargs))
    port = jax_to_port(model, state, create_model("vit_tiny", device="cpu", **kwargs))
    x = np.random.RandomState(3).randn(2, 32, 32, 3).astype(np.float32)
    want = np.asarray(jax_export.export_inference(model, state, 2, 32, dtype=None).call(x))
    with torch.no_grad():
        got = export_inference(port, 2, 32, dtype=None).module()(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4)
