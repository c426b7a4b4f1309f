"""The port's eval CLI (``eqxvision_tpu_torch.cli.eval_imagenet``) on the CPU,
against the JAX CLI (``scripts/eval_imagenet.py``).

Both CLIs read one ImageFolder of four PIL-written images (two classes,
mixed sizes) with the same ``--torch-weights`` file (resnet18, 1000
classes, the two classes' fc biases raised so that the top-1 and top-5
counts depend on the images), 40 px canvases cropped to 32: the same batch
lines and summary, plain and with ``--int8``. The JAX CLI's model is built
from its ``jax.eval_shape`` structure before the file's weights replace
every array (built eagerly, each initialiser shape compiles on its own,
seconds a model); the rest of the JAX CLI runs as it is. Also: the
transforms' order and kinds (``--fold-ln`` in f32 before the bf16 cast; ``--int8
--int8-act`` gives w8a8 Linears and weight-only int8 convolutions), the
ten-crop step against its crops' averaged softmax, and ``--device cuda``
raising without a card.
"""
import io
import json
import os
import runpy
import sys
from contextlib import redirect_stdout

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import eqxvision_tpu.models as jax_models
from eqxvision_tpu.core.state import init_state
from eqxvision_tpu.weights.torch_import import load_torch_weights
from eqxvision_tpu_torch.cli import eval_imagenet as cli
from eqxvision_tpu_torch.models import create_model
from eqxvision_tpu_torch.ops import fold_layernorm
from eqxvision_tpu_torch.ops.preprocessing import normalize, resize_shorter_side, ten_crop
from eqxvision_tpu_torch.quantize import DynActInt8Linear, QuantConv2d, QuantLinear

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_CREATE_MODEL = jax_models.create_model
COMMON = ["--model", "resnet18", "--batch-size", "4", "--resize", "40", "--crop", "32", "--workers", "1"]


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    from PIL import Image

    root = tmp_path_factory.mktemp("eval")
    rng = np.random.RandomState(0)
    for c, sizes in enumerate([((48, 64), (40, 40)), ((64, 44), (52, 60))]):
        os.makedirs(root / "val" / f"class{c}")
        for i, (h, w) in enumerate(sizes):
            Image.fromarray(rng.randint(0, 256, (h, w, 3)).astype(np.uint8)).save(root / "val" / f"class{c}" / f"{i}.png")
    model = create_model("resnet18", generator=torch.Generator().manual_seed(1), device="cpu")
    with torch.no_grad():
        model.fc.bias[:2] += 20.0
    torch.save(model.state_dict(), root / "resnet18.pth")
    return str(root / "val"), str(root / "resnet18.pth")


def _lines(text):
    out = [json.loads(line) for line in text.splitlines() if line.startswith("{")]
    for d in out:
        d.pop("elapsed_s", None), d.pop("imgs_per_sec", None)
    return out


def _abstract_create_model(name, pretrained=False, torch_weights=None, **kwargs):
    """The JAX ``create_model`` with ``torch_weights``: the structure from
    ``jax.eval_shape``, every array then loaded from the file."""
    model = jax.eval_shape(lambda: JAX_CREATE_MODEL(name, **kwargs)[0])
    model = jax.tree_util.tree_map(lambda a: jnp.zeros(a.shape, a.dtype), model)
    return load_torch_weights(model, torch_weights, init_state(model))


def _jax_cli(argv, monkeypatch):
    monkeypatch.setattr(jax_models, "create_model", _abstract_create_model)
    monkeypatch.setattr(sys, "argv", ["eval_imagenet.py", *argv])
    buf = io.StringIO()
    with redirect_stdout(buf):
        runpy.run_path(os.path.join(REPO, "scripts", "eval_imagenet.py"), run_name="__main__")
    return _lines(buf.getvalue())


@pytest.mark.parametrize("flags", [[], ["--int8"]], ids=["plain", "int8"])
def test_summary_matches_the_jax_cli(data, flags, monkeypatch):
    data_dir, weights = data
    argv = COMMON + ["--data-dir", data_dir, "--torch-weights", weights, *flags]
    buf = io.StringIO()
    with redirect_stdout(buf):
        cli.main(argv + ["--device", "cpu"])
    port = _lines(buf.getvalue())
    assert port == _jax_cli(argv, monkeypatch)
    assert port[-1]["event"] == "summary" and port[-1]["images"] == 4 and port[-1]["top5"] == 1.0


def _args(*flags, model="resnet18"):
    return cli.build_argparser().parse_args(["--model", model, "--data-dir", "-", "--device", "cpu", *flags])


def test_transforms_order_and_kinds():
    vit = ["--model", "vit_tiny"]
    args = cli.build_argparser().parse_args(vit + ["--data-dir", "-", "--device", "cpu", "--fold-ln", "--bf16"])
    folded = cli.build_model(args)
    want = fold_layernorm(create_model("vit_tiny", device="cpu").eval()).to(torch.bfloat16)
    for (name, a), b in zip(folded.state_dict().items(), want.state_dict().values()):
        assert torch.equal(a, b), name
    both = cli.build_model(_args("--int8", "--int8-act"))
    linears = [m for m in both.modules() if isinstance(m, QuantLinear)]
    assert len(linears) == 1 and isinstance(linears[0], DynActInt8Linear)
    kinds = {type(m).__name__ for m in both.modules()}
    assert "QuantConv2d" in kinds and "Conv2d" not in kinds and "BatchNorm" not in kinds
    assert all(isinstance(m, QuantConv2d) for m in both.modules() if "conv" in type(m).__name__.lower())
    with pytest.raises(RuntimeError, match="no CUDA card"):
        cli.build_model(cli.build_argparser().parse_args(["--data-dir", "-"])) if not torch.cuda.is_available() \
            else pytest.skip("a card is present")


def test_ten_crop_step_averages_the_crops_softmax():
    args = _args("--tta", "ten_crop", "--resize", "40", "--crop", "32")
    model = cli.build_model(args)
    step = cli.make_step(args)
    u8 = torch.from_numpy(np.random.RandomState(2).randint(0, 256, (3, 40, 40, 3)).astype(np.uint8))
    crops = ten_crop(normalize(resize_shorter_side(u8, 40)), 32)
    with torch.no_grad():
        want = torch.softmax(model(crops.reshape(30, 32, 32, 3)), dim=-1).reshape(10, 3, -1).mean(0)
    got = step.scores(model, u8)
    torch.testing.assert_close(got, want)
    top1, top5 = step(model, u8, want.argmax(-1))
    assert int(top1) == 3 and int(top5) == 3
