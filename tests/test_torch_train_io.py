"""The port's EMA, npz serialisation and image loader against the JAX package.

- ``ema_*``: the closed form (a constant stays, a step approaches
  geometrically, the timm warmup), and one update of a small ResNet's
  shadow against the JAX EMA of the same weights, atol 1e-6 (f32 blends of
  values below 1);
- ``save_model``/``load_model``: a round trip of every ``state_dict()``
  entry, bf16 included, exactly; a strict load that raises on a missing
  BatchNorm statistic; a file written by the JAX ``save_model`` read into
  the port, giving the JAX model's logits at atol 1e-4, rtol 1e-4 (the
  repo's logit bound);
- ``ImageFolderLoader``: the same batches as the JAX loader on PNGs the
  test writes, shuffled and in order; ``device_prefetch`` on the CPU.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eqxvision_tpu import data as jax_data
from eqxvision_tpu.core import tree_inference
from eqxvision_tpu.models.classification import resnet as JR
from eqxvision_tpu.parallel import ema as JE
from eqxvision_tpu.weights import serialize as jax_serialize
from eqxvision_tpu.weights.serialize import _flatten_with_paths
from eqxvision_tpu_torch import data
from eqxvision_tpu_torch.models.classification.resnet import BasicBlock, ResNet
from eqxvision_tpu_torch.nn import BatchNorm
from eqxvision_tpu_torch.parallel import ema_init, ema_params, ema_update
from eqxvision_tpu_torch.weights import load_model, save_model, state_dict_from_jax

from test_torch_resnet import jax_to_port
from test_torch_squeezenet import seeded_jax


@functools.lru_cache(maxsize=None)
def _jax_resnet():
    return seeded_jax(lambda key: JR.ResNet(JR.BasicBlock, [1, 1, 1, 1], num_classes=10, key=key))


def _port(seed=0):
    return ResNet(BasicBlock, [1, 1, 1, 1], num_classes=10, generator=torch.Generator().manual_seed(seed),
                  device="cpu")


# --------------------------------------------------------------------
# EMA
# --------------------------------------------------------------------


def test_ema_closed_form():
    model = torch.nn.Linear(3, 2)
    with torch.no_grad():
        model.weight.fill_(2.0)
    ema = ema_init(model)
    for _ in range(5):
        ema_update(ema, model, decay=0.9)
    torch.testing.assert_close(ema["weight"], torch.full((2, 3), 2.0))
    with torch.no_grad():
        model.weight.fill_(10.0)
    for k in range(1, 4):
        ema_update(ema, model, decay=0.9)
        torch.testing.assert_close(ema["weight"], torch.full((2, 3), 0.9**k * 2.0 + (1 - 0.9**k) * 10.0))
    # timm warmup: at step 0 the decay is 0.9999 / 10
    zero = ema_init(torch.nn.Linear(3, 2).requires_grad_(False).apply(lambda m: m.weight.zero_()))
    ema_update(zero, model, decay=0.9999, step=0)
    torch.testing.assert_close(zero["weight"], torch.full((2, 3), 10.0 * (1 - 0.9999 / 10)))


def test_ema_shadows_floating_parameters_and_buffers_in_f32():
    port = _port().to(torch.bfloat16)
    ema = ema_init(port)
    floating = {k for k, v in port.state_dict().items() if v.is_floating_point()}
    assert set(ema) == floating and all(v.dtype == torch.float32 for v in ema.values())
    assert "bn1.running_mean" in ema and "bn1.num_batches_tracked" not in ema
    with torch.no_grad():
        ema["fc.bias"].fill_(0.5)
    swapped = ema_params(ema, port)
    assert swapped is not port and swapped.fc.bias.dtype == torch.bfloat16
    assert bool((swapped.fc.bias == 0.5).all()) and not bool((port.fc.bias == 0.5).all())
    assert swapped.bn1.running_mean.dtype == torch.float32  # BatchNorm statistics stay f32


def test_ema_update_matches_jax():
    """The shadow of one set of weights, updated with another (step 3),
    against the JAX EMA of the same weights, under the port's names."""
    model, state = _jax_resnet()
    def moved(a):
        return jnp.asarray(np.asarray(a) * 0.5 + 0.01) if isinstance(a, jax.Array) else a

    other = jax.tree_util.tree_map(moved, model)
    jema = jax.jit(functools.partial(JE.ema_update, decay=0.99, step=3))(jax.jit(JE.ema_init)(model), other)
    port_a, port_b = jax_to_port(model, state, _port()), jax_to_port(other, state, _port())
    ema = ema_update(ema_init(port_a), port_b, decay=0.99, step=3)
    want = state_dict_from_jax(port_a, {k: np.asarray(v) for k, v in _flatten_with_paths(jema)})
    for name, w in want.items():
        np.testing.assert_allclose(ema[name].numpy(), w.numpy(), atol=1e-6, err_msg=name)


# --------------------------------------------------------------------
# save_model / load_model
# --------------------------------------------------------------------


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_round_trip(tmp_path, dtype):
    src = _port(seed=1).to(dtype)
    with torch.no_grad():
        for m in src.modules():
            if isinstance(m, BatchNorm):
                m.running_mean.uniform_(-1, 1)
                m.num_batches_tracked.fill_(7)
    path = str(tmp_path / "model.npz")
    save_model(path, src)
    with np.load(path, allow_pickle=False) as f:
        assert set(f.files) == set(src.state_dict())
    dst = load_model(path, _port(seed=2).to(dtype))
    for name, value in src.state_dict().items():
        got = dst.state_dict()[name]
        assert got.dtype == value.dtype, name
        torch.testing.assert_close(got, value, rtol=0, atol=0, msg=name)


def test_load_is_strict(tmp_path):
    path = str(tmp_path / "model.npz")
    save_model(path, _port())
    with np.load(path) as f:
        arrays = dict(f.items())
    del arrays["layer1.0.bn2.running_var"]
    np.savez(path, **arrays)
    with pytest.raises(RuntimeError, match="running_var"):
        load_model(path, _port())


def test_reads_a_jax_save_model_file(tmp_path):
    model, state = _jax_resnet()
    path = str(tmp_path / "jax.npz")
    jax_serialize.save_model(path, model, state)
    port = load_model(path, _port(seed=5)).eval()
    x = np.random.RandomState(0).randn(2, 32, 32, 3).astype(np.float32)
    want, _ = tree_inference(model, True)(jnp.asarray(x), state)
    with torch.no_grad():
        got = port(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, np.asarray(want), atol=1e-4, rtol=1e-4)
    # a JAX file without the statistics is refused
    jax_serialize.save_model(path, model)
    with pytest.raises(KeyError, match="running statistics"):
        load_model(path, _port())


# --------------------------------------------------------------------
# the loader
# --------------------------------------------------------------------


@pytest.fixture(scope="module")
def image_folder(tmp_path_factory):
    from PIL import Image

    root = tmp_path_factory.mktemp("imagefolder")
    rng = np.random.RandomState(0)
    for c in ("cat", "ant", "bee"):
        (root / c).mkdir()
        for i in range(5):
            h, w = rng.randint(20, 48, 2)
            Image.fromarray(rng.randint(0, 256, (h, w, 3)).astype(np.uint8)).save(root / c / f"{i}.png")
    return str(root)


@pytest.mark.parametrize("shuffle", [False, True])
def test_loader_matches_jax(image_folder, shuffle):
    kw = dict(batch_size=4, side=24, shuffle=shuffle, seed=3, num_workers=2)
    port = data.ImageFolderLoader(image_folder, **kw)
    ref = jax_data.ImageFolderLoader(image_folder, **kw)
    assert port.classes == ref.classes == ["ant", "bee", "cat"] and len(port) == len(ref) == 3
    got, want = list(port), list(ref)
    assert len(got) == 3
    for (x, y), (wx, wy) in zip(got, want):
        assert x.dtype == np.uint8 and x.shape == (4, 24, 24, 3) and y.dtype == np.int32
        np.testing.assert_array_equal(x, wx)
        np.testing.assert_array_equal(y, wy)


def test_device_prefetch_on_the_cpu(image_folder):
    loader = data.ImageFolderLoader(image_folder, batch_size=4, side=24, num_workers=2)
    batches = list(data.device_prefetch(loader, 2, "cpu"))
    assert len(batches) == 3
    for (x, y), (wx, wy) in zip(batches, loader):
        assert x.device.type == "cpu" and x.dtype == torch.uint8 and y.dtype == torch.int32
        np.testing.assert_array_equal(x.numpy(), wx)
        np.testing.assert_array_equal(y.numpy(), wy)


def test_loader_stops_early_and_raises_decode_errors(image_folder, tmp_path):
    loader = data.ImageFolderLoader(image_folder, batch_size=2, side=16, num_workers=2, prefetch=1)
    first = next(iter(loader))
    assert first[0].shape == (2, 16, 16, 3)
    broken = tmp_path / "broken" / "x"
    broken.mkdir(parents=True)
    (broken / "0.png").write_bytes(b"not an image")
    with pytest.raises(Exception, match="0.png|identify"):
        list(data.ImageFolderLoader(str(tmp_path / "broken"), batch_size=1, side=8, num_workers=1))
