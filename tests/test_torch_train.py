"""The port's train and eval steps against the JAX package's.

A small ResNet (BasicBlock, one block a stage, 10 classes, 32 x 32 input),
its BatchNorms' affine and statistics randomised, is carried into the port
with ``load_jax_params(..., state=)``; both sides then take two training
steps on the same numpy-seeded batches, the JAX step with optax, the
port's with torch's optimiser, each step from the JAX side's weights (the
optimiser states stay each side's own):

- f32, SGD with momentum 0.9 and weight decay on the parameters of more
  than one axis (optax ``add_decayed_weights`` + ``sgd``), and AdamW with
  the same mask: the losses within 1e-5, the parameters and running
  statistics after each step within atol 2e-5, rtol 1e-4 (f32 sums in
  another order, an update of lr 0.01; AdamW's ill-conditioned elements
  as the test says);
- bf16 mixed precision, on a 2-block vit_tiny (a ResNet at this size has
  1 x 1 maps in its last stage, whose batch statistics bf16 cannot hold):
  the masters stay f32, and the update is held to the JAX bf16 update
  (see the test);

and the port's remat step equals its plain step (loss, parameters and
statistics moved once, ``num_batches_tracked`` + 1) with drop path and
dropout active; GoogLeNet's aux heads add 0.3 of their loss, as the JAX
step's formula does; the eval step's top-1 and top-5 counts, with and
without ten-crop TTA, equal the JAX eval step's.
"""
import copy
import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from eqxvision_tpu.core import tree_inference
from eqxvision_tpu.models import create_model as jax_create_model
from eqxvision_tpu.models.classification import resnet as JR
from eqxvision_tpu.ops import preprocessing as JP
from eqxvision_tpu.parallel import train as JT
from eqxvision_tpu.weights.serialize import _flatten_with_paths, state_to_paths
from eqxvision_tpu_torch.models import create_model
from eqxvision_tpu_torch.models.classification import efficientnet as E
from eqxvision_tpu_torch.models.classification.googlenet import GoogLeNet
from eqxvision_tpu_torch.models.classification.resnet import BasicBlock, ResNet
from eqxvision_tpu_torch.models.classification.vit import vit_tiny
from eqxvision_tpu_torch.nn import BatchNorm
from eqxvision_tpu_torch.ops import preprocessing as P
from eqxvision_tpu_torch.parallel import (
    evaluate,
    make_eval_step,
    make_scan_epoch,
    make_train_step,
    param_groups,
    softmax_cross_entropy,
)
from eqxvision_tpu_torch.weights import load_jax_params
from eqxvision_tpu_torch.weights.from_jax import _running_stats_from_jax, state_dict_from_jax

from test_torch_resnet import jax_to_port
from test_torch_squeezenet import seeded_jax

LR, WD = 0.01, 1e-2


@functools.lru_cache(maxsize=None)
def _jax_resnet():
    """In training mode, its BatchNorms randomised (``seeded_jax``)."""
    model, state = seeded_jax(lambda key: JR.ResNet(JR.BasicBlock, [1, 1, 1, 1], num_classes=10, key=key))
    return tree_inference(model, False), state


def _port_resnet(model, state):
    port = ResNet(BasicBlock, [1, 1, 1, 1], num_classes=10, generator=torch.Generator().manual_seed(0), device="cpu")
    return jax_to_port(model, state, port).train()


def _batches(steps=2, n=4, size=32, seed=0):
    rng = np.random.RandomState(seed)
    return [(rng.randn(n, size, size, 3).astype(np.float32), rng.randint(0, 10, n).astype(np.int32))
            for _ in range(steps)]


def _optimizers(name, model, port):
    mask = jax.tree_util.tree_map(lambda p: hasattr(p, "ndim") and p.ndim > 1, model)
    if name == "sgd":
        tx = optax.chain(optax.add_decayed_weights(WD, mask=mask), optax.sgd(LR, momentum=0.9))
        opt = torch.optim.SGD(param_groups(port, WD), lr=LR, momentum=0.9)
    else:
        tx = optax.adamw(LR, weight_decay=WD, mask=mask)
        opt = torch.optim.AdamW(param_groups(port, WD), lr=LR)
    return tx, tx.init(jax.tree_util.tree_map(lambda p: p, model)), opt


def _jax_as_port(port, model, state):
    """The JAX model's parameters and statistics under the port's names and
    layouts."""
    params = {k: np.asarray(v) for k, v in _flatten_with_paths(model)}
    sd = state_dict_from_jax(port, params)
    stats = {k: (np.asarray(m), np.asarray(v)) for k, (m, v) in state_to_paths(model, state).items()}
    sd.update(_running_stats_from_jax(port, stats))
    return {k: v.numpy() for k, v in sd.items()}


def _steps(opt_name):
    """Two f32 steps on each side. Before the second, the port takes the JAX
    model's parameters and statistics again (its optimiser state stays its
    own), so each step is held from the same weights."""
    model, state = _jax_resnet()
    port = _port_resnet(model, state)
    tx, opt_state, opt = _optimizers(opt_name, model, port)
    jstep, step = JT.make_train_step(tx, donate=False), make_train_step()
    key = jax.random.PRNGKey(0)
    out = []
    for x, y in _batches():
        model, state, opt_state, jloss = jstep(model, state, opt_state, jnp.asarray(x), jnp.asarray(y), key)
        loss = step(port, opt, torch.from_numpy(x), torch.from_numpy(y))
        got = {k: v.numpy().copy() for k, v in port.state_dict().items()}
        out.append((float(jloss), loss, _jax_as_port(port, model, state), got, _adam_moments(port, opt, opt_state)))
        jax_to_port(model, state, port).train()
    return out


def _adam_moments(port, opt, opt_state):
    """{name: (the port's first moment, the JAX one, the port's second, the
    JAX one)} for AdamW, {} for SGD."""
    if not isinstance(opt, torch.optim.AdamW):
        return {}
    adam = opt_state[0]
    mu = state_dict_from_jax(port, {k: np.asarray(v) for k, v in _flatten_with_paths(adam.mu)})
    nu = state_dict_from_jax(port, {k: np.asarray(v) for k, v in _flatten_with_paths(adam.nu)})
    return {name: (opt.state[p]["exp_avg"].numpy().copy(), mu[name].numpy(), opt.state[p]["exp_avg_sq"].numpy().copy(),
                   nu[name].numpy()) for name, p in port.named_parameters()}


@pytest.mark.parametrize("opt_name", ["sgd", "adamw"])
def test_f32_step_matches_jax(opt_name):
    """Each step: the loss within 1e-5; every parameter and statistic within
    atol 2e-5, rtol 1e-4. AdamW divides each gradient by its own root mean
    square, so an element's update errs by about lr * dg / |g|, where the
    gradients agree to dg ~ 2e-5 of their tensor's largest: an element near
    0 may step by up to lr either way. So the moments are held (within 1e-4
    and 2e-4 of their tensor's largest), the elements whose first moment is
    above 0.05 of the largest to the bound above, and every element to 2 lr."""
    for jloss, loss, want, got, moments in _steps(opt_name):
        assert loss.dtype == torch.float32 and loss.ndim == 0
        assert abs(loss.item() - jloss) <= 1e-5
        for name, w in want.items():
            g, sharp = got[name], np.ones(w.shape, bool)
            if name in moments:
                m, jm, v, jv = moments[name]
                assert np.abs(m - jm).max() <= 1e-4 * np.abs(jm).max(), name
                assert np.abs(v - jv).max() <= 2e-4 * np.abs(jv).max(), name
                sharp = np.abs(jm) > 0.05 * np.abs(jm).max()
                assert np.abs(g - w).max() <= 2 * LR, name
            np.testing.assert_allclose(g[sharp], w[sharp], atol=2e-5, rtol=1e-4, err_msg=name)
        tracked = [v.item() for k, v in got.items() if k.endswith("num_batches_tracked")]
        assert tracked and len(set(tracked)) == 1


VIT_KW = dict(img_size=32, patch_size=8, depth=2, num_classes=10)


def test_bf16_step_matches_jax_and_keeps_f32_masters():
    """A 2-block vit_tiny (32 px, 16 tokens + cls), one SGD step in bf16 on
    each side. The JAX bf16 step moves each tensor up to 3.8% of its largest
    f32 update away from the f32 step on the CPU (its products round their
    outputs; the port's accumulate in f32 and round once): the port's
    bf16 update is held within 5% of that scale (the port's f32 update,
    which equals JAX's, test above) of the JAX bf16 update, its loss within
    2e-3 relative. The masters, the gradients and the optimiser state stay
    f32."""
    jmodel, _ = jax_create_model("vit_tiny", **VIT_KW)
    params = {k: np.asarray(v) for k, v in _flatten_with_paths(jmodel)}
    rng = np.random.RandomState(0)
    x, y = rng.randn(8, 32, 32, 3).astype(np.float32), rng.randint(0, 10, 8)
    tx = optax.sgd(LR, momentum=0.9)
    m, _, _, jloss = JT.make_train_step(tx, donate=False, compute_dtype=jnp.bfloat16)(
        jmodel, {}, tx.init(jmodel), jnp.asarray(x), jnp.asarray(y), jax.random.PRNGKey(0))
    want = {}
    for dt in (None, torch.bfloat16):
        port = load_jax_params(create_model("vit_tiny", device="cpu", **VIT_KW), params).train()
        before = {k: v.clone() for k, v in port.state_dict().items()}
        opt = torch.optim.SGD(port.parameters(), lr=LR, momentum=0.9)
        loss = make_train_step(compute_dtype=dt)(port, opt, torch.from_numpy(x), torch.from_numpy(y))
        want[dt] = {name: p.detach() - before[name] for name, p in port.named_parameters()}
    assert loss.dtype == torch.float32 and abs(loss.item() - float(jloss)) <= 2e-3 * float(jloss)
    jupdated = state_dict_from_jax(port, {k: np.asarray(v) for k, v in _flatten_with_paths(m)})
    for name, p in port.named_parameters():
        assert p.dtype == p.grad.dtype == opt.state[p]["momentum_buffer"].dtype == torch.float32, name
        jax_update = jupdated[name] - before[name]
        assert (want[torch.bfloat16][name] - jax_update).abs().max() <= 0.05 * want[None][name].abs().max(), name


def test_softmax_cross_entropy_matches_jax():
    rng = np.random.RandomState(1)
    logits = rng.randn(6, 7).astype(np.float32) * 3
    labels = rng.randint(0, 7, 6)
    soft = rng.dirichlet(np.ones(7), 6).astype(np.float32)
    for y in (labels, soft):
        want = float(JT.softmax_cross_entropy(jnp.asarray(logits), jnp.asarray(y)))
        got = softmax_cross_entropy(torch.from_numpy(logits), torch.from_numpy(y)).item()
        assert abs(got - want) <= 1e-6 * max(1.0, abs(want))


def _remat_models():
    """BatchNorm, drop path (stochastic depth 0.2) and dropout 0.2: a small
    EfficientNet; and a 2-block vit_tiny, drop path 0.5, dropout 0.1 (16 px:
    4 patches and the class token)."""
    eff = E.EfficientNet([E._mbconf(1, 3, 1, 32, 16, 1, width_mult=0.5), E._mbconf(6, 3, 2, 16, 24, 2, width_mult=0.5)],
                         0.2, stochastic_depth_prob=0.2, num_classes=10, generator=torch.Generator().manual_seed(0),
                         device="cpu")
    vit = vit_tiny(img_size=16, patch_size=8, depth=2, num_classes=10, drop_path_rate=0.5, drop_rate=0.1,
                   generator=torch.Generator().manual_seed(0), device="cpu")
    return {"efficientnet": eff, "vit_tiny": vit}


@pytest.mark.parametrize("compute_dtype", [None, torch.bfloat16])
@pytest.mark.parametrize("name", ["efficientnet", "vit_tiny"])
def test_remat_equals_plain_step(name, compute_dtype):
    base = _remat_models()[name].train()
    x, y = _batches(1, n=8, size=16)[0]
    results = []
    for remat in (False, True):
        model = copy.deepcopy(base)
        opt = torch.optim.SGD(model.parameters(), lr=LR, momentum=0.9)
        torch.manual_seed(5)
        loss = make_train_step(compute_dtype=compute_dtype, remat=remat)(model, opt, torch.from_numpy(x),
                                                                          torch.from_numpy(y))
        results.append((loss, model.state_dict(), {n: p.grad for n, p in model.named_parameters()}))
    (loss_a, sd_a, g_a), (loss_b, sd_b, g_b) = results
    assert loss_a.item() == loss_b.item()
    for k in sd_a:
        torch.testing.assert_close(sd_b[k], sd_a[k], rtol=0, atol=0, msg=k)
    for k in g_a:
        torch.testing.assert_close(g_b[k], g_a[k], rtol=0, atol=0, msg=k)
    tracked = [v.item() for k, v in sd_b.items() if k.endswith("num_batches_tracked")]
    assert all(t == 1 for t in tracked) and (name == "vit_tiny" or tracked)
    # the regularisers were active: another seed gives another loss
    model = copy.deepcopy(base)
    torch.manual_seed(6)
    other = make_train_step(compute_dtype=compute_dtype, remat=True)(
        model, torch.optim.SGD(model.parameters(), lr=LR), torch.from_numpy(x), torch.from_numpy(y))
    assert other.item() != loss_a.item()


class _TupleModel(torch.nn.Module):
    """Logits and two aux heads (one of them None), as GoogLeNet's tuple."""

    def __init__(self):
        super().__init__()
        self.body = torch.nn.Linear(12, 10)
        self.aux = torch.nn.Linear(12, 10)
        g = torch.Generator().manual_seed(0)
        with torch.no_grad():
            for p in self.parameters():
                p.copy_(torch.randn(p.shape, generator=g))

    def forward(self, x):
        x = x.reshape(x.shape[0], -1)
        return self.body(x), self.aux(x), None


def test_googlenet_aux_loss_follows_jax():
    """Training mode returns (logits, aux2, aux1) (held to the JAX model in
    tests/test_torch_googlenet.py); the step's loss is the JAX step's
    ``loss(logits) + 0.3 * (loss(aux2) + loss(aux1))``, here with JAX's
    cross-entropy on the outputs of the same forward (dropout 0, 64 px)."""
    port = GoogLeNet(num_classes=10, aux_logits=True, dropout=0.0, dropout_aux=0.0,
                     generator=torch.Generator().manual_seed(0), device="cpu").train()
    rng = np.random.RandomState(2)
    x, y = torch.from_numpy(rng.randn(2, 64, 64, 3).astype(np.float32)), torch.tensor([3, 7])
    outputs = []
    port.register_forward_hook(lambda module, args, out: outputs.append(out))
    with torch.no_grad():
        loss = make_train_step().loss(port, x, y)
    (logits, aux2, aux1), = outputs
    want = _jax_ce(logits, y) + 0.3 * (_jax_ce(aux2, y) + _jax_ce(aux1, y))
    assert abs(loss.item() - want) <= 1e-5 * want


def _jax_ce(logits, y):
    return float(JT.softmax_cross_entropy(jnp.asarray(logits.detach().numpy()), jnp.asarray(y.numpy())))


def test_scan_epoch_keeps_the_logits_alone():
    """As the JAX scan epoch: a tuple of outputs adds no aux loss, where the
    train step adds 0.3 of each aux head's (a None head skipped)."""
    model = _TupleModel()
    x = torch.from_numpy(np.random.RandomState(3).randn(1, 4, 2, 2, 3).astype(np.float32))
    y = torch.tensor([[1, 2, 3, 4]])
    logits, aux, _ = model(x[0])
    losses = make_scan_epoch()(model, torch.optim.SGD(model.parameters(), lr=0.0), x, y)
    assert losses.shape == (1,) and abs(losses[0].item() - _jax_ce(logits, y[0])) <= 1e-6 * _jax_ce(logits, y[0])
    loss = make_train_step().loss(model, x[0], y[0])
    want = _jax_ce(logits, y[0]) + 0.3 * _jax_ce(aux, y[0])
    assert abs(loss.item() - want) <= 1e-6 * want


@pytest.mark.parametrize("tta", [False, True])
def test_eval_step_matches_jax(tta):
    """top-1 / top-5 counts on 16 images of 40 px (ten crops of 32 px with
    TTA), the eval-mode ResNet on both sides."""
    model, state = _jax_resnet()
    port = _port_resnet(model, state).eval()
    model = tree_inference(model, True)
    rng = np.random.RandomState(4)
    x, y = rng.randn(16, 40, 40, 3).astype(np.float32), rng.randint(0, 10, 16).astype(np.int32)
    if tta:
        jstep = JT.make_eval_step(functools.partial(JP.ten_crop, crop_h=32))
        step = make_eval_step(functools.partial(P.ten_crop, crop_h=32))
    else:
        jstep, step = JT.make_eval_step(), make_eval_step()
        x = x[:, 4:36, 4:36]
    want = [int(v) for v in jstep(model, state, jnp.asarray(x), jnp.asarray(y))]
    got = step(port, torch.from_numpy(x), torch.from_numpy(y))
    assert [int(v) for v in got] == want
    assert 0 < want[1] and want[0] <= want[1] <= 16  # both counts seen
    batches = [(torch.from_numpy(x[:8]), torch.from_numpy(y[:8])), (torch.from_numpy(x[8:]), torch.from_numpy(y[8:]))]
    assert evaluate(port, batches, eval_step=step) == (want[0] / 16, want[1] / 16)


def test_scan_epoch_equals_steps():
    """make_scan_epoch over stacked batches is make_train_step in a loop,
    with the augmentation's draws from one generator."""
    model, state = _jax_resnet()
    a, b = _port_resnet(model, state), _port_resnet(model, state)
    xs = torch.from_numpy(np.stack([x for x, _ in _batches(3, size=16)]))
    ys = torch.from_numpy(np.stack([y for _, y in _batches(3, size=16)]))

    def augment_fn(g, x, y):
        return x + torch.rand(x.shape, generator=g), y

    losses = make_scan_epoch(augment_fn=augment_fn)(a, torch.optim.SGD(a.parameters(), lr=LR), xs, ys,
                                                     torch.Generator().manual_seed(0))
    step, opt, g = make_train_step(augment_fn=augment_fn), torch.optim.SGD(b.parameters(), lr=LR), \
        torch.Generator().manual_seed(0)
    want = torch.stack([step(b, opt, x, y, g) for x, y in zip(xs, ys)])
    torch.testing.assert_close(losses, want, rtol=0, atol=0)
    for k, v in a.state_dict().items():
        torch.testing.assert_close(v, b.state_dict()[k], rtol=0, atol=0)
    assert all(m.num_batches_tracked.item() == 3 for m in a.modules() if isinstance(m, BatchNorm))
