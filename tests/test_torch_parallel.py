"""The port's multi-process training and evaluation (``parallel.mesh``,
``parallel.multihost``, the tensor-parallel blocks, synchronised BatchNorm,
the training CLI's ``--mesh-model`` / ``--distributed``) on the CPU.

One world of four processes over gloo (``parallel.launch``; its ranks run
tests/torch_parallel_world.py, one thread each) holds a 2 data x 2 model
mesh and a 4 x 1 mesh. The module fixture writes the inputs, starts the
world, computes the one-process port steps and the JAX steps while the
ranks run, and each test asserts one case:

- one f32 SGD step (lr 0.1, batch 8) of the JAX package's test models, the
  dry run's ViT (32 px, patch 16, width 64, depth 2, 4 heads) and the Swin
  v1 and v2 (embed 32, depths (1, 1), heads (2, 4), window 4) and ConvNeXt
  (one stage of two blocks at 32 channels, layer scale 0.5) of
  tests/test_parallel.py, without drop path, on the 2 x 2 mesh, its
  weights carried from the JAX model (``load_jax_params``): the loss within
  1e-5 of the one-process port step's and of the JAX step's, and the
  parameters joined over the model ranks at atol 2e-5, rtol 1e-4 of both;
  the blocks on the unfused route, each attention kernel called with the
  rank's half of the heads;
- one AdamW step of the ViT (the element rule of test_torch_train.py);
- resnet18 on the 4 x 1 mesh with synchronised BatchNorm: the loss, the
  parameters and the running statistics as above;
- a remat step bit for bit the plain sharded step, with drop path and
  dropout drawing;
- drop-path masks equal on the model ranks of a data index, different
  across data indices, data index 0's those of one process with the seed;
- the shards of each model's ``state_dict`` joined give the whole one
  exactly, and each rank's shard is ``shard_state_dict`` of it (qkv by
  head: the rank's rows of q, k and v);
- ``evaluate_multihost`` on each data rank's ``local_shard`` gives every
  rank the one-process ``evaluate``'s top-1 and top-5;
- the training CLI (``--mesh-model 2 --distributed``): a run resumed from
  its checkpoint ends where the unbroken run does, and the joined
  ``model.npz`` served by the eval CLI gives the sharded model's logits;
- ``local_shard``'s padding and coverage, ``make_mesh`` refusing a world it
  does not fit, ``launch.placement`` (gloo on the CPU; on the cards NCCL
  one a rank, or round-robin over gloo where there are fewer cards than
  ranks), ``dryrun_multichip(4, device="cpu")`` and its default, the card,
  raising without one; the ranks import no JAX.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from eqxvision_tpu.core import tree_inference
from eqxvision_tpu.models import create_model as jax_create_model
from eqxvision_tpu.models.classification import resnet as JR
from eqxvision_tpu.models.classification import vit as JV
from eqxvision_tpu.models.classification.convnext import ConvNeXt as JConvNeXt
from eqxvision_tpu.models.classification.convnext import _CNBlockConfig
from eqxvision_tpu.models.classification.swin import SwinTransformer as JSwin
from eqxvision_tpu.parallel import train as JT
from eqxvision_tpu.weights.serialize import _flatten_with_paths, state_to_paths
from eqxvision_tpu_torch.cli import eval_imagenet
from eqxvision_tpu_torch.entry import dryrun_multichip
from eqxvision_tpu_torch.parallel import (
    Shard,
    evaluate,
    join_state_dicts,
    launch,
    local_shard,
    make_mesh,
    make_train_step,
    shard_state_dict,
)
from eqxvision_tpu_torch.weights import load_jax_params
from eqxvision_tpu_torch.weights.from_jax import _running_stats_from_jax, state_dict_from_jax

import torch_parallel_world as world_cases
from test_torch_squeezenet import seeded_jax

LR = world_cases.LR
TP_CASES = world_cases.TP_CASES


def _jax_models():
    """Each case's JAX model (training mode) and state."""
    key = jax.random.PRNGKey(0)
    res, res_state = seeded_jax(lambda k: JR.ResNet(JR.BasicBlock, [2, 2, 2, 2], num_classes=5, key=k))
    swin = {k: v for k, v in world_cases.SMALL_SWIN.items()}
    v2, _ = jax_create_model("swin_v2_t", **swin)
    return {
        "vit": (JV.VisionTransformer(img_size=32, patch_size=16, embed_dim=64, depth=2, num_heads=4, num_classes=5),
                {}),
        "swin_v1": (JSwin(**swin, key=key), {}),
        "swin_v2": (v2, {}),
        "convnext": (JConvNeXt([_CNBlockConfig(32, 64, 2)], num_classes=5, layer_scale=0.5, key=key), {}),
        "resnet18": (tree_inference(res, False), res_state),
    }


def _params(model):
    return {k: np.asarray(v) for k, v in _flatten_with_paths(model)}


def _stats(model, state):
    return {k: (np.asarray(m), np.asarray(v)) for k, (m, v) in state_to_paths(model, state).items()} if state else None


def _jax_as_port(name, model, state):
    """The JAX model's parameters and statistics under the port's names."""
    port = world_cases.BUILDERS[name]()
    sd = state_dict_from_jax(port, _params(model))
    if state:
        sd.update(_running_stats_from_jax(port, _stats(model, state)))
    return sd


def _one_process(name, weights, x, y, opt_name="sgd"):
    """The port's one-process step from the same weights: its loss, its
    parameters after, and its optimiser."""
    model = world_cases.BUILDERS[name]()
    model.load_state_dict(weights)
    model.train()
    opt = world_cases.optimizer(opt_name, model)
    loss = make_train_step()(model, opt, x, y)
    return loss.item(), model.state_dict(), (model, opt)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    work = str(tmp_path_factory.mktemp("parallel"))
    rng = np.random.RandomState(0)
    x = torch.from_numpy(rng.randn(8, 32, 32, 3).astype(np.float32))
    y = torch.from_numpy(rng.randint(0, 5, 8).astype(np.int64))
    torch.save((x, y), os.path.join(work, "batch.pt"))
    torch.save((torch.from_numpy(rng.randn(14, 32, 32, 3).astype(np.float32)),
                torch.from_numpy(rng.randint(0, 5, 14).astype(np.int64))), os.path.join(work, "eval.pt"))
    jax_models = _jax_models()
    weights = {}
    for name, (model, state) in jax_models.items():
        port = load_jax_params(world_cases.BUILDERS[name](), _params(model), _stats(model, state))
        weights[name] = port.state_dict()
        torch.save(weights[name], os.path.join(work, f"{name}.pt"))
    ranks = launch.World(world_cases.run, 4, (work,), device="cpu", timeout_s=600)

    # while the ranks run: the one-process port steps and the JAX steps
    one, jax_out = {}, {}
    jx, jy = jnp.asarray(x.numpy()), jnp.asarray(y.numpy())
    for case, name, opt_name in [(n, n, "sgd") for n in (*TP_CASES, "resnet18")] + [("vit_adamw", "vit", "adamw")]:
        one[case] = _one_process(name, weights[name], x, y, opt_name)
        model, state = jax_models[name]
        tx = optax.adamw(1e-3, weight_decay=1e-2) if opt_name == "adamw" else optax.sgd(LR)
        m, s, _, loss = JT.make_train_step(tx, donate=False)(model, state, tx.init(model), jx, jy,
                                                             jax.random.PRNGKey(3))
        jax_out[case] = (float(loss), _jax_as_port(name, m, s))
    yield {"ranks": ranks.wait(), "one": one, "jax": jax_out, "weights": weights, "work": work}


def _joined(results, case):
    shardings = {k: Shard(*v) for k, v in results[0][case]["shardings"].items()}
    return join_state_dicts([results[0][case]["after"], results[1][case]["after"]], shardings)


def _close(got, want, what, **tol):
    for name, w in want.items():
        g = got[name]
        if not g.is_floating_point():
            assert torch.equal(g, w.to(g.dtype)), f"{what}: {name}"
            continue
        np.testing.assert_allclose(g.numpy(), w.numpy(), err_msg=f"{what}: {name}", **tol)


def _adam_close(got, want, first_moment, what):
    """test_torch_train.py's rule for one AdamW step: every element within
    2 lr, the elements whose first moment exceeds 0.05 of its tensor's
    largest at atol 2e-5, rtol 1e-4 (an element whose gradient is near 0
    steps by up to lr either way)."""
    for name, w in want.items():
        g = got[name].numpy()
        w = w.numpy()
        assert np.abs(g - w).max() <= 2 * 1e-3, f"{what}: {name}"
        if name in first_moment:
            m = first_moment[name].abs().numpy()
            sharp = m > 0.05 * m.max()
            np.testing.assert_allclose(g[sharp], w[sharp], atol=2e-5, rtol=1e-4, err_msg=f"{what}: {name}")


@pytest.mark.parametrize("case", [*TP_CASES, "resnet18"])
def test_f32_step_matches_one_process(world, case):
    ranks = world["ranks"]
    loss, after, _ = world["one"][case]
    assert len({r[case]["loss"] for r in ranks}) == 1, "every rank reports the global loss"
    assert abs(ranks[0][case]["loss"] - loss) <= 1e-5
    got = _joined(ranks, case) if case != "resnet18" else ranks[0][case]["after"]
    _close(got, after, case, atol=2e-5, rtol=1e-4)


@pytest.mark.parametrize("case", [*TP_CASES, "resnet18"])
def test_f32_step_matches_jax(world, case):
    ranks = world["ranks"]
    jloss, want = world["jax"][case]
    assert abs(ranks[0][case]["loss"] - jloss) <= 1e-5
    got = _joined(ranks, case) if case != "resnet18" else ranks[0][case]["after"]
    _close(got, want, case, atol=2e-5, rtol=1e-4)


def test_sync_batchnorm_statistics_agree_on_every_rank(world):
    """Every data rank moves its running statistics to the global batch's."""
    states = [r["resnet18"]["after"] for r in world["ranks"] if r["resnet18"]["after"] is not None]
    assert len(states) == 4
    stats = [k for k in states[0] if k.endswith(("running_mean", "running_var"))]
    assert len(stats) == 40
    for k in stats:
        assert all(torch.equal(s[k], states[0][k]) for s in states[1:]), k


@pytest.mark.parametrize("against", ["one_process", "jax"])
def test_adamw_step_matches(world, against):
    ranks = world["ranks"]
    loss, after, (model, opt) = world["one"]["vit_adamw"]
    want = after if against == "one_process" else world["jax"]["vit_adamw"][1]
    want_loss = loss if against == "one_process" else world["jax"]["vit_adamw"][0]
    assert abs(ranks[0]["vit_adamw"]["loss"] - want_loss) <= 1e-5
    first = {name: opt.state[p]["exp_avg"] for name, p in model.named_parameters()}
    _adam_close(_joined(ranks, "vit_adamw"), {k: want[k] for k in first}, first, against)


@pytest.mark.parametrize("case", TP_CASES)
def test_tensor_parallel_blocks_run_unfused_on_local_heads(world, case):
    """Each attention call of a sharded block gets the rank's half of the
    block's heads (the fused halves and the whole-block kernel, which
    fail in the ranks, never run)."""
    full = {"vit": [4, 4], "swin_v1": [2, 4], "swin_v2": [2, 4], "convnext": []}[case]
    for r in world["ranks"]:
        assert r[case]["heads"] == [h // 2 for h in full]


@pytest.mark.parametrize("case", TP_CASES)
def test_shard_and_join_round_trip(world, case):
    ranks, whole = world["ranks"], world["weights"][case]
    shardings = {k: Shard(*v) for k, v in ranks[0][case]["shardings"].items()}
    shards = [ranks[m][case]["before"] for m in range(2)]
    joined = join_state_dicts(shards, shardings)
    assert joined.keys() == whole.keys()
    assert all(torch.equal(joined[k], whole[k]) for k in whole)
    for m in range(2):
        mine = shard_state_dict(whole, shardings, 2, m)
        assert all(torch.equal(mine[k], shards[m][k]) for k in whole)
    for name in [k for k in whole if k.endswith("attn.qkv.weight")]:
        c = whole[name].shape[1]
        q, k, v = whole[name].split(c)
        h = c // 2
        want = torch.cat([q[h:], k[h:], v[h:]])  # model rank 1: the second half of the heads of each
        assert torch.equal(shards[1][name], want)


def test_remat_step_is_bitwise_the_plain_step(world):
    for r in world["ranks"]:
        assert r["remat"]["losses"][0] == r["remat"]["losses"][1]
        assert r["remat"]["max_abs_diff"] == 0.0


def test_drop_path_masks_by_data_index(world):
    masks = [r["masks"] for r in world["ranks"]]
    assert torch.equal(masks[0], masks[1]) and torch.equal(masks[2], masks[3])
    assert not torch.equal(masks[0], masks[2])
    from eqxvision_tpu_torch.layers import DropPath

    torch.manual_seed(7)
    assert torch.equal(masks[0], DropPath(0.5).train()(torch.ones(64, 1, 1, 1)).flatten())


@pytest.mark.parametrize("case, data", [("resnet18", 4), ("vit", 2)])
def test_evaluate_multihost_matches_evaluate(world, case, data):
    ranks = world["ranks"]
    results = [r[f"eval_{case}"] for r in ranks]
    assert all(r["acc"] == results[0]["acc"] for r in results)
    # every data rank's padded shard, as one process reads them
    shards = [results[d * (4 // data)]["indices"] for d in range(data)]
    assert sorted(set(i for s in shards for i in s)) == list(range(14))
    xs, ys = torch.load(os.path.join(world["work"], "eval.pt"), weights_only=True)
    model = world_cases.BUILDERS[case]()
    model.load_state_dict(world["weights"][case])
    idx = [i for s in shards for i in s]
    want = evaluate(model.eval(), [(xs[idx[i : i + 4]], ys[idx[i : i + 4]]) for i in range(0, len(idx), 4)])
    assert tuple(results[0]["acc"]) == want


def test_cli_resumes_to_the_unbroken_run(world):
    cli = [r["cli"] for r in world["ranks"]]
    assert all(c["step"] == 4 and c["max_abs_diff"] == 0.0 for c in cli)
    files = cli[0]["files"]
    assert {"meta.json", "model.npz", "model.m0.npz", "model.m1.npz", "optimizer.m0.npz", "ema.m1.npz",
            "rng.r3.npz"} <= set(files)


def test_cli_joined_checkpoint_is_served_by_the_eval_cli(world):
    cli = world["ranks"][0]["cli"]
    path = os.path.join(world["work"], "cli_unbroken", "step_4", "model.npz")
    args = eval_imagenet.build_argparser().parse_args(
        ["--model", "convnext_tiny", "--data-dir", world["work"], "--device", "cpu", "--torch-weights", path])
    model = eval_imagenet.build_model(args)
    with torch.no_grad():
        logits = model(cli["input"])
    np.testing.assert_allclose(logits.numpy(), cli["logits"].numpy(), atol=1e-5, rtol=1e-5)


def test_ranks_import_no_jax(world):
    assert all(r["jax_modules"] == [] for r in world["ranks"])


def test_mesh_layout(world):
    """Rank r sits at data index r // 2 and model index r % 2; its data
    group holds the ranks of its model index, its model group those of its
    data index."""
    for rank, r in enumerate(world["ranks"]):
        d, m = rank // 2, rank % 2
        assert r["mesh22"] == [d, m, [m, m + 2], [2 * d, 2 * d + 1]]


def test_local_shard_pads_and_covers():
    items = list(range(10))
    shards = [local_shard(items, i, 4) for i in range(4)]
    assert shards == [[0, 1, 2], [3, 4, 5], [6, 7, 8], [9, 9, 9]]
    assert local_shard(items, 0, 1) == items and local_shard(items) == items  # one process
    assert sorted(set(sum(shards, []))) == items


def test_make_mesh_refuses_a_world_it_does_not_fit():
    with pytest.raises(ValueError, match="world size"):
        make_mesh(model=2)
    mesh = make_mesh()
    assert (mesh.data, mesh.model, mesh.data_index, mesh.model_index) == (1, 1, 0, 0)


def test_dryrun_multichip():
    losses = dryrun_multichip(4, device="cpu", timeout_s=300)
    assert set(losses) == {"vit", "resnet18"} and all(np.isfinite(v) for v in losses.values())


def test_placement(monkeypatch):
    """The CPU over gloo; on the cards one a rank over NCCL where there are
    enough, else round-robin over gloo; no card raises."""
    assert launch.placement(4, "cpu") == ("gloo", [torch.device("cpu")] * 4)
    for cards, want in [(1, ("gloo", [0, 0, 0, 0])), (3, ("gloo", [0, 1, 2, 0])), (4, ("nccl", [0, 1, 2, 3])),
                        (8, ("nccl", [0, 1, 2, 3]))]:
        monkeypatch.setattr(torch.cuda, "device_count", lambda: cards)
        backend, devices = launch.placement(4, "cuda")
        assert (backend, [d.index for d in devices]) == want and {d.type for d in devices} == {"cuda"}
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        launch.placement(4, "cuda")


def test_dryrun_multichip_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        dryrun_multichip(4)
