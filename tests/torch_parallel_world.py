"""The ranks of tests/test_torch_parallel.py's world (four CPU processes
over gloo, started by ``eqxvision_tpu_torch.parallel.launch``). This module
imports only torch and the port: the ranks load no JAX.

``run(work_dir)`` makes a 2 data x 2 model mesh and a 4 x 1 mesh in the
one world, runs every case on the inputs the test wrote to ``work_dir``
and returns each case's results; the test holds them against the one-process
step and the JAX step.
"""
import json
import os
import shutil
import sys

import torch
import torch.distributed as dist

from eqxvision_tpu_torch.layers import DropPath
from eqxvision_tpu_torch.models.classification import convnext as C
from eqxvision_tpu_torch.models.classification import swin as S
from eqxvision_tpu_torch.models.classification import vit as V
from eqxvision_tpu_torch.models.classification.resnet import resnet18
from eqxvision_tpu_torch.ops import window_attention as W
from eqxvision_tpu_torch.ops import window_attention_half as WH
from eqxvision_tpu_torch.parallel import (
    evaluate_multihost,
    local_shard,
    make_mesh,
    make_train_step,
    param_shardings,
    parallelize,
    seed_rank,
    shard_batch,
)

LR = 0.1
SMALL_SWIN = dict(patch_size=(4, 4), embed_dim=32, depths=(1, 1), num_heads=(2, 4), window_size=(4, 4),
                  num_classes=5, stochastic_depth_prob=0.0)


def _gen():
    return torch.Generator().manual_seed(0)


# the tensor-parallel cases: the JAX package's test models (tests/test_parallel.py, the dry run's ViT)
BUILDERS = {
    "vit": lambda: V.VisionTransformer(img_size=32, patch_size=16, embed_dim=64, depth=2, num_heads=4, num_classes=5,
                                       generator=_gen(), device="cpu"),
    "swin_v1": lambda: S.SwinTransformer(**SMALL_SWIN, generator=_gen(), device="cpu"),
    "swin_v2": lambda: S.swin_v2_t(**SMALL_SWIN, generator=_gen(), device="cpu"),
    "convnext": lambda: C.ConvNeXt([C.CNBlockConfig(32, 64, 2)], num_classes=5, generator=_gen(), device="cpu"),
    "resnet18": lambda: resnet18(num_classes=5, generator=_gen(), device="cpu"),
}
TP_CASES = ("vit", "swin_v1", "swin_v2", "convnext")
CLI_FLAGS = ["--device", "cpu", "--model", "convnext_tiny", "--synthetic", "2", "--batch-size", "8", "--canvas",
             "40", "--crop", "32", "--epochs", "2", "--warmup-epochs", "1", "--lr", "0.01", "--ema", "0.99",
             "--mixup", "0.2", "--log-every", "1", "--mesh-model", "2", "--distributed"]


def optimizer(name, model):
    if name == "adamw":
        return torch.optim.AdamW(model.parameters(), lr=1e-3, weight_decay=1e-2)
    return torch.optim.SGD(model.parameters(), lr=LR)


def _model(name, work_dir):
    model = BUILDERS[name]()
    model.load_state_dict(torch.load(os.path.join(work_dir, f"{name}.pt"), weights_only=True))
    return model.train()


def _batch(work_dir):
    return torch.load(os.path.join(work_dir, "batch.pt"), weights_only=True)


class _Route:
    """Records the heads each attention kernel entry is called with and
    fails on a fused half or the whole-block kernel."""

    def __init__(self):
        self.heads = []
        saved = {}

        def record(module, name, heads_at):
            orig = getattr(module, name)
            saved[(module, name)] = orig

            def wrapper(*args, **kwargs):
                self.heads.append(args[heads_at])
                return orig(*args, **kwargs)

            setattr(module, name, wrapper)

        def refuse(module, name):
            saved[(module, name)] = getattr(module, name)

            def wrapper(*args, **kwargs):
                raise AssertionError(f"a tensor-parallel block called {name}")

            setattr(module, name, wrapper)

        record(V, "fused_qkv_attention", 1)  # (qkv, num_heads, scale)
        record(W, "window_qkv_attention", 2)  # (qkv, bias, num_heads, scale, cosine_gs)
        for module, name in ((V, "fused_attention_half"), (V, "fused_mlp_half"), (C, "fused_mlp_half"),
                             (S, "fused_mlp_half"), (W, "fused_swin_block_v1"), (W, "fused_swin_block_v2"),
                             (WH, "window_attention_half_v1")):
            refuse(module, name)
        self._saved = saved

    def close(self):
        for (module, name), orig in self._saved.items():
            setattr(module, name, orig)


def step_case(name, mesh, work_dir, opt_name="sgd", remat=False):
    """One f32 step of ``name`` on ``mesh``: the global loss, this rank's
    parameters before (after ``parallelize``) and after, and the layout."""
    model = parallelize(_model(name, work_dir), mesh)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    opt = optimizer(opt_name, model)
    x, y = _batch(work_dir)
    route = _Route()
    try:
        loss = make_train_step(remat=remat, mesh=mesh)(model, opt, *shard_batch((x, y), mesh))
    finally:
        route.close()
    keep = mesh.data_index == 0 or mesh.model == 1
    return {
        "loss": loss.item(),
        "before": before if keep else None,
        "after": model.state_dict() if keep else None,
        "shardings": {k: list(v) for k, v in param_shardings(model, mesh).items() if v is not None},
        "heads": route.heads,
    }


def remat_case(mesh):
    """The ViT with drop path 0.1 and dropout: one plain and one remat step
    from the same weights and seeds, each rank's results bit for bit."""
    x = torch.randn(8, 32, 32, 3, generator=torch.Generator().manual_seed(3))
    y = torch.arange(8) % 5
    out = []
    for remat in (False, True):
        seed_rank(11, mesh)
        model = V.VisionTransformer(img_size=32, patch_size=16, embed_dim=64, depth=2, num_heads=4, num_classes=5,
                                    drop_path_rate=0.1, drop_rate=0.1, generator=_gen(), device="cpu").train()
        parallelize(model, mesh)
        opt = torch.optim.SGD(model.parameters(), lr=LR)
        loss = make_train_step(remat=remat, mesh=mesh)(model, opt, *shard_batch((x, y), mesh))
        out.append((loss, model.state_dict()))
    (l0, s0), (l1, s1) = out
    diff = max((s0[k].double() - s1[k].double()).abs().max().item() for k in s0)
    return {"losses": [l0.item(), l1.item()], "max_abs_diff": diff}


def eval_case(name, mesh, work_dir):
    """``evaluate_multihost`` on this data rank's ``local_shard`` of 14 images
    (the last shard padded), two images a batch."""
    model = parallelize(_model(name, work_dir), mesh).eval()
    xs, ys = torch.load(os.path.join(work_dir, "eval.pt"), weights_only=True)
    mine = local_shard(list(range(len(ys))), mesh.data_index, mesh.data)
    batches = [(xs[mine[i : i + 2]], ys[mine[i : i + 2]]) for i in range(0, len(mine), 2)]
    return {"acc": list(evaluate_multihost(model, batches, mesh)), "indices": mine}


def cli_case(mesh, work_dir):
    """The training CLI under torchrun's environment: an unbroken run of two
    epochs (checkpoints at steps 2 and 4), a run resumed from step 2, and
    the unbroken model's eval logits on a seeded batch."""
    from eqxvision_tpu_torch.cli import train_imagenet as cli

    unbroken, resumed = os.path.join(work_dir, "cli_unbroken"), os.path.join(work_dir, "cli_resumed")
    _, a = cli.main(CLI_FLAGS + ["--ckpt-dir", unbroken, "--ckpt-every", "2"])
    dist.barrier()
    if mesh.rank == 0:
        shutil.copytree(os.path.join(unbroken, "step_2"), os.path.join(resumed, "step_2"))
        with open(os.path.join(resumed, "latest.json"), "w") as f:
            json.dump({"step": 2}, f)
    dist.barrier()
    step, b = cli.main(CLI_FLAGS + ["--ckpt-dir", resumed, "--resume"])
    diffs = [(a.model.state_dict()[k] - v).abs().max().item() for k, v in b.model.state_dict().items()]
    sa, sb = a.optimizer.state_dict()["state"], b.optimizer.state_dict()["state"]
    diffs += [(sa[i][k] - v).abs().max().item() for i in sb for k, v in sb[i].items() if torch.is_tensor(v)]
    diffs += [(a.ema[k] - v).abs().max().item() for k, v in b.ema.items()]
    x = torch.randn(2, 32, 32, 3, generator=torch.Generator().manual_seed(5))
    with torch.no_grad():
        logits = a.model.eval()(x)
    dist.barrier()  # rank 0 has joined the last checkpoint
    return {"step": step, "max_abs_diff": max(diffs), "logits": logits, "input": x,
            "files": sorted(os.listdir(os.path.join(unbroken, "step_4")))}


def run(work_dir):
    torch.set_num_threads(1)
    mesh22 = make_mesh(data=2, model=2)
    mesh41 = make_mesh(data=4, model=1)
    out = {"mesh22": [mesh22.data_index, mesh22.model_index, list(mesh22.data_group.ranks),
                      list(mesh22.model_group.ranks)]}
    for name in TP_CASES:
        out[name] = step_case(name, mesh22, work_dir)
    out["vit_adamw"] = step_case("vit", mesh22, work_dir, opt_name="adamw")
    out["resnet18"] = step_case("resnet18", mesh41, work_dir)
    out["remat"] = remat_case(mesh22)
    seed_rank(7, mesh22)
    out["masks"] = DropPath(0.5).train()(torch.ones(64, 1, 1, 1)).flatten()
    out["eval_resnet18"] = eval_case("resnet18", mesh41, work_dir)
    out["eval_vit"] = eval_case("vit", mesh22, work_dir)
    out["cli"] = cli_case(mesh22, work_dir)
    out["jax_modules"] = [n for n in sys.modules if n == "jax" or n.startswith(("jax.", "eqxvision_tpu."))
                          or n == "eqxvision_tpu"]
    return out
