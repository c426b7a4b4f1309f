"""ImageNet training on one card (scripts/train_imagenet.py's flags).

- host threads decode images into uint8 canvases (``data.ImageFolderLoader``,
  or ``--synthetic`` random batches), copied to the card ahead of the step
  (``data.device_prefetch``);
- RandomResizedCrop, flip, the auto-augmentation policy (``--aa``), label
  smoothing and mixup / cutmix run on the card before the forward
  (``ops.augment``), from one ``torch.Generator``; mixup and cutmix each
  take their own draws, and a fair coin picks one;
- bf16 compute with f32 master weights (``--bf16``) and remat of the whole
  forward (``--remat``), ``parallel.make_train_step``;
- SGD with momentum 0.9 or AdamW, weight decay off norms and biases, a
  linear warmup then cosine decay stepped once an optimiser step (the first
  step takes the schedule's value at 0, as optax's count does);
- the EMA of the weights (``--ema``), which eval then uses;
- checkpoints under ``--ckpt-dir``/step_<n>: the model as
  ``weights.save_model``'s npz, the optimiser state, the EMA and the RNG
  states as npz, the rest as JSON; no pickle. ``--resume`` restores them
  and reruns nothing: a resumed run takes the steps an unbroken run would;
- several processes (``--distributed``, launched by ``torchrun``, each rank
  on ``cuda:$LOCAL_RANK`` over NCCL, or on the CPU over gloo) on a ``data x
  model`` mesh (``--mesh-model`` ranks of tensor parallel, the rest data
  parallel): ``--batch-size`` is the global batch, each rank takes its rows
  (``--synthetic``: every rank makes the global batch from the seed; a
  dataset: each data rank decodes its own share, ``process_shard``), the
  BatchNorms are synchronised and the transformer blocks split
  (``parallel.parallelize``). Dropout, drop path and the augmentation draw
  by (seed, data index) (ROADMAP C.22). Rank 0 logs. A checkpoint holds
  each model rank's shards of the model, optimiser and EMA
  (``model.m<i>.npz`` ..., written by the ranks of data index 0) and each
  rank's RNG states (``rng.r<rank>.npz``); after a barrier rank 0 joins the
  shards into the one-card ``model.npz`` (``weights.join_shards``), which
  ``load_model`` and the eval CLI (``--torch-weights``) read, and writes
  ``latest.json``.

Smoke test on the CPU (no dataset):

  python -m eqxvision_tpu_torch.cli.train_imagenet --device cpu \\
      --model squeezenet1_0 --synthetic 3 --batch-size 8 --canvas 56 \\
      --crop 48 --num-classes 10 --epochs 2 --warmup-epochs 0

On the card (the default ``--device cuda``; it raises where there is none):

  python -m eqxvision_tpu_torch.cli.train_imagenet --model resnet50 \\
      --data-dir /data/imagenet/train --eval-dir /data/imagenet/val \\
      --epochs 90 --batch-size 256 --opt sgd --lr 0.1 --bf16 \\
      --ckpt-dir /ckpt/r50 --resume

On four cards, 2 data x 2 tensor-parallel ranks:

  torchrun --nproc-per-node 4 -m eqxvision_tpu_torch.cli.train_imagenet \\
      --distributed --mesh-model 2 --model vit_base --synthetic 100 \\
      --batch-size 256 --opt adamw --lr 1e-3 --bf16 --ckpt-dir /ckpt/vitb
"""
from __future__ import annotations

import argparse
import json
import math
import os
import time
from typing import Callable, Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from ..data import ImageFolderLoader, device_prefetch
from ..models import create_model
from ..models._common import resolve_device
from ..ops import augment as aug
from ..ops.preprocessing import imagenet_eval_pipeline
from ..parallel import (
    Mesh,
    ema_init,
    ema_params,
    ema_update,
    initialize_multihost,
    make_eval_step,
    make_mesh,
    make_train_step,
    param_groups,
    param_shardings,
    parallelize,
    seed_rank,
    shard_batch,
)
from ..weights.serialize import join_shards, load_model, save_model


def build_argparser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m eqxvision_tpu_torch.cli.train_imagenet")
    ap.add_argument("--model", default="resnet50")
    ap.add_argument("--num-classes", type=int, default=1000)
    ap.add_argument("--device", default="cuda", help="cuda (the default; raises without a card) or cpu")
    ap.add_argument("--data-dir", default=None, help="ImageFolder train root")
    ap.add_argument("--eval-dir", default=None, help="ImageFolder val root")
    ap.add_argument("--synthetic", type=int, default=0, metavar="STEPS",
                    help="train on STEPS random uint8 batches an epoch (no dataset)")
    ap.add_argument("--epochs", type=int, default=90)
    ap.add_argument("--batch-size", type=int, default=256)
    ap.add_argument("--canvas", type=int, default=256, help="host decode canvas side (uint8, before the crop)")
    ap.add_argument("--crop", type=int, default=224)
    # optimisation
    ap.add_argument("--opt", choices=["sgd", "adamw"], default="sgd")
    ap.add_argument("--lr", type=float, default=0.5)
    ap.add_argument("--weight-decay", type=float, default=2e-5)
    ap.add_argument("--warmup-epochs", type=float, default=5.0)
    ap.add_argument("--label-smoothing", type=float, default=0.1)
    ap.add_argument("--bf16", action="store_true", help="bf16 forward and backward, f32 master weights")
    ap.add_argument("--remat", action="store_true", help="recompute the forward in the backward")
    ap.add_argument("--ema", type=float, default=0.0, metavar="DECAY",
                    help="EMA of the weights (e.g. 0.9999); eval uses the EMA")
    # augmentation (on the device)
    ap.add_argument("--aa", default=None, choices=["autoaugment", "randaugment", "trivialaugmentwide", "augmix"],
                    help="auto-augmentation policy after the crop and flip, on the device")
    ap.add_argument("--mixup", type=float, default=0.0, metavar="ALPHA")
    ap.add_argument("--cutmix", type=float, default=0.0, metavar="ALPHA")
    # parallelism
    ap.add_argument("--mesh-model", type=int, default=1,
                    help="tensor-parallel ranks (the mesh's model axis); the rest of the world is data parallel")
    ap.add_argument("--distributed", action="store_true",
                    help="join torchrun's world (RANK, WORLD_SIZE, LOCAL_RANK, MASTER_ADDR, MASTER_PORT)")
    # checkpoints and logging
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=0, metavar="STEPS",
                    help="also checkpoint every STEPS steps (0: at each epoch's end only)")
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--log-every", type=int, default=50)
    ap.add_argument("--workers", type=int, default=8)
    ap.add_argument("--seed", type=int, default=0)
    return ap


def synthetic_batches(steps: int, batch_size: int, side: int, num_classes: int, seed: int):
    """Seeded random uint8 canvases and labels (no dataset)."""
    rng = np.random.RandomState(seed)
    for _ in range(steps):
        x = rng.randint(0, 256, (batch_size, side, side, 3), np.uint8)
        y = rng.randint(0, num_classes, (batch_size,), np.int32)
        yield x, y


def warmup_cosine(warmup_steps: int, decay_steps: int) -> Callable[[int], float]:
    """optax's ``warmup_cosine_decay_schedule`` (init 0, end 0) as a
    multiplier of the peak rate, for ``LambdaLR``: linear from 0 to 1 over
    ``warmup_steps``, then ``0.5 * (1 + cos(pi t / T))`` over the
    remaining ``T = decay_steps - warmup_steps``, then 0."""
    if decay_steps <= warmup_steps:
        raise ValueError(f"the cosine decay needs decay_steps ({decay_steps}) > warmup_steps ({warmup_steps})")
    span = decay_steps - warmup_steps

    def factor(step: int) -> float:
        if step < warmup_steps:
            return step / warmup_steps
        return 0.5 * (1.0 + math.cos(math.pi * min(step - warmup_steps, span) / span))

    return factor


def build_optimizer(model: torch.nn.Module, opt: str, lr: float, weight_decay: float) -> torch.optim.Optimizer:
    """``sgd``: optax's add_decayed_weights + sgd(momentum=0.9); ``adamw``:
    optax's adamw; each with decay on the parameters of more than one axis."""
    groups = param_groups(model, weight_decay)
    if opt == "sgd":
        return torch.optim.SGD(groups, lr=lr, momentum=0.9)
    return torch.optim.AdamW(groups, lr=lr)


def make_augment_fn(num_classes: int, crop: int, label_smoothing: float, mixup: float, cutmix: float,
                    auto_augment_policy: Optional[str] = None):
    """``augment_fn(generator, x_uint8, y)``: ``imagenet_train_pipeline`` to
    ``crop`` (with ``auto_augment_policy`` after the crop and flip),
    smoothed labels, then mixup or cutmix where asked; with both, each
    draws its own values and a fair coin picks one a batch."""

    def augment_fn(generator, x, y):
        x = aug.imagenet_train_pipeline(generator, x, size=crop, auto_augment_policy=auto_augment_policy)
        y = aug.smooth_labels(y, num_classes, label_smoothing)
        if mixup and cutmix:
            pick = torch.rand((), generator=generator, device=x.device) < 0.5
            xm, ym = aug.mixup(generator, x, y, mixup)
            xc, yc = aug.cutmix(generator, x, y, cutmix)
            return torch.where(pick, xm, xc), torch.where(pick, ym, yc)
        if mixup:
            return aug.mixup(generator, x, y, mixup)
        if cutmix:
            return aug.cutmix(generator, x, y, cutmix)
        return x, y

    return augment_fn


class TrainState(NamedTuple):
    """What a checkpoint holds beside the step."""

    model: torch.nn.Module
    optimizer: torch.optim.Optimizer
    scheduler: torch.optim.lr_scheduler.LambdaLR
    ema: Optional[Dict[str, torch.Tensor]]
    generator: torch.Generator


def build_train_state(args: argparse.Namespace, device: torch.device, steps_per_epoch: int,
                      mesh: Optional[Mesh] = None) -> TrainState:
    """The model (from ``--seed``, in training mode; on a mesh its rank's
    share, ``parallelize``), optimiser, schedule, EMA and augmentation
    generator of a fresh run; the default generators and the augmentation's
    seeded with ``--seed`` (on a mesh by ``(--seed, data index)``,
    ``seed_rank``)."""
    seed = seed_rank(args.seed, mesh)
    model = create_model(args.model, num_classes=args.num_classes, generator=torch.Generator().manual_seed(args.seed),
                         device=device).train()
    if mesh is not None:
        parallelize(model, mesh)
    optimizer = build_optimizer(model, args.opt, args.lr, args.weight_decay)
    total_steps = steps_per_epoch * args.epochs
    schedule = warmup_cosine(max(1, int(args.warmup_epochs * steps_per_epoch)), max(2, total_steps))
    return TrainState(model, optimizer, torch.optim.lr_scheduler.LambdaLR(optimizer, schedule),
                      ema_init(model) if args.ema else None, torch.Generator(device=device).manual_seed(seed))


def _rng_states(generator: torch.Generator) -> Dict[str, torch.Tensor]:
    """The augmentation generator's state and the default generators' (the
    CPU's and, on the card, the device's: dropout and drop path draw there)."""
    states = {"generator": generator.get_state(), "cpu": torch.get_rng_state()}
    if generator.device.type == "cuda":
        states["cuda"] = torch.cuda.get_rng_state(generator.device)
    return states


def _rng_arrays(ts: TrainState) -> Dict[str, np.ndarray]:
    return {f"rng:{k}": v.numpy() for k, v in _rng_states(ts.generator).items()}


def save_checkpoint(path: str, step: int, ts: TrainState, mesh: Optional[Mesh] = None) -> None:
    """One process: ``model.npz``, ``optimizer.npz`` (with the RNG states),
    ``ema.npz`` and ``meta.json``. On a mesh: the ranks of data index 0
    write their shards (``model.m<i>.npz``, ``optimizer.m<i>.npz``,
    ``ema.m<i>.npz``, ``i`` the model index), every rank its RNG states
    (``rng.r<rank>.npz``) and rank 0 ``meta.json`` with the mesh and the
    shards' layout; after a barrier rank 0 joins the shards into
    ``model.npz``, and the ranks wait for it. Every rank of the mesh must
    call it."""
    os.makedirs(path, exist_ok=True)
    one = mesh is None or mesh.world == 1
    tag = "" if one else f".m{mesh.model_index}"
    opt = ts.optimizer.state_dict()
    if one or mesh.data_index == 0:
        save_model(os.path.join(path, f"model{tag}.npz"), ts.model)
        arrays = {f"state:{i}:{k}": v.detach().cpu().numpy()
                  for i, s in opt["state"].items() for k, v in s.items() if torch.is_tensor(v)}
        np.savez(os.path.join(path, f"optimizer{tag}.npz"), **arrays, **(_rng_arrays(ts) if one else {}))
        if ts.ema is not None:
            np.savez(os.path.join(path, f"ema{tag}.npz"), **{k: v.cpu().numpy() for k, v in ts.ema.items()})
    if not one:
        np.savez(os.path.join(path, f"rng.r{mesh.rank}.npz"), **_rng_arrays(ts))
        shardings = {k: list(v) for k, v in param_shardings(ts.model, mesh).items() if v is not None}
    if one or mesh.rank == 0:
        sched = {k: v for k, v in ts.scheduler.state_dict().items() if k != "lr_lambdas"}
        meta = {"step": step, "param_groups": opt["param_groups"], "scheduler": sched}
        if not one:
            meta.update(mesh=[mesh.data, mesh.model], shardings=shardings)
        with open(os.path.join(path, "meta.json"), "w") as f:
            json.dump(meta, f)
    if not one:
        dist.barrier()
        if mesh.rank == 0:
            shards = [os.path.join(path, f"model.m{m}.npz") for m in range(mesh.model)]
            join_shards(shards, shardings, os.path.join(path, "model.npz"))
        dist.barrier()  # no rank writes the next checkpoint's shards while rank 0 reads these


def _load_rng(key: str, value: np.ndarray, ts: TrainState) -> None:
    if key == "generator":
        ts.generator.set_state(torch.from_numpy(value))
    elif key == "cpu":
        torch.set_rng_state(torch.from_numpy(value))
    else:
        torch.cuda.set_rng_state(torch.from_numpy(value), ts.generator.device)


def load_checkpoint(path: str, ts: TrainState, mesh: Optional[Mesh] = None) -> int:
    """Restore ``ts`` in place from ``path`` (on a mesh, this rank's shards
    and RNG states; the mesh must be the one that saved); returns the step."""
    with open(os.path.join(path, "meta.json")) as f:
        meta = json.load(f)
    one = mesh is None or mesh.world == 1
    if not one and meta.get("mesh") != [mesh.data, mesh.model]:
        raise ValueError(f"{path} was saved on a {meta.get('mesh')} mesh, not on [{mesh.data}, {mesh.model}]")
    tag = "" if one else f".m{mesh.model_index}"
    load_model(os.path.join(path, f"model{tag}.npz"), ts.model)
    state: Dict[int, Dict[str, torch.Tensor]] = {}
    with np.load(os.path.join(path, f"optimizer{tag}.npz"), allow_pickle=False) as data:
        for key in data.files:
            kind, _, rest = key.partition(":")
            if kind == "state":
                i, _, name = rest.partition(":")
                state.setdefault(int(i), {})[name] = torch.from_numpy(data[key])
            elif one:
                _load_rng(rest, data[key], ts)
    if not one:
        with np.load(os.path.join(path, f"rng.r{mesh.rank}.npz"), allow_pickle=False) as data:
            for key in data.files:
                _load_rng(key.partition(":")[2], data[key], ts)
    groups = [{k: tuple(v) if k == "betas" else v for k, v in g.items()} for g in meta["param_groups"]]
    ts.optimizer.load_state_dict({"state": state, "param_groups": groups})
    ts.scheduler.load_state_dict({**meta["scheduler"], "lr_lambdas": [None] * len(groups)})
    if ts.ema is not None:
        with np.load(os.path.join(path, f"ema{tag}.npz"), allow_pickle=False) as data:
            for k, v in ts.ema.items():
                v.copy_(torch.from_numpy(data[k]))
    return int(meta["step"])


def setup_world(args: argparse.Namespace) -> Tuple[torch.device, Mesh]:
    """This rank's device and mesh. ``--distributed`` joins torchrun's world
    (NCCL on ``cuda:$LOCAL_RANK``, gloo with ``--device cpu``); the mesh has
    ``--mesh-model`` model ranks and raises where they do not divide the
    world."""
    device = resolve_device(args.device)
    if args.distributed:
        if device.type == "cuda":
            device = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
            torch.cuda.set_device(device)
        initialize_multihost(device=device)
    return device, make_mesh(model=args.mesh_model)


def main(argv=None) -> Tuple[int, TrainState]:
    """Train as the flags say; returns the last step and the ``TrainState``."""
    args = build_argparser().parse_args(argv)
    if not (args.data_dir or args.synthetic):
        raise SystemExit("pass --data-dir or --synthetic STEPS")
    device, mesh = setup_world(args)
    if args.batch_size % mesh.data:
        raise ValueError(f"--batch-size {args.batch_size} does not split over {mesh.data} data ranks")
    local_batch = args.batch_size // mesh.data
    shard = (mesh.data_index, mesh.data) if mesh.data > 1 else False

    def log(**kv):
        if mesh.rank == 0:
            print(json.dumps(kv), flush=True)

    # ---- data -------------------------------------------------------
    if args.synthetic:
        steps_per_epoch = args.synthetic

        def epoch_batches(epoch):
            # every rank makes the global batch from the seed and takes its rows
            return (shard_batch(b, mesh) for b in synthetic_batches(
                steps_per_epoch, args.batch_size, args.canvas, args.num_classes, args.seed + epoch))
    else:
        loader = ImageFolderLoader(args.data_dir, batch_size=local_batch, side=args.canvas, shuffle=True,
                                   seed=args.seed, num_workers=args.workers, process_shard=shard)
        steps_per_epoch = len(loader)

        def epoch_batches(epoch):
            loader.seed = args.seed + epoch  # a fresh shuffle each epoch
            return iter(loader)

    total_steps = steps_per_epoch * args.epochs

    # ---- model, optimiser, schedule, EMA -----------------------------
    ts = build_train_state(args, device, steps_per_epoch, mesh)
    model, optimizer, scheduler = ts.model, ts.optimizer, ts.scheduler
    step = make_train_step(
        compute_dtype=torch.bfloat16 if args.bf16 else None, remat=args.remat,
        augment_fn=make_augment_fn(args.num_classes, args.crop, args.label_smoothing, args.mixup, args.cutmix,
                                   args.aa),
        mesh=mesh,
    )

    # ---- checkpoint / resume ------------------------------------------
    start_step = 0
    latest = os.path.join(args.ckpt_dir, "latest.json") if args.ckpt_dir else None
    if latest and args.resume and os.path.exists(latest):
        with open(latest) as f:
            path = os.path.join(args.ckpt_dir, f"step_{json.load(f)['step']}")
        start_step = load_checkpoint(path, ts, mesh)
        log(event="resume", step=start_step, path=path)

    def checkpoint(step_no):
        if not latest:
            return
        path = os.path.join(args.ckpt_dir, f"step_{step_no}")
        save_checkpoint(path, step_no, ts, mesh)
        if mesh.rank == 0:
            with open(latest, "w") as f:
                json.dump({"step": step_no}, f)
        log(event="checkpoint", step=step_no, path=path)

    # ---- eval ---------------------------------------------------------
    eval_step = make_eval_step(mesh=mesh)

    def run_eval(epoch, step_no):
        if not args.eval_dir:
            return
        ev = ImageFolderLoader(args.eval_dir, batch_size=local_batch, side=args.canvas,
                               num_workers=args.workers, process_shard=shard)
        m = (ema_params(ts.ema, model) if args.ema else model).eval()
        c1 = c5 = n = 0
        for x_u8, y in device_prefetch(ev, 2, device):
            x = imagenet_eval_pipeline(x_u8, resize_size=args.canvas, crop_size=args.crop)
            t1, t5, bn = eval_step(m, x, y)
            c1, c5, n = c1 + int(t1), c5 + int(t5), n + bn
        model.train()
        log(event="eval", epoch=epoch, step=step_no, top1=c1 / max(n, 1), top5=c5 / max(n, 1), n=n)

    # ---- train loop ---------------------------------------------------
    step_no = start_step
    log(event="start", model=args.model, device=str(device), steps_per_epoch=steps_per_epoch,
        total_steps=total_steps, start_step=start_step, mesh=[mesh.data, mesh.model])
    for epoch in range(start_step // steps_per_epoch, args.epochs):
        t_log, imgs_since = time.time(), 0
        for x, y in device_prefetch(epoch_batches(epoch), 2, device):
            if step_no >= (epoch + 1) * steps_per_epoch:
                # a resume within an epoch reads the epoch from its start and
                # takes its remaining steps (the sample order is not replayed)
                break
            loss = step(model, optimizer, x, y, ts.generator)
            scheduler.step()
            if args.ema:
                ema_update(ts.ema, model, args.ema, step_no)
            step_no += 1
            imgs_since += args.batch_size
            if step_no % args.log_every == 0 or step_no == total_steps:
                loss_f = float(loss)  # one host sync a log interval
                dt = time.time() - t_log
                log(event="train", epoch=epoch, step=step_no, loss=loss_f, lr=scheduler.get_last_lr()[0],
                    images_per_sec=round(imgs_since / max(dt, 1e-9), 1))
                t_log, imgs_since = time.time(), 0
                if not math.isfinite(loss_f):
                    raise SystemExit(f"non-finite loss at step {step_no}")
            if args.ckpt_every and step_no % args.ckpt_every == 0:
                checkpoint(step_no)
        checkpoint(step_no)
        run_eval(epoch, step_no)
    log(event="done", step=step_no)
    return step_no, ts


if __name__ == "__main__":
    main()
