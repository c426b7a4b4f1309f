"""Training steps of ``parallel.make_train_step`` (traffic ``kind: train``).

Set-up builds the model in training mode with the traffic's stochastic
depth (``create_model``), loads the benchmark's f32 weights as the masters,
makes AdamW as the training CLI does (``cli.train_imagenet.build_optimizer``)
and the CLI's augmentation (``make_augment_fn``: RandomResizedCrop, flip,
label smoothing, mixup or cutmix), and the bf16 step. On ``ranks`` > 1 it
is one process a card (``parallel.launch``, NCCL): ``make_mesh(data=ranks)``,
``parallelize``, and the step on the mesh, each rank taking ``batch`` rows
of its own. Every batch comes to the card through
``data.device_prefetch(..., 2)`` from a pool of seeded uint8 canvases.

The first steps are the set-up's warm-up, and the first ``checked_steps``
of them are compared with the reference (below). Then the window: steps
until ``--seconds`` have passed (rank 0's clock decides, over a gloo group
of the host, so every rank takes as many steps), a step issued once the
step ``in_flight`` before it has ended; the window closes when the last has.

- ``train_images_per_s``: the images of every step of the window (all
  ranks' rows), over its length by the host's clock;
- ``correct``: after the window, the reference replays the checked steps
  from the same weights, canvases and generator states, in f32: the
  augmentation's draws, stochastic depth's masks (each rank's rows with
  that rank's generators, the gradients averaged over the ranks), the
  soft-target loss, the backward and AdamW. Compared: each step's loss
  (``loss_gap``: the largest |program - reference| / |reference|), the
  first gradient as AdamW got it (its first moment over 1 - beta1 after
  one step) and the parameters' change after the checked steps, each
  leaf's norm against the reference's (``grad_norm_gap``,
  ``change_norm_gap``: the worst leaf's |norm - reference norm| over the
  larger of the reference leaf's norm and the median leaf's). The elements
  whose reference gradient is under a thousandth of the median leaf's RMS
  gradient are left out of the change, on both sides: AdamW moves them by
  round-off alone (the key's third of a qkv bias, under softmax).
"""
from __future__ import annotations

import gc
import os
import time
from types import SimpleNamespace
from typing import Dict, List, Optional

import numpy as np
import torch

from . import inputs, result, spec, trace as tr
from .roofline import KERNEL_OPS
from ..reference import augment as ref_augment
from ..reference import train as ref_train
from ..reference.precision import PRECISIONS, exact_f32

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}
# an element whose reference gradient is under this share of the median leaf's RMS gradient moves under
# AdamW by round-off alone (a key's bias under softmax): it is left out of the change
ZERO_GRAD = 1e-3


def _rng_state(device) -> torch.Tensor:
    return torch.cuda.get_rng_state(device) if torch.device(device).type == "cuda" else torch.get_rng_state()


def _set_rng_state(state: torch.Tensor, device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.set_rng_state(state, device)
    else:
        torch.set_rng_state(state)


def _seed_default(seed: int, device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.manual_seed(seed)
    else:
        torch.manual_seed(seed)


def _rows(seed: int, k: int, rank: int, ranks: int, t: Dict, classes: int):
    """Rank ``rank``'s rows of the run's batch ``k``."""
    return inputs.canvases(seed, k * ranks + rank, t["batch"], t["canvas"], classes)


def _norms(tensors: Dict[str, torch.Tensor]) -> Dict[str, float]:
    return {k: float(v.float().norm()) for k, v in tensors.items()}


def _gap(prog: Dict[str, float], ref: Dict[str, float], keep=None) -> float:
    """The worst leaf's |prog - ref| over max(ref, the median leaf's ref)."""
    names = [k for k in ref if keep is None or keep(k)]
    if not names:
        return 0.0
    median = float(np.median([ref[k] for k in names]))
    worst = 0.0
    for k in names:
        p = prog.get(k, float("nan"))
        if not np.isfinite(p):
            return float("inf")
        worst = max(worst, abs(p - ref[k]) / max(ref[k], median, 1e-30))
    return worst


def reference_numbers(cell, seed: int, weights: Dict[str, torch.Tensor], states: List, device,
                      precision: str = "f32", fault: Optional[str] = None) -> Dict:
    """The reference's losses, first gradients' norms and changes over the
    checked steps. ``states[r]`` is rank r's (augmentation generator state,
    default generator state) before the first step. ``fault`` plants one of
    the training faults in the reference put in the program's place:
    ``half`` (each rank's step takes the first half of its rows),
    ``no_allreduce`` (each rank steps on its own rows' gradient; rank 0's
    state is read)."""
    t, cfg = cell.traffic, cell.config
    ranks, steps = t["ranks"], t["checked_steps"]
    forward = cell.reference.forward
    q = PRECISIONS[precision]
    drop = ref_train.drop_path_fn(cell.reference.drop_rates(cfg, t["drop_path"]))
    p0 = {k: v.detach().float().clone() for k, v in weights.items()}
    replicas = ranks if fault == "no_allreduce" else 1
    params = [{k: v.clone() for k, v in p0.items()} for _ in range(replicas)]
    opts = [ref_train.AdamW(p, t["lr"], t["weight_decay"]) for p in params]
    gens, defaults = [], []
    for aug_state, default_state in states:
        g = torch.Generator(device=device)
        g.set_state(aug_state)
        gens.append(g)
        defaults.append(default_state)
    saved_default = _rng_state(device)
    losses, grads0 = [], None
    with exact_f32():
        for k in range(steps):
            def shards(group):
                for r in group:
                    x_u8, y = _rows(seed, k, r, ranks, t, cfg["num_classes"])
                    if fault == "half":
                        x_u8, y = x_u8[: len(y) // 2], y[: len(y) // 2]
                    x_u8 = torch.from_numpy(x_u8).to(device)
                    y = torch.from_numpy(y).to(device)
                    x, target = ref_augment.augment(gens[r], x_u8, y, size=t["crop"], classes=cfg["num_classes"],
                                                    smoothing=t["label_smoothing"], mixup=t["mixup"],
                                                    cutmix=t["cutmix"])

                    def before(r=r):
                        _set_rng_state(defaults[r], device)

                    yield x, target, before
                    defaults[r] = _rng_state(device)

            step_losses = []
            groups = [[r] for r in range(ranks)] if replicas > 1 else [list(range(ranks))]
            for i, group in enumerate(groups):
                loss, grads = ref_train.loss_and_grads(lambda p, x, d: forward(p, x, cfg, q, d), params[i],
                                                       shards(group), drop)
                step_losses.append(float(loss))
                if k == 0 and i == 0:
                    grads0 = grads
                opts[i].step(grads)
                del grads
            losses.append(float(np.mean(step_losses)))
    _set_rng_state(saved_default, device)
    rms = float(np.median([float(g.norm()) / g.numel() ** 0.5 for g in grads0.values()]))
    keep = {k: g.abs() >= ZERO_GRAD * rms for k, g in grads0.items()}
    return {"losses": losses, "grad_norms": _norms(grads0), "delta": {k: params[0][k] - p0[k] for k in p0},
            "keep": keep}


def compare(prog: Dict, ref: Dict) -> Dict[str, float]:
    """The compared numbers of a program's (or the control's) readings
    against the reference's."""
    losses = [abs(a - b) / max(abs(b), 1e-30) if np.isfinite(a) else float("inf")
              for a, b in zip(prog["losses"], ref["losses"])]
    keep = {k: m for k, m in ref["keep"].items() if bool(m.any())}
    change_prog = {k: float(prog["delta"][k].float()[m].norm()) for k, m in keep.items()}
    change_ref = {k: float(ref["delta"][k][m].norm()) for k, m in keep.items()}
    return {
        "loss_gap": max(losses),
        "grad_norm_gap": _gap(prog["grad_norms"], ref["grad_norms"]),
        "change_norm_gap": _gap(change_prog, change_ref),
    }


class _Stopper:
    """Whether the window goes on: rank 0's clock, shared over a gloo group
    of the host so that no rank waits on the card for it."""

    def __init__(self, mesh) -> None:
        self.group = None
        if mesh is not None and mesh.world > 1:
            import torch.distributed as dist

            self.group = dist.new_group(backend="gloo")
            self.rank = dist.get_rank()
        self.flag = torch.zeros(1, dtype=torch.int32)

    def go_on(self, stop: bool) -> bool:
        """False once rank 0's ``stop`` is true, on every rank alike."""
        if self.group is None:
            return not stop
        import torch.distributed as dist

        self.flag[0] = int(stop) if self.rank == 0 else 0
        dist.broadcast(self.flag, 0, group=self.group)
        return not bool(self.flag[0])


def _apply_fault(fault: Optional[str], step, optimizer):
    """Break the timed path (tests only): ``unchanged`` (the optimiser's
    step does nothing), ``half`` (each step takes the first half of its
    rows), ``no_allreduce`` (the gradients' all-reduce is left out)."""
    if fault is None:
        return step
    if fault == "unchanged":
        optimizer.step = lambda *a, **k: None
        return step
    if fault == "half":
        return lambda model, opt, x, y, g: step(model, opt, x[: len(x) // 2], y[: len(y) // 2], g)
    if fault == "no_allreduce":
        import eqxvision_tpu_torch.parallel.train as ptrain

        ptrain.all_reduce_grads = lambda params, mesh: None
        return step
    raise ValueError(f"unknown fault {fault!r}")


def rank_run(cell_name: str, overrides: Optional[Dict], seed: int, seconds: float, trace: bool, device,
             process_start: float, fault: Optional[str] = None) -> Dict:
    """One rank's run (the whole run on one card). Rank 0's result holds the
    metrics and the check; every rank's its peak memory and busy time."""
    from eqxvision_tpu_torch.cli.train_imagenet import build_optimizer, make_augment_fn
    from eqxvision_tpu_torch.data import device_prefetch
    from eqxvision_tpu_torch.models import create_model
    from eqxvision_tpu_torch.parallel import make_mesh, make_train_step, parallelize

    cell = spec.load_cell(cell_name, overrides=overrides)
    t, cfg = cell.traffic, cell.config
    ranks = t["ranks"]
    mesh = make_mesh(data=ranks) if ranks > 1 else None
    rank = mesh.rank if mesh is not None else 0
    if mesh is not None and device != "cpu":
        from eqxvision_tpu_torch.parallel.launch import rank_device

        device = rank_device()
    device = torch.device(device)
    on_card = device.type == "cuda"

    model = create_model(cfg["factory"], device=device, generator=torch.Generator(device=device).manual_seed(0),
                         **cell.family.model_kwargs(cfg, t["drop_path"]))
    model.train()
    weights = inputs.make_weights(cell.reference.param_shapes(cfg), seed, device, torch.float32)
    inputs.load_into(model, weights)
    if mesh is not None:
        parallelize(model, mesh)
    optimizer = build_optimizer(model, t["optimizer"], t["lr"], t["weight_decay"])
    augment = make_augment_fn(cfg["num_classes"], t["crop"], t["label_smoothing"], t["mixup"], t["cutmix"])
    if trace:
        inner = augment

        def augment(generator, x, y):
            with tr.span("portbench.augment", True):
                return inner(generator, x, y)

    step = make_train_step(compute_dtype=DTYPES[t["compute_dtype"]], remat=t["remat"], augment_fn=augment, mesh=mesh)
    step = _apply_fault(fault, step, optimizer)
    gen = torch.Generator(device=device).manual_seed(inputs.sub_seed(seed, inputs.AUGMENT, rank))
    _seed_default(inputs.sub_seed(seed, inputs.DROP_PATH, rank), device)
    states = [(gen.get_state(), _rng_state(device))]
    if mesh is not None:
        import torch.distributed as dist

        gathered = [None] * ranks
        dist.all_gather_object(gathered, states[0])
        states = gathered

    pool = [_rows(seed, k, rank, ranks, t, cfg["num_classes"]) for k in range(t["pool_batches"])]

    def cycle():
        k = 0
        while True:
            yield pool[k % len(pool)]
            k += 1

    feed = device_prefetch(cycle(), 2, device)
    names = [n for n, _ in model.named_parameters()]
    by_name = dict(model.named_parameters())
    beta1 = optimizer.param_groups[0]["betas"][0]
    losses, grad_norms = [], {}
    for k in range(t["checked_steps"]):
        x, y = next(feed)
        losses.append(step(model, optimizer, x, y, gen))
        if k == 0:
            grad_norms = {n: optimizer.state[by_name[n]]["exp_avg"].norm() / (1 - beta1)
                          if by_name[n] in optimizer.state else torch.zeros((), device=device) for n in names}
    prog = {"losses": [float(v) for v in losses], "grad_norms": {n: float(v) for n, v in grad_norms.items()},
            "delta": {n: by_name[n].detach() - weights[n] for n in names}}

    def steps(go_on):
        """Steps issued in a closed loop, a step once the step ``in_flight``
        before it has ended, while ``go_on(k, elapsed)``; their losses and
        the loop's start and end (the last step ended)."""
        losses_, ends = [], []
        t0 = time.perf_counter()
        while True:
            k = len(losses_)
            if k >= t["in_flight"] and on_card:
                ends[k - t["in_flight"]].synchronize()
            x, y = next(feed)
            with tr.span("portbench.step", trace):
                losses_.append(step(model, optimizer, x, y, gen))
            if on_card:
                end = torch.cuda.Event()
                end.record()
                ends.append(end)
            if not go_on(k + 1, time.perf_counter() - t0):
                break
        if on_card:
            torch.cuda.synchronize()
        return losses_, t0, time.perf_counter()

    # further warm-up through the window's own loop, so that the allocators reach its steady state
    steps(lambda k, _: k < t["extra_warmup_steps"])
    # traced: the input shapes of the kernels' launches, over one more step of the same loop (every rank)
    with tr.shapes_probe(trace, KERNEL_OPS) as shapes:
        if trace:
            steps(lambda k, _: False)
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    setup_s = time.time() - process_start

    stopper = _Stopper(mesh)
    with tr.traced(trace) as prof:
        with tr.span(tr.WINDOW, trace):
            window_losses, t0, t_end = steps(lambda _, elapsed: stopper.go_on(elapsed >= seconds))
    n = len(window_losses)
    window_s = t_end - t0
    peak = torch.cuda.max_memory_allocated(device) if on_card else 0
    failed = sum(1 for v in window_losses if not bool(torch.isfinite(v)))
    out = {"rank": rank, "peak": peak, "kind": result.device_kind(device), "attempted": n, "failed": failed, "setup_s": setup_s,
           "forbidden": result.forbidden_modules()}
    if trace:
        tt = tr.Trace(prof)
        del prof
        out["busy_s"], out["window_s"] = tt.busy_ns / 1e9, tt.window_ns / 1e9
        if rank == 0:
            run = SimpleNamespace(
                trace=tt, cell=cell, chips=ranks, steps=n, images=n * t["batch"] * ranks,
                macs_per_image=cell.family.forward_macs(cfg), shapes=shapes,
            )
            out["metrics"] = result.per_layer_metrics(cell, run)
            out["breakdown"] = {"device_ops": tt.top_device_ops(), "idle_gaps": tt.idle_gaps()}
    else:
        out["metrics"] = {"train_images_per_s": {"value": n * t["batch"] * ranks / window_s, "unit": "images/s"}}
    del model, optimizer, step, feed, window_losses
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    if rank == 0:
        ref = reference_numbers(cell, seed, weights, states, device)
        numbers = compare(prog, ref)
        out["correct"], out["checks"] = result.judge(numbers, cell.limits)
    return out


def world_main(cell_name, overrides, seed, seconds, trace, process_start, fault=None):
    """A rank of a world started by ``run`` (module level, for spawn)."""
    from eqxvision_tpu_torch.parallel.launch import rank_device

    return rank_run(cell_name, overrides, seed, seconds, trace, rank_device().type, process_start, fault)


def run(cell, seed: int, seconds: float, trace: bool, device, process_start: float, overrides=None,
        fault: Optional[str] = None) -> Dict:
    """One run of a training cell; returns the result line's object."""
    ranks = cell.traffic["ranks"]
    if ranks == 1:
        results = [rank_run(cell.name, overrides, seed, seconds, trace, device, process_start, fault)]
    else:
        from eqxvision_tpu_torch.parallel import launch

        if torch.device(device).type == "cuda":
            from eqxvision_tpu_torch import _native

            _native.library()  # built once here, not by each rank
        os.environ.setdefault("OMP_NUM_THREADS", "4")
        results = launch.run(world_main, ranks, (cell.name, overrides, seed, seconds, trace, process_start, fault),
                             device=torch.device(device).type, timeout_s=330.0)
    first = results[0]
    forbidden = sorted({m for r in results for m in r["forbidden"]})
    if forbidden:
        raise RuntimeError(f"a rank loaded {forbidden}")
    metrics = dict(first["metrics"])
    if not trace:
        metrics["setup_s"] = {"value": first["setup_s"], "unit": "s"}
    peak = max(r["peak"] for r in results)
    if trace:
        busy = float(np.mean([r["busy_s"] for r in results]))
        window = float(np.mean([r["window_s"] for r in results]))
        device_info = result.device_block(first["kind"], ranks, peak, busy, window)
    else:
        device_info = result.device_block(first["kind"], ranks, peak)
    out = {"correct": first["correct"], "attempted": first["attempted"],
           "failed": sum(r["failed"] for r in results), "metrics": metrics, "device": device_info}
    if trace:
        out["breakdown"] = first["breakdown"]
    out["checks"] = first["checks"]
    return out
