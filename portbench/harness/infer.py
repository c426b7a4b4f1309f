"""Batched inference through the eval CLI's step (traffic ``kind: infer``).

Set-up builds the model as the eval CLI does (``create_model``, eval mode,
cast to the traffic's type), loads the benchmark's weights, makes the
step with ``cli.eval_imagenet.make_step`` and a pool of seeded uint8
canvases on the host, and warms the step up on the cell's one shape through
the window's own loop. The
window is a closed loop: each batch of the pool, in turn, comes to the
card through ``data.device_prefetch(..., 2)``, as the CLI's ``main()``
feeds it, and goes through ``step.scores`` and the top-5; a batch is issued
once the batch ``in_flight`` before it has its scores. The loop stops
issuing when ``--seconds`` have passed and the window closes when the last
batch's scores are ready.

- ``images_per_s``: the images of every batch issued, over the window's
  length by the host's clock;
- ``batch_p95_ms``: the 95th percentile over every batch of the window of
  what its caller waits: from the call, on the host's clock before the
  batch is taken from the feed (its pinning and copy included), to its
  scores being ready. The moment the scores are ready is the CUDA event
  after them, put on the host's clock by an event that the loop waited for
  at its start (the card idle, so the event and the host's reading meet);
- ``correct``: a sample of the window's batches, drawn from the seed (the
  first batch issued after each of ``check_batches`` times uniform over the
  window), keeps its scores; after the window the reference runs those
  batches in f32 (preprocessing and model), and the program's scores of
  each image are compared with it (``logit_rel_err``: the largest over the
  images of |program - reference| / |reference|, in the Euclidean norm over
  the 1000 logits). An answer never produced, or not finite, fails.
"""
from __future__ import annotations

import argparse
import gc
import time
from types import SimpleNamespace
from typing import Callable, Dict, Iterator, List, Optional

import numpy as np
import torch
import torch.nn.functional as F

from . import inputs, result, trace as tr
from .roofline import KERNEL_OPS
from ..reference.precision import PRECISIONS, exact_f32

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def _cycle(pool: List, start: int = 0) -> Iterator:
    k = start
    while True:
        yield pool[k % len(pool)]
        k += 1


def build(cell, seed: int, device):
    """The model, the step and the weights, as set-up makes them."""
    from eqxvision_tpu_torch.cli.eval_imagenet import make_step
    from eqxvision_tpu_torch.models import create_model

    cfg, t = cell.config, cell.traffic
    dtype = DTYPES[t["dtype"]]
    model = create_model(cfg["factory"], device=device, generator=torch.Generator(device=device).manual_seed(0),
                         **cell.family.model_kwargs(cfg))
    model = model.eval().to(dtype)
    weights = inputs.make_weights(cell.reference.param_shapes(cfg), seed, device, dtype)
    inputs.load_into(model, weights)
    step = make_step(argparse.Namespace(bf16=dtype == torch.bfloat16, tta=None, resize=t["resize"], crop=t["crop"]))
    return model, step, weights


def preprocess(x_u8: torch.Tensor, resize: int, crop: int) -> torch.Tensor:
    """torchvision's eval transform on NHWC uint8, in f32: the shorter side
    resized to ``resize`` (bilinear, antialiased where it shrinks), the
    centre ``crop`` square, ImageNet normalisation."""
    n, h, w, _ = x_u8.shape
    x = x_u8.permute(0, 3, 1, 2).float()
    oh, ow = (resize, max(round(w * resize / h), 1)) if h <= w else (max(round(h * resize / w), 1), resize)
    if (oh, ow) != (h, w):
        x = F.interpolate(x, size=(oh, ow), mode="bilinear", align_corners=False, antialias=oh < h or ow < w)
    top, left = (oh - crop) // 2, (ow - crop) // 2
    x = x[:, :, top:top + crop, left:left + crop].permute(0, 2, 3, 1) / 255.0
    mean = torch.tensor((0.485, 0.456, 0.406), device=x.device)
    std = torch.tensor((0.229, 0.224, 0.225), device=x.device)
    return (x - mean) / std


def reference_scores(cell, weights: Dict[str, torch.Tensor], x_u8: np.ndarray, device, precision: str,
                     rows: int = 64) -> torch.Tensor:
    """The reference's logits of the canvases ``x_u8``, f32, in blocks of ``rows``."""
    params = {k: v.float() for k, v in weights.items()}
    q = PRECISIONS[precision]
    out = []
    with torch.no_grad(), exact_f32():
        for i in range(0, len(x_u8), rows):
            x = preprocess(torch.from_numpy(x_u8[i:i + rows]).to(device), cell.traffic["resize"], cell.traffic["crop"])
            out.append(cell.reference.forward(params, x, cell.config, q))
    return torch.cat(out)


def logit_rel_err(scores: torch.Tensor, ref: torch.Tensor) -> float:
    """The largest over the images of ||scores - ref|| / ||ref||."""
    scores, ref = scores.float(), ref.float()
    if not bool(torch.isfinite(scores).all()):
        return float("inf")
    return float(((scores - ref).norm(dim=-1) / ref.norm(dim=-1).clamp_min(1e-30)).max())


def run(cell, seed: int, seconds: float, trace: bool, device, process_start: float,
        fault: Optional[Callable] = None) -> Dict:
    """One run of an inference cell; returns the result line's object.
    ``fault(scores) -> scores`` (tests only) alters each batch's answer
    where it is produced."""
    from eqxvision_tpu_torch.data import device_prefetch

    t, cfg = cell.traffic, cell.config
    batch, pool_n, flight = t["batch"], t["pool_batches"], t["in_flight"]
    on_card = torch.device(device).type == "cuda"
    model, step, weights = build(cell, seed, device)
    pool = [inputs.canvases(seed, k, batch, t["canvas"], cfg["num_classes"]) for k in range(pool_n)]
    feed = device_prefetch(_cycle(pool), 2, device)
    probe_batches = 1 if trace else 0

    def answer(x):
        s = step.scores(model, x)
        if fault is not None:
            s = fault(s)
        return s, s.topk(5, dim=-1).indices

    def sync():
        if on_card:
            torch.cuda.synchronize()

    def loop(stop, on_batch=None):
        """The closed loop: a batch is issued once the batch ``in_flight``
        before it has its scores, until ``stop(n, elapsed)``; returns each
        batch's latency in ms (from its call to its scores) and the loop's
        start and end (all scores ready)."""
        n, calls, ends = 0, [], []
        if on_card:
            # the host's clock of the loop's start, and the card's event of the same moment
            anchor = torch.cuda.Event(enable_timing=True)
            anchor.record()
            anchor.synchronize()
        t0 = time.perf_counter()
        while True:
            if n >= flight and on_card:
                ends[n - flight].synchronize()
            called = time.perf_counter()
            x, _ = next(feed)
            with tr.span("portbench.step", trace):
                s, _top5 = answer(x)
            if on_card:
                end = torch.cuda.Event(enable_timing=True)
                end.record()
            else:
                end = time.perf_counter()  # off the card the scores are ready when the call returns
            if on_batch is not None:
                on_batch(n, s, time.perf_counter() - t0)
            calls.append(called - t0)
            ends.append(end)
            n += 1
            if stop(n, time.perf_counter() - t0):
                break
        sync()
        t_end = time.perf_counter()
        ready = [anchor.elapsed_time(e) / 1e3 for e in ends] if on_card else [e - t0 for e in ends]
        return [(r - c) * 1e3 for r, c in zip(ready, calls)], t0, t_end

    with torch.inference_mode():
        # warm-up through the window's own loop, so that the allocators' pools (the card's and the
        # pinned host memory's) reach the window's steady state before it opens
        last = {}
        loop(lambda n, _: n >= t["warmup_batches"], lambda k, s, _: last.update(s=s))
        # the checked batches: the ones issued first after times drawn from the seed, their scores
        # copied into buffers made here, so that the window allocates nothing that it keeps
        # traced: the input shapes of the kernels' launches, over one more batch of the same loop
        with tr.shapes_probe(trace, KERNEL_OPS) as shapes:
            if probe_batches:
                loop(lambda n, _: n >= probe_batches)
        rng = np.random.default_rng(inputs.sub_seed(seed, inputs.CHECK))
        due = sorted(rng.uniform(0.0, seconds, t["check_batches"]).tolist())
        slots = [torch.empty_like(last["s"]) for _ in due]
        del last
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    first = t["warmup_batches"] + probe_batches  # the pool index of the window's first batch
    setup_s = time.time() - process_start

    checked = []

    def keep_checked(k, s, elapsed):
        while len(checked) < len(due) and elapsed >= due[len(checked)]:
            slots[len(checked)].copy_(s)
            checked.append(k)

    with tr.traced(trace) as prof, torch.inference_mode():
        with tr.span(tr.WINDOW, trace):
            batch_ms, t0, t_end = loop(lambda n, elapsed: elapsed >= seconds, keep_checked)
    n = len(batch_ms)
    window_s = t_end - t0
    peak = torch.cuda.max_memory_allocated() if on_card else 0

    metrics = {
        "images_per_s": {"value": n * batch / window_s, "unit": "images/s"},
        "batch_p95_ms": {"value": float(np.percentile(batch_ms, 95)), "unit": "ms"},
        "setup_s": {"value": setup_s, "unit": "s"},
    }
    out = {"attempted": n, "metrics": metrics}
    traced = None
    if trace:
        tt = tr.Trace(prof)
        del prof
        traced = SimpleNamespace(
            trace=tt, cell=cell, chips=1, steps=n, images=n * batch, macs_per_image=cell.family.forward_macs(cfg),
            shapes=shapes,
        )
        out["metrics"] = result.per_layer_metrics(cell, traced)
        out["device"] = result.device_block(result.device_kind(device), 1, peak, tt.busy_ns / 1e9, tt.window_ns / 1e9)
        out["breakdown"] = {"device_ops": tt.top_device_ops(), "idle_gaps": tt.idle_gaps()}
    else:
        out["device"] = result.device_block(result.device_kind(device), 1, peak)

    # the check, once the window has closed and the program's state is freed
    del model, step, feed, traced
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    worst, failed = (0.0, 0) if len(checked) == len(due) else (float("inf"), len(due) - len(checked))
    for k, s in zip(checked, slots):
        x_u8 = pool[(first + k) % pool_n][0]
        err = logit_rel_err(s, reference_scores(cell, weights, x_u8, device, "f32"))
        worst = max(worst, err)
        failed += int(not err <= cell.limits.get("logit_rel_err", {}).get("limit", float("-inf")))
    correct, checks = result.judge({"logit_rel_err": worst}, cell.limits)
    out.update(correct=correct, failed=failed, checks=checks)
    return out
