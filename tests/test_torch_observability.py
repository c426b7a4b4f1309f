"""The port's spans (``observability.annotate``, ``observability.SPANS``) on
the CPU with tiny models: under a profiler, the train step records its
phases once each, in order, on the calling thread; the eval step records
the preprocessing inside its scores; the feed records one span a batch,
closed before the consumer's work. With no profiler a span never enters
``record_function``, and the steps' outputs are bit-identical with the
profiler on and off."""
from __future__ import annotations

import argparse
import contextlib

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from eqxvision_tpu_torch import data, observability
from eqxvision_tpu_torch.cli import eval_imagenet
from eqxvision_tpu_torch.cli.train_imagenet import make_augment_fn
from eqxvision_tpu_torch.models import create_model
from eqxvision_tpu_torch.parallel import make_train_step

PHASES = ["eqxvision.train.augment", "eqxvision.train.forward", "eqxvision.train.backward",
          "eqxvision.train.optimizer"]


def _spans(prof):
    """The port's spans the profiler recorded: (name, start, end, thread), by start."""
    out = [(e.name(), e.start_ns(), e.start_ns() + e.duration_ns(), e.start_thread_id())
           for e in prof.profiler.kineto_results.events()
           if e.device_type() == torch.autograd.DeviceType.CPU and e.name().startswith("eqxvision.")]
    return sorted(out, key=lambda s: s[1])


def _recorded(fn):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    return out, _spans(prof)


def _train_case(remat=False):
    """A tiny ViT, AdamW and one bf16 step with the training CLI's augmentation: (run, outputs)."""
    model = create_model("vit_tiny", device="cpu", img_size=32, patch_size=8, depth=2, num_classes=10,
                         generator=torch.Generator().manual_seed(0)).train()
    state = {k: v.clone() for k, v in model.state_dict().items()}
    x = torch.from_numpy(np.random.RandomState(0).randint(0, 256, (4, 40, 40, 3)).astype(np.uint8))
    y = torch.arange(4)
    step = make_train_step(compute_dtype=torch.bfloat16, remat=remat,
                           augment_fn=make_augment_fn(10, 32, 0.1, 0.8, 1.0))

    def run():
        model.load_state_dict(state)
        opt = torch.optim.AdamW(model.parameters(), lr=1e-3, weight_decay=0.05)
        torch.manual_seed(3)
        loss = step(model, opt, x, y, torch.Generator().manual_seed(1))
        return [loss] + [p.detach().clone() for p in model.parameters()]

    return run


def _eval_case(tta=None):
    args = argparse.Namespace(bf16=False, tta=tta, resize=40, crop=32)
    model = create_model("resnet18", num_classes=4, device="cpu", generator=torch.Generator().manual_seed(0)).eval()
    step = eval_imagenet.make_step(args)
    u8 = torch.from_numpy(np.random.RandomState(1).randint(0, 256, (2, 48, 40, 3)).astype(np.uint8))
    return lambda: [step.scores(model, u8)]


def _feed_case():
    batches = [(np.full((2, 4), k, np.float32), np.arange(2) + k) for k in range(3)]

    def run():
        out = []
        for x, y in data.device_prefetch(iter(batches), 2, "cpu"):
            with torch.autograd.profiler.record_function("consumer"):  # not the patched name
                out += [x * 2, y]
        return out

    return run


@pytest.mark.parametrize("remat", [False, True])
def test_train_step_records_each_phase_once_in_order_on_the_calling_thread(remat):
    def marked():
        with torch.profiler.record_function("marker"):
            pass
        return _train_case(remat)()

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        marked()
    events = [(e.name(), e.start_thread_id()) for e in prof.profiler.kineto_results.events()
              if e.device_type() == torch.autograd.DeviceType.CPU]
    thread = next(t for n, t in events if n == "marker")
    spans = _spans(prof)
    assert [n for n, _, _, _ in spans] == PHASES
    assert all(t == thread for _, _, _, t in spans)
    assert all(a[2] <= b[1] for a, b in zip(spans, spans[1:])), "the phases do not overlap"
    assert "eqxvision.train.sync" not in {n for n, _, _, _ in spans}


@pytest.mark.parametrize("tta", [None, "five_crop"])
def test_eval_scores_records_preprocess_inside_scores(tta):
    _, spans = _recorded(_eval_case(tta))
    assert [n for n, _, _, _ in spans] == ["eqxvision.eval.scores", "eqxvision.eval.preprocess"]
    (_, s0, e0, t0), (_, s1, e1, t1) = spans
    assert s0 <= s1 < e1 <= e0 and t0 == t1


def test_feed_records_one_span_a_batch_closed_before_the_consumer_runs():
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _feed_case()()
    events = [(e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
              for e in prof.profiler.kineto_results.events() if e.device_type() == torch.autograd.DeviceType.CPU]
    feeds = [(s, e) for n, s, e in events if n == "eqxvision.feed"]
    consumers = [(s, e) for n, s, e in events if n == "consumer"]
    assert len(feeds) == 3 and len(consumers) == 3
    for cs, ce in consumers:
        assert all(fe <= cs or fs >= ce for fs, fe in feeds), "a feed span is open while the consumer runs"


CASES = {"train": _train_case, "eval": _eval_case, "feed": _feed_case}


@pytest.mark.parametrize("case", sorted(CASES))
def test_without_a_profiler_a_span_never_enters_record_function(case, monkeypatch):
    run = CASES[case]()

    def refuse(name, *args, **kwargs):
        raise AssertionError(f"record_function({name!r}) entered with no profiler running")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    assert observability.annotate("eqxvision.feed") is observability.annotate("eqxvision.train.sync")
    off = run()
    monkeypatch.undo()
    on, spans = _recorded(run)
    assert spans, "the profiler recorded the port's spans"
    assert len(off) == len(on)
    for a, b in zip(off, on):
        assert torch.equal(a, b)


def test_annotate_is_a_record_function_only_while_a_profiler_records():
    assert isinstance(observability.annotate("eqxvision.feed"), contextlib.nullcontext)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with observability.annotate("eqxvision.feed"):
            pass
        assert isinstance(observability.annotate("eqxvision.feed"), torch.profiler.record_function)
    assert [n for n, _, _, _ in _spans(prof)] == ["eqxvision.feed"]
    assert isinstance(observability.annotate("eqxvision.feed"), contextlib.nullcontext)


def test_spans_are_named_once_and_under_the_ports_prefix():
    assert len(set(observability.SPANS)) == len(observability.SPANS) == 8
    assert all(n.startswith("eqxvision.") for n in observability.SPANS)
    for name in observability.SPANS:
        assert f"``{name}``" in observability.__doc__
