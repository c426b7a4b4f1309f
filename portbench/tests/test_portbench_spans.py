"""The readers of the program's spans (``harness/spans.py``) on a synthetic
trace: nested spans count once, an activity launched from another thread
inside a span counts, idle time counts only where it meets the span, a
reader finds nothing where its span is absent, and every span a reader
reads is one the program opens (``observability.SPANS``)."""
from __future__ import annotations

import json
import re
from types import SimpleNamespace

import pytest

from eqxvision_tpu_torch.observability import SPANS
from portbench.harness import spans, spec

MAIN, AUTOGRAD = 1, 2
MS = 1_000_000


def _trace(ops, device, window=(0, 100 * MS)):
    """A stand-in for ``trace.Trace``: ``ops`` (name, start, end, thread),
    ``device`` (start, end, index of the launching op or -1), in ns. The
    window's own span is op 0."""
    ops = [("portbench.window", *window, MAIN)] + list(ops)
    busy = []
    for s, e, _ in sorted(device):
        if busy and s <= busy[-1][1]:
            busy[-1][1] = max(busy[-1][1], e)
        else:
            busy.append([s, e])
    return SimpleNamespace(
        op_name=[o[0] for o in ops], op_span=[(o[1], o[2], o[3]) for o in ops], window=window, window_thread=MAIN,
        device=sorted((s, e, "kernel", op + 1 if op >= 0 else -1) for s, e, op in device),
        busy_intervals=lambda: [tuple(b) for b in busy])


def _run(trace, steps=2):
    return SimpleNamespace(trace=trace, steps=steps)


def test_nested_spans_count_once():
    trace = _trace([("eqxvision.eval.scores", 10 * MS, 30 * MS, MAIN),
                    ("eqxvision.eval.scores", 12 * MS, 20 * MS, MAIN),  # nested: inside the first
                    ("eqxvision.eval.scores", 25 * MS, 40 * MS, MAIN),  # overlaps the first's end
                    ("eqxvision.eval.scores", 50 * MS, 60 * MS, AUTOGRAD)],  # another thread: not the window's
                   [])
    assert spans.intervals(trace, "eqxvision.eval.scores") == [(10 * MS, 40 * MS)]
    assert spans.host_ms(_run(trace), "eqxvision.eval.scores") == pytest.approx(15.0)


def test_spans_are_clipped_to_the_window():
    trace = _trace([("eqxvision.feed", -5 * MS, 5 * MS, MAIN), ("eqxvision.feed", 95 * MS, 120 * MS, MAIN)], [])
    assert spans.host_ms(_run(trace, 1), "eqxvision.feed") == pytest.approx(10.0)


def test_an_activity_launched_from_another_thread_inside_the_span_counts():
    trace = _trace([("eqxvision.train.backward", 10 * MS, 40 * MS, MAIN),  # op 0
                    ("aten::mm", 20 * MS, 21 * MS, AUTOGRAD),  # op 1: the autograd engine's, inside the span
                    ("aten::mm", 50 * MS, 51 * MS, AUTOGRAD),  # op 2: after it
                    ("aten::add", 5 * MS, 6 * MS, MAIN)],  # op 3: before it
                   [(22 * MS, 30 * MS, 1), (52 * MS, 56 * MS, 2), (7 * MS, 8 * MS, 3),
                    (30 * MS, 33 * MS, -1)])  # linked to no op: left out
    assert spans.device_ms(_run(trace), "eqxvision.train.backward") == pytest.approx(4.0)
    assert spans.device_ms(_run(trace, 1), "eqxvision.train.backward") == pytest.approx(8.0)


def test_the_launching_op_decides_not_where_the_activity_runs():
    # launched inside the span, run on the device after it ended: it counts; launched before it: it does not
    trace = _trace([("eqxvision.train.forward", 10 * MS, 20 * MS, MAIN), ("aten::mm", 15 * MS, 16 * MS, MAIN),
                    ("aten::mm", 2 * MS, 3 * MS, MAIN)],
                   [(40 * MS, 45 * MS, 1), (12 * MS, 18 * MS, 2)])
    assert spans.device_ms(_run(trace, 1), "eqxvision.train.forward") == pytest.approx(5.0)


def test_idle_time_counts_only_where_it_meets_the_span():
    # busy 0-20 and 30-80 ms; idle 20-30 and 80-100; the feed span 25-35 and 70-90 meets 5 + 10 ms of idle
    trace = _trace([("eqxvision.feed", 25 * MS, 35 * MS, MAIN), ("eqxvision.feed", 70 * MS, 90 * MS, MAIN)],
                   [(0, 20 * MS, -1), (30 * MS, 60 * MS, -1), (50 * MS, 80 * MS, -1)])
    assert spans.idle_share(_run(trace), "eqxvision.feed") == pytest.approx(15.0)
    assert spans.idle_share(_run(trace), "eqxvision.eval.scores") is None


@pytest.mark.parametrize("helper", [spans.host_ms, spans.device_ms, spans.idle_share])
def test_a_helper_finds_nothing_where_its_span_is_absent(helper):
    trace = _trace([("aten::mm", 10 * MS, 20 * MS, MAIN)], [(12 * MS, 18 * MS, 0)])
    assert helper(_run(trace), "eqxvision.feed") is None


BENCH = json.loads((spec.ROOT / "BENCHMARK.json").read_text())
SPAN_READERS = [m["name"] for m in BENCH["per_layer"]
                if "portbench.harness.spans" in (spec.HERE / "metrics" / f"{m['name']}.py").read_text()]


def _full_trace():
    """Every span the program opens, each with an op inside it that launched a kernel."""
    ops, device = [], []
    for k, name in enumerate(SPANS):
        start = (10 * k + 1) * MS
        ops += [(name, start, start + 5 * MS, MAIN), ("aten::mm", start + MS, start + 2 * MS, MAIN)]
        device.append((start + 2 * MS, start + 3 * MS, len(ops) - 1))
    return _trace(ops, device)


def test_every_span_a_reader_reads_is_one_the_program_opens():
    assert len(SPAN_READERS) == 11
    for name in SPAN_READERS:
        source = (spec.HERE / "metrics" / f"{name}.py").read_text()
        read = re.findall(r'"(eqxvision\.[a-z._]+)"', source)
        assert read and set(read) <= set(SPANS), name


@pytest.mark.parametrize("name", SPAN_READERS)
def test_a_reader_reads_the_programs_span_and_none_without_it(name):
    read = spec.load_reader(name)
    assert read(_run(_full_trace())) > 0
    assert read(_run(_trace([("aten::mm", 10 * MS, 20 * MS, MAIN)], [(12 * MS, 18 * MS, 0)]))) is None
