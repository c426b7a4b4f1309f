"""The device trace of a run's window, read from ``torch.profiler``.

``traced()`` wraps the window in a profiler that records the host's ops and
the card's activity (kernels, copies, fills). ``Trace`` then keeps, from the
profiler's raw events:

- the device's activities, each with its start, length, name and the host
  op that launched it (the profiler links a device event to the innermost
  host op open at its launch);
- the host ops, each with its parent on its own thread, so that a kernel
  can be attributed to any op around its launch: an autograd Function of
  the program (``_FusedMlpHalf``), a backward node
  (``autograd::engine::evaluate_function: _LayerNormBackward``) or a span
  that the benchmark opened (``portbench.augment``);
- the traced window: the span ``portbench.window``, opened before the
  first timed call and closed after the last result was ready.

``shapes_probe()`` records, apart from the window, the input shapes of the
program's kernel ops over one iteration of the window's own loop: recording
every op's shapes inside the window would slow the host's side of the loop
that the window measures.

``busy_ns`` is the union of the device's activities inside the window, so
that work overlapping on two streams counts once. Nothing here reads a
clock of its own.
"""
from __future__ import annotations

import bisect
import contextlib
from collections import defaultdict
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import torch

WINDOW = "portbench.window"
SPAN_PREFIX = "portbench."


@contextlib.contextmanager
def traced(enabled: bool):
    """A profiler of the host and the card around the block (``None`` when
    not ``enabled``)."""
    if not enabled:
        yield None
        return
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        yield prof


@contextlib.contextmanager
def shapes_probe(enabled: bool, names: Iterable[str]):
    """Yields a dict that, once the block has ended, holds the input shapes
    of each host op named in ``names`` that ran inside it, in order: one list
    a launch, of one list a positional input (empty for one that is not a
    tensor). Empty when not ``enabled``."""
    found: Dict[str, List[List[List[int]]]] = {}
    if not enabled:
        yield found
        return
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU], record_shapes=True) as prof:
        yield found
    wanted = set(names)
    for e in sorted(prof.profiler.kineto_results.events(), key=lambda e: e.start_ns()):
        if e.device_type() == torch.autograd.DeviceType.CPU and e.name() in wanted:
            found.setdefault(e.name(), []).append([list(s) for s in e.shapes()])


def span(name: str, enabled: bool):
    """A named host span (``record_function``) where tracing is on."""
    return torch.profiler.record_function(name) if enabled else contextlib.nullcontext()


def _device_kind(event) -> bool:
    """True for an activity of the card (a kernel, a copy or a fill), false
    for the card-side copy of a host annotation."""
    if event.device_type() != torch.autograd.DeviceType.CUDA:
        return False
    if event.is_user_annotation() or event.name().startswith(SPAN_PREFIX):
        return False
    kind = getattr(event, "activity_type", None)
    if kind is not None:
        try:
            return "annotation" not in str(kind()).lower()
        except Exception:  # an older profiler without the field's value
            return True
    return True


class Trace:
    """The events of one traced window (see the module docstring)."""

    def __init__(self, prof) -> None:
        events = prof.profiler.kineto_results.events()
        ops: List[Tuple[int, int, str, int, int]] = []  # start, end, name, correlation id, thread
        device: List[Tuple[int, int, str, int]] = []  # start, end, name, linked correlation id
        for e in events:
            start = e.start_ns()
            end = start + e.duration_ns()
            if e.device_type() == torch.autograd.DeviceType.CPU:
                if e.linked_correlation_id() == 0:
                    ops.append((start, end, e.name(), e.correlation_id(), e.start_thread_id()))
            elif _device_kind(e):
                device.append((start, end, e.name(), e.linked_correlation_id()))
        ops.sort(key=lambda o: (o[0], -o[1]))
        # ops are keyed by their place in ``ops``: correlation ids repeat (0 for many host events)
        self.op_name: List[str] = [o[2] for o in ops]
        self.op_span: List[Tuple[int, int, int]] = [(o[0], o[1], o[4]) for o in ops]
        self.parent: List[int] = [-1] * len(ops)
        by_correlation: Dict[int, int] = {}
        stacks: Dict[int, List[Tuple[int, int]]] = defaultdict(list)  # thread -> [(end, index)]
        for i, (start, end, name, cid, thread) in enumerate(ops):
            stack = stacks[thread]
            while stack and stack[-1][0] <= start:
                stack.pop()
            if stack:
                self.parent[i] = stack[-1][1]
            stack.append((end, i))
            if cid > 0:
                by_correlation.setdefault(cid, i)
        windows = [self.op_span[i][:2] for i, n in enumerate(self.op_name) if n == WINDOW]
        if not windows:
            raise RuntimeError(f"the trace holds no {WINDOW!r} span")
        self.window = (min(w[0] for w in windows), max(w[1] for w in windows))
        lo, hi = self.window
        self.device = sorted((max(s, lo), min(e, hi), n, by_correlation.get(op, -1))
                             for s, e, n, op in device if e > lo and s < hi)
        self.window_thread = next(self.op_span[i][2] for i, n in enumerate(self.op_name) if n == WINDOW)

    # ------------------------------------------------------------ window
    @property
    def window_ns(self) -> int:
        return self.window[1] - self.window[0]

    def busy_intervals(self) -> List[Tuple[int, int]]:
        """The union of the device's activities inside the window."""
        merged: List[List[int]] = []
        for s, e, _, _ in self.device:
            if merged and s <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], e)
            else:
                merged.append([s, e])
        return [(s, e) for s, e in merged]

    @property
    def busy_ns(self) -> int:
        return sum(e - s for s, e in self.busy_intervals())

    # ------------------------------------------------------- attribution
    def ancestors(self, op: int) -> Iterable[str]:
        """The names of op ``op`` (an index) and of every op around it on its
        thread (each parent starts before its child: the walk ends)."""
        while op >= 0:
            yield self.op_name[op]
            op = self.parent[op]

    def device_ns(self, under: Optional[Sequence[str]] = None, prefix: Optional[str] = None,
                  kernel_contains: Optional[str] = None) -> int:
        """Summed device time of the activities launched inside an op named
        in ``under`` (or whose name starts with ``prefix``), and/or whose
        own name contains ``kernel_contains``."""
        names = set(under or ())
        cache: Dict[int, bool] = {}
        total = 0
        for s, e, name, op in self.device:
            if kernel_contains is not None and kernel_contains not in name:
                continue
            if names or prefix is not None:
                hit = cache.get(op)
                if hit is None:
                    hit = any(a in names or (prefix is not None and a.startswith(prefix)) for a in self.ancestors(op))
                    cache[op] = hit
                if not hit:
                    continue
            total += e - s
        return total

    def count_ops(self, name: str) -> int:
        """How many host ops named ``name`` started inside the window."""
        lo, hi = self.window
        return sum(1 for i, n in enumerate(self.op_name) if n == name and lo <= self.op_span[i][0] < hi)

    # --------------------------------------------------------- breakdown
    def top_device_ops(self, k: int = 10) -> List[List]:
        """The ``k`` device activities (by name) that took most time, in s."""
        by_name: Dict[str, int] = defaultdict(int)
        for s, e, name, _ in self.device:
            by_name[_short(name)] += e - s
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:k]
        return [[n, ns / 1e9] for n, ns in top]

    def idle_gaps(self, k: int = 10) -> List[List]:
        """The ``k`` longest idle gaps of the device inside the window, in s,
        each named by the innermost host op open on the window's thread at
        the gap's middle (``host: idle`` where none but the window is)."""
        lo, hi = self.window
        busy = self.busy_intervals()
        gaps, cursor = [], lo
        for s, e in busy:
            if s > cursor:
                gaps.append((cursor, s))
            cursor = max(cursor, e)
        if hi > cursor:
            gaps.append((cursor, hi))
        gaps.sort(key=lambda g: g[0] - g[1])
        thread_ops = sorted((s, e, i) for i, (s, e, thread) in enumerate(self.op_span) if thread == self.window_thread)
        starts = [o[0] for o in thread_ops]
        out = []
        for a, b in gaps[:k]:
            mid = (a + b) // 2
            best = None
            for j in range(bisect.bisect_right(starts, mid) - 1, -1, -1):
                s, e, i = thread_ops[j]
                if e >= mid and self.op_name[i] != WINDOW:
                    best = i
                    break
                if mid - s > 5_000_000_000:  # no op starts more than 5 s before it and still runs
                    break
            name = "host: idle" if best is None else "host: " + " < ".join(list(self.ancestors(best))[:3])
            out.append([_short(name), (b - a) / 1e9])
        return out


def _short(name: str, limit: int = 120) -> str:
    name = " ".join(name.split())
    return name if len(name) <= limit else name[: limit - 3] + "..."
