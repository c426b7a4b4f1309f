"""The program's spans in a traced window (``observability.SPANS``), read
from ``trace.Trace``'s public fields.

The port opens its spans (``observability.annotate``) as the profiler's own
host events, on the clock of the card's activities. A span here is every
interval of a host op on the window's thread whose name starts with a
prefix, clipped to the window and merged, so that a span nested in another
of the same prefix counts once. Each helper returns None where the trace
holds none of the span's intervals, or nothing for it to read:

- ``host_ms``: the host's ms a step inside the span;
- ``device_ms``: the device's ms a step of the activities whose launching
  host op started inside one of the span's intervals, on any thread: the
  autograd engine's device thread launches the backward while the window's
  thread waits in ``loss.backward()``, under no op of that span. An
  activity linked to no host op is left out;
- ``idle_share``: % of the window in which the device is idle while the
  window's thread is inside the span.
"""
from __future__ import annotations

import bisect
from typing import List, Optional, Tuple

Intervals = List[Tuple[int, int]]


def intervals(trace, prefix: str) -> Intervals:
    """The union of the span's intervals on the window's thread, inside the
    window, in order."""
    lo, hi = trace.window
    spans = sorted((max(s, lo), min(e, hi)) for name, (s, e, thread) in zip(trace.op_name, trace.op_span)
                   if thread == trace.window_thread and name.startswith(prefix) and e > lo and s < hi)
    merged: List[List[int]] = []
    for s, e in spans:
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return [(s, e) for s, e in merged]


def _inside(spans: Intervals, t: int) -> bool:
    k = bisect.bisect_right(spans, (t, float("inf"))) - 1
    return k >= 0 and spans[k][0] <= t < spans[k][1]


def _overlap(a: Intervals, b: Intervals) -> int:
    """The length of the intersection of two sorted unions of intervals."""
    total, i, j = 0, 0, 0
    while i < len(a) and j < len(b):
        total += max(0, min(a[i][1], b[j][1]) - max(a[i][0], b[j][0]))
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total


def _per_step(run, ns: int) -> Optional[float]:
    return ns / 1e6 / run.steps if run.steps else None


def host_ms(run, prefix: str) -> Optional[float]:
    spans = intervals(run.trace, prefix)
    return _per_step(run, sum(e - s for s, e in spans)) if spans else None


def device_ms(run, prefix: str) -> Optional[float]:
    trace = run.trace
    spans = intervals(trace, prefix)
    if not spans or not trace.device:
        return None
    return _per_step(run, sum(e - s for s, e, _, op in trace.device
                              if op >= 0 and _inside(spans, trace.op_span[op][0])))


def idle_share(run, prefix: str) -> Optional[float]:
    trace = run.trace
    spans = intervals(trace, prefix)
    if not spans or not trace.device:
        return None
    lo, hi = trace.window
    idle, cursor = [], lo
    for s, e in trace.busy_intervals():
        if s > cursor:
            idle.append((cursor, s))
        cursor = max(cursor, e)
    if hi > cursor:
        idle.append((cursor, hi))
    return 100.0 * _overlap(idle, spans) / (hi - lo)
