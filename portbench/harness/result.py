"""The parts of a run's result line that every runner shares: the device
block, the per-layer metrics, and the comparisons that decide ``correct``.

A compared number has its limit in ``limits/<cell>.json`` (``{"name":
{"limit": ..., "lower": ..., "upper": ...}}``, the two readings it was set
between). ``correct`` is true when every compared number has a limit and
lies at or below it; a number the file gives no limit is reported with the
limit null and fails.
"""
from __future__ import annotations

import math
import sys
from typing import Dict, List, Optional, Tuple

import torch

from . import spec

FORBIDDEN = ("jax", "jaxlib", "flax", "eqxvision_tpu")


def device_kind(device) -> str:
    device = torch.device(device)
    return torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"


def device_block(kind: str, count: int, memory_peak_bytes: int, busy_s: Optional[float] = None,
                 window_s: Optional[float] = None) -> Dict:
    out = {"platform": "gpu", "kind": kind, "count": count, "memory_peak_bytes": int(memory_peak_bytes)}
    if busy_s is not None:
        out["busy_s"], out["window_s"] = busy_s, window_s
    return out


def per_layer_metrics(cell, run) -> Dict[str, Dict]:
    """Each per-layer metric of the cell that its reader finds something
    to read for, with its unit."""
    out = {}
    for m in cell.per_layer:
        value = spec.load_reader(m["name"])(run)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def judge(numbers: Dict[str, float], limits: Dict[str, Dict]) -> Tuple[bool, Dict[str, Dict]]:
    """(correct, {name: {"value": v, "limit": l}}) for the compared numbers."""
    checks, correct = {}, bool(numbers)
    for name, value in numbers.items():
        limit = limits.get(name, {}).get("limit")
        checks[name] = {"value": value, "limit": limit}
        if limit is None or not (math.isfinite(value) and value <= limit):
            correct = False
    return correct, checks


def forbidden_modules() -> List[str]:
    """The loaded modules whose top-level name is JAX's, its libraries' or
    the JAX package's (compared whole: ``eqxvision_tpu_torch`` is not
    ``eqxvision_tpu``)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def print_checks(checks: Dict[str, Dict]) -> None:
    """The compared numbers and their limits, as the last lines on stderr."""
    for name, c in checks.items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    sys.stderr.flush()
