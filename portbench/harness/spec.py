"""``BENCHMARK.json`` and the data files it names, found by name.

- a configuration: ``BENCHMARK.json``'s ``configs`` entry and its ``file``
  (the sizes as run, with the ``family`` whose counts and reference it
  takes: ``families/<family>.py``, ``reference/<family>.py``);
- a traffic mix: ``traffic/<name>.json``, read by the runner its ``kind``
  names (``infer`` or ``train``);
- a cell: a ``workloads`` entry, with its limits in ``limits/<cell>.json``;
- a per-layer metric: ``metrics/<name>.py``, whose ``read(run)`` returns a
  number or None.

Adding a configuration, a mix, a cell or a metric adds files and entries;
nothing here names one.
"""
from __future__ import annotations

import importlib
import importlib.util
import json
from dataclasses import dataclass, field
from pathlib import Path
from typing import Callable, Dict, List, Optional

HERE = Path(__file__).resolve().parents[1]  # portbench/
ROOT = HERE.parent


@dataclass
class Cell:
    name: str
    chips: int
    config: Dict
    traffic: Dict
    family: object
    end_to_end: List[Dict]
    per_layer: List[Dict]
    limits: Dict[str, Dict] = field(default_factory=dict)

    @property
    def reference(self):
        return self.family.REFERENCE


def load_json(path: Path) -> Dict:
    with open(path) as f:
        return json.load(f)


def load_reader(metric: str) -> Callable:
    path = HERE / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(f"portbench_metric_{metric.replace('.', '_')}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def _applies(metric: Dict, cell: str, reported: List[str]) -> bool:
    if "workloads" in metric:
        return cell in metric["workloads"]
    return metric.get("moves", metric["name"]) in reported


def load_cell(name: str, root: Path = ROOT, overrides: Optional[Dict] = None) -> Cell:
    """The cell ``name`` of ``root``'s ``BENCHMARK.json``. ``overrides``
    (tests only) replaces keys of the configuration and the traffic:
    ``{"config": {...}, "traffic": {...}, "limits": {...}}``."""
    bench = load_json(root / "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json (it has {sorted(cells)})")
    w = cells[name]
    entry = next(c for c in bench["configs"] if c["name"] == w["config"])
    config = load_json(root / entry["file"])
    traffic = load_json(HERE / "traffic" / f"{w['traffic']}.json")
    limits_path = HERE / "limits" / f"{name}.json"
    limits = load_json(limits_path) if limits_path.exists() else {}
    overrides = overrides or {}
    config.update(overrides.get("config", {}))
    traffic.update(overrides.get("traffic", {}))
    limits.update(overrides.get("limits", {}))
    e2e = [m for m in bench["end_to_end"] if "workloads" not in m or name in m["workloads"]]
    reported = [m["name"] for m in e2e]
    per_layer = [m for m in bench["per_layer"] if _applies(m, name, reported)]
    family = importlib.import_module(f"portbench.families.{config['family']}")
    return Cell(name, int(w["chips"]), config, traffic, family, e2e, per_layer, limits)
