"""The harness finds every configuration, traffic mix, cell, limit and
per-layer metric by the name ``BENCHMARK.json`` gives it."""
from __future__ import annotations

import json
import re

import pytest

from portbench.harness import spec

BENCH = json.loads((spec.ROOT / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in BENCH["workloads"]]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


@pytest.mark.parametrize("cell", CELLS)
def test_cell_found_by_name(cell):
    c = spec.load_cell(cell)
    assert c.traffic["kind"] in ("infer", "train")
    assert c.family.REFERENCE.param_shapes(c.config)
    reported = {m["name"] for m in c.end_to_end}
    assert "setup_s" in reported and len(reported) >= 2
    assert c.per_layer, "every cell reports a per-layer metric"
    for m in c.per_layer:
        assert m["moves"] in reported
        assert callable(spec.load_reader(m["name"]))


@pytest.mark.parametrize("cell", CELLS)
def test_cell_has_limits(cell):
    limits = spec.load_cell(cell).limits
    assert limits, f"limits/{cell}.json"
    for name, entry in limits.items():
        assert entry["lower"] < entry["limit"] < entry.get("upper", float("inf")), name


def test_every_config_file_and_traffic_file_is_there():
    for c in BENCH["configs"]:
        cfg = json.loads((spec.ROOT / c["file"]).read_text())
        assert cfg["name"] == c["name"] and cfg["reduced"] == c["reduced"]
        assert c["file"].startswith("portbench/")
    for w in BENCH["workloads"]:
        assert (spec.HERE / "traffic" / f"{w['traffic']}.json").exists()


def test_names_units_and_keys_keep_to_the_format():
    metrics = BENCH["end_to_end"] + BENCH["per_layer"]
    names = [m["name"] for m in metrics] + CELLS + [c["name"] for c in BENCH["configs"]]
    assert len(set(names)) == len(names)
    for n in names:
        assert NAME.match(n), n
    for m in metrics:
        assert re.match(r"^[A-Za-z0-9_/%.-]{1,16}$", m["unit"]) and m["better"] in ("lower", "higher")
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    for m in BENCH["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert (spec.HERE / "metrics" / f"{m['name']}.py").exists()
        if m["name"].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"
    assert sum(w["chips"] == 4 for w in BENCH["workloads"]) <= max(1, len(CELLS) // 4)


def test_unknown_cell_is_refused():
    with pytest.raises(KeyError):
        spec.load_cell("no_such.cell")
