"""The command line and the result line: ``run.py`` exits without a result
where there is no card, or no program; a run's last line has exactly the
keys the contract names; nothing that a run loads is JAX or the JAX
package; and the reference imports nothing of the program."""
from __future__ import annotations

import json
import shutil
import subprocess
import sys
import textwrap

import pytest

from portbench.harness import spec

ROOT = spec.ROOT
KEYS = ["correct", "attempted", "failed", "metrics", "device"]


def _run(args, cwd=ROOT, env=None):
    return subprocess.run([sys.executable, *args], cwd=cwd, capture_output=True, text=True, timeout=300, env=env)


def _no_card():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")


def test_run_exits_without_a_result_where_there_is_no_card():
    _no_card()
    proc = _run(["portbench/run.py", "--workload", "vit_base.infer_b256", "--seed", "1", "--seconds", "1"])
    assert proc.returncode != 0
    assert not proc.stdout.strip()
    assert "no result" in proc.stderr


def test_run_exits_without_a_result_beside_no_program(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench", ignore=shutil.ignore_patterns("__pycache__"))
    proc = _run(["portbench/run.py", "--workload", "vit_base.infer_b256", "--seed", "1", "--seconds", "1"],
                cwd=tmp_path)
    assert proc.returncode != 0
    assert not proc.stdout.strip()


DRY = textwrap.dedent("""
    import json, sys, time
    sys.path.insert(0, {root!r})
    sys.argv = ["run.py"]
    import portbench.run as run_module
    from portbench.harness import infer, result, spec, train
    tiny = {{"config": {{"image_size": 32, "patch_size": 8, "embed_dim": 32, "depth": 2, "num_heads": 2,
                        "num_classes": 10}},
            "traffic": {{"batch": 4, "canvas": 40, "resize": 40, "crop": 32, "pool_batches": 2,
                         "warmup_batches": 1, "check_batches": 1}}}}
    cell = spec.load_cell({workload!r}, overrides=tiny)
    runner = infer if cell.traffic["kind"] == "infer" else train
    kwargs = {{}} if runner is infer else {{"overrides": tiny}}
    out = runner.run(cell, 2**40 + 1, 0.2, bool({trace}), "cpu", time.time(), **kwargs)
    print(json.dumps({{"keys": sorted(out), "metrics": sorted(out["metrics"]),
                      "device": sorted(out["device"]), "forbidden": result.forbidden_modules(),
                      "tops": sorted({{m.split(".")[0] for m in sys.modules}})}}))
""")


@pytest.mark.parametrize("workload,trace", [("vit_base.infer_b256", 0), ("vit_base.infer_b256", 1),
                                            ("vit_base.train_b128", 0), ("vit_base.train_b128", 1)])
def test_dry_run_result_keys_and_no_jax(workload, trace):
    """A CPU dry run of the harness in a fresh process: the result's keys,
    and no JAX, JAX library or JAX package among the loaded modules
    (top-level names compared whole)."""
    proc = _run(["-c", DRY.format(root=str(ROOT), workload=workload, trace=trace)])
    assert proc.returncode == 0, proc.stderr[-3000:]
    got = json.loads(proc.stdout.strip().splitlines()[-1])
    expected = set(KEYS) | {"checks"} | ({"breakdown"} if trace else set())
    assert set(got["keys"]) == expected
    assert set(got["device"]) == {"platform", "kind", "count", "memory_peak_bytes"} | (
        {"busy_s", "window_s"} if trace else set())
    cell = spec.load_cell(workload)
    wanted = {m["name"] for m in (cell.per_layer if trace else cell.end_to_end)}
    assert set(got["metrics"]) <= wanted
    if not trace:
        assert set(got["metrics"]) == wanted
    assert got["forbidden"] == []
    assert not {"jax", "jaxlib", "flax", "eqxvision_tpu"} & set(got["tops"])
    assert "eqxvision_tpu_torch" in got["tops"]


REFERENCE_ONLY = textwrap.dedent("""
    import json, sys
    sys.path.insert(0, {root!r})
    import torch
    from portbench.reference import augment, precision, swin, train, vit
    cfg = {{"image_size": 32, "patch_size": 8, "in_chans": 3, "embed_dim": 16, "depth": 1, "num_heads": 2,
           "mlp_ratio": 4.0, "num_classes": 10, "ln_eps": 1e-6}}
    params = {{k: torch.randn(s) * 0.02 for k, s in vit.param_shapes(cfg)}}
    g = torch.Generator().manual_seed(0)
    x, t = augment.augment(g, torch.randint(0, 256, (4, 40, 40, 3), dtype=torch.uint8), torch.arange(4),
                           size=32, classes=10, smoothing=0.1, mixup=0.8, cutmix=1.0)
    vit.forward(params, x, cfg, precision.fp8)
    print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
""")


def test_reference_imports_nothing_of_the_program():
    proc = _run(["-c", REFERENCE_ONLY.format(root=str(ROOT))])
    assert proc.returncode == 0, proc.stderr[-3000:]
    tops = set(json.loads(proc.stdout.strip().splitlines()[-1]))
    assert not {"jax", "jaxlib", "flax", "eqxvision_tpu", "eqxvision_tpu_torch"} & tops


@pytest.mark.cuda
def test_run_on_the_card_prints_a_result():
    """On the card (``python -m pytest -m cuda portbench/tests``): a short run
    of the first cell, its last line and its checks."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    proc = _run(["portbench/run.py", "--workload", "vit_base.infer_b256", "--seed", "3", "--seconds", "2"])
    assert proc.returncode == 0, proc.stderr[-3000:]
    line = json.loads(proc.stdout.strip().splitlines()[-1])
    assert list(line)[:5] == KEYS and list(line)[-1] == "checks"
    assert proc.stderr.strip().splitlines()[-1].startswith("check ")
