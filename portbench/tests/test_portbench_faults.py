"""The comparison that decides ``correct`` fails what it has to, at a size a
test run holds, on the CPU (the card's readings are in PERF.md):

- the control, the reference with its products' operands rounded to
  float8 e4m3, reads several times what the program (bf16) reads;
- a run with the timed path broken underneath, the look for a card
  skipped, comes out not correct: an answer altered where it is produced
  (inference); the optimiser's step doing nothing, half of each batch left
  out, the gradients' all-reduce left out (training).
"""
from __future__ import annotations

import time

import pytest

from portbench import control
from portbench.harness import infer, spec, train

SEED = 2**33 + 17
VIT = {"image_size": 32, "patch_size": 8, "embed_dim": 64, "depth": 3, "num_heads": 4, "num_classes": 10}
INFER = {"config": VIT, "traffic": {"batch": 8, "canvas": 40, "resize": 40, "crop": 32, "pool_batches": 2,
                                    "warmup_batches": 1, "check_batches": 2}}
SWIN = {"config": {"image_size": 112, "patch_size": 4, "embed_dim": 16, "depths": [2, 2, 2], "num_heads": [1, 2, 4],
                   "num_classes": 10},
        "traffic": {"batch": 4, "canvas": 120, "resize": 120, "crop": 112, "pool_batches": 2, "warmup_batches": 1,
                    "check_batches": 2}}
TRAIN = {"config": VIT, "traffic": {"batch": 8, "canvas": 40, "crop": 32, "pool_batches": 3}}


def _cells():
    import json

    return {w["name"] for w in json.loads((spec.ROOT / "BENCHMARK.json").read_text())["workloads"]}


def _cell(name, overrides):
    if name not in _cells():
        pytest.skip(f"{name} is not a cell of BENCHMARK.json")
    return spec.load_cell(name, overrides=overrides)


@pytest.mark.parametrize("name,overrides", [("vit_base.infer_b256", INFER), ("swin_t.infer_b256", SWIN)])
def test_control_reads_above_the_program_inference(name, overrides):
    cell = _cell(name, overrides)
    prog = infer.run(cell, SEED, 0.1, False, "cpu", time.time())["checks"]["logit_rel_err"]["value"]
    ctl = control.control_infer(cell, SEED, "cpu")["logit_rel_err"]
    assert ctl > 3 * prog, (ctl, prog)


def test_control_reads_above_the_program_training():
    cell = _cell("vit_base.train_b128", TRAIN)
    prog = {k: c["value"] for k, c in train.run(cell, SEED, 0.1, False, "cpu", time.time(),
                                                overrides=TRAIN)["checks"].items()}
    ctl = control.control_train(cell, SEED, "cpu")
    assert any(ctl[k] > 3 * prog[k] for k in prog), (ctl, prog)


@pytest.mark.parametrize("name,overrides", [("vit_base.infer_b256", INFER), ("vit_base.train_b128", TRAIN)])
def test_control_script_judges_each_reading_against_the_limits(name, overrides, monkeypatch, capsys):
    """``control.py`` judges the program's and the control's readings as a run
    judges its own: it exits with 0 where the limits pass the program and
    fail the control, and with 1 where a limit lets the control through."""
    import json

    cell = _cell(name, overrides)
    if cell.traffic["kind"] == "infer":
        prog = {k: c["value"] for k, c in infer.run(cell, SEED, 0.1, False, "cpu", time.time())["checks"].items()}
        ctl = control.control_infer(cell, SEED, "cpu")
    else:
        prog = {k: c["value"] for k, c in train.run(cell, SEED, 0.1, False, "cpu", time.time(),
                                                    overrides=overrides)["checks"].items()}
        ctl = control.control_train(cell, SEED, "cpu")
    # a limit between the two readings where the control reads higher, else well above both
    between = {k: {"limit": (prog[k] * ctl[k]) ** 0.5 if ctl[k] > 3 * prog[k] else 10 * max(prog[k], ctl[k])}
               for k in prog}
    argv = ["--workload", name, "--seeds", str(SEED), "--control-seeds", str(SEED), "--seconds", "0.1",
            "--device", "cpu"]
    load = spec.load_cell
    for limits, code in ((between, 0), ({k: {"limit": 1e9} for k in prog}, 1)):
        tiny = {**overrides, "limits": limits}
        monkeypatch.setattr(spec, "load_cell", lambda n, root=spec.ROOT, overrides=None, tiny=tiny: load(n, root, tiny))
        assert control.main(argv) == code
        summary = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
        assert summary["separated"] == (code == 0), summary


def test_an_altered_answer_is_not_correct():
    cell = _cell("vit_base.infer_b256", INFER)

    def altered(scores):
        scores = scores.clone()
        scores[0] = scores[0].flip(0)
        return scores

    out = infer.run(cell, SEED, 0.1, False, "cpu", time.time(), fault=altered)
    assert not out["correct"], out["checks"]


@pytest.mark.parametrize("name,fault", [("vit_base.train_b128", "unchanged"), ("vit_base.train_b128", "half"),
                                        ("vit_base.train_dp4", "no_allreduce"), ("vit_base.train_dp4", "half")])
def test_a_broken_training_step_is_not_correct(name, fault):
    cell = _cell(name, TRAIN)
    out = train.run(cell, SEED, 0.1, False, "cpu", time.time(), overrides=TRAIN, fault=fault)
    assert not out["correct"], out["checks"]


def test_the_sound_runs_are_correct():
    """The same sizes without a fault pass the cells' limits, so that the
    failures above are the faults'."""
    assert infer.run(_cell("vit_base.infer_b256", INFER), SEED, 0.1, False, "cpu", time.time())["correct"]
    out = train.run(_cell("vit_base.train_b128", TRAIN), SEED, 0.1, False, "cpu", time.time(), overrides=TRAIN)
    assert out["correct"], out["checks"]
