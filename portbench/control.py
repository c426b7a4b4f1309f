#!/usr/bin/env python3
"""The readings that a cell's limits are set from, on the card, in one process.

    python3 portbench/control.py --workload vit_base.infer_b256 --seeds 11 12 13 --control-seeds 21 22 23 \\
        --seconds 3 [--faults half]

For each of ``--seeds``, a short run of the program at the cell's own size
and load (``--seconds`` of window, as many answers compared as a run
compares): its compared numbers, the lower readings. For each of
``--control-seeds``, the control in the program's place: the reference
computed with every matrix product's operands rounded to float8 e4m3
(``reference.precision.fp8``), the step below the cell's bf16, against the
reference in f32 on the same weights, inputs and generator states: the
upper readings. ``--faults`` (training: ``half``, ``no_allreduce``) reads
each fault planted in the reference put in the program's place, on the
control seeds (a state left unchanged reads 1 and needs no run). Each reading
is judged against the cell's limits (``limits/<cell>.json``) as a run
judges its own (``result.judge``). One JSON line a reading, with its
``correct``, then a summary line: each number's largest program reading and
smallest control and fault readings, and the verdict. It exits with 1 when
a program reading comes out not correct or a control or fault reading comes
out correct: the limits do not separate the two. The benchmark's runs do
not run this.
"""
from __future__ import annotations

import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def control_infer(cell, seed: int, device) -> dict:
    import numpy as np

    from portbench.harness import infer, inputs

    t = cell.traffic
    weights = inputs.make_weights(cell.reference.param_shapes(cell.config), seed, device,
                                  infer.DTYPES[t["dtype"]])
    rng = np.random.default_rng(inputs.sub_seed(seed, inputs.CHECK))
    worst = 0.0
    for k in rng.choice(t["pool_batches"], size=min(t["check_batches"], t["pool_batches"]), replace=False):
        x_u8, _ = inputs.canvases(seed, int(k), t["batch"], t["canvas"], cell.config["num_classes"])
        ref = infer.reference_scores(cell, weights, x_u8, device, "f32")
        ctl = infer.reference_scores(cell, weights, x_u8, device, "fp8")
        worst = max(worst, infer.logit_rel_err(ctl, ref))
    return {"logit_rel_err": worst}


def control_train(cell, seed: int, device, faults=()) -> dict:
    """The control's numbers, and each planted fault's (``{fault: numbers}``
    under ``"faults"``), against the reference in f32."""
    import torch

    from portbench.harness import inputs, train

    t = cell.traffic
    weights = inputs.make_weights(cell.reference.param_shapes(cell.config), seed, device, torch.float32)
    states = []
    for r in range(t["ranks"]):
        g = torch.Generator(device=device).manual_seed(inputs.sub_seed(seed, inputs.AUGMENT, r))
        train._seed_default(inputs.sub_seed(seed, inputs.DROP_PATH, r), device)
        states.append((g.get_state(), train._rng_state(device)))
    ref = train.reference_numbers(cell, seed, weights, states, device, "f32")
    ctl = train.reference_numbers(cell, seed, weights, states, device, "fp8")
    out = train.compare(ctl, ref)
    out["faults"] = {f: train.compare(train.reference_numbers(cell, seed, weights, states, device, "f32", f), ref)
                     for f in faults}
    return out


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(prog="python3 portbench/control.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="*", default=[])
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--faults", nargs="*", default=[])
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    from portbench.harness import result, spec

    cell = spec.load_cell(args.workload)
    kind = cell.traffic["kind"]
    if kind == "infer":
        from portbench.harness import infer as runner
    else:
        from portbench.harness import train as runner
    readings, wrong = {"program": {}, "control": {}}, []

    def record(side, seed, numbers, **extra):
        correct, _ = result.judge(numbers, cell.limits)
        print(json.dumps({"side": side, "seed": seed, "correct": correct, **extra, **numbers}), flush=True)
        if correct != (side == "program"):
            wrong.append((side, seed))
        for k, v in numbers.items():
            readings.setdefault(side, {}).setdefault(k, []).append(v)

    for seed in args.seeds:
        out = runner.run(cell, seed, args.seconds, False, args.device, time.time())
        record("program", seed, {k: c["value"] for k, c in out["checks"].items()},
               attempted=out["attempted"], failed=out["failed"])
    for seed in args.control_seeds:
        if kind == "infer":
            record("control", seed, control_infer(cell, seed, args.device))
            continue
        numbers = control_train(cell, seed, args.device, args.faults)
        for fault, fault_numbers in numbers.pop("faults").items():
            record(f"fault:{fault}", seed, fault_numbers)
        record("control", seed, numbers)
    summary = {}
    for side, numbers in readings.items():
        for name, values in numbers.items():
            summary.setdefault(name, {})[side] = max(values) if side == "program" else min(values)
    print(json.dumps({"summary": summary, "limits": {k: v.get("limit") for k, v in cell.limits.items()},
                      "separated": not wrong, "wrong": wrong}), flush=True)
    return 1 if wrong else 0


if __name__ == "__main__":
    sys.exit(main())
