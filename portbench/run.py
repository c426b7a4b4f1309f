#!/usr/bin/env python3
"""Run one cell of the benchmark of eqxvision_tpu_torch on the card.

    python3 portbench/run.py --workload vit_base.infer_b256 --seed 7 --seconds 20 --trace 0

from the root of a checkout. The cell, its configuration, traffic, limits
and per-layer metrics come from ``BENCHMARK.json`` and the files under
``portbench/`` (see README.md). The last line of standard output is the
result, one JSON object; the compared numbers and their limits are the last
lines of standard error. Without a CUDA card, or with fewer cards than the
cell asks for, it prints no result and exits with 2. It exits with 3, and
prints no result, if JAX, its libraries or the JAX package were loaded.
"""
from __future__ import annotations

import faulthandler
import os
import sys
import time
from pathlib import Path


def _process_start() -> float:
    """The wall-clock time this process started (Linux), else now."""
    try:
        with open(f"/proc/{os.getpid()}/stat") as f:
            ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return time.time() - uptime + ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return time.time()


PROCESS_START = _process_start()
ROOT = Path(__file__).resolve().parents[1]
# the host's threads of torch's intra-op pool: fewer than the card machine's 8 cores, so that the
# loop's own thread never waits for a core behind idling pool threads
HOST_THREADS = 4


def _caches() -> None:
    """Every build and kernel cache at a fixed path inside the checkout (the
    port's own kernel library lives in ``eqxvision_tpu_torch/_build/``)."""
    cache = ROOT / ".portbench_cache"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ["PYTORCH_KERNEL_CACHE_PATH"] = str(cache / "torch_kernels")  # torch's own NVRTC kernels
    (cache / "torch_kernels").mkdir(parents=True, exist_ok=True)  # torch does not make this one itself
    os.environ.setdefault("USE_FLAX", "0")


def main(argv=None) -> int:
    import argparse
    import json

    ap = argparse.ArgumentParser(prog="python3 portbench/run.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    # a run that hangs ends with every thread's stack on stderr, inside the first run's allowance
    faulthandler.dump_traceback_later(1150, exit=True)
    _caches()
    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))
    from portbench.harness import result, spec

    cell = spec.load_cell(args.workload)
    import torch

    torch.set_num_threads(HOST_THREADS)

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"portbench: {args.workload} needs {cell.chips} CUDA card(s), found {have}; no result", file=sys.stderr)
        return 2
    kind = cell.traffic["kind"]
    if kind == "infer":
        from portbench.harness import infer

        out = infer.run(cell, args.seed, args.seconds, bool(args.trace), "cuda", PROCESS_START)
    elif kind == "train":
        from portbench.harness import train

        out = train.run(cell, args.seed, args.seconds, bool(args.trace), "cuda", PROCESS_START)
    else:
        raise ValueError(f"traffic kind {kind!r} has no runner")
    forbidden = result.forbidden_modules()
    if forbidden:
        print(f"portbench: the run loaded {forbidden}; no result", file=sys.stderr)
        return 3
    checks = out.pop("checks")
    line = {k: out[k] for k in ("correct", "attempted", "failed", "metrics", "device")}
    if "breakdown" in out:
        line["breakdown"] = out["breakdown"]
    line["checks"] = checks
    sys.stdout.flush()
    print(json.dumps(line), flush=True)
    result.print_checks(checks)
    return 0


if __name__ == "__main__":
    sys.exit(main())
