"""Where a forward of the PyTorch port's Swin models spends its time on the card.

Run from the root of the repository on a machine with a CUDA card:

    python3 scripts/profile_torch_swin.py [--model swin_t] [--size 224] [--batch 128] [--forwards 3]

Builds the model (random weights from seed 0, bf16), warms up, and records
``--forwards`` forwards with ``torch.profiler`` (CPU and CUDA activity). It
prints the wall time, the summed device time of the kernels, the device's
idle share (1 - device time / wall time), and the device time per kernel
name per forward with its share, largest first. Imports nothing of JAX.
"""
import argparse
import subprocess
import sys
import time
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--model", default="swin_t")
    ap.add_argument("--size", type=int, default=224)
    ap.add_argument("--batch", type=int, default=128)
    ap.add_argument("--forwards", type=int, default=3)
    ap.add_argument("--top", type=int, default=15)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("profile_torch_swin: needs a CUDA card", file=sys.stderr)
        return 1
    from torch.profiler import ProfilerActivity, profile

    from eqxvision_tpu_torch.models import create_model

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    model = create_model(args.model, generator=torch.Generator().manual_seed(0), device="cuda").eval()
    model = model.to(torch.bfloat16)
    x = torch.randn(args.batch, args.size, args.size, 3, device="cuda").to(torch.bfloat16)
    with torch.inference_mode():
        for _ in range(3):
            model(x)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(args.forwards):
                model(x)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
    rows = [
        (e.key, e.device_time_total / 1e3 / args.forwards, e.count // args.forwards)
        for e in prof.key_averages()
        if e.device_time_total > 0 and e.device_type == torch.autograd.DeviceType.CUDA
    ]
    device_ms = sum(ms for _, ms, _ in rows) * args.forwards
    print(smi)
    print(f"{args.model} {args.size}px b{args.batch} bf16, {args.forwards} forwards: wall {wall_ms:.2f} ms, "
          f"device kernel time {device_ms:.2f} ms, idle share {1 - device_ms / wall_ms:.3f}")
    print(f"{'kernel':<90} {'ms/fwd':>9} {'calls':>6} {'share':>7}")
    for key, ms, count in sorted(rows, key=lambda r: -r[1])[: args.top]:
        print(f"{key[:90]:<90} {ms:9.3f} {count:6d} {ms * args.forwards / device_ms:7.1%}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
