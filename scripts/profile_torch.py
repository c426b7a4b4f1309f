"""Where a bf16 forward of the PyTorch port's models spends its time on the card.

Run from the root of the repository on a machine with a CUDA card:

    python3 scripts/profile_torch.py [--model convnext_tiny --model vit_base ...] [--forwards 3]

For each ``--model`` (default: convnext_tiny, vit_base, swin_t, swin_v2_t),
in one process, at the size and batch ``chip_smoke.py`` serves it (224 px,
256 for Swin v2; b256 for vit_base, b128 for the others; ``--batch``
overrides): builds the model with random weights from seed 0 in bf16, warms
up, times 10 forwards with CUDA events (ms per forward, images/s), then
records ``--forwards`` forwards with ``torch.profiler`` (CPU and CUDA
activity) and prints the wall time, the summed device time of the kernels,
the device's idle share (1 - device time / wall time), and the device time
per kernel name per forward with its share, largest first. Imports nothing
of JAX.
"""
import argparse
import subprocess
import sys
import time
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

DEFAULT_MODELS = ("convnext_tiny", "vit_base", "swin_t", "swin_v2_t")


def _forward_ms(model, x, iters=10):
    model(x)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        model(x)
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def profile_model(create_model, name, batch, forwards, top):
    from torch.profiler import ProfilerActivity, profile

    size = 256 if name.startswith("swin_v2") else 224
    batch = batch or (256 if name.startswith("vit") else 128)
    model = create_model(name, generator=torch.Generator().manual_seed(0), device="cuda").eval().to(torch.bfloat16)
    x = torch.randn(batch, size, size, 3, device="cuda", generator=torch.Generator("cuda").manual_seed(1))
    x = x.to(torch.bfloat16)
    with torch.inference_mode():
        ms = _forward_ms(model, x)
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(forwards):
                model(x)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
    rows = [
        (e.key, e.device_time_total / 1e3 / forwards, e.count // forwards)
        for e in prof.key_averages()
        if e.device_time_total > 0 and e.device_type == torch.autograd.DeviceType.CUDA
    ]
    device_ms = sum(r[1] for r in rows) * forwards
    print(f"\n{name} {size}px b{batch} bf16: {ms:.3f} ms per forward, {batch / ms * 1e3:.1f} images/s (CUDA events, "
          f"10 forwards)")
    print(f"profile, {forwards} forwards: wall {wall_ms:.2f} ms, device kernel time {device_ms:.2f} ms, "
          f"idle share {1 - device_ms / wall_ms:.3f}")
    print(f"{'kernel':<90} {'ms/fwd':>9} {'calls':>6} {'share':>7}")
    for key, kms, count in sorted(rows, key=lambda r: -r[1])[:top]:
        print(f"{key[:90]:<90} {kms:9.3f} {count:6d} {kms * forwards / device_ms:7.1%}")
    del model, x
    torch.cuda.empty_cache()


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--model", action="append", help="repeatable; default: " + ", ".join(DEFAULT_MODELS))
    ap.add_argument("--batch", type=int, default=None)
    ap.add_argument("--forwards", type=int, default=3)
    ap.add_argument("--top", type=int, default=15)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("profile_torch: needs a CUDA card", file=sys.stderr)
        return 1
    from eqxvision_tpu_torch.models import create_model

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    print(smi)
    for name in args.model or DEFAULT_MODELS:
        profile_model(create_model, name, args.batch, args.forwards, args.top)
    return 0


if __name__ == "__main__":
    sys.exit(main())
