"""The LayerNorm kernel (K6) against F.layer_norm: device time and call time.

Run from the root of the repository on a machine with a CUDA card:

    python3 scripts/profile_torch_layer_norm.py [--calls 50]

At the classifier's shape (128, 768) and convnext_tiny stage 3's (25088,
384), in bf16 and f32 with the affine in the input's type, it times
``ops.layer_norm`` (``csrc/layer_norm.cu``) and ``F.layer_norm`` on the same
input two ways: CUDA events around ``--calls`` back-to-back calls (what
``chip_smoke.py`` reports: the host's cost per call included where it is
larger than the kernel's), and the summed device time of the kernels each
call launches by ``torch.profiler`` (CUDA activity), divided by the calls.
It prints both beside the bound (each input and output byte once over 3.35
TB/s). Where the device times agree and the event times do not, the
difference is the host's. Imports nothing of JAX.
"""
import argparse
import subprocess
import sys
from pathlib import Path

import torch
import torch.nn.functional as F
from torch.profiler import ProfilerActivity, profile

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

CASES = {"classifier (128, 768)": (128, 768), "convnext_tiny stage 3 (25088, 384)": (25088, 384)}
HBM_BYTES_PER_S = 3.35e12


def _event_ms(fn, calls):
    fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(calls):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / calls


def _device_ms(fn, calls):
    """Summed device time of the kernels ``calls`` calls launch, per call, and their names."""
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    events = [e for e in prof.key_averages() if e.device_time_total > 0]
    total_us = sum(e.device_time_total for e in events)
    return total_us / 1e3 / calls, sorted({e.key[:60] for e in events})


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--calls", type=int, default=50)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("profile_torch_layer_norm: needs a CUDA card", file=sys.stderr)
        return 1
    from eqxvision_tpu_torch.ops import layernorm as LN

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())
    gen = torch.Generator(device="cuda").manual_seed(0)
    for name, (rows, d) in CASES.items():
        for dtype in (torch.bfloat16, torch.float32):
            x = torch.randn(rows, d, device="cuda", generator=gen).to(dtype)
            w = (1 + 0.1 * torch.randn(d, device="cuda", generator=gen)).to(dtype)
            b = (0.1 * torch.randn(d, device="cuda", generator=gen)).to(dtype)
            fns = {"K6": lambda: LN.layer_norm(x, w, b, 1e-6), "F.layer_norm": lambda: F.layer_norm(x, (d,), w, b, 1e-6)}
            bound = (2 * x.numel() + 2 * d) * x.element_size() / HBM_BYTES_PER_S * 1e3
            with torch.inference_mode():
                for label, fn in fns.items():
                    ev = [_event_ms(fn, args.calls) for _ in range(2)]
                    dev, kernels = _device_ms(fn, args.calls)
                    print(f"{name} {str(dtype)[6:]} {label}: device {dev:.4f} ms a call ({', '.join(kernels)}); "
                          f"CUDA events over {args.calls} calls {ev[0]:.4f}, {ev[1]:.4f} ms a call; "
                          f"bound {bound:.4f} ms (bytes)", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
