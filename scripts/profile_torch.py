"""Where a forward of the PyTorch port's models spends its time on the card.

Run from the root of the repository on a machine with a CUDA card:

    python3 scripts/profile_torch.py [--model convnext_tiny --model vit_base ...] [--forwards 3] [--dtype float32]
        [--widen-bf16-conv] [--no-cudnn-tf32] [--fold-bn]

For each ``--model`` (default: convnext_tiny, vit_base, swin_t, swin_v2_t, resnet50),
in one process, at the size and batch ``chip_smoke.py`` serves it (224 px,
256 for Swin v2; b256 for vit_base, b128 for the others; ``--batch``
overrides): builds the model with random weights from seed 0 in ``--dtype``
(bfloat16 by default; in float32 torch's defaults hold: TF32 off for its
matmuls, on for cuDNN's convolutions), warms
up, times 10 forwards with CUDA events (ms per forward, images/s), then
records ``--forwards`` forwards with ``torch.profiler`` (CPU and CUDA
activity) and prints the wall time, the summed device time of the kernels,
the device's idle share (1 - device time / wall time), and the device time
per kernel name per forward with its share, largest first.
``--widen-bf16-conv`` times the repair of ROADMAP C.9 in a bf16 model: each
``Conv2d``'s bias is kept in f32, so the layer takes its mixed path (the
operands widened to f32, the f32 convolution plus the bias rounded once)
where a bf16 bias takes one cuDNN call that rounds twice; the profile names
the cuDNN kernels each path runs. ``--no-cudnn-tf32`` sets
``torch.backends.cudnn.allow_tf32 = False`` first, as ``chip_smoke.py``
does. ``--fold-bn`` profiles each model with its BatchNorms folded into its
convolutions (``ops.fold_batchnorm`` on the f32 model, then cast), beside
the unfolded model in the same process. Imports nothing of JAX.
"""
import argparse
import subprocess
import sys
import time
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

DEFAULT_MODELS = ("convnext_tiny", "vit_base", "swin_t", "swin_v2_t", "resnet50")


def _forward_ms(model, x, iters=10):
    model(x)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        model(x)
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def widen_conv_biases(model):
    """Every Conv2d's bias back in f32 (exact for a bf16 value): its forward
    then widens the bf16 input and weight and rounds once."""
    from eqxvision_tpu_torch.nn import Conv2d

    for m in model.modules():
        if isinstance(m, Conv2d) and m.bias is not None:
            m.bias.data = m.bias.data.float()


def profile_model(create_model, name, batch, forwards, top, dtype, widen=False, fold=False):
    from torch.profiler import ProfilerActivity, profile

    from eqxvision_tpu_torch.ops import fold_batchnorm

    size = 256 if name.startswith("swin_v2") else 224
    batch = batch or (256 if name.startswith("vit") else 128)
    model = create_model(name, generator=torch.Generator().manual_seed(0), device="cuda").eval()
    model = (fold_batchnorm(model) if fold else model).to(dtype)
    x = torch.randn(batch, size, size, 3, device="cuda", generator=torch.Generator("cuda").manual_seed(1))
    x = x.to(dtype)
    if widen:
        widen_conv_biases(model)
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
    label = (" (bf16 convs widened)" if widen else "") + (" (BatchNorm folded)" if fold else "")
    print(f"\n{name} {size}px b{batch} {str(dtype)[6:]}{label}: {ms:.3f} ms per forward, {batch / ms * 1e3:.1f} images/s (CUDA events, "
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
    ap.add_argument("--dtype", choices=("bfloat16", "float32"), default="bfloat16")
    ap.add_argument("--widen-bf16-conv", action="store_true", help="Conv2d biases in f32: one rounding (ROADMAP C.9)")
    ap.add_argument("--no-cudnn-tf32", action="store_true", help="cuDNN's TF32 off, as chip_smoke.py sets it")
    ap.add_argument("--fold-bn", action="store_true", help="also each model with its BatchNorms folded")
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
    if args.no_cudnn_tf32:
        torch.backends.cudnn.allow_tf32 = False
    print(f"cudnn.allow_tf32 {torch.backends.cudnn.allow_tf32}, cuda.matmul.allow_tf32 "
          f"{torch.backends.cuda.matmul.allow_tf32}")
    for name in args.model or DEFAULT_MODELS:
        for fold in (False, True) if args.fold_bn else (False,):
            profile_model(create_model, name, args.batch, args.forwards, args.top, getattr(torch, args.dtype),
                          args.widen_bf16_conv, fold)
    return 0


if __name__ == "__main__":
    sys.exit(main())
