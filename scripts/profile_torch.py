"""Where a forward of the PyTorch port's models spends its time on the card.

Run from the root of the repository on a machine with a CUDA card:

    python3 scripts/profile_torch.py [--model convnext_tiny --model vit_base ...] [--forwards 3] [--dtype float32]
        [--widen-bf16-conv] [--no-cudnn-tf32] [--fold-bn] [--by-layer]

For each ``--model`` (default: convnext_tiny, vit_base, swin_t, swin_v2_t, resnet50;
any name of ``create_model``), in one process, at the size and batch
``chip_smoke.py`` serves it (224 px, 256 for Swin v2, 520 for the
segmentation models; b256 for vit_base, mobilenet_v3_large and
efficientnet_b0, b8 for the segmentation models, b128 for the others;
``--batch`` overrides; deeplabv3 and fcn with the aux head on layer3, as
chip_smoke serves them): builds the model with random weights from seed 0 in ``--dtype``
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
the unfolded model in the same process. ``--by-layer`` then records the
same forwards again with each layer's forward in a ``record_function``
range named for its kind (convolution, depthwise or grouped convolution,
BatchNorm, squeeze-excitation as a whole, activation layer, linear) and
prints the device time of each kind a forward, the rest (residual adds,
pooling, casts, functional activations such as ResNet's ``F.relu``) as
"other"; the ranges cost host time, so the idle share is the first
recording's. Imports nothing of JAX.
"""
import argparse
import subprocess
import sys
import time
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

DEFAULT_MODELS = ("convnext_tiny", "vit_base", "swin_t", "swin_v2_t", "resnet50")
BATCH_256 = ("vit", "mobilenet_v3_large", "efficientnet_b0")
SEGMENTATION = {"deeplabv3": dict(aux_in_channels=1024), "fcn": dict(aux_in_channels=1024),
                "lraspp_mobilenet_v3_large": {}}
LAYER_RANGE = "layer: "


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


def _layer_kind(m):
    from eqxvision_tpu_torch.layers import SqueezeExcitation
    from eqxvision_tpu_torch.nn import BatchNorm, Conv2d, Lambda, Linear

    if isinstance(m, SqueezeExcitation):
        return "squeeze-excitation"
    if isinstance(m, Conv2d):
        return "conv" if m.groups == 1 else "depthwise conv" if m.groups == m.in_channels else "grouped conv"
    if isinstance(m, BatchNorm):
        return "BatchNorm"
    if isinstance(m, Lambda):
        return "activation"
    if isinstance(m, Linear):
        return "linear"
    return None


def label_layers(model):
    """Put each layer's forward of a known kind in a ``record_function``
    range ``layer: <kind>`` (a squeeze-excitation's children stay in its
    range); returns the hooks' handles."""
    from eqxvision_tpu_torch.layers import SqueezeExcitation

    inside_se = {id(c) for m in model.modules() if isinstance(m, SqueezeExcitation) for c in m.modules() if c is not m}
    stack, handles = [], []

    def enter(label):
        def hook(module, args):
            ctx = torch.profiler.record_function(label)
            ctx.__enter__()
            stack.append(ctx)
        return hook

    def leave(module, args, out):
        stack.pop().__exit__(None, None, None)

    for m in model.modules():
        kind = _layer_kind(m)
        if kind is not None and id(m) not in inside_se:
            handles += [m.register_forward_pre_hook(enter(LAYER_RANGE + kind)), m.register_forward_hook(leave)]
    return handles


def _kernel_rows(prof, forwards):
    """(name, device ms a forward, calls a forward) of each CUDA kernel."""
    return [
        (e.key, e.device_time_total / 1e3 / forwards, e.count // forwards)
        for e in prof.key_averages()
        if e.device_time_total > 0 and e.device_type == torch.autograd.DeviceType.CUDA
        and not e.key.startswith(LAYER_RANGE)
    ]


def profile_layers(model, x, forwards, device_ms):
    from torch.profiler import ProfilerActivity, profile

    handles = label_layers(model)
    try:
        with torch.inference_mode(), profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(forwards):
                model(x)
            torch.cuda.synchronize()
    finally:
        for h in handles:
            h.remove()
    kinds = {e.key[len(LAYER_RANGE):]: (e.device_time_total / 1e3 / forwards, e.count // forwards)
             for e in prof.key_averages()
             if e.key.startswith(LAYER_RANGE) and e.device_type == torch.autograd.DeviceType.CPU}
    total = sum(ms for _, ms, _ in _kernel_rows(prof, forwards))
    print(f"by layer kind (device time a forward; {total:.3f} ms of kernels in this recording, "
          f"{device_ms / forwards:.3f} in the first):")
    print(f"{'kind':<24} {'ms/fwd':>9} {'layers':>7} {'share':>7}")
    for kind, (ms, count) in sorted(kinds.items(), key=lambda r: -r[1][0]):
        print(f"{kind:<24} {ms:9.3f} {count:7d} {ms / total:7.1%}")
    other = total - sum(ms for ms, _ in kinds.values())
    print(f"{'other':<24} {other:9.3f} {'':>7} {other / total:7.1%}")


def profile_model(create_model, name, batch, forwards, top, dtype, widen=False, fold=False, by_layer=False):
    from torch.profiler import ProfilerActivity, profile

    from eqxvision_tpu_torch.ops import fold_batchnorm

    size = 256 if name.startswith("swin_v2") else 520 if name in SEGMENTATION else 224
    batch = batch or (256 if name.startswith(BATCH_256) else 8 if name in SEGMENTATION else 128)
    model = create_model(name, generator=torch.Generator().manual_seed(0), device="cuda",
                         **SEGMENTATION.get(name, {})).eval()
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
    rows = _kernel_rows(prof, forwards)
    device_ms = sum(r[1] for r in rows) * forwards
    label = (" (bf16 convs widened)" if widen else "") + (" (BatchNorm folded)" if fold else "")
    print(f"\n{name} {size}px b{batch} {str(dtype)[6:]}{label}: {ms:.3f} ms per forward, {batch / ms * 1e3:.1f} images/s (CUDA events, "
          f"10 forwards)")
    print(f"profile, {forwards} forwards: wall {wall_ms:.2f} ms, device kernel time {device_ms:.2f} ms, "
          f"idle share {1 - device_ms / wall_ms:.3f}")
    print(f"{'kernel':<90} {'ms/fwd':>9} {'calls':>6} {'share':>7}")
    for key, kms, count in sorted(rows, key=lambda r: -r[1])[:top]:
        print(f"{key[:90]:<90} {kms:9.3f} {count:6d} {kms * forwards / device_ms:7.1%}")
    if by_layer:
        profile_layers(model, x, forwards, device_ms)
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
    ap.add_argument("--by-layer", action="store_true", help="also device time by layer kind")
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
                          args.widen_bf16_conv, fold, args.by_layer)
    return 0


if __name__ == "__main__":
    sys.exit(main())
