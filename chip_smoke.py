"""Drive the PyTorch port's ViT-B/16 inference path once on one NVIDIA card.

Run from the root of the repository: ``python3 chip_smoke.py``. It needs a
CUDA card and exits non-zero without one; it imports nothing of JAX.

1. Prints the card's name and power limit (nvidia-smi).
2. Builds the CUDA kernels from ``eqxvision_tpu_torch/csrc`` with nvcc and
   prints the build time and the compiler's report.
3. Holds each kernel against its plain torch version on the card at the
   slice's shapes, and times both with CUDA events in turns
   (plain, kernel, kernel, plain).
4. Serves ``vit_base`` (random weights from a seed): f32 logits of a batch
   of 2 against the same weights on the CPU's plain path, then requests of
   1, 8 and 256 NHWC 224-px images in bf16 with the kernel launch counts
   read around them, then b256 bf16 images/s.

Any failed check raises. The line before the last is a JSON summary of the
kernels; the last line is the JSON result.
"""
import json
import subprocess
import sys
import time

import torch

# bf16 kernel vs the f32 plain version on the same bf16-rounded inputs
# (tests/test_hw_parity.py uses this bound for the TPU kernel).
BF16_BOUND = 0.02
# f32 kernel vs f32 plain version: both in full f32 (no TF32); they differ
# only in summation order over <= 197 keys and 64 head dims and in expf,
# about 1e-6 on outputs of size ~1.
F32_BOUND = 1e-4
# f32 logits on the card vs the CPU's plain path, same weights and input:
# f32 sums in another order on two devices, through 12 blocks whose dot
# products run over 768 and 3072 terms.
LOGIT_BOUND = 1e-3
KERNEL_CASES = [(1, 197, 12, 64), (8, 197, 12, 64), (256, 197, 12, 64), (4, 50, 3, 64)]
REQUESTS = (1, 8, 256)


def _check(ok, what):
    if not ok:
        raise RuntimeError(f"chip_smoke: {what}")


def _time_ms(fn, iters):
    fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def check_kernels(attention):
    """fused_qkv_attention kernel vs its plain version; returns the b256
    bf16 numbers (the shape of the served model's calls)."""
    gen = torch.Generator(device="cuda").manual_seed(0)
    main = None
    for b, l, h, dh in KERNEL_CASES:
        scale = dh**-0.5
        qkv32 = torch.randn(b, l, 3 * h * dh, device="cuda", generator=gen)
        for dtype, bound in ((torch.bfloat16, BF16_BOUND), (torch.float32, F32_BOUND)):
            qkv = qkv32.to(dtype)
            with torch.no_grad():
                out = attention.fused_qkv_attention(qkv, h, scale)
                ref = attention.fused_qkv_attention_reference(qkv.float(), h, scale)
            torch.cuda.synchronize()
            _check(out.shape == (b, l, h * dh) and out.dtype == dtype, f"kernel output {out.shape} {out.dtype}")
            _check(bool(torch.isfinite(out).all()), "kernel output not finite")
            err = (out.float() - ref).abs().max().item()
            _check(err < bound, f"kernel vs plain max|diff| {err} >= {bound} at {(b, l, h, dh)} {dtype}")

            def kernel():
                attention.fused_qkv_attention(qkv, h, scale)

            def plain():
                attention.fused_qkv_attention_reference(qkv, h, scale)

            with torch.no_grad():
                turns = [_time_ms(fn, 20) for fn in (plain, kernel, kernel, plain)]
            ms, plain_ms = (turns[1] + turns[2]) / 2, (turns[0] + turns[3]) / 2
            print(
                f"fused_qkv_attention B={b} L={l} H={h} Dh={dh} {str(dtype)[6:]}: max|kernel-plain_f32| {err:.3e} "
                f"(bound {bound}); kernel {ms:.4f} ms, plain {plain_ms:.4f} ms "
                f"(turns plain/kernel/kernel/plain {', '.join(f'{t:.4f}' for t in turns)})"
            )
            if (b, dtype) == (256, torch.bfloat16):
                main = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms)
    return main


def serve(create_model, attention):
    """vit_base as a server; returns the main path's launch count."""
    model = create_model("vit_base", generator=torch.Generator().manual_seed(0), device="cuda").eval()
    x2 = torch.randn(2, 224, 224, 3, generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        card = model(x2.cuda()).cpu()
        cpu_model = create_model("vit_base", generator=torch.Generator().manual_seed(0)).eval()
        cpu_model.load_state_dict(model.state_dict())
        cpu = cpu_model(x2)
    err = (card - cpu).abs().max().item()
    print(f"vit_base f32 b2 logits, card vs CPU plain path: max|diff| {err:.3e} (bound {LOGIT_BOUND}), "
          f"max|logit| {cpu.abs().max().item():.3f}")
    _check(card.shape == (2, 1000) and bool(torch.isfinite(card).all()), "f32 logits malformed")
    _check(err < LOGIT_BOUND, f"card vs CPU logits differ by {err}")

    model = model.to(torch.bfloat16)
    gen = torch.Generator(device="cuda").manual_seed(2)
    batches = {b: torch.randn(b, 224, 224, 3, device="cuda", generator=gen).to(torch.bfloat16) for b in REQUESTS}
    attention.fused_qkv_attention.launches = 0
    for b in REQUESTS:
        before = attention.fused_qkv_attention.launches
        with torch.inference_mode():
            logits = model(batches[b])
        torch.cuda.synchronize()
        launched = attention.fused_qkv_attention.launches - before
        print(f"request b={b} bf16: logits {tuple(logits.shape)} finite={bool(torch.isfinite(logits).all())} "
              f"kernel launches {launched}")
        _check(logits.shape == (b, 1000) and bool(torch.isfinite(logits).all()), f"b={b} logits malformed")
        _check(launched == 12, f"b={b}: {launched} fused_qkv_attention launches, expected 12")
    launches = attention.fused_qkv_attention.launches

    x = batches[256]
    with torch.inference_mode():
        ms = _time_ms(lambda: model(x), 10)
    print(f"vit_base b256 bf16: {ms:.3f} ms per forward, {256 / ms * 1000:.1f} images/s")
    return launches


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this check needs a CUDA card", file=sys.stderr)
        return 1
    from eqxvision_tpu_torch import _native
    from eqxvision_tpu_torch.models import create_model
    from eqxvision_tpu_torch.ops import attention

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    print(smi)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} python {sys.version.split()[0]}")

    t0 = time.perf_counter()
    _native.library()
    print(f"kernel build: {time.perf_counter() - t0:.1f} s ({_native.library_path().name})")
    print(_native.build_log().strip())

    main_numbers = check_kernels(attention)
    launches = serve(create_model, attention)

    print(json.dumps({"kernels": [{
        "name": "fused_qkv_attention",
        "route": "cuda",
        "source": "eqxvision_tpu_torch/csrc/fused_qkv_attention.cu",
        "replaces": "eqxvision_tpu/ops/attention.py:276",
        "launches": launches,
        **main_numbers,
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
