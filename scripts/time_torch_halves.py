"""Time the port's three fused halves at chip_smoke.py's cases, in the tree
the script sits in.

Run from the root of a tree on a machine with a CUDA card:

    python3 scripts/time_torch_halves.py [--iters 20] [--dtype float32]

It builds (or loads) that tree's kernels and, for each case of its
``chip_smoke.py``'s MLP_CASES, ATTN_HALF_CASES and WINDOW_HALF_CASES, makes
the inputs as chip_smoke does (seeded), calls the op once, then times
``--iters`` calls with CUDA events and prints the mean ms a call, beside the
device time of the op's kernels a call by torch.profiler (at small shapes
the host's launch cost, not the kernels, sets the first). For the ViT
attention half it also prints its attention stage's device time alone (the
kernels named ``attention_stage*``), and it times the fused-qkv attention
(K1) on a qkv of vit_base b256's shape the same way, and the public
attention (K2) on q, k, v of that shape, (256, 12, 197, 64), without
and with a compact (12, 197, 197) relative-position bias, and at swin_t
stage 1's (128, 192, 49, 32) with its (192, 49, 49) bias. Every input is
in ``--dtype`` (bfloat16 by default). To compare two
trees on one card, copy the script into the other tree and run the two in
one command in turns (parent, change, change, parent). Imports nothing of
JAX.
"""
import argparse
import importlib
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
# K2's cases (q lead dims, N, Dh, bias lead dims or None), kept here so that
# the script runs in trees whose chip_smoke.py lacks them
K2_CASES = {"swin_t stage 1": ((128, 192), 49, 32, (1, 192)), "vit_base b256": ((256, 12), 197, 64, None),
            "vit_base b256 rel-pos bias": ((256, 12), 197, 64, (12,))}


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--dtype", choices=("bfloat16", "float32"), default="bfloat16")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("time_torch_halves: needs a CUDA card", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from eqxvision_tpu_torch.ops import attention_half as AH
    from eqxvision_tpu_torch.ops import mlp_half as M
    from eqxvision_tpu_torch.ops import window_attention as W
    from eqxvision_tpu_torch.ops import window_attention_half as WH

    A = importlib.import_module("eqxvision_tpu_torch.ops.attention")  # ops.attention is the public op

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())
    gen = torch.Generator(device="cuda").manual_seed(0)
    bf16 = getattr(torch, args.dtype)  # the inputs' type
    torch.backends.cuda.matmul.allow_tf32 = False
    print(f"inputs in {args.dtype}")
    calls = []
    for name, (rows, c, residual_is_x) in cs.MLP_CASES.items():
        x, residual, params = cs._mlp_inputs(rows, c, residual_is_x, bf16, gen)
        calls.append((f"fused_mlp_half {name} {(rows, c, 4 * c)}",
                      lambda x=x, residual=residual, params=params: M.fused_mlp_half(x, residual, *params)))
    for name, (b, l, d, heads) in cs.ATTN_HALF_CASES.items():
        x, params = cs._attn_half_inputs(b, l, d, bf16, gen)
        calls.append((f"fused_attention_half {name} {(b, l, d, heads)}",
                      lambda x=x, params=params, heads=heads: AH.fused_attention_half(x, *params, heads)))
    qkv = torch.randn(256, 197, 3 * 768, device="cuda", generator=gen).to(bf16)
    calls.append(("fused_qkv_attention vit_base b256 (256, 197, 12, 64)",
                  lambda: A.fused_qkv_attention(qkv, 12)))
    for name, (lead, n, dh, bias_lead) in K2_CASES.items():
        q, k, v, bias = cs._attn_inputs(lead, n, dh, bias_lead, bf16, gen)
        calls.append((f"attention (K2) {name} {tuple(q.shape)}",
                      lambda q=q, k=k, v=v, bias=bias: A.attention(q, k, v, bias)))
    for name, (b, side, c, heads) in cs.WINDOW_HALF_CASES.items():
        x, params, bias, valid = cs._window_half_inputs(b, side, c, heads, bf16, gen, W, WH)
        calls.append((f"fused_window_attention_half {name} {tuple(x.shape) + (heads,)}",
                      lambda x=x, params=params, bias=bias, heads=heads, valid=valid:
                      WH.fused_window_attention_half(x, *params, bias, heads, None, 1e-5, valid)))
    from torch.profiler import ProfilerActivity, profile

    for name, fn in calls:
        with torch.inference_mode():
            events_ms = cs._time_ms(fn, args.iters)
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                for _ in range(args.iters):
                    fn()
                torch.cuda.synchronize()
        kernels = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
        device_ms = sum(e.device_time_total for e in kernels) / 1e3 / args.iters
        stage = ""
        if name.startswith("fused_attention_half"):
            stage_ms = sum(e.device_time_total for e in kernels if "attention_stage" in e.key) / 1e3 / args.iters
            stage = f" (its attention stage {stage_ms:.4f} ms)"
        print(f"{name}: {events_ms:.4f} ms by CUDA events, {device_ms:.4f} ms of kernels{stage}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
