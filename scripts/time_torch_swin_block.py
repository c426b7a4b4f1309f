"""The whole-block Swin kernel (K5) at its main-path shapes, in the tree the script sits in.

Run from the root of a checkout on a machine with a CUDA card:

    python3 scripts/time_torch_swin_block.py [--iters 20] [--dtype float32]

For swin_t stages 1 and 2 (224 px, window 7, shifted) and swin_v2_t stages
1 and 2 (256 px, window 8, shifted) at b128 in bf16 (or f32), it calls the
NHWC entry ``fused_swin_block_v1``/``_v2`` on a map of random values from
a seed and prints, per call: the time by CUDA events (whatever the entry
runs around the kernel included) and the device time of the kernels whose
name holds ``swin_block`` or ``split_weights`` (f32: the weights' split
before the block) by torch.profiler. The script reads nothing but the
public entry points, so a copy of it runs unchanged in an older checkout
(copied into a ``git archive`` of it): turns parent, change, change, parent
compare two trees on one card. Imports nothing of JAX.
"""
import argparse
import math
import subprocess
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

SHAPES = [  # name, map side, window, C, heads, v2
    ("swin_t stage 1", 56, 7, 96, 3, False),
    ("swin_t stage 2", 28, 7, 192, 6, False),
    ("swin_v2_t stage 1", 64, 8, 96, 3, True),
    ("swin_v2_t stage 2", 32, 8, 192, 6, True),
]


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--dtype", choices=["bfloat16", "float32"], default="bfloat16")
    args = ap.parse_args()
    dt = getattr(torch, args.dtype)
    if not torch.cuda.is_available():
        print("time_torch_swin_block: needs a CUDA card", file=sys.stderr)
        return 1
    from torch.profiler import ProfilerActivity, profile

    from eqxvision_tpu_torch.ops import window_attention as W

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())
    gen = torch.Generator(device="cuda").manual_seed(0)
    for name, side, win, c, h, v2 in SHAPES:
        def r(*shape, s=0.1, base=0.0):
            return base + s * torch.randn(*shape, device="cuda", generator=gen)

        hid = 4 * c
        kw = dict(norm1_w=r(c, base=1.0), norm1_b=r(c), qkv_weight=r(3 * c, c).to(dt), qkv_bias=r(3 * c),
                  proj_weight=r(c, c).to(dt), proj_bias=r(c), norm2_w=r(c, base=1.0), norm2_b=r(c),
                  fc1_weight=r(hid, c).to(dt), fc1_bias=r(hid), fc2_weight=r(c, hid).to(dt), fc2_bias=r(c),
                  relative_position_bias=r(1, h, win * win, win * win, s=1.0), window_size=(win, win),
                  shift_size=(win // 2, win // 2), num_heads=h)
        x = r(128, side, side, c, s=0.5).to(dt)
        if v2:
            scale = torch.full((h, 1, 1), math.log(10.0), device="cuda")
            call = lambda: W.fused_swin_block_v2(x, logit_scale=scale, **kw)  # noqa: E731
        else:
            call = lambda: W.fused_swin_block_v1(x, **kw)  # noqa: E731
        with torch.inference_mode():
            call()
            torch.cuda.synchronize()
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(args.iters):
                call()
            end.record()
            end.synchronize()
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                for _ in range(args.iters):
                    call()
                torch.cuda.synchronize()
        kernel_ms = sum(e.device_time_total for e in prof.key_averages()
                        if "swin_block" in e.key or "split_weights" in e.key) / 1e3 / args.iters
        print(f"{name:18s} (128, {side}, {side}, {c}) {args.dtype}, {h} heads: "
              f"call {start.elapsed_time(end) / args.iters:.4f} ms, "
              f"K5 device time {kernel_ms:.4f} ms", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
