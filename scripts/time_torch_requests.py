"""Eager bf16 request times of the PyTorch port's models on the card, with
their spread.

Run from the root of a tree of the repository on a machine with a CUDA card:

    python3 scripts/time_torch_requests.py [--model vit_base --model swin_t] [--batch 1 --batch 8]
        [--repeats 7] [--iters 20]

For each model (default vit_base and swin_t, 224 px) and batch (default 1
and 8): the model built from seed 0 in eval mode and cast to bf16, a seeded
bf16 input, a warm-up, then ``--repeats`` timings of ``--iters`` forwards
each with CUDA events; prints the mean ms a forward with the least and the
largest repeat (the spread), and images/s. It reads only ``create_model``,
so it runs in older trees too: copy it into a ``git archive`` of another
commit to time the two trees in turns (parent, change, change, parent) in
one call to the card. Imports nothing of JAX.
"""
import argparse
import json
import subprocess
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def _ms(fn, iters):
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--model", action="append")
    ap.add_argument("--batch", action="append", type=int)
    ap.add_argument("--repeats", type=int, default=7)
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--tag", default=str(Path(__file__).resolve().parent.parent.name))
    args = ap.parse_args()
    from eqxvision_tpu_torch.models import create_model

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    for name in args.model or ["vit_base", "swin_t"]:
        model = create_model(name, generator=torch.Generator().manual_seed(0), device="cuda").eval()
        model = model.to(torch.bfloat16)
        for b in args.batch or [1, 8]:
            x = torch.randn(b, 224, 224, 3, device="cuda", generator=torch.Generator(device="cuda").manual_seed(1))
            x = x.to(torch.bfloat16)
            with torch.inference_mode():
                for _ in range(5):
                    model(x)
                times = [_ms(lambda: model(x), args.iters) for _ in range(args.repeats)]
            mean = sum(times) / len(times)
            print(json.dumps({"tree": args.tag, "model": name, "batch": b, "ms": mean, "min_ms": min(times),
                              "max_ms": max(times), "images_per_s": b / mean * 1e3, "card": smi}), flush=True)


if __name__ == "__main__":
    main()
