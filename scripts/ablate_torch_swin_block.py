"""Where the whole-block Swin kernel spends its time, by removing phases.

Run from the root of the repository on a machine with a CUDA card:

    python3 scripts/ablate_torch_swin_block.py [--variants base no_attn ...] [--iters 20]

For each variant it copies ``eqxvision_tpu_torch`` into
``eqxvision_tpu_torch/_build/ablate/<variant>/``, deletes one phase from
that copy's ``csrc/swin_block.cu`` (the outputs are then wrong; only the
time is read), builds it in a fresh process, and times the kernel with
CUDA events at the b128 bf16 shapes of swin_t stages 1 and 2 and
swin_v2_t stage 1. A phase's cost is the base time less the variant's.
The variants are the counterpart of the prototype scripts/ablate_swin8.py,
which times a v2 block with one piece switched off at swin_v2_t stage 1
(``no_norm`` is its ``nonorm``). Imports nothing of JAX.
"""
import argparse
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
PKG = ROOT / "eqxvision_tpu_torch"
HEADS = "  for (int h = 0; h < H; ++h) {"
MLP = "  for (int c0 = 0; c0 < p.hidden; c0 += kHidChunk) {"
COSINE = "    if (p.gs != nullptr) {\n      // cosine attention"
VARIANTS = {  # name: [(source line, replacement)]
    "base": [],
    "no_attn": [("      attention_head_mma(qkvh, sq, Dh, L, q_scale, k_inv, p.scale, bias_h, s_buf, o_t + h * Dh, lda);", "")],
    "no_heads": [(HEADS, HEADS.replace("h < H", "h < 0"))],
    "no_mlp": [(MLP, MLP.replace("c0 < p.hidden", "c0 < 0"))],
    "no_fc2": [("    block_matmul(hid, sh, nc, p.w_fc2 + c0,", "    if (0) block_matmul(hid, sh, nc, p.w_fc2 + c0,")],
    "shell": [(HEADS, HEADS.replace("h < H", "h < 0")), (MLP, MLP.replace("c0 < p.hidden", "c0 < 0"))],
    # v2's cosine head norm skipped (q and k scales stay 1): the prototype
    # scripts/ablate_swin8.py's ``nonorm``; v1 shapes do not run it
    "no_norm": [(COSINE, COSINE.replace("p.gs != nullptr", "false"))],
    "no_gelu": [("from_f32<T>(0.5f * u * (1.f + erff(u * 0.70710678118654752f)))", "from_f32<T>(u)")],
    "no_fetch": [("      if (n < N && k < K) v[q] =", "      if (n < 0) v[q] =")],
    "no_mma": [("      mma_bf16(acc[0], a, b01[0], b01[1]);\n      mma_bf16(acc[1], a, b01[2], b01[3]);\n"
                "      mma_bf16(acc[2], a, b23[0], b23[1]);\n      mma_bf16(acc[3], a, b23[2], b23[3]);",
                "      acc[0][0] += __uint_as_float(a[0] ^ b01[0] ^ b23[0]);")],
}
SHAPES = [  # name, C, heads, nW, L, v2
    ("swin_t stage 1", 96, 3, 64, 49, False),
    ("swin_t stage 2", 192, 6, 16, 49, False),
    ("swin_v2_t stage 1", 96, 3, 64, 64, True),
]

TIMER = """
import sys, torch
sys.path.insert(0, sys.argv[1])
from eqxvision_tpu_torch.ops import window_attention as W
gen = torch.Generator(device="cuda").manual_seed(0)
for name, c, h, nw, L, v2 in {shapes}:
    def r(*shape, s=0.1, base=0.0):
        return base + s * torch.randn(*shape, device="cuda", generator=gen)
    hid = 4 * c
    p = W.SwinBlockParams(r(c, base=1.0), r(c), r(3 * c, c).bfloat16(), r(3 * c), r(c, c).bfloat16(), r(c),
                          r(c, base=1.0), r(c), r(hid, c).bfloat16(), r(hid), r(c, hid).bfloat16(), r(c))
    x = r(128, nw, L, c, s=0.5).bfloat16()
    bias = torch.randn(nw, h, L, L, device="cuda", generator=gen)
    gs = torch.full((h,), 10.0, device="cuda") if v2 else None
    f = lambda: W.fused_swin_block(x, p, bias, h, 1.0 if v2 else (c // h) ** -0.5, 1e-5, v2, gs)
    with torch.inference_mode():
        f()
        torch.cuda.synchronize()
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        e0.record()
        for _ in range({iters}):
            f()
        e1.record()
        e1.synchronize()
    print(f"{{sys.argv[2]:9s}} {{name:18s}} {{e0.elapsed_time(e1) / {iters}:.4f}} ms", flush=True)
"""


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--variants", nargs="+", default=list(VARIANTS), choices=list(VARIANTS))
    ap.add_argument("--iters", type=int, default=20)
    args = ap.parse_args()
    code = TIMER.format(shapes=SHAPES, iters=args.iters)
    for name in args.variants:
        root = PKG / "_build" / "ablate" / name
        shutil.rmtree(root, ignore_errors=True)
        shutil.copytree(PKG, root / PKG.name, ignore=shutil.ignore_patterns("_build", "__pycache__"))
        src = root / PKG.name / "csrc" / "swin_block.cu"
        text = src.read_text()
        for old, new in VARIANTS[name]:
            if old not in text:
                raise SystemExit(f"{name}: the line to remove is not in swin_block.cu: {old!r}")
            text = text.replace(old, new)
        src.write_text(text)
        subprocess.run([sys.executable, "-c", code, str(root), name], check=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
