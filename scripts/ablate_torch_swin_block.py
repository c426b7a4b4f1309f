"""Where the whole-block Swin kernel spends its time, by removing phases.

Run from the root of the repository on a machine with a CUDA card:

    python3 scripts/ablate_torch_swin_block.py [--variants base no_attn ...] [--iters 20]
    python3 scripts/ablate_torch_swin_block.py --dtype float32 [--variants base f32_g1 ...]

For each variant it copies ``eqxvision_tpu_torch`` into
``eqxvision_tpu_torch/_build/ablate/<variant>/``, changes one phase or one
design choice of the bf16 kernel (or, with ``--dtype float32``, of the f32
kernel) in that copy's ``csrc/swin_block.cu`` (a phase removed leaves the
outputs wrong; only the time is read), builds it in a fresh process, and
times the NHWC entry (``fused_swin_block_v1``/``_v2``, one kernel launch
that reads the windows from the map; in f32 after the weights' split) with
CUDA events at the b128 shapes of swin_t stages 1 and 2 (224 px, window 7,
shifted) and swin_v2_t stages 1 and 2 (256 px, window 8, shifted). A
phase's cost is the base time less the variant's. Each patch names one
whole source line, which must occur exactly once, or the script stops.
Name a variant twice to time it twice (turns).

Variants (the counterpart of the prototype scripts/ablate_swin8.py, which
times a v2 block with one piece switched off; ``no_norm`` is its
``nonorm``):
  base      the kernel as it is
  no_attn   no attention (S, softmax, P V) for any head
  no_mlp    no MLP: no hidden chunk is loaded or multiplied
  no_fc2    fc2's products not issued (its weights still stream)
  no_gelu   gelu's erf replaced by the identity
  no_fetch  no weight tile is loaded by TMA (the stages are still handed over)
  no_mma    no tensor-core instruction: no wgmma and no mma.sync
  shell     load, LN1, proj, the residual, store: no qkv, attention or MLP
  no_norm   v2's cosine head norm skipped (the q and k scales stay 1)
  no_bias   the attention's bias table is not read
f32 kernel (``--dtype float32``):
  f32_g1       one window a block of 128 threads, two weight stages, so two
               blocks an SM (the design kept: two windows a block, four stages)
  f32_stages3  three weight stages; f32_stages2: two
  f32_hi_only  one TF32 product (hi hi) in place of the split's three
  f32_no_wgmma no wgmma product issued (the stages still stream)
  f32_no_fetch no weight tile is loaded by TMA
  f32_no_attn  no attention for any head; f32_no_mlp: no MLP chunk
  f32_no_gelu  gelu's erf replaced by the identity
Imports nothing of JAX.
"""
import argparse
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
PKG = ROOT / "eqxvision_tpu_torch"
PIECES = "  const int n_pieces = (H + hp - 1) / hp;"
CHUNKS = "  const int n_chunks = (hidden + kChunk - 1) / kChunk;"
F32_MMA = ["    wgmma_tf32_rs<N>(part, ah[ks], dl + 2 * ks, ks > 0);",  # the f32 kernel's three products a k-step
           "    wgmma_tf32_rs<N>(part, al[ks], db + 2 * ks, 1);",
           "    wgmma_tf32_rs<N>(part, ah[ks], db + 2 * ks, 1);"]
VARIANTS = {  # name: [(whole source line, replacement)]
    "base": [],
    "no_attn": [("      for (int hl = 0; hl < heads; ++hl) {", "      for (int hl = 0; hl < 0; ++hl) {")],
    "no_mlp": [(CHUNKS, "  const int n_chunks = 0;")],
    "no_fc2": [("        mma_k_tile<NC>(acc, sw128_desc(hid_tile), sw128_desc(st), true);  // fc2's partial product", "")],
    "no_gelu": [("          a1[4 * jj + e] = 0.5f * u * (1.f + erff(u * 0.70710678118654752f));",
                 "          a1[4 * jj + e] = u;")],
    "no_fetch": [("  auto expect = [&](int s, int bytes) { mbar_arrive_expect_tx(&full[s], bytes); };",
                  "  auto expect = [&](int s, int bytes) { mbar_arrive(&full[s]); };"),
                 ("    tma_load_2d(ring + s * kStageBytes + offset, map, &full[s], c0, c1);", "")],
    "no_mma": [
        ("  for (int ks = 0; ks < 4; ++ks) wgmma_tile<N>(acc, da + 2 * ks, db + 2 * ks, accumulate || ks > 0);", ""),
        ("            mma_bf16(s[2 * jj], qf, kb[0], kb[1]);", "            s[2 * jj][0] += __uint_as_float(qf[0] ^ kb[0]);"),
        ("            mma_bf16(s[2 * jj + 1], qf, kb[2], kb[3]);", ""),
        ("            mma_bf16(o[2 * nd], a, vb[0], vb[1]);", "            o[2 * nd][0] += __uint_as_float(a[0] ^ vb[0]);"),
        ("            mma_bf16(o[2 * nd + 1], a, vb[2], vb[3]);", ""),
    ],
    "shell": [(PIECES, "  const int n_pieces = 0;"), (CHUNKS, "  const int n_chunks = 0;")],
    "no_norm": [("  constexpr bool cosine = kCosine;  // v2: q and k L2-normalised per head",
                 "  constexpr bool cosine = false;")],
    "no_bias": [("            bv[n][e] = r < L && c < L ? __ldg(bias_h + r * L + c) : 0.f;", "            bv[n][e] = 0.f;"),
                ("            const float2 b2 = r < L && c < L ? __ldg(reinterpret_cast<const float2*>(bias_h + r * L + c))",
                 "            const float2 b2 = false ? __ldg(reinterpret_cast<const float2*>(bias_h + r * L + c))")],
    "f32_g1": [("constexpr int kF32G = 2;  // windows per block: one per warpgroup", "constexpr int kF32G = 1;"),
               ("constexpr int kF32MaxStages = 4;", "constexpr int kF32MaxStages = 2;")],
    "f32_stages3": [("constexpr int kF32MaxStages = 4;", "constexpr int kF32MaxStages = 3;")],
    "f32_stages2": [("constexpr int kF32MaxStages = 4;", "constexpr int kF32MaxStages = 2;")],
    "f32_hi_only": [(F32_MMA[0], ""), (F32_MMA[1], ""), (F32_MMA[2], F32_MMA[2].replace(", 1);", ", ks > 0);"))],
    "f32_no_wgmma": [(line, "") for line in F32_MMA],
    "f32_no_fetch": [("    mbar_arrive_expect_tx(&full[s], 2 * rows * 128);", "    mbar_arrive(&full[s]);"),
                     ("    tma_load_3d(dst, map, &full[s], k, row, 0);  // plane 0, hi", ""),
                     ("    tma_load_3d(dst + kF32LoBytes, map, &full[s], k, row, 1);", "")],
    "f32_no_attn": [("      for (int hl = 0; hl < heads; ++hl) {  // the piece's heads",
                     "      for (int hl = 0; hl < 0; ++hl) {")],
    "f32_no_mlp": [("  const int n_pieces = (H + hp - 1) / hp, n_chunks = (hidden + kChunk - 1) / kChunk;",
                    "  const int n_pieces = (H + hp - 1) / hp, n_chunks = 0;")],
    "f32_no_gelu": [("          a1[4 * jj + e] = 0.5f * u * (1.f + erff(0.70710678118654752f * u));",
                     "          a1[4 * jj + e] = u;")],
}
SHAPES = [  # name, map side, window, C, heads, v2
    ("swin_t stage 1", 56, 7, 96, 3, False),
    ("swin_t stage 2", 28, 7, 192, 6, False),
    ("swin_v2_t stage 1", 64, 8, 96, 3, True),
    ("swin_v2_t stage 2", 32, 8, 192, 6, True),
]

TIMER = """
import math, sys, torch
sys.path.insert(0, sys.argv[1])
from eqxvision_tpu_torch.ops import window_attention as W
gen = torch.Generator(device="cuda").manual_seed(0)
for name, side, win, c, h, v2 in {shapes}:
    def r(*shape, s=0.1, base=0.0):
        return base + s * torch.randn(*shape, device="cuda", generator=gen)
    hid = 4 * c
    dt = torch.{dtype}
    kw = dict(norm1_w=r(c, base=1.0), norm1_b=r(c), qkv_weight=r(3 * c, c).to(dt), qkv_bias=r(3 * c),
              proj_weight=r(c, c).to(dt), proj_bias=r(c), norm2_w=r(c, base=1.0), norm2_b=r(c),
              fc1_weight=r(hid, c).to(dt), fc1_bias=r(hid), fc2_weight=r(c, hid).to(dt), fc2_bias=r(c),
              relative_position_bias=r(1, h, win * win, win * win, s=1.0), window_size=(win, win),
              shift_size=(win // 2, win // 2), num_heads=h)
    x = r(128, side, side, c, s=0.5).to(dt)
    if v2:
        f = lambda: W.fused_swin_block_v2(x, logit_scale=torch.full((h, 1, 1), math.log(10.0), device="cuda"), **kw)
    else:
        f = lambda: W.fused_swin_block_v1(x, **kw)
    with torch.inference_mode():
        f()
        torch.cuda.synchronize()
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        e0.record()
        for _ in range({iters}):
            f()
        e1.record()
        e1.synchronize()
    print(f"{{sys.argv[2]:12s}} {dtype} {{name:18s}} {{e0.elapsed_time(e1) / {iters}:.4f}} ms", flush=True)
"""


def patch(text, name):
    lines = text.split("\n")
    for old, new in VARIANTS[name]:
        hits = [i for i, line in enumerate(lines) if line == old]
        if len(hits) != 1:
            raise SystemExit(f"{name}: the line to change occurs {len(hits)} times in swin_block.cu: {old!r}")
        lines[hits[0]] = new
    return "\n".join(lines)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--variants", nargs="+", choices=list(VARIANTS))
    ap.add_argument("--dtype", choices=["bfloat16", "float32"], default="bfloat16")
    ap.add_argument("--iters", type=int, default=20)
    args = ap.parse_args()
    f32 = args.dtype == "float32"
    variants = args.variants or [v for v in VARIANTS if v == "base" or v.startswith("f32_") == f32]
    code = TIMER.format(shapes=SHAPES, iters=args.iters, dtype=args.dtype)
    for name in variants:  # patch them all first: a stale patch stops the run before any build
        patch((PKG / "csrc" / "swin_block.cu").read_text(), name)
    roots = {}
    for name in dict.fromkeys(variants):
        root = roots[name] = PKG / "_build" / "ablate" / name
        shutil.rmtree(root, ignore_errors=True)
        shutil.copytree(PKG, root / PKG.name, ignore=shutil.ignore_patterns("_build", "__pycache__"))
        src = root / PKG.name / "csrc" / "swin_block.cu"
        src.write_text(patch(src.read_text(), name))
    # build every copy at once, then time them one after another
    build = "import sys; sys.path.insert(0, sys.argv[1]); from eqxvision_tpu_torch import _native; _native.library()"
    procs = [subprocess.Popen([sys.executable, "-c", build, str(root)]) for root in roots.values()]
    if any([proc.wait() for proc in procs]):
        raise SystemExit("a variant failed to build")
    for name in variants:
        subprocess.run([sys.executable, "-c", code, str(roots[name]), name], check=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
