"""Design choices of the GEMMs of ``csrc/gemm_bf16.cuh``, timed against
each other on the card.

Run from the root of the repository on a machine with a CUDA card:

    python3 scripts/ablate_torch_gemm.py [--variants base one_tile_per_block ...] [--iters 20] [--dtype float32]

For each variant it copies ``eqxvision_tpu_torch`` into
``eqxvision_tpu_torch/_build/ablate_gemm/<variant>/``, changes one line of
that copy's header and builds it (all variants at once, each in a process
of its own); then, one process a variant in the order given (a variant
named twice is timed twice, for turns), it drives the fused MLP
half at vit_base b256 (C 768) and convnext_tiny b128 stages 1 and 2 (C 96,
192) in bf16 (``gemm_bf16_kernel``) or, with ``--dtype float32``, in f32
(``gemm_f32_kernel``, split TF32) under torch.profiler: device time per
call of each GEMM (fc1 with the LayerNorm on A and gelu, fc2 with the
residual) and of the whole op by CUDA events. Variants:

- ``base``: the shipped kernel (a persistent grid, one block per SM
  walking the tiles; 96-wide column tiles where N is 96 or 192);
- ``one_tile_per_block``: one block per output tile, no persistent loop;
- ``no_narrow_tile``: column tiles of 256 or 128 only (f32: 128 only), so
  N = 96 and 192 take a 128-wide tile padded by a quarter or a third;
- f32 only: ``f32_cvt_hi`` (the split's hi by ``cvt.rna.tf32.f32``) and
  ``f32_unchecked`` (hi without the non-finite check, which a NaN does not
  survive: the check's cost);
- phases removed, the outputs then wrong (only the time is read):
  ``no_norm_pass`` (A not normalised in shared memory), ``no_gelu`` (fc1's
  epilogue adds the bias only), ``no_epilogue`` (the accumulator is never
  written out).

Imports nothing of JAX.
"""
import argparse
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
PKG = ROOT / "eqxvision_tpu_torch"
GRID = "  const unsigned grid = (unsigned)(tiles < sms ? tiles : sms);  // persistent: one block per SM"
WIDTHS = "  const int widths[3] = {256, 128, 96};"
SPLIT_HI = "  hi = fabsf(x) < INFINITY ? tf32_rna_bits(x) : __float_as_uint(x);"
NARROW_F32 = "    const bool narrow = (long long)(p.N + 95) / 96 * 96 < (long long)(p.N + 127) / 128 * 128;"
TRANSFORM = "  constexpr bool kTransformA = kNormA || kMaskRows;"
GELU = "      return 0.5f * y * (1.f + erff(y * 0.70710678118654752f));"
CHUNKS = "      for (int ch = 0; ch < BN / kEpiCols; ++ch) {"
VARIANTS = {  # name: [(header line, replacement)]
    "base": [],
    "one_tile_per_block": [(GRID, "  const unsigned grid = (unsigned)tiles;")],
    "no_narrow_tile": [(WIDTHS, "  const int widths[3] = {256, 128, 128};"), (NARROW_F32, "    const bool narrow = false;")],
    # f32: hi by cvt.rna.tf32.f32, or without the non-finite check (a NaN may become -0: its cost only)
    "f32_cvt_hi": [(SPLIT_HI, '  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(hi) : "f"(x));')],
    "f32_unchecked": [(SPLIT_HI, "  hi = tf32_rna_bits(x);")],
    # phases removed (the outputs are then wrong; only the time is read)
    "no_norm_pass": [(TRANSFORM, "  constexpr bool kTransformA = false;")],
    "no_gelu": [(GELU, "      return y;")],
    "no_epilogue": [(CHUNKS, CHUNKS.replace("ch < BN / kEpiCols", "ch < 0"))],
}
SHAPES = [  # name, rows, C, residual is x
    ("vit_base b256", 50432, 768, True),
    ("convnext_tiny b128 stage 1", 401408, 96, False),
    ("convnext_tiny b128 stage 2", 100352, 192, False),
]

TIMER = """
import sys, torch
from torch.profiler import ProfilerActivity, profile
sys.path.insert(0, sys.argv[1])
from eqxvision_tpu_torch.ops import mlp_half as M
gen = torch.Generator(device="cuda").manual_seed(0)
for name, rows, c, residual_is_x in {shapes}:
    def r(*shape, s=1.0, base=0.0):
        return (base + s * torch.randn(*shape, device="cuda", generator=gen)).to(torch.{dtype})
    x = r(rows, c)
    res = x if residual_is_x else r(rows, c)
    params = (r(c, s=0.1, base=1.0), r(c, s=0.1), r(4 * c, c, s=c**-0.5), r(4 * c, s=0.1),
              r(c, 4 * c, s=(4 * c) ** -0.5), r(c, s=0.1), None if residual_is_x else r(c, s=0.1, base=0.5))
    f = lambda: M.fused_mlp_half(x, res, *params)
    with torch.inference_mode():
        f()
        torch.cuda.synchronize()
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        e0.record()
        for _ in range({iters}):
            f()
        e1.record()
        e1.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range({iters}):
                f()
            torch.cuda.synchronize()
    kernel = "gemm_{short}_kernel<"
    gemms = {{e.key[e.key.index(kernel) + len(kernel) - 1:e.key.index(">") + 1]: e.device_time_total / 1e3 / e.count
             for e in prof.key_averages() if kernel in e.key and e.count}}
    flops = {{"fc1": 2 * rows * c * 4 * c, "fc2": 2 * rows * 4 * c * c}}
    parts = []
    for tile, ms in sorted(gemms.items(), reverse=True):
        which = "fc1" if tile.startswith("<true") else "fc2"
        parts.append(f"{{which}} {{tile}} {{ms:.4f}} ms ({{flops[which] / ms / 1e9:.1f}} TFLOP/s)")
    print(f"{{sys.argv[2]:19s}} {short} {{name:27s}} op {{e0.elapsed_time(e1) / {iters}:.4f}} ms; " + "; ".join(parts),
          flush=True)
"""


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--variants", nargs="+", default=list(VARIANTS), choices=list(VARIANTS),
                    help="timed in this order; a variant named twice is built once and timed twice (turns)")
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--dtype", choices=("bfloat16", "float32"), default="bfloat16")
    args = ap.parse_args()
    code = TIMER.format(shapes=SHAPES, iters=args.iters, dtype=args.dtype,
                        short="bf16" if args.dtype == "bfloat16" else "f32")
    roots = {}
    for name in dict.fromkeys(args.variants):
        root = roots[name] = PKG / "_build" / "ablate_gemm" / name
        shutil.rmtree(root, ignore_errors=True)
        shutil.copytree(PKG, root / PKG.name, ignore=shutil.ignore_patterns("_build", "__pycache__"))
        src = root / PKG.name / "csrc" / "gemm_bf16.cuh"
        text = src.read_text()
        for old, new in VARIANTS[name]:
            if old not in text:
                raise SystemExit(f"{name}: the line to change is not in gemm_bf16.cuh: {old!r}")
            text = text.replace(old, new)
        src.write_text(text)
    # every variant's library built at once, then timed one process at a time
    build = "import sys; sys.path.insert(0, sys.argv[1]); from eqxvision_tpu_torch import _native; _native.library()"
    procs = [subprocess.Popen([sys.executable, "-c", build, str(root)]) for root in roots.values()]
    if any(proc.wait() != 0 for proc in procs):
        raise SystemExit("a variant did not build")
    for name in args.variants:
        subprocess.run([sys.executable, "-c", code, str(roots[name]), name], check=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
