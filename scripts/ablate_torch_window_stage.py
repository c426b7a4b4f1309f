"""Where the window attention kernels (K3/K4) spend their time, by removing phases.

Run from the root of the repository on a machine with a CUDA card:

    python3 scripts/ablate_torch_window_stage.py [--dtype float32] [--variants base no_exp ...] [--iters 20]

``csrc/window_attention.cu`` runs windows of at most 64 tokens on its window
stage (``window_stage``: persistent one-warpgroup blocks walking (window,
head) tiles over a TMA ring; bf16 S and P V on wgmma, f32 by split TF32 on
mma.sync). For each variant the script copies
``eqxvision_tpu_torch/csrc`` into
``eqxvision_tpu_torch/_build/ablate_window/<variant>/``, changes one phase or
design choice there (the outputs may then be wrong; only the time is read),
compiles that copy's ``window_attention.cu`` alone into a small library
with the package's nvcc flags (all variants at once, one nvcc each), then
times its entry ``eqx_window_attention`` with CUDA events, in two turns
(every variant, then every variant in reverse), at swin_t stage 3 (b128,
(512 windows, 49, 3 x 384), 12 heads, a bias a window) and stage 4 (128
windows, 24 heads, one bias) in v1, and swin_v2_t stage 3 (L = 64, v2
cosine). Each patch names one whole source line, which must occur exactly
once, or the script stops before any build. It also prints each variant's
registers and spills of the Dh = 32 kernels from ptxas and the window
stage's blocks.

Variants (bf16; with ``--dtype float32`` the f32 ones and those marked *):
  base        the kernels as they are
  no_bias*    the bias not read (v1: the accumulators start at 0; v2 and f32: 0 added)
  bias_l2*    the bias read from L2 (global memory, through L1) at each score
              rather than from the tile's slab in shared memory (the first design)
  no_s        no Q K^T wgmma
  no_pv       no P V wgmma
  no_exp*     2^x replaced by x
  no_mask*    keys past L not masked
  no_softmax  no mask, max, exp or sum (p is the raw scores; the bf16 pack stays)
  no_norms*   (v2) q's and k's row norms not computed (the scales stay 1)
  no_store    the output's global stores skipped (in f32 the compiler then
              drops the products too: no measure there)
  ring1*, ring2*, ring3*, ring4*  a ring of 1, 2, 3 or 4 stages in both types
              (kept: bf16 2, f32 1)
  one_tile*   one block a tile (no persistence: blocks = tiles)
  block_per_sm*  one block an SM, each walking its share of the tiles
  f32_attention_stage  f32 on the attention stage's split-TF32 kernel
              (attention_stage_f32, one block of four warps per (window, head),
              K and V by cp.async), the f32 candidate that measured slower
  f32_no_s    no Q K^T products
  f32_no_pv   no P V products
Imports nothing of JAX.
"""
import argparse
import ctypes
import re
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
PKG = ROOT / "eqxvision_tpu_torch"
COPY = PKG / "_build" / "ablate_window"
SOURCE = "window_attention.cu"
FILES = (SOURCE, "attention_stage.cuh")
EXP = ("      const float x = F32 ? exp2f((s[i] - mx[(i >> 1) & 1]) * kLog2e) : "
       "ex2(s[i] - mx[(i >> 1) & 1]);")
MASK = "        v = 8 * j + (e & 1) < lim ? v : -INFINITY;"
RING = "constexpr int kWinStages = kWinIsF32<T> ? 1 : 2;"
BIAS_V1 = ("          s[4 * j + e] = b0[key] * a.inv_scale;", "          s[4 * j + 2 + e] = b1[key] * a.inv_scale;")
BIAS_PASS = "          const float bv = (e >> 1 ? b1 : b0)[min(8 * j + 2 * t + (e & 1), L - 1)];"
SLAB_COPY = "      for (int i = tid; i < L * L; i += kWinThreads) sb[i] = __ldg(src + i);"
GLOBAL_ROW = "__ldg(a.bias + want * L * L + min(r0 + g{}, L - 1) * L + {})"
VARIANTS = {  # name: [(whole source line, replacement)]
    "base": [],
    "no_bias": [(BIAS_V1[0], "          s[4 * j + e] = 0.f;"), (BIAS_V1[1], "          s[4 * j + 2 + e] = 0.f;"),
                (BIAS_PASS, "          const float bv = 0.f;"), (SLAB_COPY, "")],
    "bias_l2": [(BIAS_V1[0], f"          s[4 * j + e] = {GLOBAL_ROW.format('', 'key')} * a.inv_scale;"),
                (BIAS_V1[1], f"          s[4 * j + 2 + e] = {GLOBAL_ROW.format(' + 8', 'key')} * a.inv_scale;"),
                (BIAS_PASS, "          const float bv = "
                            + GLOBAL_ROW.format(" + 8 * (e >> 1)", "min(8 * j + 2 * t + (e & 1), L - 1)") + ";"),
                (SLAB_COPY, "")],
    "no_s": [("        wgmma_m64n64k16(s, win_desc<RB>(tq) + 2 * ks, win_desc<RB>(tk) + 2 * ks, !kCosine || ks > 0);",
              "        ;")],
    "no_pv": [("      for (int kk = 0; kk < 4; ++kk) wgmma_win_pv<BW>(o, pa[kk], win_mn_desc<RB>(tv + 16 * kk * RB), kk > 0);",
               "")],
    "no_exp": [(EXP, "      const float x = s[i] - mx[(i >> 1) & 1];")],
    "no_mask": [(MASK, "")],
    "no_softmax": [(MASK, ""), (EXP, "      const float x = s[i];"),
                   ("    const float inv[2] = {1.f / quad_sum(sum[0]), 1.f / quad_sum(sum[1])};",
                    "    const float inv[2] = {1.f, 1.f};")],
    "no_norms": [("    if constexpr (kCosine) {  // (bf16: while the products run) two threads a row, each half its columns",
                  "    if constexpr (false) {"),
                 ("    if constexpr (kCosine) named_barrier(1, kWinThreads);  // the row scales", "")],
    "no_store": [("        if (row < L && u < DH / 8)", "        if (false)"), ("        if (row < L)", "        if (false)")],
    "ring1": [(RING, "constexpr int kWinStages = 1;")],
    "ring2": [(RING, "constexpr int kWinStages = 2;")],
    "ring3": [(RING, "constexpr int kWinStages = 3;")],
    "ring4": [(RING, "constexpr int kWinStages = 4;")],
    "one_tile": [("  return tiles < resident ? tiles : resident;", "  return tiles;")],
    "block_per_sm": [("  const long long resident = (long long)sms * (occupancy > 0 ? occupancy : 1);",
                      "  const long long resident = sms;")],
    "f32_attention_stage": [("  if (dtype == 0) return tiles && (head_dim == 16 || head_dim == 32) ? kPathStageF32 : "
                             "kPathAttentionStageF32;", "  if (dtype == 0) return kPathAttentionStageF32;")],
    "f32_no_s": [("          mma_split(win_tile(s, j), ah, al, bh0, bh1, bl0, bl1);", "")],
    "f32_no_pv": [("          mma_split(win_tile(o, n), ph, pl, bh0, bh1, bl0, bl1);", "")],
}
F32_SHARED = ("no_bias", "bias_l2", "no_exp", "no_mask", "no_norms", "ring1", "ring2", "ring3", "ring4", "one_tile",
              "block_per_sm")
# (name, B, nW, nW of the bias, L, C, H, v2)
CASES = [("swin_t s3", 128, 4, 4, 49, 384, 12, False), ("swin_t s4", 128, 1, 1, 49, 768, 24, False),
         ("swin_v2_t s3", 128, 4, 4, 64, 384, 12, True)]
KERNELS = {"bfloat16": ("window_stageI13__nv_bfloat16Li32ELb0E", "window_stageI13__nv_bfloat16Li32ELb1E"),
           "float32": ("window_stageIfLi32ELb0E", "window_stageIfLi32ELb1E")}


def patch(texts, name):
    """``texts`` ({file: text}) with ``name``'s lines changed; each line to
    change must occur once in exactly one of the files."""
    lines = {f: text.split("\n") for f, text in texts.items()}
    for old, new in VARIANTS[name]:
        hits = [(f, i) for f, ls in lines.items() for i, line in enumerate(ls) if line == old]
        if len(hits) != 1:
            raise SystemExit(f"{name}: the line to change occurs {len(hits)} times in {', '.join(texts)}: {old!r}")
        f, i = hits[0]
        lines[f][i] = new
    return {f: "\n".join(ls) for f, ls in lines.items()}


def registers(log, kernel):
    """'<n> registers, <m> bytes spilled' of the kernel whose mangled name holds ``kernel``."""
    name, spills = None, 0
    for line in log.splitlines():
        if "Compiling entry function" in line:
            name = line
        elif name and kernel in name and "spill stores" in line:
            spills = sum(int(v) for v in re.findall(r"(\d+) bytes spill", line))
        elif name and kernel in name and "Used" in line:
            serialised = "; C7520" if any("C7520" in x and kernel in x for x in log.splitlines()) else ""
            regs = re.search(r"Used (\d+) registers", line).group(1)
            return f"{regs} registers, {spills} bytes spilled{serialised}"
    return "not in the build log"


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--variants", nargs="+", default=None, choices=list(VARIANTS))
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--dtype", choices=("bfloat16", "float32"), default="bfloat16")
    args = ap.parse_args()
    f32 = args.dtype == "float32"
    variants = args.variants or [v for v in VARIANTS
                                 if v == "base" or v.startswith("f32_") == f32 or (f32 and v in F32_SHARED)]
    import torch

    if not torch.cuda.is_available():
        print("ablate_torch_window_stage: needs a CUDA card", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    from eqxvision_tpu_torch import _native

    texts = {f: (PKG / "csrc" / f).read_text() for f in FILES}
    for name in variants:  # patch them all first: a stale patch stops the run before any build
        patch(texts, name)
    builds = {}
    for name in variants:
        root = COPY / name
        shutil.rmtree(root, ignore_errors=True)
        shutil.copytree(PKG / "csrc", root / "csrc")
        for f, text in patch(texts, name).items():
            (root / "csrc" / f).write_text(text)
        lib = root / "libwindow.so"
        cmd = [_native._nvcc(), *_native.NVCC_FLAGS, "-shared", "-o", str(lib), str(root / "csrc" / SOURCE)]
        builds[name] = (lib, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    code, dtype = (0, torch.float32) if f32 else (1, torch.bfloat16)
    libs = {}
    for name, (lib_path, proc) in builds.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise SystemExit(f"{name} failed to build:\n{log}")
        lib = ctypes.CDLL(str(lib_path))
        lib.eqx_window_attention.argtypes = [*([ctypes.c_void_p] * 4), *([ctypes.c_int] * 6), ctypes.c_float,
                                             ctypes.c_int, ctypes.c_void_p]
        lib.eqx_window_attention_config.argtypes = [*([ctypes.c_int] * 4), ctypes.c_longlong,
                                                    ctypes.POINTER(ctypes.c_int)]
        libs[name] = lib
        design = ""
        cfg = (ctypes.c_int * 5)()
        lib.eqx_window_attention_config(49, 32, code, 0, 6144, cfg)
        design = (f"; at swin_t s3 path {cfg[0]}, {cfg[3]} blocks, {cfg[1]} an SM, {cfg[2]} bytes of shared memory "
                  f"a block")
        v1, v2 = KERNELS[args.dtype]
        print(f"{name:13s} v1 {registers(log, v1)}; v2 {registers(log, v2)}{design}", flush=True)

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())
    gen = torch.Generator(device="cuda").manual_seed(0)
    stream = torch.cuda.current_stream().cuda_stream
    inputs = []
    for case, b, nw, nwb, L, c, h, v2 in CASES:
        qkv = (0.5 * torch.randn(b * nw, L, 3 * c, device="cuda", generator=gen)).to(dtype)
        bias = torch.randn(nwb, h, L, L, device="cuda", generator=gen)
        gs = torch.full((h,), 10.0, device="cuda") if v2 else None
        out = torch.empty(b * nw, L, c, dtype=dtype, device="cuda")
        inputs.append((case, b * nw, nw, nwb, L, c, h, 1.0 if v2 else (c // h) ** -0.5, qkv, bias, gs, out))

    def time_ms(lib, args_):
        case, windows, nw, nwb, L, c, h, scale, qkv, bias, gs, out = args_

        def call():
            err = lib.eqx_window_attention(qkv.data_ptr(), bias.data_ptr(), None if gs is None else gs.data_ptr(),
                                           out.data_ptr(), windows, nw, nwb, L, h, c // h, scale, code, stream)
            if err:
                raise SystemExit(f"{case}: launch failed, CUDA error {err}")

        call()
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        e0.record()
        for _ in range(args.iters):
            call()
        e1.record()
        e1.synchronize()
        return e0.elapsed_time(e1) / args.iters

    times = {(name, x[0]): [] for name in libs for x in inputs}
    for turn in range(2):
        for name in (list(libs) if turn == 0 else list(libs)[::-1]):
            for x in inputs:
                times[name, x[0]].append(time_ms(libs[name], x))
    for (name, case), ms in times.items():
        print(f"{name:13s} {case:13s} {args.dtype}: {ms[0]:.4f}, {ms[1]:.4f} ms", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
