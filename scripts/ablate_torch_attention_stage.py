"""Where the ViT attention stage spends its time, by removing phases.

Run from the root of the repository on a machine with a CUDA card:

    python3 scripts/ablate_torch_attention_stage.py [--entry k1|k2_bias] [--dtype float32] [--variants base no_exp ...] [--iters 20]

The stage (``csrc/attention_stage.cuh``) is the one kernel that K1's entry
``eqx_fused_qkv_attention``, the fused attention half's third launch and
the public attention's (K2) rows longer than 64 tokens run.
For each variant the script copies ``eqxvision_tpu_torch/csrc`` into
``eqxvision_tpu_torch/_build/ablate_stage/<entry>/<variant>/``, changes one
phase or design choice of the bf16 wgmma stage (or, with ``--dtype
float32``, of the f32 stage) in that copy's header (the outputs may then
be wrong; only the time is read), compiles that copy's
entry source alone (K2's with ``window_attention.cu``, whose window stage it
runs for short rows) into a small library with the package's nvcc flags (all
variants at once, one nvcc each), then times the entry with CUDA events, in
turns base-first: ``--entry k1`` (the default) K1's
``fused_qkv_attention.cu`` on a bf16 qkv of vit_base b256's shape, (256,
197, 3 x 768) with 12 heads; ``--entry k2_bias`` K2's ``attention.cu`` on
bf16 q, k, v of (256 x 12, 197, 64) with a compact (12, 197, 197) f32 bias,
vit_base b256 with a BEiT-style relative-position bias. Each patch names
one whole source line, which must occur exactly once, or the script stops
before any build. It also prints each variant's registers and spills of the
one-pass Dh = 64 kernel (with the bias for k2_bias; in f32 the f32 stage at
head dim 64) from ptxas. In f32 the inputs are f32 of the same shapes.

Variants:
  base        the stage as it is
  no_exp      2^x replaced by x (the SFUs' share)
  no_softmax  no scale, mask, max, exp or sum (p is the raw scores; the bf16 pack stays)
  no_wgmma    no wgmma issued, neither Q K^T nor P V
  no_kv_load  K and V not loaded (their buffers hold whatever they hold)
  no_store    the output's global stores skipped
  two_pass    the two-pass kernel at L <= 256 too: pass 1 max and sum, pass 2
              recomputes Q K^T, as the stage's earlier mma.sync design did
  per_tile    one block per (image, head, 64-query tile), each loading the
              head's K and V itself, rather than one per (image, head) (at
              b256 the stage's own choice gives one per (image, head))
  no_mask     keys past L not masked (the mask's selects' share)
  raw_max     the rows' max taken on the unscaled scores and the scale folded
              into the exp's argument (right only for a positive scale)
  skip_dead   warps whose 16 query rows all lie past L skip the softmax,
              under a branch
  guarded     the products of pieces and k16 steps wholly past L skipped,
              under branches (a variant whose wgmma ptxas serialises is
              marked C7520 in the register line)
  no_bias_load  (k2_bias) the accumulators start at 0 instead of the bias
              read from L2 (the loads' share)
  bias_row0   (k2_bias) every query row reads row 0 of its image's bias:
              the same loads and instructions, an eighth of the cache lines
              a warp's load touches (the bias's L1 and L2 traffic share)
  bias_evict_last  (k2_bias) the bias loads ask L2 to keep their lines
              (an evict_last policy), against the q, k and v streams
  bias_no_l1  (k2_bias) the bias loads do not allocate in L1
f32 variants (``--dtype float32``; base is the f32 stage as it is):
  f32_cvt     Q's, K's, V's and P's TF32 split by cvt.rna.tf32.f32 rather
              than by integer operations (split_tf32_bits in gemm_bf16.cuh)
  f32_cvt_hi  hi by cvt.rna.tf32.f32 (which keeps a NaN), lo by integer
              operations
  f32_unchecked  hi rounded without the non-finite check (a NaN may become
              -0: the check's cost, not a kernel to keep)
  f32_keys64  K and V staged in chunks of 64 keys rather than 32 (two
              blocks an SM at head dim 64 rather than three)
  f32_tf32    one TF32 product (hi hi) where split TF32 takes three: the
              split's cost (not f32-accurate)
  f32_fma     the CUDA-core two-pass stage the f32 path took before
              (attention_stage_fma<float>), true f32 FMAs
  f32_no_split  Q's, K's, V's and P's values passed as they are, hi = lo = x (the
              split's integer work; the three products stay)
  f32_no_exp  2^x replaced by x
  f32_no_pv   no P V products
  f32_no_s    no Q K^T products
  f32_no_kv_load  K and V not loaded (16-byte path)
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
COPY = PKG / "_build" / "ablate_stage"
HEADER = "attention_stage.cuh"
SPLIT_HEADER = "gemm_bf16.cuh"  # split_tf32_bits, which the f32_cvt and f32_no_split lines change
MASK = "          const float v = kStageTile * p + 8 * j + (e & 1) < lim ? s[p][4 * j + e] * c : -INFINITY;"
BIAS_LOAD = "            const float2 v = __ldg(reinterpret_cast<const float2*>(bp + kStageTile * p + 8 * j));"
BIAS_ROWS = ("      const int r0 = min(q0 + 16 * warp + lane / 4, L - 1), "
             "r1 = min(q0 + 16 * warp + lane / 4 + 8, L - 1);")
ROW_MAX = ("    for (int r = 0; r < 2; ++r) mx[r] = quad_max(fmaxf(fmaxf(pm[0][r], pm[1][r]), "
           "fmaxf(pm[2][r], pm[3][r])));")
VARIANTS = {  # name: [(whole source line, replacement)]
    "base": [],
    "no_exp": [("          const float x = ex2(s[p][4 * j + e] - m[e >> 1]);",
                "          const float x = s[p][4 * j + e] - m[e >> 1];")],
    "no_softmax": [("        scale_mask(key0, s, mb);", "        mb[0] = mb[1] = 0.f;"),
                   ("        exponentiate(s, mr, sum);", "        sum[0] = sum[1] = 1.f;"),
                   ("      scale_mask(key0, s, mb);", "      mb[0] = mb[1] = 0.f;"),
                   ("      exponentiate(s, m, sum);", "      sum[0] = sum[1] = 1.f;")],
    "no_wgmma": [("        wgmma_m64n64k16(s[p], dq, dk, kBias || ks > 0);", "        ;"),
                 ("        wgmma_pv<DP>(o, pa[p][kk], sw128_mn_desc(vb + (kStageTile * p + 16 * kk) * 128, kv_half));",
                  "        ;")],
    "no_kv_load": [("    if (resident) load_kv(0, true);", ""), ("    if (resident) mbar_wait(&bar[2], 0);", ""),
                   ("      if (resident && blk == 0) mbar_wait(&bar[3], 0);", "")],
    "no_store": [("        if (row < L && col < DH)", "        if (false)")],
    "two_pass": [("  const bool one_pass = seq_len <= kStageBlock;", "  const bool one_pass = false;")],
    "per_tile": [("  const int split = stage_split((long long)batch * num_heads, seq_len, sms);",
                  "  const int split = (seq_len + kStageTile - 1) / kStageTile;")],
    "no_mask": [(MASK, "          const float v = s[p][4 * j + e] * c;")],
    "raw_max": [(MASK, MASK.replace(" * c : ", " : ")),
                (ROW_MAX, ROW_MAX.replace("= quad_max(", "= c * quad_max(")),
                ("          const float x = ex2(s[p][4 * j + e] - m[e >> 1]);",
                 "          const float x = ex2(fmaf(s[p][4 * j + e], c, -m[e >> 1]));")],
    "skip_dead": [("      scale_mask(key0, s, mb);",
                   "      if (q0 + 16 * warp < L) scale_mask(key0, s, mb); else mb[0] = mb[1] = 0.f;"),
                  ("      exponentiate(s, m, sum);",
                   "      if (q0 + 16 * warp < L) exponentiate(s, m, sum); else sum[0] = sum[1] = 1.f;")],
    "guarded": [("        wgmma_m64n64k16(s[p], dq, dk, kBias || ks > 0);",
                 "        if (kStageTile * p < L) wgmma_m64n64k16(s[p], dq, dk, kBias || ks > 0);"),
                ("        wgmma_pv<DP>(o, pa[p][kk], sw128_mn_desc(vb + (kStageTile * p + 16 * kk) * 128, kv_half));",
                 "        if (kStageTile * p + 16 * kk < L) "
                 "wgmma_pv<DP>(o, pa[p][kk], sw128_mn_desc(vb + (kStageTile * p + 16 * kk) * 128, kv_half));")],
    "no_bias_load": [(BIAS_LOAD, "            const float2 v = make_float2(0.f, 0.f);")],
    "bias_evict_last": [(BIAS_LOAD, "            float2 v; { uint64_t pol; asm(\"createpolicy.fractional."
                         "L2::evict_last.b64 %0, 1.0;\" : \"=l\"(pol)); asm(\"ld.global.nc.L2::cache_hint.v2.f32 "
                         "{%0, %1}, [%2], %3;\" : \"=f\"(v.x), \"=f\"(v.y) : \"l\"(bp + kStageTile * p + 8 * j), "
                         "\"l\"(pol)); }")],
    "bias_no_l1": [(BIAS_LOAD, "            float2 v; asm(\"ld.global.nc.L1::no_allocate.v2.f32 {%0, %1}, [%2];\" : "
                               "\"=f\"(v.x), \"=f\"(v.y) : \"l\"(bp + kStageTile * p + 8 * j));")],
    "bias_row0": [(BIAS_ROWS, "      const int r0 = 0, r1 = 0;")],
    "f32_cvt": [("  hi = fabsf(x) < INFINITY ? tf32_rna_bits(x) : __float_as_uint(x);",
                 '  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(hi) : "f"(x));'),
                ("  lo = tf32_rna_bits(x - __uint_as_float(hi));",
                 '  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(lo) : "f"(x - __uint_as_float(hi)));')],
    "f32_cvt_hi": [("  hi = fabsf(x) < INFINITY ? tf32_rna_bits(x) : __float_as_uint(x);",
                    '  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(hi) : "f"(x));')],
    "f32_unchecked": [("  hi = fabsf(x) < INFINITY ? tf32_rna_bits(x) : __float_as_uint(x);",
                       "  hi = tf32_rna_bits(x);")],
    "f32_keys64": [("constexpr int kF32StageKeys = 32;", "constexpr int kF32StageKeys = 64;")],
    "f32_tf32": [("  mma_tf32(d, ah, bl0, bl1);", ""), ("  mma_tf32(d, al, bh0, bh1);", "")],
    "f32_fma": [("    case 4: return launch_f32<64>(a, batch, stream);",
                 "    case 4: return launch_fma_stage<float>(a, batch, stream);")],
    "f32_no_split": [("  hi = fabsf(x) < INFINITY ? tf32_rna_bits(x) : __float_as_uint(x);", "  hi = __float_as_uint(x);"),
                     ("  lo = tf32_rna_bits(x - __uint_as_float(hi));", "  lo = hi;")],
    "f32_no_exp": [("          const float pe = exp2f((sc[j][e] - m_ref[e >> 1]) * kLog2e);",
                    "          const float pe = sc[j][e] - m_ref[e >> 1];")],
    "f32_no_pv": [("            mma_split(o[n], ph, pl, bh0, bh1, bl0, bl1);", "")],
    "f32_no_s": [("            mma_split(sc[j], ah, al, bh0, bh1, bl0, bl1);", "")],
    "f32_no_kv_load": [("        cp_async16(sK + j * S + d, kb + at, ok);", ""),
                       ("        cp_async16(sV + j * S + d, vb + at, ok);", "")],
}
BIAS_VARIANTS = ("no_bias_load", "bias_row0", "bias_evict_last", "bias_no_l1")
SHAPE = (256, 197, 12, 64)  # vit_base b256: B, L, heads, head dim
# entry: (sources, C entry point, mangled name of its one-pass Dh = 64 kernel)
ENTRIES = {"k1": (("fused_qkv_attention.cu",), "eqx_fused_qkv_attention", "attention_stage_wgmmaILi64ELb1ELb0E"),
           "k2_bias": (("attention.cu", "window_attention.cu"), "eqx_attention",
                       "attention_stage_wgmmaILi64ELb1ELb1E")}
F32_KERNEL = "attention_stage_f32ILi64ELb0EE"


def patch(texts, name):
    """``texts`` ({header: text}) with ``name``'s lines changed; each line to
    change must occur once in exactly one of the headers."""
    lines = {header: text.split("\n") for header, text in texts.items()}
    for old, new in VARIANTS[name]:
        hits = [(h, i) for h, ls in lines.items() for i, line in enumerate(ls) if line == old]
        if len(hits) != 1:
            raise SystemExit(f"{name}: the line to change occurs {len(hits)} times in {', '.join(texts)}: {old!r}")
        header, i = hits[0]
        lines[header][i] = new
    return {header: "\n".join(ls) for header, ls in lines.items()}


def registers(log, kernel):
    """'<n> registers, <m> bytes spilled' of the kernel whose mangled name holds ``kernel`` in ptxas's report."""
    name = None
    for line in log.splitlines():
        if "Compiling entry function" in line:
            name = line
        elif name and kernel in name and "spill stores" in line:
            spills = sum(int(v) for v in re.findall(r"(\d+) bytes spill", line))
        elif name and kernel in name and "Used" in line:
            regs = re.search(r"Used (\d+) registers", line).group(1)
            serialised = "; ptxas serialises its wgmma (C7520)" if "C7520" in log else ""
            return f"{regs} registers, {spills} bytes spilled{serialised}"
    return "not in the build log"


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--entry", choices=list(ENTRIES), default="k1")
    ap.add_argument("--variants", nargs="+", default=None, choices=list(VARIANTS),
                    help="default: every variant that applies to the entry")
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--dtype", choices=("bfloat16", "float32"), default="bfloat16")
    args = ap.parse_args()
    f32 = args.dtype == "float32"
    variants = args.variants or [v for v in VARIANTS if (v == "base" or v.startswith("f32_") == f32)
                                 and (args.entry == "k2_bias" or v not in BIAS_VARIANTS)]
    import torch

    if not torch.cuda.is_available():
        print("ablate_torch_attention_stage: needs a CUDA card", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    from eqxvision_tpu_torch import _native

    sources, entry, kernel = ENTRIES[args.entry]
    kernel = F32_KERNEL if f32 else kernel
    dtype, code = (torch.float32, 0) if f32 else (torch.bfloat16, 1)
    headers = {h: (PKG / "csrc" / h).read_text() for h in (HEADER, SPLIT_HEADER)}
    for name in variants:  # patch them all first: a stale patch stops the run before any build
        patch(headers, name)
    builds = {}
    for name in variants:
        root = COPY / args.entry / name
        shutil.rmtree(root, ignore_errors=True)
        shutil.copytree(PKG / "csrc", root / "csrc")
        for h, text in patch(headers, name).items():
            (root / "csrc" / h).write_text(text)
        lib = root / "libstage.so"
        cmd = [_native._nvcc(), *_native.NVCC_FLAGS, "-shared", "-o", str(lib),
               *(str(root / "csrc" / src) for src in sources)]
        builds[name] = (lib, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    b, l, h, dh = SHAPE
    for name, (lib_path, proc) in builds.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise SystemExit(f"{name} failed to build:\n{log}")
        lib = ctypes.CDLL(str(lib_path))
        if args.entry == "k1":
            lib.eqx_fused_qkv_attention.argtypes = [ctypes.c_void_p, ctypes.c_void_p, *([ctypes.c_int] * 4),
                                                     ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
            cfg = (ctypes.c_int * 5)()
            lib.eqx_fused_qkv_attention_config(l, dh, cfg)
            design = f"{cfg[0]} blocks an SM, {cfg[1]} bytes of shared memory a block"
        else:
            lib.eqx_attention.argtypes = [*([ctypes.c_void_p] * 4), ctypes.c_int, ctypes.c_void_p,
                                          *([ctypes.c_int] * 4), ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
            cfg = (ctypes.c_int * 6)()
            lib.eqx_attention_config.argtypes = [*([ctypes.c_int] * 4), ctypes.c_longlong, ctypes.POINTER(ctypes.c_int)]
            lib.eqx_attention_config(l, dh, code, 1, b * h, cfg)
            design = f"kernel {cfg[0]} (2: wgmma, 3: f32), {cfg[1]} blocks an SM, {cfg[2]} bytes of shared memory a block"
        libs[name] = lib
        stage = "attention_stage_f32<64>" if f32 else "attention_stage_wgmma<64, true>"
        print(f"{name:12s} {entry}, {stage}: {registers(log, kernel)}; {design}", flush=True)

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())
    gen = torch.Generator(device="cuda").manual_seed(0)
    stream = torch.cuda.current_stream().cuda_stream
    if args.entry == "k1":
        qkv = torch.randn(b, l, 3 * h * dh, device="cuda", generator=gen).to(dtype)
        out = torch.empty(b, l, h * dh, dtype=dtype, device="cuda")

        def launch(lib):
            return lib.eqx_fused_qkv_attention(qkv.data_ptr(), out.data_ptr(), b, l, h, dh, dh**-0.5, code, stream)
    else:
        q, k, v = (torch.randn(b * h, l, dh, device="cuda", generator=gen).to(dtype) for _ in range(3))
        # the compact bias with an even row stride and the room after it that the kernel may read, as
        # ops.attention lays it out
        ld = (l + 1) // 2 * 2
        bias = torch.randn(h * l * ld + 256, device="cuda", generator=gen)
        out = torch.empty_like(q)

        def launch(lib):
            return lib.eqx_attention(q.data_ptr(), k.data_ptr(), v.data_ptr(), bias.data_ptr(), ld, out.data_ptr(),
                                     b * h, h, l, dh, dh**-0.5, code, stream)

    def call(lib):
        err = launch(lib)
        if err:
            raise SystemExit(f"launch failed: CUDA error {err}")

    def time_ms(lib):
        call(lib)
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        e0.record()
        for _ in range(args.iters):
            call(lib)
        e1.record()
        e1.synchronize()
        return e0.elapsed_time(e1) / args.iters

    times = {name: [] for name in libs}
    for turn in range(2):  # two turns: base and every variant, then the reverse
        for name in (list(libs) if turn == 0 else list(libs)[::-1]):
            times[name].append(time_ms(libs[name]))
    what = "K1 entry at vit_base b256" if args.entry == "k1" else "K2 entry, vit_base b256 with a (12, 197, 197) bias,"
    for name, ms in times.items():
        print(f"{name:12s} {what} {SHAPE} {args.dtype}: {ms[0]:.4f}, {ms[1]:.4f} ms", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
