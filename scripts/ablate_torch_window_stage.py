"""Where the window stage spends its time, by removing phases or changing a design choice.

Run from the root of the repository on a machine with a CUDA card:

    python3 scripts/ablate_torch_window_stage.py [--entry k3|k2] [--dtype float32] [--cases stages]
        [--variants base no_exp ...] [--iters 20]

``csrc/window_attention.cu``'s window stage (``window_stage``: persistent
one-warpgroup blocks walking contiguous runs of (window, head) tiles in
slab-major order over a TMA ring; bf16 S and P V on wgmma, f32 by split
TF32 on mma.sync) runs the window attention (K3/K4) and the public
attention's (K2) rows of at most 64 tokens. For each variant the script
copies ``eqxvision_tpu_torch/csrc`` into
``eqxvision_tpu_torch/_build/ablate_window/<entry>/<variant>/``, changes one
phase or design choice there (the outputs may then be wrong; only the time
is read), compiles that copy's entry source (``window_attention.cu``; for
K2 ``attention.cu`` with it) into a small library with the package's nvcc
flags (all variants at once, one nvcc each), then times the entry in two
turns (every variant, then every variant in reverse): CUDA events over
``--iters`` calls (which read the host where a call's host cost exceeds
the kernel) and the kernels' device time by torch.profiler over as many.

Cases. ``--entry k3`` (``eqx_window_attention``, b128): swin_t stage 3
((512 windows, 49, 3 x 384), 12 heads, a bias a window) and stage 4 (128
windows, 24 heads, one bias) in v1 and swin_v2_t stage 3 (L = 64, v2
cosine); with ``--cases stages`` every stage of swin_t (224 px) and
swin_v2_t (256 px), a bias a window where the stage is shifted, one bias
where it is not. ``--entry k2`` (``eqx_attention``): swin_t stage 1 through
the public op, q, k, v (24576, 49, 32) with a compact (192, 49, 49) bias,
and the same without a bias.

Each patch names one whole source line, which must occur exactly once, or
the script stops before any build. It also prints each variant's registers
and spills of the Dh = 32 kernels from ptxas and the window stage's blocks.

Variants (bf16; with ``--dtype float32`` the f32 ones and those marked *):
  base        the kernels as they are
  strided_walk*  (K2) K3's walk: block j takes rows j, j + grid, ..., so a
              block's rows change slab whenever the grid is not a multiple of
              the slabs (K2's walk before)
  slab_walk*  (K3) K2's walk: each block a contiguous run of tiles in
              slab-major order
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
  k2_attention_stage*  (K2) short rows on the attention stage, as before
              they moved: bf16 its wgmma kernel, f32 its split-TF32 kernel
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
SOURCES = {"k3": ("window_attention.cu",), "k2": ("attention.cu", "window_attention.cu")}
FILES = ("window_attention.cu", "attention.cu", "attention_stage.cuh")
EXP = ("      const float x = F32 ? exp2f((s[i] - mx[(i >> 1) & 1]) * kLog2e) : "
       "ex2(s[i] - mx[(i >> 1) & 1]);")
MASK = "        v = 8 * j + (e & 1) < lim ? v : -INFINITY;"
RING = "constexpr int kWinStages = kWinIsF32<T> ? 1 : 2;"
BIAS_V1 = ("          s[4 * j + e] = b0[key] * a.inv_scale;", "          s[4 * j + 2 + e] = b1[key] * a.inv_scale;")
BIAS_PASS = "          const float bv = (e >> 1 ? b1 : b0)[min(8 * j + 2 * t + (e & 1), L - 1)];"
SLAB_COPY = "        for (int i = tid; i < L * L; i += kWinThreads) sb[i] = __ldg(src + i);"
GLOBAL_ROW = "__ldg(a.bias + ((w % a.n_windows) % a.n_bias * H + h) * L * L + min(r0 + g{}, L - 1) * L + {})"
WALK = "  constexpr bool kSlabWalk = kMode >= kRowsBias;"
VARIANTS = {  # name: [(whole source line, replacement)]
    "base": [],
    "strided_walk": [(WALK, "  constexpr bool kSlabWalk = false;")],
    "slab_walk": [(WALK, "  constexpr bool kSlabWalk = true;")],
    "no_bias": [(BIAS_V1[0], "          s[4 * j + e] = 0.f;"), (BIAS_V1[1], "          s[4 * j + 2 + e] = 0.f;"),
                (BIAS_PASS, "          const float bv = 0.f;"), (SLAB_COPY, "")],
    "bias_l2": [(BIAS_V1[0], f"          s[4 * j + e] = {GLOBAL_ROW.format('', 'key')} * a.inv_scale;"),
                (BIAS_V1[1], f"          s[4 * j + 2 + e] = {GLOBAL_ROW.format(' + 8', 'key')} * a.inv_scale;"),
                (BIAS_PASS, "          const float bv = "
                            + GLOBAL_ROW.format(" + 8 * (e >> 1)", "min(8 * j + 2 * t + (e & 1), L - 1)") + ";"),
                (SLAB_COPY, "")],
    "no_s": [("        wgmma_m64n64k16(s, win_desc<RB>(tq) + 2 * ks, win_desc<RB>(tk) + 2 * ks, (kBias && !kCosine) || "
              "ks > 0);", "        ;")],
    "no_pv": [("      for (int kk = 0; kk < 4; ++kk) wgmma_win_pv<BW>(o, pa[kk], win_mn_desc<RB>(tv + 16 * kk * RB), kk > 0);",
               "")],
    "no_exp": [(EXP, "      const float x = s[i] - mx[(i >> 1) & 1];")],
    "no_mask": [(MASK, "")],
    "no_softmax": [(MASK, ""), (EXP, "      const float x = s[i];"),
                   ("    const float inv[2] = {1.f / quad_sum(sum[0]), 1.f / quad_sum(sum[1])};",
                    "    const float inv[2] = {1.f, 1.f};")],
    "no_norms": [("      if constexpr (kCosine) row_scales();  // first: the products' 32 accumulators are not live yet",
                  ""),
                 ("      if constexpr (kCosine) row_scales();  // while the products run", ""),
                 ("    if constexpr (kCosine) named_barrier(1, kWinThreads);  // the row scales", "")],
    "no_store": [("        if (row < L && u < DH / 8)", "        if (false)"), ("        if (row < L)", "        if (false)")],
    "ring1": [(RING, "constexpr int kWinStages = 1;")],
    "ring2": [(RING, "constexpr int kWinStages = 2;")],
    "ring3": [(RING, "constexpr int kWinStages = 3;")],
    "ring4": [(RING, "constexpr int kWinStages = 4;")],
    "one_tile": [("  return tiles < resident ? tiles : resident;", "  return tiles;")],
    "block_per_sm": [("  const long long resident = (long long)sms * (occupancy > 0 ? occupancy : 1);",
                      "  const long long resident = sms;")],
    "k2_attention_stage": [("  if (eqx_window::stage_takes(dtype, seq_len, head_dim, aligned, false, bias, scale))",
                            "  if (false)")],
    "f32_attention_stage": [("  if (dtype == 0) return stage ? kPathStageF32 : kPathAttentionStageF32;",
                             "  if (dtype == 0) return kPathAttentionStageF32;")],
    "f32_no_s": [("          mma_split(win_tile(s, j), ah, al, bh0, bh1, bl0, bl1);", "")],
    "f32_no_pv": [("          mma_split(win_tile(o, n), ph, pl, bh0, bh1, bl0, bl1);", "")],
}
F32_SHARED = ("strided_walk", "slab_walk", "no_bias", "bias_l2", "no_exp", "no_mask", "no_norms", "ring1", "ring2",
              "ring3", "ring4", "one_tile", "block_per_sm", "k2_attention_stage")
K3_ONLY = ("no_norms", "f32_attention_stage", "slab_walk")
K2_ONLY = ("k2_attention_stage", "strided_walk")
# K3: (name, B, nW, nW of the bias, L, C, H, v2)
CASES = [("swin_t s3", 128, 4, 4, 49, 384, 12, False), ("swin_t s4", 128, 1, 1, 49, 768, 24, False),
         ("swin_v2_t s3", 128, 4, 4, 64, 384, 12, True)]
# K2: (name, B, N, Dh, Bb or None)
K2_CASES = [("K2 swin_t s1", 24576, 49, 32, 192), ("K2 swin_t s1 no bias", 24576, 49, 32, None)]
# The Dh = 32 kernels' mangled names by mode: K3 v1, K3 cosine, K2 with a bias, K2 without
KERNELS = {dt: tuple(f"window_stageI{t}Li32ELi{mode}E" for mode in range(4))
           for dt, t in (("bfloat16", "13__nv_bfloat16"), ("float32", "f"))}


def stage_cases():
    """Every stage of swin_t (224 px, window 7) and swin_v2_t (256 px,
    window 8) at b128, as CASES: a bias a window where the stage is shifted."""
    cases = []
    for name, size, win, v2 in (("swin_t", 224, 7, False), ("swin_v2_t", 256, 8, True)):
        side = size // 4
        for stage, h in enumerate((3, 6, 12, 24)):
            nw = (-(-side // win)) ** 2
            cases.append((f"{name} s{stage + 1}", 128, nw, nw if side > win else 1, win * win, 96 * 2**stage, h, v2))
            side = -(-side // 2)
    return cases


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
    ap.add_argument("--entry", choices=("k3", "k2"), default="k3")
    ap.add_argument("--variants", nargs="+", default=None, choices=list(VARIANTS))
    ap.add_argument("--cases", choices=("default", "stages"), default="default")
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--dtype", choices=("bfloat16", "float32"), default="bfloat16")
    args = ap.parse_args()
    f32, k2 = args.dtype == "float32", args.entry == "k2"
    variants = args.variants or [
        v for v in VARIANTS
        if (v == "base" or v.startswith("f32_") == f32 or (f32 and v in F32_SHARED))
        and v not in (K3_ONLY if k2 else K2_ONLY)
    ]
    import torch
    from torch.profiler import ProfilerActivity, profile

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
        root = COPY / args.entry / name
        shutil.rmtree(root, ignore_errors=True)
        shutil.copytree(PKG / "csrc", root / "csrc")
        for f, text in patch(texts, name).items():
            (root / "csrc" / f).write_text(text)
        lib = root / "libwindow.so"
        cmd = [_native._nvcc(), *_native.NVCC_FLAGS, "-shared", "-o", str(lib),
               *(str(root / "csrc" / src) for src in SOURCES[args.entry])]
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
        cfg = (ctypes.c_int * 6)()
        if k2:
            lib.eqx_attention.argtypes = [*([ctypes.c_void_p] * 4), ctypes.c_int, ctypes.c_void_p,
                                          *([ctypes.c_int] * 4), ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
            lib.eqx_attention_config.argtypes = [*([ctypes.c_int] * 4), ctypes.c_longlong,
                                                 ctypes.POINTER(ctypes.c_int)]
            lib.eqx_attention_bias_layout.argtypes = [*([ctypes.c_int] * 3), ctypes.POINTER(ctypes.c_int)]
            lib.eqx_attention_config(49, 32, code, 1, 24576, cfg)
            design = f"; K2 at swin_t s1 path {cfg[0]}, {cfg[3]} blocks, {cfg[1]} an SM, {cfg[2]} bytes a block"
        else:
            lib.eqx_window_attention_config(49, 32, code, 0, 6144, cfg)
            design = f"; at swin_t s3 path {cfg[0]}, {cfg[3]} blocks, {cfg[1]} an SM, {cfg[2]} bytes a block"
        libs[name] = lib
        names = ("K3 v1", "K3 v2", "K2", "K2 no bias")
        regs = "; ".join(f"{m} {registers(log, k)}" for m, k in zip(names, KERNELS[args.dtype]))
        print(f"{name:18s} {regs}{design}", flush=True)

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())
    gen = torch.Generator(device="cuda").manual_seed(0)
    stream = torch.cuda.current_stream().cuda_stream
    calls = []  # (case, fn(lib) -> error code)
    if k2:
        for case, b, n, dh, bb in K2_CASES:
            q, k, v = (torch.randn(b, n, dh, device="cuda", generator=gen).to(dtype) for _ in range(3))
            bias = None if bb is None else torch.randn(bb, n, n, device="cuda", generator=gen)
            out = torch.empty_like(q)
            laid_out = {}  # each library's bias in the layout it takes (the attention stage pads its rows)
            for lib in libs.values():
                layout = (ctypes.c_int * 2)()
                lib.eqx_attention_bias_layout(n, dh, code, layout)
                ld, slack = layout
                if bias is None or (ld, slack) == (n, 0):
                    laid_out[id(lib)] = (bias, n)
                else:
                    padded = torch.zeros(bb * n * ld + slack, device="cuda")
                    padded[: bb * n * ld].view(bb, n, ld)[:, :, :n].copy_(bias)
                    laid_out[id(lib)] = (padded, ld)

            def call(lib, q=q, k=k, v=v, laid_out=laid_out, out=out, b=b, n=n, dh=dh, bb=bb):
                bias, ld = laid_out[id(lib)]
                return lib.eqx_attention(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                                         None if bias is None else bias.data_ptr(), ld, out.data_ptr(), b, bb or 1, n,
                                         dh, dh**-0.5, code, stream)

            calls.append((case, call))
    else:
        for case, b, nw, nwb, L, c, h, v2 in (stage_cases() if args.cases == "stages" else CASES):
            qkv = (0.5 * torch.randn(b * nw, L, 3 * c, device="cuda", generator=gen)).to(dtype)
            bias = torch.randn(nwb, h, L, L, device="cuda", generator=gen)
            gs = torch.full((h,), 10.0, device="cuda") if v2 else None
            out = torch.empty(b * nw, L, c, dtype=dtype, device="cuda")
            scale = 1.0 if v2 else (c // h) ** -0.5

            def call(lib, qkv=qkv, bias=bias, gs=gs, out=out, windows=b * nw, nw=nw, nwb=nwb, L=L, c=c, h=h,
                     scale=scale):
                return lib.eqx_window_attention(qkv.data_ptr(), bias.data_ptr(),
                                                None if gs is None else gs.data_ptr(), out.data_ptr(), windows, nw,
                                                nwb, L, h, c // h, scale, code, stream)

            calls.append((case + (" v2" if v2 else ""), call))

    def run(lib, case, call):
        err = call(lib)
        if err:
            raise SystemExit(f"{case}: launch failed, CUDA error {err}")

    def time_ms(lib, case, call):
        """(CUDA events, device time by torch.profiler) a call, in ms."""
        run(lib, case, call)
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        e0.record()
        for _ in range(args.iters):
            run(lib, case, call)
        e1.record()
        e1.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(args.iters):
                run(lib, case, call)
            torch.cuda.synchronize()
        device = sum(e.device_time_total for e in prof.key_averages() if e.device_time_total) / 1e3 / args.iters
        return e0.elapsed_time(e1) / args.iters, device

    times = {(name, case): [] for name in libs for case, _ in calls}
    for turn in range(2):
        for name in (list(libs) if turn == 0 else list(libs)[::-1]):
            for case, call in calls:
                times[name, case].append(time_ms(libs[name], case, call))
    for (name, case), ms in times.items():
        print(f"{name:18s} {case:22s} {args.dtype}: device {ms[0][1]:.4f}, {ms[1][1]:.4f} ms; "
              f"events {ms[0][0]:.4f}, {ms[1][0]:.4f} ms", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
