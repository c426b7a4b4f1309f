"""The f32 GEMM's two candidate designs side by side, on one card.

Run from the root of the repository on a machine with a CUDA card:

    python3 scripts/ablate_torch_gemm_f32.py [--iters 10]

The port's f32 GEMM (``csrc/gemm_bf16.cuh``, ``gemm_f32_kernel``) multiplies
by split TF32 on ``wgmma``. The other candidate is a register-tiled SGEMM on
the CUDA cores: 128 x 128 block tiles, 256 threads of 8 x 8 outputs, k-tiles
of 8 double-buffered through registers into shared memory, true f32 FMAs.
This script builds that SGEMM from the source below (nvcc, into
``eqxvision_tpu_torch/_build/ablate_gemm_f32``), with the bias epilogue
only, and times at vit_base b256's shapes (fc1 50432 x 3072 x 768, fc2
50432 x 768 x 3072, qkv 50432 x 2304 x 768, proj 50432 x 768 x 768):
the SGEMM, the port's split-TF32 kernel (device time of ``gemm_f32_kernel``
inside ``fused_mlp_half`` / ``fused_attention_half`` by torch.profiler; it
also normalises A or adds a residual) and ``F.linear`` in f32 (TF32 off),
each with its error against the f64 product. Imports nothing of JAX.
"""
import argparse
import ctypes
import subprocess
import sys
from pathlib import Path

import torch
import torch.nn.functional as F

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

SGEMM_SOURCE = r"""
#include <cuda_runtime.h>
// out[M, N] = A[M, K] W[N, K]^T + bias[N], all f32, K % 4 == 0, N % 4 == 0.
__global__ void __launch_bounds__(256) sgemm_128x128(const float* __restrict__ A, const float* __restrict__ W,
                                                     const float* __restrict__ bias, float* __restrict__ out,
                                                     int M, int N, int K) {
  __shared__ __align__(16) float sA[2][8][128];
  __shared__ __align__(16) float sW[2][8][128];
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const long long m0 = (long long)blockIdx.y * 128;
  const int n0 = blockIdx.x * 128;
  const int lr = tid / 2, lk = (tid % 2) * 4;  // the float4 this thread loads: row lr, k lk .. lk + 3
  const long long ar = m0 + lr;
  const int wr = n0 + lr;
  float acc[8][8] = {};
  float4 a4, w4;
  auto fetch = [&](int k0) {
    const int k = k0 + lk;
    a4 = ar < M && k < K ? *reinterpret_cast<const float4*>(A + ar * K + k) : make_float4(0.f, 0.f, 0.f, 0.f);
    w4 = wr < N && k < K ? *reinterpret_cast<const float4*>(W + (long long)wr * K + k) : make_float4(0.f, 0.f, 0.f, 0.f);
  };
  auto stash = [&](int buf) {
    sA[buf][lk + 0][lr] = a4.x; sA[buf][lk + 1][lr] = a4.y; sA[buf][lk + 2][lr] = a4.z; sA[buf][lk + 3][lr] = a4.w;
    sW[buf][lk + 0][lr] = w4.x; sW[buf][lk + 1][lr] = w4.y; sW[buf][lk + 2][lr] = w4.z; sW[buf][lk + 3][lr] = w4.w;
  };
  fetch(0);
  stash(0);
  __syncthreads();
  int buf = 0;
  for (int k0 = 0; k0 < K; k0 += 8) {
    const bool more = k0 + 8 < K;
    if (more) fetch(k0 + 8);  // the next k-tile's loads fly during this one's FMAs
#pragma unroll
    for (int kk = 0; kk < 8; ++kk) {
      float a[8], w[8];
      *reinterpret_cast<float4*>(a) = *reinterpret_cast<const float4*>(&sA[buf][kk][4 * ty]);
      *reinterpret_cast<float4*>(a + 4) = *reinterpret_cast<const float4*>(&sA[buf][kk][64 + 4 * ty]);
      *reinterpret_cast<float4*>(w) = *reinterpret_cast<const float4*>(&sW[buf][kk][4 * tx]);
      *reinterpret_cast<float4*>(w + 4) = *reinterpret_cast<const float4*>(&sW[buf][kk][64 + 4 * tx]);
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], w[j], acc[i][j]);
    }
    if (more) {
      stash(buf ^ 1);
      __syncthreads();
      buf ^= 1;
    }
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const long long r = m0 + (i < 4 ? 4 * ty + i : 64 + 4 * ty + i - 4);
    if (r >= M) continue;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int n = n0 + 64 * h + 4 * tx;
      if (n < N) {
        const float4 b = *reinterpret_cast<const float4*>(bias + n);
        *reinterpret_cast<float4*>(out + r * N + n) =
            make_float4(acc[i][4 * h] + b.x, acc[i][4 * h + 1] + b.y, acc[i][4 * h + 2] + b.z, acc[i][4 * h + 3] + b.w);
      }
    }
  }
}

extern "C" int ablate_sgemm(const void* A, const void* W, const void* bias, void* out, int M, int N, int K,
                            void* stream) {
  const dim3 grid((N + 127) / 128, (M + 127) / 128);
  sgemm_128x128<<<grid, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(A), static_cast<const float*>(W), static_cast<const float*>(bias),
      static_cast<float*>(out), M, N, K);
  return cudaGetLastError();
}
"""

# (GEMM, op, instantiation in the profiler's kernel name, M, N, K)
CASES = [("fc1", "mlp", "<true, 1, false,", 50432, 3072, 768), ("fc2", "mlp", "<false, 2, false,", 50432, 768, 3072),
         ("qkv", "attn", "<true, 0, false,", 50432, 2304, 768), ("proj", "attn", "<false, 2, false,", 50432, 768, 768)]


def _build():
    from eqxvision_tpu_torch import _native

    out = _native._BUILD / "ablate_gemm_f32"
    out.mkdir(parents=True, exist_ok=True)
    src, lib = out / "sgemm.cu", out / "libsgemm.so"
    src.write_text(SGEMM_SOURCE)
    cmd = [_native._nvcc(), *_native.NVCC_FLAGS, "-shared", "-o", str(lib), str(src)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed:\n{proc.stdout}\n{proc.stderr}")
    print("\n".join(line for line in (proc.stdout + proc.stderr).splitlines() if "registers" in line or "spill" in line))
    lib = ctypes.CDLL(str(lib))
    lib.ablate_sgemm.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    lib.ablate_sgemm.restype = ctypes.c_int
    return lib


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--iters", type=int, default=10)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("ablate_torch_gemm_f32: needs a CUDA card", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from torch.profiler import ProfilerActivity, profile

    from eqxvision_tpu_torch.ops import attention_half as AH
    from eqxvision_tpu_torch.ops import mlp_half as M

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())
    torch.backends.cuda.matmul.allow_tf32 = False
    lib = _build()
    gen = torch.Generator(device="cuda").manual_seed(0)
    f32 = torch.float32
    x, residual, mlp_params = cs._mlp_inputs(50432, 768, True, f32, gen)
    xa, attn_params = cs._attn_half_inputs(256, 197, 768, f32, gen)
    ops = {"mlp": lambda: M.fused_mlp_half(x, residual, *mlp_params),
           "attn": lambda: AH.fused_attention_half(xa, *attn_params, 12)}
    split_ms = {}
    with torch.inference_mode():
        for op, fn in ops.items():
            fn()
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                for _ in range(args.iters):
                    fn()
                torch.cuda.synchronize()
            for e in prof.key_averages():
                if "gemm_f32_kernel<" in e.key and e.count:
                    split_ms[(op, e.key)] = e.device_time_total / 1e3 / e.count
    for gemm, op, inst, m, n, k in CASES:
        a = torch.randn(m, k, device="cuda", generator=gen)
        w = torch.randn(n, k, device="cuda", generator=gen) * k**-0.5
        bias = torch.randn(n, device="cuda", generator=gen) * 0.1
        out = torch.empty(m, n, device="cuda")
        stream = torch.cuda.current_stream().cuda_stream

        def sgemm():
            err = lib.ablate_sgemm(a.data_ptr(), w.data_ptr(), bias.data_ptr(), out.data_ptr(), m, n, k, stream)
            if err:
                raise RuntimeError(f"ablate_sgemm: CUDA error {err}")

        with torch.inference_mode():
            sgemm_ms = cs._time_ms(sgemm, args.iters)
            library_ms = cs._time_ms(lambda: F.linear(a, w, bias), args.iters)
            ref = F.linear(a[:4096].double(), w.double(), bias.double())
            sgemm_err = float((out[:4096].double() - ref).abs().max())
            lib_err = float((F.linear(a[:4096], w, bias).double() - ref).abs().max())
        hits = [ms for (o, key), ms in split_ms.items() if o == op and inst in key]
        flops = 2 * m * n * k
        split = f"{hits[0]:.4f} ms, {flops / hits[0] / 1e9:.1f} TFLOP/s" if len(hits) == 1 else "not found"
        print(f"{gemm} (M {m}, N {n}, K {k}): CUDA-core SGEMM {sgemm_ms:.4f} ms, {flops / sgemm_ms / 1e9:.1f} TFLOP/s "
              f"(max|err| {sgemm_err:.2e}); split TF32 in its op {split}; F.linear f32 {library_ms:.4f} ms, "
              f"{flops / library_ms / 1e9:.1f} TFLOP/s (max|err| {lib_err:.2e})", flush=True)
        del a, w, out
    return 0


if __name__ == "__main__":
    sys.exit(main())
