// GEMM machinery shared by mlp_half.cu, attention_half.cu and
// window_attention_half.cu:
//
//   out[r, n] = epi(sum_k A'[r, k] * W[n, k])
//
// with W in torch's (out, in) layout, k contiguous, and A' either A itself
// or A normalised row by row with precomputed LayerNorm statistics and the
// LayerNorm affine (applied to the A tile as it lands in shared memory).
// Three independent compile-time choices:
//   kNormA  normalise the A tile with the row statistics (yes / no);
//   kEpi    the epilogue on the f32 accumulator: the bias only; the bias
//           then exact-erf gelu; the bias, an optional per-column scale
//           and a residual; or the accumulator rounded to the output type
//           plus the bias rounded to it (a product and its bias added in
//           the input's type, as the JAX Swin computes its windowed qkv).
//   kMaskRows  rows whose flag in row_valid is 0 read A as zeros (their
//           normalised A is 0, not the LayerNorm's shift): the padding
//           tokens of Swin's windows.
// Every epilogue then rounds once to the output type.
//
// bf16 runs on the tensor cores: 128 x 128 output tiles, 8 warps of 64 x 32,
// mma.sync m16n8k16 with f32 accumulation, operand tiles of depth 32 staged
// by cp.async in a ring of three, fragments read with ldmatrix. The grid is
// one-dimensional with the column tiles of a row panel adjacent, so that the
// panel is read from device memory once and from L2 by its neighbours.
// f32 runs true f32 FMAs on the CUDA cores (no TF32): 64 x 64 tiles, a 4 x 4
// register tile per thread.
// Limits: K and N multiples of 8, A, W and out 16-byte aligned (the callers
// check them).
//
// Everything here has internal linkage: each source that includes the
// header gets its own copy of the kernels it instantiates.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "tensor_core_attention.cuh"

namespace {

using eqx_tc::ldmatrix_x4;
using eqx_tc::mma_bf16;
using eqx_tc::pack_bf16;
using eqx_tc::warp_sum;

constexpr int kGemmThreads = 256;
constexpr int kGemmWarps = kGemmThreads / 32;
// bf16 tensor-core GEMM
constexpr int kBM = 128, kBN = 128, kBK = 32, kStages = 3;
constexpr int kSk = kBK + 8;  // smem row stride: 80 bytes, so 8 ldmatrix rows hit 8 distinct 16-byte bank groups
constexpr int kGemmSmemBytes = kStages * (kBM + kBN) * kSk * 2;
// f32 CUDA-core GEMM
constexpr int kFM = 64, kFN = 64, kFK = 16;

enum Epilogue { kBias = 0, kBiasGelu = 1, kBiasResidual = 2, kRoundedBias = 3 };

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

// x rounded to T and back.
template <typename T>
__device__ __forceinline__ float round_to(float x);
template <>
__device__ __forceinline__ float round_to<float>(float x) { return x; }
template <>
__device__ __forceinline__ float round_to<__nv_bfloat16>(float x) { return __bfloat162float(__float2bfloat16(x)); }

// Element i of a vector stored in f32 (bf16 == false) or bf16, in f32.
__device__ __forceinline__ float param(const void* p, bool bf16, int i) {
  return bf16 ? __bfloat162float(static_cast<const __nv_bfloat16*>(p)[i]) : static_cast<const float*>(p)[i];
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool pred) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  const int bytes = pred ? 16 : 0;  // 0: the 16 bytes are zero-filled and nothing is read
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(gmem), "r"(bytes));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

struct GemmArgs {
  const void* a;  // (M, K) in T
  const void* w;  // (N, K) in T
  void* out;      // (M, N) in T
  long long M;
  int N, K;
  const float2* stats;   // kNormA: (M,) row mean and rstd of A
  const void* ln_w;      // kNormA: (K,) LayerNorm affine
  const void* ln_b;
  const void* bias;      // (N,)
  const void* scale;     // kBiasResidual: (N,) column scale, or null for 1
  const void* residual;  // kBiasResidual: (M, N) in T
  bool param_bf16;       // ln_w, ln_b, bias and scale are bf16 (else f32)
  const unsigned char* row_valid;  // kMaskRows: (valid_period,) flags, row r reads row_valid[r % valid_period]
  long long valid_period;
};

template <bool kMaskRows>
__device__ __forceinline__ bool row_reads_a(const GemmArgs& p, long long r) {
  if constexpr (kMaskRows) {
    return r < p.M && p.row_valid[r % p.valid_period] != 0;
  } else {
    return r < p.M;
  }
}

template <typename T, int kEpi>
__device__ __forceinline__ float epilogue(const GemmArgs& p, long long r, int n, float acc) {
  if constexpr (kEpi == kRoundedBias) {
    return round_to<T>(acc) + round_to<T>(param(p.bias, p.param_bf16, n));
  } else {
    float y = acc + param(p.bias, p.param_bf16, n);
    if constexpr (kEpi == kBiasGelu) {
      return 0.5f * y * (1.f + erff(y * 0.70710678118654752f));
    } else if constexpr (kEpi == kBiasResidual) {
      if (p.scale != nullptr) y *= param(p.scale, p.param_bf16, n);
      return to_f32(static_cast<const T*>(p.residual)[r * p.N + n]) + y;
    } else {
      return y;
    }
  }
}

// (mean, rstd) of each row, one warp per row; rows are 16-byte aligned and
// dim a multiple of 16 / sizeof(T). The mean is summed about the row's
// first value and the variance taken over the centred values, so a row of
// 1e3 + N(0, 1) keeps its variance.
template <typename T>
__global__ void __launch_bounds__(kGemmThreads)
    row_stats_kernel(const T* __restrict__ x, float2* __restrict__ stats, long long rows, int dim, float eps) {
  constexpr int E = 16 / sizeof(T);
  const long long row = (long long)blockIdx.x * kGemmWarps + threadIdx.x / 32;
  if (row >= rows) return;  // whole warps leave together
  const int lane = threadIdx.x % 32, nvec = dim / E;
  const T* src = x + row * dim;
  const uint4* vsrc = reinterpret_cast<const uint4*>(src);
  const float pivot = to_f32(src[0]);
  float sum = 0.f;
  for (int v = lane; v < nvec; v += 32) {
    const uint4 raw = vsrc[v];
    const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
    for (int u = 0; u < E; ++u) sum += to_f32(e[u]) - pivot;
  }
  const float inv_d = 1.f / dim;
  const float mean = pivot + warp_sum(sum) * inv_d;
  float sq = 0.f;
  for (int v = lane; v < nvec; v += 32) {
    const uint4 raw = vsrc[v];
    const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
    for (int u = 0; u < E; ++u) {
      const float c = to_f32(e[u]) - mean;
      sq += c * c;
    }
  }
  const float rstd = rsqrtf(warp_sum(sq) * inv_d + eps);
  if (lane == 0) stats[row] = make_float2(mean, rstd);
}

template <typename T>
cudaError_t launch_row_stats(const void* x, float2* stats, long long rows, int dim, float eps, cudaStream_t stream) {
  const long long blocks = (rows + kGemmWarps - 1) / kGemmWarps;
  if (blocks > INT_MAX) return cudaErrorInvalidValue;
  row_stats_kernel<T><<<(unsigned)blocks, kGemmThreads, 0, stream>>>(static_cast<const T*>(x), stats, rows, dim, eps);
  return cudaGetLastError();
}

// bf16 on the tensor cores. Block tile kBM x kBN; warp w computes rows
// 64 * (w % 2) .. +64 and columns 32 * (w / 2) .. +32 as 4 x 4 m16n8 tiles.
// Each thread copies two 16-byte pieces of each operand tile: rows lr and
// lr + 64, columns lc .. lc + 8 of the k-tile.
template <bool kNormA, int kEpi, bool kMaskRows = false>
__global__ void __launch_bounds__(kGemmThreads, 2) gemm_bf16_kernel(GemmArgs p) {
  using bf16 = __nv_bfloat16;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* sA = reinterpret_cast<bf16*>(smem);  // kStages x kBM x kSk
  bf16* sB = sA + kStages * kBM * kSk;       // kStages x kBN x kSk
  const int n_tiles = (p.N + kBN - 1) / kBN;
  const long long m0 = (long long)(blockIdx.x / n_tiles) * kBM;
  const int n0 = (blockIdx.x % n_tiles) * kBN;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wm = (warp % 2) * 64, wn = (warp / 2) * 32;
  const bf16* A = static_cast<const bf16*>(p.a);
  const bf16* W = static_cast<const bf16*>(p.w);
  const int k_tiles = (p.K + kBK - 1) / kBK;

  const int lr = threadIdx.x / 4, lc = (threadIdx.x % 4) * 8;
  bool a_ok[2], w_ok[2];
  const bf16* a_src[2];
  const bf16* w_src[2];
  float mean[2] = {0.f, 0.f}, rstd[2] = {0.f, 0.f};
#pragma unroll
  for (int q = 0; q < 2; ++q) {
    const long long r = m0 + lr + 64 * q;
    const int n = n0 + lr + 64 * q;
    a_ok[q] = row_reads_a<kMaskRows>(p, r);
    w_ok[q] = n < p.N;
    a_src[q] = A + (a_ok[q] ? r : 0) * p.K;
    w_src[q] = W + (long long)(w_ok[q] ? n : 0) * p.K;
    if constexpr (kNormA) {
      if (a_ok[q]) {
        const float2 s = p.stats[r];
        mean[q] = s.x;
        rstd[q] = s.y;
      }
    }
  }

  auto load_tile = [&](int kt, int stage) {
    const int k = kt * kBK + lc;
    const bool k_ok = k < p.K;  // K % 8 == 0: a piece is wholly in or out
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      cp_async16(sA + (stage * kBM + lr + 64 * q) * kSk + lc, a_src[q] + (k_ok ? k : 0), a_ok[q] && k_ok);
      cp_async16(sB + (stage * kBN + lr + 64 * q) * kSk + lc, w_src[q] + (k_ok ? k : 0), w_ok[q] && k_ok);
    }
  };

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < k_tiles) load_tile(s, s);
    cp_async_commit();
  }

  float acc[4][4][4] = {};
  for (int kt = 0; kt < k_tiles; ++kt) {
    cp_async_wait<kStages - 2>();  // this thread's pieces of tile kt have landed
    const int stage = kt % kStages;
    if constexpr (kNormA) {
      // LayerNorm of this thread's own pieces of the A tile, in place,
      // rounded to bf16; padding (rows past M or masked, k past K) stays zero
      const int k = kt * kBK + lc;
      if (k < p.K) {
        float g[8], b[8];
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          g[e] = param(p.ln_w, p.param_bf16, k + e);
          b[e] = param(p.ln_b, p.param_bf16, k + e);
        }
#pragma unroll
        for (int q = 0; q < 2; ++q) {
          if (!a_ok[q]) continue;
          uint4* piece = reinterpret_cast<uint4*>(sA + (stage * kBM + lr + 64 * q) * kSk + lc);
          uint4 raw = *piece;
          bf16* v = reinterpret_cast<bf16*>(&raw);
#pragma unroll
          for (int e = 0; e < 8; ++e) v[e] = __float2bfloat16((__bfloat162float(v[e]) - mean[q]) * rstd[q] * g[e] + b[e]);
          *piece = raw;
        }
      }
    }
    __syncthreads();  // tile kt is visible to every warp, and every warp is done with tile kt - 1
    if (kt + kStages - 1 < k_tiles) load_tile(kt + kStages - 1, (kt + kStages - 1) % kStages);
    cp_async_commit();

    // this lane's ldmatrix rows: A row wm + lane % 16 at k + 8 * (lane / 16);
    // B row (an n) wn + lane % 8 + 8 * (lane / 16) at k + 8 * (lane / 8 % 2)
    const bf16* a_row = sA + (stage * kBM + wm + lane % 16) * kSk + 8 * (lane / 16);
    const bf16* b_row = sB + (stage * kBN + wn + lane % 8 + 8 * (lane / 16)) * kSk + 8 * (lane / 8 % 2);
#pragma unroll
    for (int ks = 0; ks < kBK; ks += 16) {
      uint32_t a[4][4], b01[4], b23[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) ldmatrix_x4(a[i], a_row + i * 16 * kSk + ks);
      ldmatrix_x4(b01, b_row + ks);             // n8 tiles 0 and 1: {b0, b1} of each
      ldmatrix_x4(b23, b_row + 16 * kSk + ks);  // n8 tiles 2 and 3
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        mma_bf16(acc[i][0], a[i], b01[0], b01[1]);
        mma_bf16(acc[i][1], a[i], b01[2], b01[3]);
        mma_bf16(acc[i][2], a[i], b23[0], b23[1]);
        mma_bf16(acc[i][3], a[i], b23[2], b23[3]);
      }
    }
  }
  cp_async_wait<0>();

  // accumulator (i, j, e): row wm + 16 i + g + 8 (e / 2), column wn + 8 j + 2 t + e % 2
  const int g = lane >> 2, t = lane & 3;
  bf16* out = static_cast<bf16*>(p.out);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const long long r = m0 + wm + 16 * i + g + 8 * h;
      if (r >= p.M) continue;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int n = n0 + wn + 8 * j + 2 * t;  // N is even: n + 1 < N with n
        if (n >= p.N) continue;
        const float y0 = epilogue<bf16, kEpi>(p, r, n, acc[i][j][2 * h]);
        const float y1 = epilogue<bf16, kEpi>(p, r, n + 1, acc[i][j][2 * h + 1]);
        *reinterpret_cast<uint32_t*>(out + r * p.N + n) = pack_bf16(__float2bfloat16(y0), __float2bfloat16(y1));
      }
    }
  }
}

// f32 on the CUDA cores. Block tile kFM x kFN; thread (tx, ty) of 16 x 16
// computes rows ty + 16 i and columns tx + 16 j. Each k-tile of A and W is
// read as one float4 a thread (row lr, k piece lk) and stored k-major.
template <bool kNormA, int kEpi, bool kMaskRows = false>
__global__ void __launch_bounds__(kGemmThreads) gemm_f32_kernel(GemmArgs p) {
  __shared__ float sA[kFK][kFM + 4];
  __shared__ float sB[kFK][kFN + 4];
  const int n_tiles = (p.N + kFN - 1) / kFN;
  const long long m0 = (long long)(blockIdx.x / n_tiles) * kFM;
  const int n0 = (blockIdx.x % n_tiles) * kFN;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int lr = threadIdx.x / 4, lk = (threadIdx.x % 4) * 4;
  const long long ar = m0 + lr;
  const bool a_ok = row_reads_a<kMaskRows>(p, ar), w_ok = n0 + lr < p.N;
  const float* a_src = static_cast<const float*>(p.a) + (a_ok ? ar : 0) * p.K;
  const float* w_src = static_cast<const float*>(p.w) + (long long)(w_ok ? n0 + lr : 0) * p.K;
  float mean = 0.f, rstd = 0.f;
  if constexpr (kNormA) {
    if (a_ok) {
      const float2 s = p.stats[ar];
      mean = s.x;
      rstd = s.y;
    }
  }
  float acc[4][4] = {};
  for (int k0 = 0; k0 < p.K; k0 += kFK) {
    const int k = k0 + lk;
    const bool k_ok = k < p.K;  // K % 4 == 0
    float4 a = a_ok && k_ok ? *reinterpret_cast<const float4*>(a_src + k) : make_float4(0.f, 0.f, 0.f, 0.f);
    const float4 w = w_ok && k_ok ? *reinterpret_cast<const float4*>(w_src + k) : make_float4(0.f, 0.f, 0.f, 0.f);
    if constexpr (kNormA) {
      if (a_ok && k_ok) {
        float* v = reinterpret_cast<float*>(&a);
#pragma unroll
        for (int e = 0; e < 4; ++e)
          v[e] = (v[e] - mean) * rstd * param(p.ln_w, p.param_bf16, k + e) + param(p.ln_b, p.param_bf16, k + e);
      }
    }
    __syncthreads();  // the previous tile's readers are done
    sA[lk + 0][lr] = a.x;
    sA[lk + 1][lr] = a.y;
    sA[lk + 2][lr] = a.z;
    sA[lk + 3][lr] = a.w;
    sB[lk + 0][lr] = w.x;
    sB[lk + 1][lr] = w.y;
    sB[lk + 2][lr] = w.z;
    sB[lk + 3][lr] = w.w;
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kFK; ++kk) {
      float av[4], bv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) av[i] = sA[kk][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) bv[j] = sB[kk][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
  }
  float* out = static_cast<float*>(p.out);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const long long r = m0 + ty + 16 * i;
    if (r >= p.M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx + 16 * j;
      if (n < p.N) out[r * p.N + n] = epilogue<float, kEpi>(p, r, n, acc[i][j]);
    }
  }
}

template <typename T, bool kNormA, int kEpi, bool kMaskRows = false>
cudaError_t launch_gemm(const GemmArgs& p, cudaStream_t stream) {
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    const long long blocks = ((p.M + kBM - 1) / kBM) * ((p.N + kBN - 1) / kBN);
    if (blocks > INT_MAX) return cudaErrorInvalidValue;
    auto kernel = gemm_bf16_kernel<kNormA, kEpi, kMaskRows>;
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kGemmSmemBytes);
    if (err != cudaSuccess) return err;
    kernel<<<(unsigned)blocks, kGemmThreads, kGemmSmemBytes, stream>>>(p);
  } else {
    const long long blocks = ((p.M + kFM - 1) / kFM) * ((p.N + kFN - 1) / kFN);
    if (blocks > INT_MAX) return cudaErrorInvalidValue;
    gemm_f32_kernel<kNormA, kEpi, kMaskRows><<<(unsigned)blocks, kGemmThreads, 0, stream>>>(p);
  }
  return cudaGetLastError();
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

}  // namespace
