// Scaled dot-product attention with a compact additive bias.
//
// Replaces the Pallas TPU kernels _attn_kernel and the kernel4 closure
// (eqxvision_tpu/ops/attention.py, launched from _attention_pallas) behind
// the public ops.attention. It computes what _attn_compute computes there:
//
//   q, k, v (B, N, Dh); bias (Bb, N, N) with B % Bb == 0, or none
//   out[b, i] = softmax(q_i . K_b^T * scale + bias[b % Bb, i]) . V_b
//
// with the scores, the bias and the softmax in f32, the probabilities
// rounded to v's type before p.V, p.V accumulated in f32 and the output
// stored in q's type. The compact bias is read through its own index,
// b % Bb, and never broadcast into a (B, N, N) copy: that reuse over batch
// repeats is what kernel4 was for. The TPU kernels pad N to the sublane
// and mask the padded keys; here the ragged tail is masked in the kernel
// and nothing is padded in device memory.
//
// Design. Two paths, chosen from dtype and shape:
// - bf16 with N <= 64 and a head dim that is a multiple of 16 (at most 64):
//   one block of 8 warps per row b on the tensor cores. The block stages
//   q|k|v of row b in shared memory (rows past N zero) and runs the head
//   attention of tensor_core_attention.cuh, the one the window-attention
//   and whole-block kernels use (S = Q K^T and O = P V with mma.sync, the
//   softmax by one warp per row between them).
// - otherwise (f32, longer rows, other head dims): the CUDA-core design of
//   the fused-qkv kernel. One block of 8 warps per (row b, tile of 32
//   queries) stages K and V of row b in shared memory in the input type
//   and its q rows in f32; each lane keeps a 4 x 4 register tile of scores
//   (4 query rows x 4 keys of a 128-key chunk), the softmax runs per row
//   with warp shuffles, and each lane accumulates output columns lane,
//   lane + 32, ... K's row stride is an odd number of 32-bit words, so 32
//   lanes reading 32 rows hit 32 banks.
//
// What bounds it. It must read q, k, v and the compact bias once and write
// the output once. At swin_t stage 1 through this op (B = 24,576, N = 49,
// Dh = 32, bf16, Bb = 192) that is 0.31 GB, 0.093 ms at 3.35 TB/s, against
// 9.4 GFLOP (0.01 ms on the tensor cores); at vit_base b256 (B = 3,072,
// N = 197, Dh = 64, bf16, no bias) 0.31 GB and 0.093 ms against 30.5
// GFLOP (0.03 ms). Both are bound by device memory. The CUDA-core path
// runs its products on the f32 CUDA cores and is bound by those and by
// its shared-memory reads (the fused-qkv kernel runs 39x its bound this
// way). Limits: head_dim <= 128, and one row's K and V must fit in shared
// memory (N up to about 570 at Dh = 64 in bf16); the entry point returns
// cudaErrorInvalidValue outside them.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

#include "tensor_core_attention.cuh"

namespace {

constexpr int kWarps = 8;
constexpr int kRowsPerWarp = 4;
constexpr int kTileRows = kWarps * kRowsPerWarp;
constexpr int kKeysPerLane = 4;
constexpr int kMaxHeadDim = 128;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) { return __float2bfloat16(x); }

__host__ __device__ __forceinline__ int padded_len(int seq_len) { return (seq_len + 3) & ~3; }

// Row stride of the staged K and V, in elements: at least head_dim, and an
// odd number of 32-bit words.
__host__ __device__ __forceinline__ int kv_stride(int head_dim, int elem_bytes) {
  int words = (head_dim * elem_bytes + 3) / 4;
  if (words % 2 == 0) words += 1;
  return words * 4 / elem_bytes;
}

size_t smem_bytes(int seq_len, int head_dim, int elem_bytes) {
  const size_t lp = padded_len(seq_len);
  return kTileRows * lp * sizeof(float)                      // scores / probabilities
         + kTileRows * (size_t)head_dim * sizeof(float)       // q rows
         + 2 * lp * kv_stride(head_dim, elem_bytes) * elem_bytes;  // K and V
}

// NI: output columns per lane, ceil(head_dim / 32).
template <typename T, int NI>
__global__ void __launch_bounds__(kWarps * 32, 2)
    attention_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                     const float* __restrict__ bias, T* __restrict__ out, int n_bias, int seq_len, int head_dim,
                     float scale, int n_tiles) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int L = seq_len, Dh = head_dim;
  const int lp = padded_len(L);
  const int ks = kv_stride(Dh, sizeof(T));
  float* s_all = reinterpret_cast<float*>(smem);
  float* q_all = s_all + kTileRows * lp;
  T* k_s = reinterpret_cast<T*>(q_all + kTileRows * Dh);
  T* v_s = k_s + lp * ks;

  const int tile = blockIdx.x % n_tiles;
  const long long b = blockIdx.x / n_tiles;
  const long long base = b * L * Dh;
  const int row0 = tile * kTileRows;
  const float* bias_b = bias == nullptr ? nullptr : bias + (b % n_bias) * L * L;

  const T zero = from_f32<T>(0.f);
  for (int idx = threadIdx.x; idx < lp * Dh; idx += blockDim.x) {
    const int j = idx / Dh, d = idx - j * Dh;
    const bool in = j < L;
    k_s[j * ks + d] = in ? k[base + idx] : zero;
    v_s[j * ks + d] = in ? v[base + idx] : zero;
  }
  for (int idx = threadIdx.x; idx < kTileRows * Dh; idx += blockDim.x) {
    const int i = row0 + idx / Dh;
    q_all[idx] = i < L ? to_f32(q[base + (long long)row0 * Dh + idx]) : 0.f;
  }
  __syncthreads();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  float* s_w = s_all + warp * kRowsPerWarp * lp;
  const float* q_w = q_all + warp * kRowsPerWarp * Dh;
  const int wrow0 = row0 + warp * kRowsPerWarp;

  // Scores, scaled after the dot and then biased, as the reference does.
  for (int j0 = 0; j0 < L; j0 += 32 * kKeysPerLane) {
    float acc[kRowsPerWarp][kKeysPerLane] = {};
    int k_off[kKeysPerLane];
#pragma unroll
    for (int c = 0; c < kKeysPerLane; ++c) k_off[c] = min(j0 + lane + 32 * c, lp - 1) * ks;
    for (int d = 0; d < Dh; ++d) {
      float kf[kKeysPerLane];
#pragma unroll
      for (int c = 0; c < kKeysPerLane; ++c) kf[c] = to_f32(k_s[k_off[c] + d]);
#pragma unroll
      for (int r = 0; r < kRowsPerWarp; ++r) {
        const float qv = q_w[r * Dh + d];
#pragma unroll
        for (int c = 0; c < kKeysPerLane; ++c) acc[r][c] = fmaf(qv, kf[c], acc[r][c]);
      }
    }
#pragma unroll
    for (int c = 0; c < kKeysPerLane; ++c) {
      const int j = j0 + lane + 32 * c;
      if (j < L) {
#pragma unroll
        for (int r = 0; r < kRowsPerWarp; ++r) {
          const int i = min(wrow0 + r, L - 1);  // rows past L are computed and not stored
          s_w[r * lp + j] = acc[r][c] * scale + (bias_b ? bias_b[(long long)i * L + j] : 0.f);
        }
      }
    }
  }
  __syncwarp();

  // Softmax per row; probabilities rounded to T as the reference rounds
  // them before p.V. Columns L..lp-1 get probability 0.
  for (int r = 0; r < kRowsPerWarp; ++r) {
    float* s = s_w + r * lp;
    float m = -INFINITY;
    for (int j = lane; j < L; j += 32) m = fmaxf(m, s[j]);
    m = eqx_tc::warp_max(m);
    float sum = 0.f;
    for (int j = lane; j < L; j += 32) {
      const float e = expf(s[j] - m);
      s[j] = e;
      sum += e;
    }
    sum = eqx_tc::warp_sum(sum);
    for (int j = lane; j < lp; j += 32) s[j] = j < L ? to_f32(from_f32<T>(s[j] / sum)) : 0.f;
  }
  __syncwarp();

  float o[kRowsPerWarp][NI] = {};
  for (int j = 0; j < lp; j += 4) {
    float4 p[kRowsPerWarp];
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) p[r] = *reinterpret_cast<const float4*>(s_w + r * lp + j);
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
      const T* v_row = v_s + (j + jj) * ks;
#pragma unroll
      for (int n = 0; n < NI; ++n) {
        const int d = lane + 32 * n;
        const float vv = d < Dh ? to_f32(v_row[d]) : 0.f;
#pragma unroll
        for (int r = 0; r < kRowsPerWarp; ++r) {
          const float pr = jj == 0 ? p[r].x : jj == 1 ? p[r].y : jj == 2 ? p[r].z : p[r].w;
          o[r][n] = fmaf(pr, vv, o[r][n]);
        }
      }
    }
  }

#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    const int i = wrow0 + r;
    if (i >= L) continue;
    T* dst = out + base + (long long)i * Dh;
#pragma unroll
    for (int n = 0; n < NI; ++n) {
      const int d = lane + 32 * n;
      if (d < Dh) dst[d] = from_f32<T>(o[r][n]);
    }
  }
}

template <typename T, int NI>
cudaError_t launch(const void* q, const void* k, const void* v, const float* bias, void* out, int batch, int n_bias,
                   int seq_len, int head_dim, float scale, cudaStream_t stream) {
  const size_t smem = smem_bytes(seq_len, head_dim, sizeof(T));
  int device = 0, max_smem = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&max_smem, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (err != cudaSuccess) return err;
  if (smem > (size_t)max_smem) return cudaErrorInvalidValue;
  const int n_tiles = (seq_len + kTileRows - 1) / kTileRows;
  const long long blocks = (long long)batch * n_tiles;
  if (blocks > INT_MAX) return cudaErrorInvalidValue;
  auto kernel = attention_kernel<T, NI>;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kernel<<<(unsigned)blocks, kWarps * 32, smem, stream>>>(static_cast<const T*>(q), static_cast<const T*>(k),
                                                            static_cast<const T*>(v), bias, static_cast<T*>(out),
                                                            n_bias, seq_len, head_dim, scale, n_tiles);
  return cudaGetLastError();
}

// bf16 rows of at most 64 tokens with a head dim that is a multiple of 16,
// and q, k, v on 4-byte boundaries: the tensor cores.
bool takes_tensor_cores(int dtype, int seq_len, int head_dim, const void* q, const void* k, const void* v) {
  const bool aligned = (reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
                        reinterpret_cast<uintptr_t>(v)) % 4 == 0;
  return dtype == 1 && seq_len <= eqx_tc::kRows && head_dim % 16 == 0 && head_dim <= 64 && aligned;
}

// Row stride of the staged q|k|v: 3 * Dh + 2 elements, an odd number of
// 32-bit words for head dims that are multiples of 16.
__host__ __device__ __forceinline__ int qkv_stride(int head_dim) { return 3 * head_dim + 2; }

size_t smem_bytes_mma(int head_dim) {
  return (size_t)eqx_tc::kRows * qkv_stride(head_dim) * sizeof(__nv_bfloat16)  // q|k|v
         + (size_t)eqx_tc::kRows * eqx_tc::kSs * sizeof(float)                // scores, then p
         + 2 * (size_t)eqx_tc::kRows * sizeof(float);                         // unit row scales of q and k
}

__global__ void __launch_bounds__(eqx_tc::kThreads)
    attention_mma_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                         const __nv_bfloat16* __restrict__ v, const float* __restrict__ bias,
                         __nv_bfloat16* __restrict__ out, int n_bias, int seq_len, int head_dim, float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int L = seq_len, Dh = head_dim, sq = qkv_stride(Dh);
  __nv_bfloat16* qkvh = reinterpret_cast<__nv_bfloat16*>(smem);
  float* s_buf = reinterpret_cast<float*>(smem + (size_t)eqx_tc::kRows * sq * sizeof(__nv_bfloat16));
  float* ones = s_buf + eqx_tc::kRows * eqx_tc::kSs;

  const long long b = blockIdx.x;
  const long long base = b * L * Dh;
  const __nv_bfloat16* src[3] = {q + base, k + base, v + base};
  const int pairs = 3 * Dh / 2;  // 32-bit pieces of a row's q|k|v
  for (int e = threadIdx.x; e < eqx_tc::kRows * pairs; e += eqx_tc::kThreads) {
    const int r = e / pairs, c = (e % pairs) * 2;
    const uint32_t val = r < L ? eqx_tc::ld32(src[c / Dh] + r * Dh + c % Dh) : 0u;
    *reinterpret_cast<uint32_t*>(qkvh + r * sq + c) = val;
  }
  for (int r = threadIdx.x; r < 2 * eqx_tc::kRows; r += eqx_tc::kThreads) ones[r] = 1.f;
  __syncthreads();
  eqx_tc::attention_head_mma(qkvh, sq, Dh, L, ones, ones + eqx_tc::kRows, scale,
                             bias == nullptr ? nullptr : bias + (b % n_bias) * L * L, s_buf, out + base, Dh);
}

cudaError_t launch_mma(const void* q, const void* k, const void* v, const float* bias, void* out, int batch,
                       int n_bias, int seq_len, int head_dim, float scale, cudaStream_t stream) {
  const size_t smem = smem_bytes_mma(head_dim);
  cudaError_t err =
      cudaFuncSetAttribute(attention_mma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  attention_mma_kernel<<<batch, eqx_tc::kThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), bias, static_cast<__nv_bfloat16*>(out), n_bias, seq_len, head_dim,
      scale);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. q, k, v and out (batch, seq_len,
// head_dim); bias (n_bias, seq_len, seq_len) f32 with batch % n_bias == 0,
// or null; all contiguous on the current device. Launches on `stream` and
// returns the cudaError_t of the launch.
int eqx_attention(const void* q, const void* k, const void* v, const void* bias, void* out, int batch, int n_bias,
                  int seq_len, int head_dim, float scale, int dtype, void* stream) {
  if (batch <= 0 || n_bias <= 0 || batch % n_bias != 0 || seq_len <= 0 || head_dim <= 0 ||
      head_dim > kMaxHeadDim)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* b = static_cast<const float*>(bias);
  const bool narrow = head_dim <= 64;
  if (dtype == 0)
    return narrow ? launch<float, 2>(q, k, v, b, out, batch, n_bias, seq_len, head_dim, scale, s)
                  : launch<float, 4>(q, k, v, b, out, batch, n_bias, seq_len, head_dim, scale, s);
  if (dtype != 1) return cudaErrorInvalidValue;
  if (takes_tensor_cores(dtype, seq_len, head_dim, q, k, v))
    return launch_mma(q, k, v, b, out, batch, n_bias, seq_len, head_dim, scale, s);
  return narrow ? launch<__nv_bfloat16, 2>(q, k, v, b, out, batch, n_bias, seq_len, head_dim, scale, s)
                : launch<__nv_bfloat16, 4>(q, k, v, b, out, batch, n_bias, seq_len, head_dim, scale, s);
}

// Dynamic shared memory one block of the CUDA-core path needs (the
// tensor-core path needs about 30 KB at any size it takes); for error messages.
long long eqx_attention_smem_bytes(int seq_len, int head_dim, int elem_bytes) {
  return (long long)smem_bytes(seq_len, head_dim, elem_bytes);
}

}  // extern "C"
