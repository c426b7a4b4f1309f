// Swin window attention read straight out of a fused qkv projection.
//
// Replaces the Pallas TPU kernels _window_qkv_kernel and
// _packed_window_kernel (eqxvision_tpu/ops/attention.py, launched from
// _window_qkv_attention and _packed_window_attention). Both compute one
// function on two layouts; this kernel computes it on the unpadded one:
//
//   qkv  (B*nW, L, 3*H*Dh) laid out [q heads | k heads | v heads]
//   bias (nWb, H, L, L) f32, window w reads bias[w % nWb]
//   out[bw, i, h*Dh:(h+1)*Dh] = softmax(q_i . K^T * scale + bias[w, h, i]) . V
//
// with the scores and the softmax in f32, the probabilities rounded to the
// input type, and p.V accumulated in f32 and stored in the input type, as
// window_qkv_attention_reference does. With cosine_gs (Swin v2) q and k are
// L2-normalised per head and row (norm floored at 1e-12) and q is
// multiplied by its head's gs, all in f32: the normalised q stays in f32
// registers, and k keeps its input-type values beside an f32 inverse norm
// per row that scales its scores.
// The TPU kernels' 128-lane padding of C, head-masked K/V stacks and
// segment-sum softmax are layout devices of that chip. Here the softmax is
// per head and exact, so no head can underflow against another.
//
// Design. bf16 windows of at most 64 tokens with a head dim that is a
// multiple of 16 (every Swin stage in bf16) take the tensor cores: one
// block of 8 warps per (window, head) stages the head's q|k|v rows and
// runs the attention of tensor_core_attention.cuh, the one the whole-block
// kernel uses (S = Q K^T and O = P V with mma.sync, the softmax by one warp
// per row between them). Other shapes and f32 take the CUDA cores:
// one block of 4 warps per (window, head). The block stages that
// head's K and V in shared memory in the input type (one warp per row,
// with K's inverse row norms in cosine mode), reading them with strides
// out of the qkv rows.
// Each warp then takes query rows in turn: q goes to a per-warp f32
// buffer, each lane computes the scores of keys lane, lane+32, ... and
// writes them to a per-warp score row, warp shuffles give the row's max
// and sum, and each lane accumulates output columns lane and lane+32.
// K's row stride is an odd number of 32-bit words, so 32 lanes reading 32
// rows at one column hit 32 banks.
//
// What bounds it. At swin_t stage 3, b128 bf16 (B*nW=512, L=49, H=12,
// Dh=32), one call reads 57.8 MB of qkv and 0.5 MB of bias and writes
// 19.3 MB, 0.023 ms at 3.35 TB/s; its 1.9 GFLOP take 0.002 ms on the tensor
// cores. The bound is device memory. Each (window, head) pair is one block
// that reads its bytes once; the CUDA-core path spends its time in serial
// per-row FMA chains on shared-memory operands, the tensor-core path in
// its staging and barriers. Limits: head_dim <= 64; one head's K and V
// must fit in shared memory (L up to several hundred); the entry point
// returns cudaErrorInvalidValue outside them.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

#include "tensor_core_attention.cuh"

namespace {

constexpr int kWarps = 4;
constexpr int kMaxHeadDim = 64;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) { return __float2bfloat16(x); }

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// Row stride of the staged K and V, in elements: at least head_dim, and an
// odd number of 32-bit words.
__host__ __device__ __forceinline__ int kv_stride(int head_dim, int elem_bytes) {
  int words = (head_dim * elem_bytes + 3) / 4;
  if (words % 2 == 0) words += 1;
  return words * 4 / elem_bytes;
}

size_t smem_bytes(int seq_len, int head_dim, int elem_bytes) {
  return 2 * (size_t)seq_len * kv_stride(head_dim, elem_bytes) * elem_bytes  // K and V
         + kWarps * (size_t)seq_len * sizeof(float)                         // score rows
         + kWarps * (size_t)kMaxHeadDim * sizeof(float)                     // q rows
         + (size_t)seq_len * sizeof(float);                                 // K's inverse norms
}

// Loads one head's row of q or k (columns lane and lane+32; 0 past
// head_dim) in f32 and returns the inverse of its L2 norm, floored at 1e-12.
template <typename T>
__device__ __forceinline__ float load_head_row(const T* src, int head_dim, int lane, float (&v)[2]) {
#pragma unroll
  for (int t = 0; t < 2; ++t) {
    const int d = lane + 32 * t;
    v[t] = d < head_dim ? to_f32(src[d]) : 0.f;
  }
  return 1.f / fmaxf(sqrtf(warp_sum(v[0] * v[0] + v[1] * v[1])), 1e-12f);
}

template <typename T>
__global__ void __launch_bounds__(kWarps * 32)
    window_attention_kernel(const T* __restrict__ qkv, const float* __restrict__ bias, const float* __restrict__ gs,
                            T* __restrict__ out, int n_windows, int n_bias, int seq_len, int num_heads,
                            int head_dim, float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int L = seq_len, Dh = head_dim;
  const int ks = kv_stride(Dh, sizeof(T));
  T* k_s = reinterpret_cast<T*>(smem);
  T* v_s = k_s + (size_t)L * ks;
  float* s_all = reinterpret_cast<float*>(v_s + (size_t)L * ks);
  float* q_all = s_all + kWarps * L;
  float* k_inv = q_all + kWarps * kMaxHeadDim;

  const int h = blockIdx.x % num_heads;
  const long long bw = blockIdx.x / num_heads;  // image * nW + window
  const int wb = (int)(bw % n_windows) % n_bias;
  const int D = num_heads * Dh;
  const long long row_stride = 3LL * D;
  const T* base = qkv + bw * L * row_stride + h * Dh;
  const float* bias_h = bias + ((long long)wb * num_heads + h) * L * L;
  const bool cosine = gs != nullptr;

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int j = warp; j < L; j += kWarps) {
    const T* row = base + j * row_stride;
    float kv[2];
    const float inv = load_head_row(row + D, Dh, lane, kv);
    if (lane == 0) k_inv[j] = cosine ? inv : 1.f;
#pragma unroll
    for (int t = 0; t < 2; ++t) {
      const int d = lane + 32 * t;
      if (d < Dh) {
        k_s[j * ks + d] = row[D + d];
        v_s[j * ks + d] = row[2 * D + d];
      }
    }
  }
  __syncthreads();

  float* s_w = s_all + warp * L;
  float* q_w = q_all + warp * kMaxHeadDim;
  const float gain = cosine ? gs[h] : 1.f;
  for (int i = warp; i < L; i += kWarps) {
    float qv[2];
    const float inv = load_head_row(base + i * row_stride, Dh, lane, qv);
    const float q_scale = cosine ? gain * inv : 1.f;
    q_w[lane] = qv[0] * q_scale;
    q_w[lane + 32] = qv[1] * q_scale;
    __syncwarp();

    // scores, scaled after the dot as the reference does
    const float* b_row = bias_h + (long long)i * L;
    float m = -INFINITY;
    for (int j = lane; j < L; j += 32) {
      const T* k_row = k_s + j * ks;
      float acc = 0.f;
      for (int d = 0; d < Dh; ++d) acc = fmaf(q_w[d], to_f32(k_row[d]), acc);
      const float s = acc * k_inv[j] * scale + b_row[j];
      s_w[j] = s;
      m = fmaxf(m, s);
    }
    m = warp_max(m);
    float sum = 0.f;
    for (int j = lane; j < L; j += 32) {
      const float e = expf(s_w[j] - m);
      s_w[j] = e;
      sum += e;
    }
    const float inv_sum = 1.f / warp_sum(sum);
    for (int j = lane; j < L; j += 32) s_w[j] = to_f32(from_f32<T>(s_w[j] * inv_sum));
    __syncwarp();

    float o[2] = {0.f, 0.f};
    for (int j = 0; j < L; ++j) {
      const float p = s_w[j];
      const T* v_row = v_s + j * ks;
#pragma unroll
      for (int t = 0; t < 2; ++t) {
        const int d = lane + 32 * t;
        if (d < Dh) o[t] = fmaf(p, to_f32(v_row[d]), o[t]);
      }
    }
    T* dst = out + (bw * L + i) * D + h * Dh;
#pragma unroll
    for (int t = 0; t < 2; ++t) {
      const int d = lane + 32 * t;
      if (d < Dh) dst[d] = from_f32<T>(o[t]);
    }
    __syncwarp();  // s_w and q_w are rewritten by the next row
  }
}

// bf16 windows of at most 64 tokens with a head dim that is a multiple of
// 16: one block of 8 warps per (window, head) on the tensor cores. The
// block stages the head's q|k|v rows in shared memory (rows past L zero)
// and runs eqx_tc::attention_head_mma, whose score tile takes v2's norms as
// f32 row and column scales.
bool takes_tensor_cores(int dtype, int seq_len, int head_dim) {
  return dtype == 1 && seq_len <= eqx_tc::kRows && head_dim % 16 == 0;
}

// Row stride of the staged q|k|v: 3 * Dh + 2 elements, an odd number of
// 32-bit words for head dims that are multiples of 16.
__host__ __device__ __forceinline__ int qkv_stride(int head_dim) { return 3 * head_dim + 2; }

size_t smem_bytes_mma(int head_dim) {
  return (size_t)eqx_tc::kRows * qkv_stride(head_dim) * sizeof(__nv_bfloat16)  // q|k|v, 16-byte multiple
         + (size_t)eqx_tc::kRows * eqx_tc::kSs * sizeof(float)                // scores, then p
         + 2 * (size_t)eqx_tc::kRows * sizeof(float);                         // row scales of q and k
}

__global__ void __launch_bounds__(eqx_tc::kThreads)
    window_attention_mma_kernel(const __nv_bfloat16* __restrict__ qkv, const float* __restrict__ bias,
                                const float* __restrict__ gs, __nv_bfloat16* __restrict__ out, int n_windows,
                                int n_bias, int seq_len, int num_heads, int head_dim, float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int L = seq_len, Dh = head_dim, sq = qkv_stride(Dh);
  __nv_bfloat16* qkvh = reinterpret_cast<__nv_bfloat16*>(smem);
  float* s_buf = reinterpret_cast<float*>(smem + (size_t)eqx_tc::kRows * sq * sizeof(__nv_bfloat16));
  float* q_scale = s_buf + eqx_tc::kRows * eqx_tc::kSs;
  float* k_inv = q_scale + eqx_tc::kRows;

  const int h = blockIdx.x % num_heads;
  const long long bw = blockIdx.x / num_heads;  // image * nW + window
  const int wb = (int)(bw % n_windows) % n_bias;
  const int D = num_heads * Dh;
  const __nv_bfloat16* base = qkv + bw * L * 3LL * D + h * Dh;
  const int pairs = 3 * Dh / 2;  // 32-bit pieces of a row's q|k|v
  for (int e = threadIdx.x; e < eqx_tc::kRows * pairs; e += eqx_tc::kThreads) {
    const int r = e / pairs, c = (e % pairs) * 2;
    const uint32_t v = r < L ? eqx_tc::ld32(base + r * 3LL * D + (c / Dh) * D + c % Dh) : 0u;
    *reinterpret_cast<uint32_t*>(qkvh + r * sq + c) = v;
  }
  for (int r = threadIdx.x; r < eqx_tc::kRows; r += eqx_tc::kThreads) q_scale[r] = k_inv[r] = 1.f;
  __syncthreads();
  if (gs != nullptr) {
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    for (int r = warp; r < L; r += eqx_tc::kWarps) {
      const __nv_bfloat16* row = qkvh + r * sq;
      float q2 = 0.f, k2 = 0.f;
      for (int d = lane; d < Dh; d += 32) {
        const float q = __bfloat162float(row[d]), k = __bfloat162float(row[Dh + d]);
        q2 += q * q;
        k2 += k * k;
      }
      q2 = eqx_tc::warp_sum(q2);
      k2 = eqx_tc::warp_sum(k2);
      if (lane == 0) {
        q_scale[r] = gs[h] / fmaxf(sqrtf(q2), 1e-12f);
        k_inv[r] = 1.f / fmaxf(sqrtf(k2), 1e-12f);
      }
    }
    __syncthreads();
  }
  eqx_tc::attention_head_mma(qkvh, sq, Dh, L, q_scale, k_inv, scale, bias + ((long long)wb * num_heads + h) * L * L,
                             s_buf, out + bw * L * D + h * Dh, D);
}

cudaError_t launch_mma(const void* qkv, const float* bias, const float* gs, void* out, int windows, int n_windows,
                       int n_bias, int seq_len, int num_heads, int head_dim, float scale, cudaStream_t stream) {
  const size_t smem = smem_bytes_mma(head_dim);
  const long long blocks = (long long)windows * num_heads;
  if (blocks > INT_MAX) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(window_attention_mma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return err;
  window_attention_mma_kernel<<<(unsigned)blocks, eqx_tc::kThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(qkv), bias, gs, static_cast<__nv_bfloat16*>(out), n_windows, n_bias, seq_len,
      num_heads, head_dim, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch(const void* qkv, const float* bias, const float* gs, void* out, int windows, int n_windows,
                   int n_bias, int seq_len, int num_heads, int head_dim, float scale, cudaStream_t stream) {
  const size_t smem = smem_bytes(seq_len, head_dim, sizeof(T));
  int device = 0, max_smem = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&max_smem, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (err != cudaSuccess) return err;
  if (smem > (size_t)max_smem) return cudaErrorInvalidValue;
  const long long blocks = (long long)windows * num_heads;
  if (blocks > INT_MAX) return cudaErrorInvalidValue;
  auto kernel = window_attention_kernel<T>;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kernel<<<(unsigned)blocks, kWarps * 32, smem, stream>>>(static_cast<const T*>(qkv), bias, gs, static_cast<T*>(out),
                                                            n_windows, n_bias, seq_len, num_heads, head_dim, scale);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. qkv (windows, seq_len, 3*num_heads*head_dim)
// with windows = images * n_windows, bias (n_bias, num_heads, seq_len, seq_len)
// f32, gs (num_heads,) f32 or null (null: v1, non-null: v2 cosine attention),
// out (windows, seq_len, num_heads*head_dim); all contiguous on the current
// device. Launches on `stream` and returns the cudaError_t of the launch.
int eqx_window_attention(const void* qkv, const void* bias, const void* gs, void* out, int windows, int n_windows,
                         int n_bias, int seq_len, int num_heads, int head_dim, float scale, int dtype, void* stream) {
  if (windows <= 0 || n_windows <= 0 || n_bias <= 0 || seq_len <= 0 || num_heads <= 0 || head_dim <= 0 ||
      head_dim > kMaxHeadDim || windows % n_windows != 0)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* b = static_cast<const float*>(bias);
  const float* g = static_cast<const float*>(gs);
  if (dtype == 0)
    return launch<float>(qkv, b, g, out, windows, n_windows, n_bias, seq_len, num_heads, head_dim, scale, s);
  if (takes_tensor_cores(dtype, seq_len, head_dim))
    return launch_mma(qkv, b, g, out, windows, n_windows, n_bias, seq_len, num_heads, head_dim, scale, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(qkv, b, g, out, windows, n_windows, n_bias, seq_len, num_heads, head_dim, scale,
                                 s);
  return cudaErrorInvalidValue;
}

// Dynamic shared memory one block needs; for error messages and reports.
long long eqx_window_attention_smem_bytes(int seq_len, int head_dim, int elem_bytes) {
  if (takes_tensor_cores(elem_bytes == 2 ? 1 : 0, seq_len, head_dim)) return (long long)smem_bytes_mma(head_dim);
  return (long long)smem_bytes(seq_len, head_dim, elem_bytes);
}

}  // extern "C"
