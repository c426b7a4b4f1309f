// Multi-head attention read straight out of a fused qkv projection.
//
// Replaces the Pallas TPU kernels _qkv_attn_kernel and
// _qkv_attn_kernel_pair (eqxvision_tpu/ops/attention.py, launched from
// _fused_qkv_attention). It computes exactly what _fused_qkv_reference
// computes there:
//
//   qkv (B, L, 3*H*Dh) laid out [q heads | k heads | v heads]
//   out[b, i, h*Dh:(h+1)*Dh] = softmax(q_i . K^T * scale) . V
//
// with the scores and the softmax in f32, the probabilities rounded to the
// input type, and p.V accumulated in f32 and stored in the input type.
// The TPU kernels' 128-lane head pairing and their grouping of batch rows
// per program are layout devices of that chip and are not carried over.
//
// Design. One block of 8 warps per (batch row, head, tile of 32 query
// rows); each warp owns 4 query rows. The block stages that head's K and
// V in shared memory in the input type (one head at L=197, Dh=64, bf16 is
// 50 KB) and its q rows in f32, reading all three straight out of the
// (B, L, 3D) tensor with strides: no transposes, no padding copies.
//   scores:  each lane owns 4 key columns of a 128-column chunk and keeps a
//            4 x 4 register tile (query rows x keys), so one shared-memory
//            read of K feeds 4 FMAs. K's row stride is an odd number of
//            32-bit words, so 32 lanes reading 32 rows hit 32 banks.
//   softmax: per query row in the warp's slice of a shared score buffer,
//            with warp shuffles for the max and the sum.
//   p.V:     each lane owns output columns lane, lane+32, ...; four
//            probabilities are read at once as a float4 broadcast.
// Ragged edges: K/V rows from L up to the next multiple of 4 are zero, and
// their probabilities are zero; query rows past L are computed from zero q
// and not stored.
//
// What bounds it. At ViT-B/16 b256 (L=197, H=12, Dh=64) one call does
// 4*B*H*L^2*Dh = 30.5 GFLOP and moves about 310 MB. This first version
// runs on the f32 CUDA cores (67 TFLOP/s on the data sheet, so >= 0.45 ms)
// and not on the tensor cores (about 31 us of bf16 work), so it is bound by
// its arithmetic and its shared-memory reads, not by device memory.
// Tensor cores (mma.sync / wgmma) and TMA loads are later work.
// Limits: head_dim <= 128, and one head's K and V must fit in shared
// memory (L up to about 570 at Dh=64 in bf16); the entry point returns
// cudaErrorInvalidValue outside them.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>

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
  return kTileRows * lp * sizeof(float)               // scores / probabilities
         + kTileRows * (size_t)head_dim * sizeof(float)  // q rows
         + 2 * lp * kv_stride(head_dim, elem_bytes) * elem_bytes;  // K and V
}

// NI: output columns per lane, ceil(head_dim / 32).
template <typename T, int NI>
__global__ void __launch_bounds__(kWarps * 32, 2)
    fused_qkv_attention_kernel(const T* __restrict__ qkv, T* __restrict__ out, int seq_len, int num_heads,
                               int head_dim, float scale, int n_tiles) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int L = seq_len, Dh = head_dim;
  const int lp = padded_len(L);
  const int ks = kv_stride(Dh, sizeof(T));
  float* s_all = reinterpret_cast<float*>(smem);
  float* q_all = s_all + kTileRows * lp;
  T* k_s = reinterpret_cast<T*>(q_all + kTileRows * Dh);
  T* v_s = k_s + lp * ks;

  const int tile = blockIdx.x % n_tiles;
  const int h = (blockIdx.x / n_tiles) % num_heads;
  const long long b = blockIdx.x / ((unsigned)n_tiles * num_heads);
  const int D = num_heads * Dh;
  const long long row_stride = 3LL * D;
  const T* base = qkv + b * L * row_stride + h * Dh;
  const int row0 = tile * kTileRows;

  const T zero = from_f32<T>(0.f);
  for (int idx = threadIdx.x; idx < lp * Dh; idx += blockDim.x) {
    const int j = idx / Dh, d = idx - j * Dh;
    T kv = zero, vv = zero;
    if (j < L) {
      const T* row = base + j * row_stride + d;
      kv = row[D];
      vv = row[2 * D];
    }
    k_s[j * ks + d] = kv;
    v_s[j * ks + d] = vv;
  }
  for (int idx = threadIdx.x; idx < kTileRows * Dh; idx += blockDim.x) {
    const int r = idx / Dh, d = idx - r * Dh;
    const int i = row0 + r;
    q_all[idx] = i < L ? to_f32(base[i * row_stride + d]) : 0.f;
  }
  __syncthreads();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  float* s_w = s_all + warp * kRowsPerWarp * lp;
  const float* q_w = q_all + warp * kRowsPerWarp * Dh;

  // Scores, scaled after the dot as the reference does.
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
        for (int r = 0; r < kRowsPerWarp; ++r) s_w[r * lp + j] = acc[r][c] * scale;
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
    m = warp_max(m);
    float sum = 0.f;
    for (int j = lane; j < L; j += 32) {
      const float e = expf(s[j] - m);
      s[j] = e;
      sum += e;
    }
    sum = warp_sum(sum);
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
      for (int i = 0; i < NI; ++i) {
        const int d = lane + 32 * i;
        const float v = d < Dh ? to_f32(v_row[d]) : 0.f;
#pragma unroll
        for (int r = 0; r < kRowsPerWarp; ++r) {
          const float pr = jj == 0 ? p[r].x : jj == 1 ? p[r].y : jj == 2 ? p[r].z : p[r].w;
          o[r][i] = fmaf(pr, v, o[r][i]);
        }
      }
    }
  }

#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    const int i_row = row0 + warp * kRowsPerWarp + r;
    if (i_row >= L) continue;
    T* dst = out + (b * L + i_row) * D + h * Dh;
#pragma unroll
    for (int i = 0; i < NI; ++i) {
      const int d = lane + 32 * i;
      if (d < Dh) dst[d] = from_f32<T>(o[r][i]);
    }
  }
}

template <typename T, int NI>
cudaError_t launch(const void* qkv, void* out, int batch, int seq_len, int num_heads, int head_dim, float scale,
                   cudaStream_t stream) {
  const size_t smem = smem_bytes(seq_len, head_dim, sizeof(T));
  int device = 0, max_smem = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&max_smem, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (err != cudaSuccess) return err;
  if (smem > (size_t)max_smem) return cudaErrorInvalidValue;
  const int n_tiles = (seq_len + kTileRows - 1) / kTileRows;
  const long long blocks = (long long)batch * num_heads * n_tiles;
  if (blocks > INT_MAX) return cudaErrorInvalidValue;
  auto kernel = fused_qkv_attention_kernel<T, NI>;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kernel<<<(unsigned)blocks, kWarps * 32, smem, stream>>>(static_cast<const T*>(qkv), static_cast<T*>(out), seq_len,
                                                            num_heads, head_dim, scale, n_tiles);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. qkv (batch, seq_len, 3*num_heads*head_dim)
// and out (batch, seq_len, num_heads*head_dim) are contiguous on the current
// device. Launches on `stream` and returns the cudaError_t of the launch.
int eqx_fused_qkv_attention(const void* qkv, void* out, int batch, int seq_len, int num_heads, int head_dim,
                            float scale, int dtype, void* stream) {
  if (batch <= 0 || seq_len <= 0 || num_heads <= 0 || head_dim <= 0 || head_dim > kMaxHeadDim)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool narrow = head_dim <= 64;
  if (dtype == 0)
    return narrow ? launch<float, 2>(qkv, out, batch, seq_len, num_heads, head_dim, scale, s)
                  : launch<float, 4>(qkv, out, batch, seq_len, num_heads, head_dim, scale, s);
  if (dtype == 1)
    return narrow ? launch<__nv_bfloat16, 2>(qkv, out, batch, seq_len, num_heads, head_dim, scale, s)
                  : launch<__nv_bfloat16, 4>(qkv, out, batch, seq_len, num_heads, head_dim, scale, s);
  return cudaErrorInvalidValue;
}

// Dynamic shared memory one block needs; for error messages and reports.
long long eqx_fused_qkv_attention_smem_bytes(int seq_len, int head_dim, int elem_bytes) {
  return (long long)smem_bytes(seq_len, head_dim, elem_bytes);
}

const char* eqx_cuda_error_string(int err) { return cudaGetErrorString(static_cast<cudaError_t>(err)); }

}  // extern "C"
