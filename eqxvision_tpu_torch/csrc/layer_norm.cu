// Last-axis LayerNorm.
//
// Replaces the Pallas TPU kernel _ln_kernel (eqxvision_tpu/ops/layernorm.py,
// launched from _layer_norm). It computes what _ln_kernel computes, for each
// row of x viewed as (rows, D):
//
//   mean = sum(x) / D, var = sum((x - mean)^2) / D   (f32, centred form)
//   y    = (x - mean) * rsqrt(var + eps) [* weight + bias]   (f32)
//
// rounded once to x's type. The mean is summed as x0 + sum(x - x0) / D, x0
// the row's first value: the same number, but a row far from zero (1e3 +
// N(0, 1) in f32) keeps its mean to f32 rounding instead of losing ~1e-4
// in the sum of large values. x is f32 or bf16; the weight and bias are read
// in their stored type (f32 or bf16) and widened to f32. The TPU kernel's
// 128-lane gate and its fall-back when no 8-aligned row block divides the
// rows are tiling devices of that chip: this kernel takes any D and any
// row count.
//
// Design. A group of lanes owns one row and holds it in registers: each lane
// loads its share of the row as 16-byte vectors (8 bf16 or 4 f32 values),
// the group sums them with warp shuffles, then sums the squares of the
// centred values it still holds, and writes the normalised row back as
// 16-byte vectors. The group is as many lanes (a power of two, at most 32)
// as divide the row's vector count, so that every lane of a narrow row is
// busy: at D = 96 in bf16 a row is 12 vectors, taken by 4 lanes of 3
// vectors each, 8 rows to a warp. A lane holds at most 64 values (D up to
// 2048 in either type). No shared memory, no atomics. A row whose size or
// address does not allow 16-byte vectors, or one wider than 2048, takes a
// plain one-warp-per-row kernel that reads it from device memory three
// times.
//
// What bounds it. It reads each input once and writes each output once:
// 2 * rows * D * itemsize bytes over 3.35 TB/s, about 0.046 ms at vit_base
// b256 (50,432 x 768 bf16) and at convnext_tiny b128 stage 1 (401,408 x 96
// bf16), against 8 * rows * D operations that are far below the card's
// rate. The bound is device memory. Launch overhead bounds the small calls
// (the 128 x 768 classifier norm).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxValuesPerLane = 64;  // f32 registers holding a lane's share of its row

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) { return __float2bfloat16(x); }

// Element d of a weight or bias stored in f32 (bf16 == false) or bf16, in f32.
__device__ __forceinline__ float param(const void* p, bool bf16, int d) {
  return bf16 ? __bfloat162float(static_cast<const __nv_bfloat16*>(p)[d]) : static_cast<const float*>(p)[d];
}

// Sum over the `width` lanes of an aligned group of a warp (width a power of two).
__device__ __forceinline__ float group_sum(float v, int width) {
  for (int off = width / 2; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// One row per group of `tpr` lanes, held in registers as up to VPL 16-byte
// vectors a lane; lane s of the group owns vectors s, s + tpr, ...
template <typename T, int VPL>
__global__ void __launch_bounds__(kThreads)
    layer_norm_vec_kernel(const T* __restrict__ x, const void* __restrict__ weight, const void* __restrict__ bias,
                          bool param_bf16, T* __restrict__ out, long long rows, int dim, int tpr, float eps) {
  constexpr int E = 16 / sizeof(T);
  const int nvec = dim / E;
  const int sub = threadIdx.x % tpr;
  const long long row = (long long)blockIdx.x * (kThreads / tpr) + threadIdx.x / tpr;
  const bool live = row < rows;  // dead lanes still take part in the shuffles
  const uint4* src = reinterpret_cast<const uint4*>(x + (live ? row : 0) * dim);

  float v[VPL][E];
#pragma unroll
  for (int k = 0; k < VPL; ++k) {
    const int vi = sub + k * tpr;
    const uint4 raw = live && vi < nvec ? src[vi] : make_uint4(0u, 0u, 0u, 0u);
    const T* in = reinterpret_cast<const T*>(&raw);
#pragma unroll
    for (int e = 0; e < E; ++e) v[k][e] = to_f32(in[e]);
  }
  // x0 from the group's first lane, which holds vector 0
  const float pivot = __shfl_sync(0xffffffffu, v[0][0], (threadIdx.x % 32) & ~(tpr - 1));
  float sum = 0.f;
#pragma unroll
  for (int k = 0; k < VPL; ++k) {
    if (sub + k * tpr < nvec) {
#pragma unroll
      for (int e = 0; e < E; ++e) sum += v[k][e] - pivot;
    }
  }
  const float inv_d = 1.f / dim;
  const float mean = pivot + group_sum(sum, tpr) * inv_d;
  float sq = 0.f;
#pragma unroll
  for (int k = 0; k < VPL; ++k) {
    if (sub + k * tpr < nvec) {
#pragma unroll
      for (int e = 0; e < E; ++e) {
        v[k][e] -= mean;
        sq += v[k][e] * v[k][e];
      }
    }
  }
  const float rstd = rsqrtf(group_sum(sq, tpr) * inv_d + eps);
  if (!live) return;
  uint4* dst = reinterpret_cast<uint4*>(out + row * dim);
#pragma unroll
  for (int k = 0; k < VPL; ++k) {
    const int vi = sub + k * tpr;
    if (vi >= nvec) continue;
    uint4 raw;
    T* o = reinterpret_cast<T*>(&raw);
#pragma unroll
    for (int e = 0; e < E; ++e) {
      float y = v[k][e] * rstd;
      if (weight != nullptr) {
        const int d = vi * E + e;
        y = y * param(weight, param_bf16, d) + param(bias, param_bf16, d);
      }
      o[e] = from_f32<T>(y);
    }
    dst[vi] = raw;
  }
}

// Any D and alignment: one warp per row, three passes over the row.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    layer_norm_plain_kernel(const T* __restrict__ x, const void* __restrict__ weight, const void* __restrict__ bias,
                            bool param_bf16, T* __restrict__ out, long long rows, int dim, float eps) {
  const long long row = (long long)blockIdx.x * (kThreads / 32) + threadIdx.x / 32;
  if (row >= rows) return;  // whole warps leave together
  const int lane = threadIdx.x % 32;
  const T* src = x + row * dim;
  const float pivot = to_f32(src[0]);
  float sum = 0.f;
  for (int d = lane; d < dim; d += 32) sum += to_f32(src[d]) - pivot;
  const float inv_d = 1.f / dim;
  const float mean = pivot + group_sum(sum, 32) * inv_d;
  float sq = 0.f;
  for (int d = lane; d < dim; d += 32) {
    const float c = to_f32(src[d]) - mean;
    sq += c * c;
  }
  const float rstd = rsqrtf(group_sum(sq, 32) * inv_d + eps);
  T* dst = out + row * dim;
  for (int d = lane; d < dim; d += 32) {
    float y = (to_f32(src[d]) - mean) * rstd;
    if (weight != nullptr) y = y * param(weight, param_bf16, d) + param(bias, param_bf16, d);
    dst[d] = from_f32<T>(y);
  }
}

// Lanes per row: the largest power of two up to 32 that divides the vector
// count with at most max_vpl vectors a lane, else 32.
int lanes_per_row(int nvec, int max_vpl) {
  for (int tpr = 32; tpr > 1; tpr >>= 1)
    if (nvec % tpr == 0 && nvec / tpr <= max_vpl) return tpr;
  return nvec <= max_vpl ? 1 : 32;
}

template <typename T, int VPL>
cudaError_t launch_vec(const void* x, const void* w, const void* b, bool pbf16, void* out, long long rows, int dim,
                       int tpr, float eps, cudaStream_t stream) {
  const long long blocks = (rows + kThreads / tpr - 1) / (kThreads / tpr);
  if (blocks > INT_MAX) return cudaErrorInvalidValue;
  layer_norm_vec_kernel<T, VPL><<<(unsigned)blocks, kThreads, 0, stream>>>(
      static_cast<const T*>(x), w, b, pbf16, static_cast<T*>(out), rows, dim, tpr, eps);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch(const void* x, const void* w, const void* b, bool pbf16, void* out, long long rows, int dim,
                   float eps, cudaStream_t stream) {
  constexpr int E = 16 / sizeof(T);
  constexpr int kMaxVpl = kMaxValuesPerLane / E;  // 16 for f32, 8 for bf16
  const bool aligned = dim % E == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                       reinterpret_cast<uintptr_t>(out) % 16 == 0;
  const int nvec = dim / E;
  if (aligned && nvec <= 32 * kMaxVpl) {
    const int tpr = lanes_per_row(nvec, kMaxVpl);
    const int vpl = (nvec + tpr - 1) / tpr;
    if (vpl <= 1) return launch_vec<T, 1>(x, w, b, pbf16, out, rows, dim, tpr, eps, stream);
    if (vpl <= 2) return launch_vec<T, 2>(x, w, b, pbf16, out, rows, dim, tpr, eps, stream);
    if (vpl <= 3) return launch_vec<T, 3>(x, w, b, pbf16, out, rows, dim, tpr, eps, stream);
    if (vpl <= 4) return launch_vec<T, 4>(x, w, b, pbf16, out, rows, dim, tpr, eps, stream);
    if (vpl <= 6) return launch_vec<T, 6>(x, w, b, pbf16, out, rows, dim, tpr, eps, stream);
    if (vpl <= 8) return launch_vec<T, 8>(x, w, b, pbf16, out, rows, dim, tpr, eps, stream);
    if constexpr (kMaxVpl > 8) {
      if (vpl <= 12) return launch_vec<T, 12>(x, w, b, pbf16, out, rows, dim, tpr, eps, stream);
      return launch_vec<T, 16>(x, w, b, pbf16, out, rows, dim, tpr, eps, stream);
    }
  }
  const long long blocks = (rows + kThreads / 32 - 1) / (kThreads / 32);
  if (blocks > INT_MAX) return cudaErrorInvalidValue;
  layer_norm_plain_kernel<T><<<(unsigned)blocks, kThreads, 0, stream>>>(
      static_cast<const T*>(x), w, b, pbf16, static_cast<T*>(out), rows, dim, eps);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16, for x and out; param_dtype the same for
// weight and bias, which are both null (no affine) or both (dim,). x and
// out are contiguous (rows, dim) on the current device. Launches on
// `stream` and returns the cudaError_t of the launch.
int eqx_layer_norm(const void* x, const void* weight, const void* bias, void* out, long long rows, int dim,
                   float eps, int dtype, int param_dtype, void* stream) {
  if (rows <= 0 || dim <= 0 || (weight == nullptr) != (bias == nullptr) || param_dtype < 0 || param_dtype > 1)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool pbf16 = param_dtype == 1;
  if (dtype == 0) return launch<float>(x, weight, bias, pbf16, out, rows, dim, eps, s);
  if (dtype == 1) return launch<__nv_bfloat16>(x, weight, bias, pbf16, out, rows, dim, eps, s);
  return cudaErrorInvalidValue;
}

}  // extern "C"
