// Tensor-core pieces shared by swin_block.cu, attention.cu, and through
// gemm_bf16.cuh by the other sources: mma.sync and ldmatrix wrappers, and
// one head's attention in bf16 (S = Q K^T, softmax, O = P V) for rows of at
// most 64 tokens, run by a block of 8 warps: the public attention's (K2)
// short rows.
#pragma once

#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace eqx_tc {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRows = 64;       // tokens per window, padded
constexpr int kSs = kRows + 4;  // row stride of the f32 score tile (bf16 p: 68 words)

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

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) { return *reinterpret_cast<const uint32_t*>(p); }

// Four 8 x 8 bf16 matrices from shared memory; lane l gives the address of
// row l % 8 of matrix l / 8 (16 bytes, 16-byte aligned).
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const __nv_bfloat16* p) {
  const unsigned addr = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// The same, each matrix transposed: lane l's row is read as a column.
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const __nv_bfloat16* p) {
  const unsigned addr = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// D += A B on the tensor cores: A 16 x 16 (row), B 16 x 8 (col), bf16 in, f32 out.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, "
      "{%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(__nv_bfloat16 lo, __nv_bfloat16 hi) {
  return (uint32_t)__bfloat16_as_ushort(lo) | ((uint32_t)__bfloat16_as_ushort(hi) << 16);
}

// One head's attention on the tensor cores (bf16): S = Q K^T as four m16n8
// tiles per warp (16 rows x 32 keys), scaled per row and key (q_scale,
// k_inv: v2's inverse norms and gs, else 1), times `scale`, plus the bias,
// into an f32 tile; softmax by one warp per row, p rounded to bf16 and
// written over its row; O = P V (16 rows x Dh/2 columns per warp) into
// `o`. Keys and rows past L take no part: their p is 0 and their outputs
// are not stored. All kThreads threads call it; it ends without a barrier.
// qkvh: kRows rows of [q | k | v], Dh each, at an even stride sq, rows past
// L zero; s_buf: kRows x kSs floats; bias_h: the head's (L, L) f32 bias,
// or null for none. Needs Dh % 16 == 0 and Dh <= 64.
__device__ inline void attention_head_mma(const __nv_bfloat16* qkvh, int sq, int Dh, int L, const float* q_scale,
                                          const float* k_inv, float scale, const float* bias_h, float* s_buf,
                                          __nv_bfloat16* o, int ldo) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  const int r0 = (warp % 4) * 16;
  {
    const int cw = (warp / 4) * 32;
    float acc[4][4] = {};
    for (int ks = 0; ks < Dh; ks += 16) {
      const __nv_bfloat16* ap = qkvh + (r0 + g) * sq + ks + 2 * t;
      const uint32_t a[4] = {ld32(ap), ld32(ap + 8 * sq), ld32(ap + 8), ld32(ap + 8 * sq + 8)};
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const __nv_bfloat16* bp = qkvh + (cw + 8 * j + g) * sq + Dh + ks + 2 * t;
        mma_bf16(acc[j], a, ld32(bp), ld32(bp + 8));
      }
    }
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = r0 + g + 8 * (e / 2), c = cw + 8 * j + 2 * t + (e % 2);
        if (r < L && c < L)
          s_buf[r * kSs + c] = acc[j][e] * q_scale[r] * k_inv[c] * scale + (bias_h ? bias_h[r * L + c] : 0.f);
      }
  }
  __syncthreads();
  __nv_bfloat16* p_buf = reinterpret_cast<__nv_bfloat16*>(s_buf);  // row stride 2 * kSs
  for (int i = warp; i < L; i += kWarps) {
    const float s0 = lane < L ? s_buf[i * kSs + lane] : -INFINITY;
    const float s1 = lane + 32 < L ? s_buf[i * kSs + lane + 32] : -INFINITY;
    const float m = warp_max(fmaxf(s0, s1));
    const float e0 = lane < L ? expf(s0 - m) : 0.f;
    const float e1 = lane + 32 < L ? expf(s1 - m) : 0.f;
    const float inv = 1.f / warp_sum(e0 + e1);
    __syncwarp();  // every lane has read the row before it is overwritten
    p_buf[i * 2 * kSs + lane] = __float2bfloat16(e0 * inv);
    p_buf[i * 2 * kSs + lane + 32] = __float2bfloat16(e1 * inv);
  }
  __syncthreads();
  {
    const int cols = Dh / 2, cw = (warp / 4) * cols;
    float acc[4][4] = {};
    for (int ks = 0; ks < kRows; ks += 16) {
      const __nv_bfloat16* ap = p_buf + (r0 + g) * 2 * kSs + ks + 2 * t;
      const uint32_t a[4] = {ld32(ap), ld32(ap + 16 * kSs), ld32(ap + 8), ld32(ap + 16 * kSs + 8)};
      const __nv_bfloat16* vk = qkvh + (ks + 2 * t) * sq + 2 * Dh;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (8 * j >= cols) break;
        const __nv_bfloat16* vp = vk + cw + 8 * j + g;
        mma_bf16(acc[j], a, pack_bf16(vp[0], vp[sq]), pack_bf16(vp[8 * sq], vp[9 * sq]));
      }
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if (8 * j >= cols) break;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = r0 + g + 8 * (e / 2), n = cw + 8 * j + 2 * t + (e % 2);
        if (r < L) o[r * ldo + n] = __float2bfloat16(acc[j][e]);
      }
    }
  }
}

}  // namespace eqx_tc
