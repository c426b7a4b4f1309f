// One whole Swin block at inference, one window per thread block.
//
// Replaces the Pallas TPU kernel _swin_block_kernel
// (eqxvision_tpu/ops/window_attention.py, launched from _fused_swin_block).
// For one window of L <= 64 tokens and C <= 192 channels it computes
//
//   v1 (pre-norm):   h = x + proj(attn(LN1 x));    out = h + fc2(gelu(fc1(LN2 h)))
//   v2 (post-norm):  h = x + LN1(proj(cosattn x)); out = h + LN2(fc2(gelu(fc1 h)))
//
// where attn is the windowed multi-head attention of window_attention.cu
// with the additive bias (relative-position bias plus shift mask) of the
// window, and cosattn its Swin v2 form (q, k L2-normalised per head, q
// times the head's clamped logit scale gs, score scale 1). The padding,
// cyclic shift and window partition stay outside, in torch.
//
// Rounding points (fused_swin_block_reference mirrors them): LayerNorm
// statistics and outputs in f32; every product accumulates in f32 and adds
// its bias in f32; the inputs of the four products (LN1 x or x, the
// attention output, LN2 h or h, gelu's output), q, k and v, and the
// probabilities are rounded to the input type; v2's normalised q and k
// stay in f32; the residual stream stays in f32 and the output is rounded
// once. gelu is the exact erf form (erff).
// The TPU kernel's compact bf16 softmax/residual mode and its erf polynomial
// were devices of that chip and are not carried over.
//
// Design. 256 threads (8 warps) per window. The window's activations stay
// in shared memory: the f32 residual stream (64 x C), two 64 x (C+8)
// buffers that hold the products' inputs and outputs in turn, one head's
// q|k|v (or one 64-wide chunk of the MLP's hidden layer), and a work area
// that holds a staged weight tile during a product and one head's 64 x 64
// score tile during its attention. Rows past L ride along in the 64-row
// products and are never stored.
// The four products are computed here, by one routine over 64 x 64 output
// tiles: in bf16 on the tensor cores (mma.sync m16n8k16, f32 accumulation;
// each warp a 16 x 32 piece), the 64 x 64 weight tiles staged through
// shared memory from device memory (the block's weights are under 1 MB and
// stay in L2) with the next tile's loads in flight while the current one
// is multiplied; in f32 on the CUDA cores (a 4 x 4 register tile per
// thread). Attention runs one head at a time: the head's q|k|v columns of
// the qkv product, then, in bf16, S = Q K^T and O = P V on the tensor cores
// with the softmax between them by one warp per row (v2's norms enter as
// f32 scales of S's rows and columns, so q and k are not rounded again);
// in f32, one warp per query row on the CUDA cores. The MLP runs in chunks
// of 64 hidden units, each fc2 partial product added into an f32
// accumulator, so the 4C-wide hidden layer never exists whole. The window
// is read and written 16 bytes per thread at a time.
//
// What bounds it. At swin_t stage 1, b128 bf16 (8192 windows of 49 tokens,
// C=96), one call does about 240 kFLOP per token, 96 GFLOP, and moves
// 154 MB: 0.097 ms of tensor-core math at 989 TFLOP/s against 0.046 ms of
// device memory, so its bound is the arithmetic. This version computes all
// 64 rows of a window of 49, reads every weight tile once per window from
// L2 (about 0.3 MB a window), and separates its phases by block-wide
// barriers with one or two blocks on an SM (about 106 KB of shared memory
// at C=96, 182 KB at C=192), so the tensor cores mostly wait on the
// staging, the barriers and the scalar epilogues. wgmma with TMA-fed
// weight tiles, more windows per block to reuse each staged tile, and
// packing 49-token windows into 64-row tiles are later work.
// Limits: C <= 192, L <= 64, head_dim <= 64, and C, hidden and head_dim
// multiples of 16; the entry point returns cudaErrorInvalidValue outside
// them.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "tensor_core_attention.cuh"

namespace {

using eqx_tc::attention_head_mma;
using eqx_tc::ld32;
using eqx_tc::ldmatrix_x4;
using eqx_tc::mma_bf16;
using eqx_tc::pack_bf16;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRows = 64;      // tokens per window, padded
constexpr int kTileN = 64;     // output columns per product tile
constexpr int kTileK = 32;     // depth of one staged weight tile
constexpr int kHidChunk = 64;  // hidden units per MLP chunk
constexpr int kMaxC = 192;
constexpr int kMaxHeadDim = 64;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) { return __float2bfloat16(x); }

template <typename T>
__device__ __forceinline__ float round_to(float x) { return to_f32(from_f32<T>(x)); }

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

// Row stride, in elements of `elem_bytes`, of a row of at least `cols`
// elements that is an odd number of 32-bit words (conflict-free column reads).
__host__ __device__ __forceinline__ int odd_stride(int cols, int elem_bytes) {
  int words = (cols * elem_bytes + 3) / 4;
  if (words % 2 == 0) words += 1;
  return words * 4 / elem_bytes;
}

// Shared-memory layout, in bytes from the start.
struct Layout {
  int ldr;     // row stride of the f32 residual stream: C + 4 words, off the banks of row + 1
  int lda;     // row stride of buf_a and buf_o, in elements (T or f32)
  int sq;      // row stride of one head's q|k|v, in T elements
  int sh;      // row stride of a hidden chunk, in T elements
  size_t res, buf_a, buf_o, scratch, wtile, scores, qrow, q_scale, k_inv, s_buf, total;
};

constexpr int kTileKMma = 64;          // depth of one staged bf16 weight tile
constexpr int kWsMma = kTileKMma + 8;  // its row stride: 36 words, 4 mod 8
using eqx_tc::kSs;
static_assert(kThreads == eqx_tc::kThreads && kRows == eqx_tc::kRows, "the shared attention assumes this block shape");

__host__ __device__ inline Layout make_layout(int C, int head_dim, int elem_bytes) {
  Layout g;
  // lda and sh, in 32-bit words for bf16, are 4 mod 8: the tensor-core
  // fragment reads (8 rows x 4 words) hit 32 banks.
  g.ldr = C + 4;
  g.lda = C + 8;
  g.sq = odd_stride(3 * head_dim, elem_bytes);
  g.sh = kHidChunk + 8;
  const int scratch_row = (g.sq > g.sh ? g.sq : g.sh) * elem_bytes;
  g.res = 0;
  g.buf_a = g.res + (size_t)kRows * g.ldr * 4;
  g.buf_o = g.buf_a + (size_t)kRows * g.lda * 4;
  g.scratch = g.buf_o + (size_t)kRows * g.lda * 4;
  // One work area holds the staged weight tile while a product runs and,
  // for bf16, one head's score tile while its attention runs; the f32
  // attention keeps per-warp score and q rows instead.
  const bool mma = elem_bytes == 2;
  const size_t work = mma ? (size_t)kRows * kSs * 4 : (size_t)kTileK * (kTileN + 1) * 4;
  g.wtile = g.s_buf = g.scratch + (((size_t)kRows * scratch_row + 15) & ~(size_t)15);
  g.scores = g.wtile + work;
  g.qrow = g.scores + (mma ? 0 : (size_t)kWarps * kRows * 4);
  g.q_scale = g.qrow + (mma ? 0 : (size_t)kWarps * kMaxHeadDim * 4);
  g.k_inv = g.q_scale + (size_t)kRows * 4;
  g.total = g.k_inv + (size_t)kRows * 4;
  return g;
}

template <typename T>
struct BlockArgs {
  const T* x;
  T* out;
  const T* w_qkv;   // (3C, C)
  const T* w_proj;  // (C, C)
  const T* w_fc1;   // (hidden, C)
  const T* w_fc2;   // (C, hidden)
  const float* ln1_w;
  const float* ln1_b;
  const float* b_qkv;
  const float* b_proj;
  const float* ln2_w;
  const float* ln2_b;
  const float* b_fc1;
  const float* b_fc2;
  const float* bias;  // (n_bias, H, L, L)
  const float* gs;    // (H,) or null
  int n_windows, n_bias, L, C, hidden, num_heads, head_dim;
  float scale, eps;
  int postnorm;
};

// f32 inputs: CUDA-core FMAs. 16 x 16 threads, each a 4 x 4 register
// tile of a 64 x 64 output tile; the weight tile is staged in f32.
template <typename WRow, typename Epi>
__device__ void block_matmul_fma(const float* A, int lda, int K, const float* W, long long ldw, int N, int L,
                                 WRow wrow, float* wtile, Epi epi) {
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  constexpr int kWs = kTileN + 1;
  for (int n0 = 0; n0 < N; n0 += kTileN) {
    float acc[4][4] = {};
    for (int k0 = 0; k0 < K; k0 += kTileK) {
      const int kn = min(kTileK, K - k0);
      __syncthreads();  // the previous tile's readers are done
      for (int e = threadIdx.x; e < kTileK * kTileN; e += kThreads) {
        const int n = e / kTileK, kk = e % kTileK;
        float w = 0.f;
        if (n0 + n < N && kk < kn) w = to_f32(W[(long long)wrow(n0 + n) * ldw + k0 + kk]);
        wtile[kk * kWs + n] = w;
      }
      __syncthreads();
#pragma unroll 4
      for (int kk = 0; kk < kn; ++kk) {
        float a[4], w[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) a[i] = to_f32(A[(ty + 16 * i) * lda + k0 + kk]);
#pragma unroll
        for (int j = 0; j < 4; ++j) w[j] = wtile[kk * kWs + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], w[j], acc[i][j]);
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty + 16 * i;
      if (r >= L) continue;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int n = n0 + tx + 16 * j;
        if (n < N) epi(r, n, acc[i][j]);
      }
    }
  }
  __syncthreads();
}

// LayerNorm of rows r < L of an f32 matrix (row stride lds, C columns),
// one warp per row, statistics in f32; store(r, c, y) takes each output.
// Ends with a barrier.
template <typename Store>
__device__ void layer_norm_rows(const float* src, int lds, int L, int C, const float* g, const float* b, float eps,
                                Store store) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  constexpr int kPer = kMaxC / 32;
  for (int r = warp; r < L; r += kWarps) {
    float v[kPer];
    float sum = 0.f;
#pragma unroll
    for (int t = 0; t < kPer; ++t) {
      const int c = lane + 32 * t;
      v[t] = c < C ? src[r * lds + c] : 0.f;
      sum += v[t];
    }
    const float mean = warp_sum(sum) / C;
    float sq = 0.f;
#pragma unroll
    for (int t = 0; t < kPer; ++t) {
      const int c = lane + 32 * t;
      if (c < C) sq += (v[t] - mean) * (v[t] - mean);
    }
    const float rstd = rsqrtf(warp_sum(sq) / C + eps);
#pragma unroll
    for (int t = 0; t < kPer; ++t) {
      const int c = lane + 32 * t;
      if (c < C) store(r, c, (v[t] - mean) * rstd * g[c] + b[c]);
    }
  }
  __syncthreads();
}

// bf16 inputs: tensor cores (mma.sync m16n8k16, f32 accumulation). Warp w
// computes rows 16*(w%4) .. +16 and columns 32*(w/4) .. +32 of a 64 x 64
// output tile as four m16n8 tiles. The weight tiles (64 n x 64 k) are
// staged through shared memory, two 16-byte loads per thread; the loads of
// the next tile are issued before the current one is multiplied, so the
// L2 latency overlaps the tensor-core work. Fragments are read from shared
// memory with ldmatrix, one x4 for A's 16 x 16 and one for each two n8
// tiles of B; the row strides of A (C + 8) and of the tile (72) are 16-byte
// multiples that are 4 mod 8 words, so the 8 rows of a matrix hit 32
// banks. Needs K % 16 == 0, A rows 16-byte aligned, and 16-byte aligned W
// rows.
template <typename WRow, typename Epi>
__device__ void block_matmul_mma(const __nv_bfloat16* A, int lda, int K, const __nv_bfloat16* W, long long ldw, int N,
                                 int L, WRow wrow, float* wtile, Epi epi) {
  __nv_bfloat16* ws = reinterpret_cast<__nv_bfloat16*>(wtile);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  const int r0 = (warp % 4) * 16, cw = (warp / 4) * 32;
  const int n_k = (K + kTileKMma - 1) / kTileKMma;
  const int tiles = n_k * ((N + kTileN - 1) / kTileN);
  const int sn = threadIdx.x / 8, sk = (threadIdx.x % 8) * 8;  // this thread's rows sn, sn+32; k piece sk
  auto fetch = [&](int it, uint4 (&v)[2]) {
    const int n0 = (it / n_k) * kTileN, k = (it % n_k) * kTileKMma + sk;
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      const int n = n0 + sn + 32 * q;
      v[q] = make_uint4(0u, 0u, 0u, 0u);
      if (n < N && k < K) v[q] = *reinterpret_cast<const uint4*>(W + (long long)wrow(n) * ldw + k);
    }
  };
  uint4 v[2];
  fetch(0, v);
  float acc[4][4] = {};
  for (int it = 0; it < tiles; ++it) {
    __syncthreads();  // the previous tile's readers are done
#pragma unroll
    for (int q = 0; q < 2; ++q) *reinterpret_cast<uint4*>(ws + (sn + 32 * q) * kWsMma + sk) = v[q];
    __syncthreads();
    if (it + 1 < tiles) fetch(it + 1, v);
    const int n0 = (it / n_k) * kTileN, k0 = (it % n_k) * kTileKMma;
    const int kn = min(kTileKMma, K - k0);
    // this lane's ldmatrix rows: A row r0 + lane % 16 at k + 8 * (lane / 16);
    // B row (an n) cw + lane % 8 + 8 * (lane / 16) at k + 8 * (lane / 8 % 2)
    const __nv_bfloat16* a_row = A + (r0 + lane % 16) * lda + k0 + 8 * (lane / 16);
    const __nv_bfloat16* b_row = ws + (cw + lane % 8 + 8 * (lane / 16)) * kWsMma + 8 * (lane / 8 % 2);
#pragma unroll
    for (int ks = 0; ks < kTileKMma; ks += 16) {
      if (ks >= kn) break;
      uint32_t a[4], b01[4], b23[4];
      ldmatrix_x4(a, a_row + ks);
      ldmatrix_x4(b01, b_row + ks);                // n8 tiles 0 and 1: {b0, b1} of each
      ldmatrix_x4(b23, b_row + 16 * kWsMma + ks);  // n8 tiles 2 and 3
      mma_bf16(acc[0], a, b01[0], b01[1]);
      mma_bf16(acc[1], a, b01[2], b01[3]);
      mma_bf16(acc[2], a, b23[0], b23[1]);
      mma_bf16(acc[3], a, b23[2], b23[3]);
    }
    if (it % n_k == n_k - 1) {
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = r0 + g + 8 * (e / 2), n = n0 + cw + 8 * j + 2 * t + (e % 2);
          if (r < L && n < N) epi(r, n, acc[j][e]);
          acc[j][e] = 0.f;
        }
    }
  }
  __syncthreads();
}

// Y[r, n] = sum_k A[r, k] * W[wrow(n), k] for r < kRows, n < N; epi(r, n, y)
// is called for r < L only. A: kRows x K in shared memory, type T, row
// stride lda. W: device memory, row stride ldw, k contiguous. The epilogue
// must not write A. Ends with a barrier.
template <typename T, typename WRow, typename Epi>
__device__ __forceinline__ void block_matmul(const T* A, int lda, int K, const T* W, long long ldw, int N, int L,
                                             WRow wrow, float* wtile, Epi epi) {
  if constexpr (std::is_same<T, __nv_bfloat16>::value)
    block_matmul_mma(A, lda, K, W, ldw, N, L, wrow, wtile, epi);
  else
    block_matmul_fma(A, lda, K, W, ldw, N, L, wrow, wtile, epi);
}

template <typename T>
__global__ void __launch_bounds__(kThreads) swin_block_kernel(BlockArgs<T> p) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int L = p.L, C = p.C, H = p.num_heads, Dh = p.head_dim;
  const Layout g = make_layout(C, Dh, sizeof(T));
  float* res = reinterpret_cast<float*>(smem + g.res);
  float* a_f = reinterpret_cast<float*>(smem + g.buf_a);
  T* a_t = reinterpret_cast<T*>(smem + g.buf_a);
  float* o_f = reinterpret_cast<float*>(smem + g.buf_o);
  T* o_t = reinterpret_cast<T*>(smem + g.buf_o);
  T* qkvh = reinterpret_cast<T*>(smem + g.scratch);
  T* hid = qkvh;
  float* wtile = reinterpret_cast<float*>(smem + g.wtile);
  float* scores = reinterpret_cast<float*>(smem + g.scores);
  float* qrow = reinterpret_cast<float*>(smem + g.qrow);
  float* q_scale = reinterpret_cast<float*>(smem + g.q_scale);
  float* k_inv = reinterpret_cast<float*>(smem + g.k_inv);
  float* s_buf = reinterpret_cast<float*>(smem + g.s_buf);
  const int ldr = g.ldr, lda = g.lda, sq = g.sq, sh = g.sh;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  constexpr int kVec = 16 / sizeof(T);  // elements in one 16-byte access; C % kVec == 0

  // Rows L..kRows-1 of every buffer stay zero: epilogues and norms write
  // rows < L only.
  for (size_t i = threadIdx.x; i < g.total / 4; i += kThreads) reinterpret_cast<float*>(smem)[i] = 0.f;
  __syncthreads();
  for (int r = threadIdx.x; r < kRows; r += kThreads) q_scale[r] = k_inv[r] = 1.f;  // v2 rewrites them per head

  const long long bw = blockIdx.x;  // image * nW + window
  const int wb = (int)(bw % p.n_windows) % p.n_bias;
  const T* x = p.x + bw * L * C;  // the window's L x C tokens are contiguous
  for (int e = threadIdx.x * kVec; e < L * C; e += kThreads * kVec) {
    const uint4 raw = *reinterpret_cast<const uint4*>(x + e);
    const T* v = reinterpret_cast<const T*>(&raw);
    const int r = e / C, c = e % C;
#pragma unroll
    for (int u = 0; u < kVec; ++u) {
      res[r * ldr + c + u] = to_f32(v[u]);
      if (p.postnorm) a_t[r * lda + c + u] = v[u];
    }
  }
  __syncthreads();
  if (!p.postnorm)
    layer_norm_rows(res, ldr, L, C, p.ln1_w, p.ln1_b, p.eps,
                    [&](int r, int c, float y) { a_t[r * lda + c] = from_f32<T>(y); });

  // ---- attention, one head at a time
  float* s_w = scores + warp * kRows;
  float* q_w = qrow + warp * kMaxHeadDim;
  for (int h = 0; h < H; ++h) {
    auto wrow = [&](int n) { return (n / Dh) * C + h * Dh + n % Dh; };
    block_matmul(a_t, lda, C, p.w_qkv, C, 3 * Dh, L, wrow, wtile, [&](int r, int n, float y) {
      qkvh[r * sq + n] = from_f32<T>(y + p.b_qkv[wrow(n)]);
    });
    if (p.gs != nullptr) {
      // cosine attention: per row, gs over q's L2 norm and 1 over k's, in f32
      for (int r = warp; r < L; r += kWarps) {
        const T* q_row = qkvh + r * sq;
        float q2 = 0.f, k2 = 0.f;
        for (int d = lane; d < Dh; d += 32) {
          q2 += to_f32(q_row[d]) * to_f32(q_row[d]);
          k2 += to_f32(q_row[Dh + d]) * to_f32(q_row[Dh + d]);
        }
        q2 = warp_sum(q2);
        k2 = warp_sum(k2);
        if (lane == 0) {
          q_scale[r] = p.gs[h] / fmaxf(sqrtf(q2), 1e-12f);
          k_inv[r] = 1.f / fmaxf(sqrtf(k2), 1e-12f);
        }
      }
      __syncthreads();
    }
    const float* bias_h = p.bias + ((long long)wb * H + h) * L * L;
    if constexpr (std::is_same<T, __nv_bfloat16>::value) {
      attention_head_mma(qkvh, sq, Dh, L, q_scale, k_inv, p.scale, bias_h, s_buf, o_t + h * Dh, lda);
    } else {
      for (int i = warp; i < L; i += kWarps) {
        const T* q_src = qkvh + i * sq;
        q_w[lane] = lane < Dh ? to_f32(q_src[lane]) * q_scale[i] : 0.f;
        q_w[lane + 32] = lane + 32 < Dh ? to_f32(q_src[lane + 32]) * q_scale[i] : 0.f;
        __syncwarp();
        float m = -INFINITY;
        for (int j = lane; j < L; j += 32) {
          const T* k_row = qkvh + j * sq + Dh;
          float acc = 0.f;
          for (int d = 0; d < Dh; ++d) acc = fmaf(q_w[d], to_f32(k_row[d]), acc);
          const float s = acc * k_inv[j] * p.scale + bias_h[i * L + j];
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
        const float inv = 1.f / warp_sum(sum);
        for (int j = lane; j < L; j += 32) s_w[j] = round_to<T>(s_w[j] * inv);
        __syncwarp();
#pragma unroll
        for (int t = 0; t < 2; ++t) {
          const int d = lane + 32 * t;
          if (d >= Dh) continue;
          float o = 0.f;
          for (int j = 0; j < L; ++j) o = fmaf(s_w[j], to_f32(qkvh[j * sq + 2 * Dh + d]), o);
          o_t[i * lda + h * Dh + d] = from_f32<T>(o);
        }
        __syncwarp();  // s_w and q_w are rewritten by the next row
      }
    }
    __syncthreads();  // the next head's product rewrites q|k|v
  }

  // ---- projection and the first residual
  auto ident = [](int n) { return n; };
  if (!p.postnorm) {
    block_matmul(o_t, lda, C, p.w_proj, C, C, L, ident, wtile,
                 [&](int r, int n, float y) { res[r * ldr + n] += y + p.b_proj[n]; });
    layer_norm_rows(res, ldr, L, C, p.ln2_w, p.ln2_b, p.eps,
                    [&](int r, int c, float y) { a_t[r * lda + c] = from_f32<T>(y); });
    for (int r = warp; r < L; r += kWarps)
      for (int c = lane; c < C; c += 32) res[r * ldr + c] += p.b_fc2[c];
  } else {
    block_matmul(o_t, lda, C, p.w_proj, C, C, L, ident, wtile,
                 [&](int r, int n, float y) { a_f[r * lda + n] = y + p.b_proj[n]; });
    layer_norm_rows(a_f, lda, L, C, p.ln1_w, p.ln1_b, p.eps, [&](int r, int c, float y) { res[r * ldr + c] += y; });
    for (int r = warp; r < L; r += kWarps)
      for (int c = lane; c < C; c += 32) {
        a_t[r * lda + c] = from_f32<T>(res[r * ldr + c]);
        o_f[r * lda + c] = p.b_fc2[c];
      }
  }
  __syncthreads();

  // ---- MLP in chunks of hidden units; fc2 sums into res (v1) or o_f (v2)
  float* acc2 = p.postnorm ? o_f : res;
  const int ld2 = p.postnorm ? lda : ldr;
  for (int c0 = 0; c0 < p.hidden; c0 += kHidChunk) {
    const int nc = min(kHidChunk, p.hidden - c0);
    block_matmul(a_t, lda, C, p.w_fc1, C, nc, L, [&](int n) { return c0 + n; }, wtile, [&](int r, int n, float y) {
      const float u = y + p.b_fc1[c0 + n];
      hid[r * sh + n] = from_f32<T>(0.5f * u * (1.f + erff(u * 0.70710678118654752f)));
    });
    block_matmul(hid, sh, nc, p.w_fc2 + c0, p.hidden, C, L, ident, wtile,
                 [&](int r, int n, float y) { acc2[r * ld2 + n] += y; });
  }

  T* out = p.out + bw * L * C;
  if (p.postnorm) {  // res += LN2(y), in place
    layer_norm_rows(o_f, lda, L, C, p.ln2_w, p.ln2_b, p.eps, [&](int r, int c, float y) { res[r * ldr + c] += y; });
  }
  for (int e = threadIdx.x * kVec; e < L * C; e += kThreads * kVec) {
    const float* src = res + (e / C) * ldr + e % C;
    uint32_t w[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      if constexpr (std::is_same<T, __nv_bfloat16>::value)
        w[q] = pack_bf16(__float2bfloat16(src[2 * q]), __float2bfloat16(src[2 * q + 1]));
      else
        w[q] = __float_as_uint(src[q]);
    }
    *reinterpret_cast<uint4*>(out + e) = make_uint4(w[0], w[1], w[2], w[3]);
  }
}

template <typename T>
cudaError_t launch(BlockArgs<T> args, int windows, cudaStream_t stream) {
  const size_t smem = make_layout(args.C, args.head_dim, sizeof(T)).total;
  int device = 0, max_smem = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&max_smem, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (err != cudaSuccess) return err;
  if (smem > (size_t)max_smem) return cudaErrorInvalidValue;
  auto kernel = swin_block_kernel<T>;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kernel<<<windows, kThreads, smem, stream>>>(args);
  return cudaGetLastError();
}

template <typename T>
cudaError_t run(const void* x, void* out, const void* w_qkv, const void* w_proj, const void* w_fc1,
                const void* w_fc2, const float* const* vecs, const float* bias, const float* gs, int windows,
                int n_windows, int n_bias, int seq_len, int channels, int hidden, int num_heads, float scale,
                float eps, int postnorm, cudaStream_t stream) {
  BlockArgs<T> a;
  a.x = static_cast<const T*>(x);
  a.out = static_cast<T*>(out);
  a.w_qkv = static_cast<const T*>(w_qkv);
  a.w_proj = static_cast<const T*>(w_proj);
  a.w_fc1 = static_cast<const T*>(w_fc1);
  a.w_fc2 = static_cast<const T*>(w_fc2);
  a.ln1_w = vecs[0];
  a.ln1_b = vecs[1];
  a.b_qkv = vecs[2];
  a.b_proj = vecs[3];
  a.ln2_w = vecs[4];
  a.ln2_b = vecs[5];
  a.b_fc1 = vecs[6];
  a.b_fc2 = vecs[7];
  a.bias = bias;
  a.gs = gs;
  a.n_windows = n_windows;
  a.n_bias = n_bias;
  a.L = seq_len;
  a.C = channels;
  a.hidden = hidden;
  a.num_heads = num_heads;
  a.head_dim = channels / num_heads;
  a.scale = scale;
  a.eps = eps;
  a.postnorm = postnorm;
  return launch<T>(a, windows, stream);
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. x and out (windows, seq_len, channels)
// with windows = images * n_windows; w_qkv (3C, C), w_proj (C, C), w_fc1
// (hidden, C), w_fc2 (C, hidden) in the input type, torch's (out, in)
// layout; the f32 vectors ln1_w, ln1_b, b_qkv (3C), b_proj, ln2_w, ln2_b,
// b_fc1 (hidden), b_fc2; bias (n_bias, heads, L, L) f32; gs (heads,) f32 or
// null (null: v1; non-null: v2 cosine attention). postnorm: 0 = v1, 1 = v2.
// All contiguous on the current device. Launches on `stream` and returns
// the cudaError_t of the launch.
int eqx_swin_block(const void* x, void* out, const void* w_qkv, const void* w_proj, const void* w_fc1,
                   const void* w_fc2, const void* ln1_w, const void* ln1_b, const void* b_qkv, const void* b_proj,
                   const void* ln2_w, const void* ln2_b, const void* b_fc1, const void* b_fc2, const void* bias,
                   const void* gs, int windows, int n_windows, int n_bias, int seq_len, int channels, int hidden,
                   int num_heads, float scale, float eps, int postnorm, int dtype, void* stream) {
  if (windows <= 0 || n_windows <= 0 || n_bias <= 0 || windows % n_windows != 0 || seq_len <= 0 ||
      seq_len > kRows || channels <= 0 || channels > kMaxC || channels % 16 != 0 || hidden % 16 != 0 ||
      hidden <= 0 || num_heads <= 0 ||
      channels % num_heads != 0 || channels / num_heads > kMaxHeadDim || (channels / num_heads) % 16 != 0)
    return cudaErrorInvalidValue;
  const float* vecs[8] = {
      static_cast<const float*>(ln1_w), static_cast<const float*>(ln1_b), static_cast<const float*>(b_qkv),
      static_cast<const float*>(b_proj), static_cast<const float*>(ln2_w), static_cast<const float*>(ln2_b),
      static_cast<const float*>(b_fc1), static_cast<const float*>(b_fc2)};
  const float* b = static_cast<const float*>(bias);
  const float* g = static_cast<const float*>(gs);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return run<float>(x, out, w_qkv, w_proj, w_fc1, w_fc2, vecs, b, g, windows, n_windows, n_bias, seq_len, channels,
                      hidden, num_heads, scale, eps, postnorm, s);
  if (dtype == 1)
    return run<__nv_bfloat16>(x, out, w_qkv, w_proj, w_fc1, w_fc2, vecs, b, g, windows, n_windows, n_bias, seq_len,
                              channels, hidden, num_heads, scale, eps, postnorm, s);
  return cudaErrorInvalidValue;
}

// Dynamic shared memory one block needs; for error messages and reports.
long long eqx_swin_block_smem_bytes(int channels, int head_dim, int elem_bytes) {
  return (long long)make_layout(channels, head_dim, elem_bytes).total;
}

}  // extern "C"
