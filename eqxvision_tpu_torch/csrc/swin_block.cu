// One whole Swin block at inference, read from and written to the NHWC map.
//
// Replaces the Pallas TPU kernel _swin_block_kernel
// (eqxvision_tpu/ops/window_attention.py, launched from _fused_swin_block).
// For each window of L <= 64 tokens and C <= 192 channels it computes
//
//   v1 (pre-norm):   h = x + proj(attn(LN1 x));    out = h + fc2(gelu(fc1(LN2 h)))
//   v2 (post-norm):  h = x + LN1(proj(cosattn x)); out = h + LN2(fc2(gelu(fc1 h)))
//
// where attn is the windowed multi-head attention of window_attention.cu
// with the additive bias (relative-position bias plus shift mask) of the
// window, and cosattn its Swin v2 form (q, k L2-normalised per head, q
// times the head's clamped logit scale gs, score scale 1).
//
// Windows straight from the map. The kernel takes the map's (N, H, W), the
// padded (ph, pw), the window (wh, ww) and the effective shift (sh, sw)
// (zeroed where one window covers a side; ops/window_attention.py's
// window_geometry computes them once for both this kernel and the torch
// plumbing, and window_token_index writes the same formula in torch).
// Token t of window w of image n sits at
//   y = (wy * wh + t / ww + sh) mod ph,  x = (wx * ww + t % ww + sw) mod pw
// with (wy, wx) the window's place in the padded grid; a token at or past
// (H, W) is padding and reads as zeros. The output is stored back to the
// same positions and the padding dropped, so no pad, roll, partition or
// copy runs around the kernel. The (N, nW, L, C) windows entry is the
// same kernel on a map of (nW, L) with (1, L) windows and no shift.
//
// Rounding points (fused_swin_block_reference mirrors them): LayerNorm
// statistics and outputs in f32; every product accumulates in f32 and adds
// its bias in f32; the inputs of the four products (LN1 x or x, the
// attention output, LN2 h or h, gelu's output), q, k and v, and the
// probabilities are rounded to the input type; v2's normalised q and k
// stay in f32 (they enter as f32 scales of S's rows and columns); the
// residual stream stays in f32 and the output is rounded once. gelu is
// the exact erf form (erff). The LayerNorm, bias and scale vectors are
// read in their stored type (f32 or bf16, all one type) and applied in f32.
//
// bf16 design (sm_90a), on gemm_bf16.cuh's primitives:
//   - A persistent grid of one block per SM, 256 threads: two warpgroups,
//     each owning one 64-row window of a group of G = 2 (rows past L ride
//     along and are never stored). A block walks a contiguous run of
//     groups, the windows numbered window-major (one window position over
//     consecutive images), so that its groups share a bias table. The last
//     group may be ragged: a warpgroup without a window computes on zeros
//     and stores nothing, so that it still consumes every stage.
//   - Weights by TMA into a ring of mbarrier-guarded 24 KB stages (128-byte
//     swizzle, torch's (out, in) layout, K-major for wgmma's B), in the
//     same order for every group: per qkv piece three stages, the q, k and
//     v rows of up to 64 / Dh heads at every k; proj by 64-deep k-tile;
//     per 64-unit hidden chunk fc1's 64 rows at every k, then fc2's C rows
//     at the chunk's 64 k. Both warpgroups multiply every stage, so each
//     weight tile read from L2 serves G windows. There is no producer warp:
//     the eighth warp to finish with a stage (a shared-memory counter)
//     issues the stage's next load at once, so no thread waits to refill
//     and the block keeps 256 threads, which lets ptxas give each up to 255
//     registers (a 288- or 384-thread block gets 168 and spilled heavily).
//     TMA zero-fills k past C or hidden and rows past hidden.
//   - The four products on wgmma (m64nNk16, f32 accumulators in registers):
//     qkv as three N = 64 products per piece, each over all of K from one
//     stage, the next issued before the last one's epilogue; proj and fc2
//     at N = NC, C rounded up to 96, 128 or 192 (the template argument);
//     fc1 at N = 64 per hidden chunk, issued together with the previous
//     chunk's fc2. Their A operands are written into 64 x 64 swizzled bf16
//     tiles (logical 16-byte unit u of row r at u ^ (r % 8)), then
//     fence.proxy.async and a warpgroup barrier. No mma.sync in them.
//   - Attention in registers, per warp 16 query rows, per head: S = Q K^T
//     on mma.sync m16n8k16 from ldmatrix reads of the swizzled q|k|v tiles;
//     the scales, the f32 bias (asked for a head ahead) and the key mask on
//     the accumulator fragments; the softmax by quad shuffles (a row lives
//     in one quad); P rounded to bf16 in registers and reused as the A
//     fragments of O = P V (V by ldmatrix.trans). No score tile goes
//     through shared memory and no barrier runs per head; v2's q and k
//     norms take one warpgroup barrier per qkv piece.
//   - LayerNorms: v1's LN1 in shared memory, two threads a row; proj's and
//     fc2's on the accumulators, the row statistics by quad shuffles. The
//     v1 residual h stays in registers: fc2 accumulates onto h + b2. v2
//     keeps h in f32 in shared memory over the MLP, over the A and O tiles.
//   - The vectors in f32 in shared memory, staged once per block from
//     their stored type (b_fc1 read from device memory). The window moves
//     16 bytes a thread: its loads all issued before its stores, the output
//     through a staging tile; x is read again for the residual after proj.
//     Synchronisation: mbarriers for the stages, warpgroup-scoped named
//     barriers around the shared tiles; __syncthreads only at the start.
// Shared memory (K-tiles kC = ceil(C / 64); per window kC A tiles, kC O
// tiles, 3 q|k|v tiles (later the MLP input and the output staging), one
// hidden tile (v2's norms during attention), 8 KB a tile; the vectors;
// up to 1 KB of slack to align the tiles to 1024 bytes):
//   C = 96:  2 x 64 KB windows + 3.4 KB + 3 stages of 24 KB = 204.4 KB
//   C = 128: 2 x 64 KB windows + 4.5 KB + 3 stages          = 205.5 KB
//   C = 192: 2 x 80 KB windows + 6.8 KB + 2 stages          = 215.8 KB
// so one block an SM and G = 2 windows in flight at every C the gate admits.
// Registers, per thread: 64 for two of qkv's N = 64 accumulators in
// flight, then NC / 2 for proj and fc2 (the v1 residual rides in them) and
// 32 for an fc1 chunk; the attention's S (32), bias (32), P (16) and O (32).
// ptxas reports 255 and some spills (chip_smoke.py prints them).
//
// f32 keeps the earlier design, one window a block of 256 threads, products
// as CUDA-core FMAs (wgmma has no f32 product that rounds as the reference
// does); it reads the map the same way.
//
// What bounds it. At swin_t stage 1, b128 bf16 (8192 windows of 49 tokens,
// C = 96), one call does about 240 kFLOP per token, 96 GFLOP, and moves
// 154 MB: 0.097 ms of tensor-core math at 989 TFLOP/s against 0.046 ms of
// device memory, so its bound is the arithmetic. This design computes all
// 64 rows of a window of 49 (31% padding) and runs its products,
// epilogues, softmax and gelu in the same eight warps one after another:
// clock64 probes on an H100 found it bound by issue and latency on the
// CUDA cores (gelu, the softmax, the bias reads, the index math), with the
// tensor cores and the weight stream mostly idle (PERF.md, PR 8).
// Limits: C <= 192, L <= 64, head_dim <= 64, and C, hidden and head_dim
// multiples of 16; the entry point returns cudaErrorInvalidValue outside
// them.

#include "gemm_bf16.cuh"

namespace {

using bf16 = __nv_bfloat16;
using eqx_tc::ldmatrix_x4;
using eqx_tc::ldmatrix_x4_trans;
using eqx_tc::mma_bf16;
using eqx_tc::pack_bf16;
using eqx_tc::warp_max;

constexpr int kRows = 64;  // tokens per window, padded
constexpr int kMaxC = 192;
constexpr int kMaxHeadDim = 64;
constexpr int kVecs = 8;  // ln1_w, ln1_b, b_qkv, b_proj, ln2_w, ln2_b, b_fc1, b_fc2
enum { kLn1W, kLn1B, kBQkv, kBProj, kLn2W, kLn2B, kBFc1, kBFc2 };

// Where the windows sit in the NHWC map.
struct Geometry {
  int n_windows;  // windows per image, (ph / wh) * (pw / ww)
  int nwx;        // windows per padded row, pw / ww
  int H, W, ph, pw, wh, ww, sh, sw;
};

// Where window w (image * n_windows + window) starts: the image's first
// row, the window's first row and column after the shift, and 2^16 / ww
// rounded up (t / ww = t * inv_ww >> 16 exactly for t < 64 <= 2^16 / ww).
struct WindowOrigin {
  long long img_row;  // n * H
  int oy, ox;         // (wy * wh + sh) mod ph, (wx * ww + sw) mod pw
  unsigned inv_ww;
};

__device__ __forceinline__ WindowOrigin window_origin(const Geometry& g, unsigned w) {
  const unsigned n = w / (unsigned)g.n_windows, wi = w % (unsigned)g.n_windows;
  const int wy = (int)wi / g.nwx, wx = (int)wi % g.nwx;
  return {(long long)n * g.H, (wy * g.wh + g.sh) % g.ph, (wx * g.ww + g.sw) % g.pw,
          (65536u + (unsigned)g.ww - 1) / (unsigned)g.ww};
}

// Token index (n * H + y) * W + x in the map of token t of the window,
// or -1 for a padding token or t >= L.
__device__ __forceinline__ long long token_at(const Geometry& g, const WindowOrigin& o, int t, int L) {
  if (t >= L) return -1;
  const int ty = (int)(((unsigned)t * o.inv_ww) >> 16), tx = t - ty * g.ww;
  int y = o.oy + ty, x = o.ox + tx;
  if (y >= g.ph) y -= g.ph;
  if (x >= g.pw) x -= g.pw;
  if (y >= g.H || x >= g.W) return -1;
  return (o.img_row + y) * g.W + x;
}

// ============================ f32: CUDA cores ============================

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTileN = 64;     // output columns per product tile
constexpr int kTileK = 32;     // depth of one staged weight tile
constexpr int kHidChunk = 64;  // hidden units per MLP chunk

// Row stride, in floats, of a row of at least `cols` floats that is an odd
// number of 32-bit words (conflict-free column reads).
__host__ __device__ __forceinline__ int odd_stride(int cols) { return cols % 2 == 0 ? cols + 1 : cols; }

// Shared-memory layout of the f32 kernel, in bytes from the start.
struct Layout {
  int ldr;  // row stride of the f32 residual stream: C + 4, off the banks of row + 1
  int lda;  // row stride of buf_a and buf_o
  int sq;   // row stride of one head's q|k|v
  int sh;   // row stride of a hidden chunk
  size_t res, buf_a, buf_o, scratch, wtile, scores, qrow, q_scale, k_inv, total;
};

__host__ __device__ inline Layout make_layout(int C, int head_dim) {
  Layout g;
  g.ldr = C + 4;
  g.lda = C + 8;
  g.sq = odd_stride(3 * head_dim);
  g.sh = kHidChunk + 8;
  const int scratch_row = (g.sq > g.sh ? g.sq : g.sh) * 4;
  g.res = 0;
  g.buf_a = g.res + (size_t)kRows * g.ldr * 4;
  g.buf_o = g.buf_a + (size_t)kRows * g.lda * 4;
  g.scratch = g.buf_o + (size_t)kRows * g.lda * 4;
  g.wtile = g.scratch + (((size_t)kRows * scratch_row + 15) & ~(size_t)15);
  g.scores = g.wtile + (size_t)kTileK * (kTileN + 1) * 4;
  g.qrow = g.scores + (size_t)kWarps * kRows * 4;
  g.q_scale = g.qrow + (size_t)kWarps * kMaxHeadDim * 4;
  g.k_inv = g.q_scale + (size_t)kRows * 4;
  g.total = g.k_inv + (size_t)kRows * 4;
  return g;
}

struct BlockArgs {
  const void* x;  // the NHWC map (N, H, W, C)
  void* out;
  const void* w_qkv;   // (3C, C)
  const void* w_proj;  // (C, C)
  const void* w_fc1;   // (hidden, C)
  const void* w_fc2;   // (C, hidden)
  const void* vec[kVecs];
  bool param_bf16;     // the vectors are bf16 (else f32)
  const float* bias;  // (n_bias, H, L, L)
  const float* gs;    // (H,) or null
  Geometry geo;
  int windows, n_bias, L, C, hidden, num_heads, head_dim;
  float scale, eps;
  int postnorm;
};

__device__ __forceinline__ float vec_at(const BlockArgs& p, int which, int i) {
  return param(p.vec[which], p.param_bf16, i);
}

// Y[r, n] = sum_k A[r, k] * W[wrow(n), k] for r < kRows, n < N; epi(r, n, y)
// is called for r < L only. 16 x 16 threads, each a 4 x 4 register tile of
// a 64 x 64 output tile; the weight tile is staged in shared memory. The
// epilogue must not write A. Ends with a barrier.
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
        if (n0 + n < N && kk < kn) w = W[(long long)wrow(n0 + n) * ldw + k0 + kk];
        wtile[kk * kWs + n] = w;
      }
      __syncthreads();
#pragma unroll 4
      for (int kk = 0; kk < kn; ++kk) {
        float a[4], w[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) a[i] = A[(ty + 16 * i) * lda + k0 + kk];
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
__device__ void layer_norm_rows(const float* src, int lds, int L, int C, const BlockArgs& p, int gw, int gb,
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
    const float rstd = rsqrtf(warp_sum(sq) / C + p.eps);
#pragma unroll
    for (int t = 0; t < kPer; ++t) {
      const int c = lane + 32 * t;
      if (c < C) store(r, c, (v[t] - mean) * rstd * vec_at(p, gw, c) + vec_at(p, gb, c));
    }
  }
  __syncthreads();
}

__global__ void __launch_bounds__(kThreads) swin_block_f32_kernel(BlockArgs p) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int L = p.L, C = p.C, H = p.num_heads, Dh = p.head_dim;
  const Layout g = make_layout(C, Dh);
  float* res = reinterpret_cast<float*>(smem + g.res);
  float* a_f = reinterpret_cast<float*>(smem + g.buf_a);
  float* o_f = reinterpret_cast<float*>(smem + g.buf_o);
  float* qkvh = reinterpret_cast<float*>(smem + g.scratch);
  float* hid = qkvh;
  float* wtile = reinterpret_cast<float*>(smem + g.wtile);
  float* scores = reinterpret_cast<float*>(smem + g.scores);
  float* qrow = reinterpret_cast<float*>(smem + g.qrow);
  float* q_scale = reinterpret_cast<float*>(smem + g.q_scale);
  float* k_inv = reinterpret_cast<float*>(smem + g.k_inv);
  const float* xin = static_cast<const float*>(p.x);
  const float* w_qkv = static_cast<const float*>(p.w_qkv);
  const float* w_proj = static_cast<const float*>(p.w_proj);
  const float* w_fc1 = static_cast<const float*>(p.w_fc1);
  const float* w_fc2 = static_cast<const float*>(p.w_fc2);
  const int ldr = g.ldr, lda = g.lda, sq = g.sq, sh = g.sh;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  // Rows L..kRows-1 of every buffer stay zero: epilogues and norms write
  // rows < L only.
  for (size_t i = threadIdx.x; i < g.total / 4; i += kThreads) reinterpret_cast<float*>(smem)[i] = 0.f;
  __syncthreads();
  for (int r = threadIdx.x; r < kRows; r += kThreads) q_scale[r] = k_inv[r] = 1.f;  // v2 rewrites them per head

  const unsigned w = blockIdx.x;  // image * n_windows + window
  const int wb = (int)(w % (unsigned)p.geo.n_windows) % p.n_bias;
  const WindowOrigin origin = window_origin(p.geo, w);
  for (int e = threadIdx.x * 4; e < L * C; e += kThreads * 4) {  // C % 4 == 0: 16 bytes at a time
    const int r = e / C, c = e % C;
    const long long tok = token_at(p.geo, origin, r, L);
    const float4 v = tok >= 0 ? *reinterpret_cast<const float4*>(xin + tok * C + c) : make_float4(0.f, 0.f, 0.f, 0.f);
    *reinterpret_cast<float4*>(res + r * ldr + c) = v;
    if (p.postnorm) *reinterpret_cast<float4*>(a_f + r * lda + c) = v;
  }
  __syncthreads();
  if (!p.postnorm) layer_norm_rows(res, ldr, L, C, p, kLn1W, kLn1B, [&](int r, int c, float y) { a_f[r * lda + c] = y; });

  // ---- attention, one head at a time
  float* s_w = scores + warp * kRows;
  float* q_w = qrow + warp * kMaxHeadDim;
  for (int h = 0; h < H; ++h) {
    auto wrow = [&](int n) { return (n / Dh) * C + h * Dh + n % Dh; };
    block_matmul_fma(a_f, lda, C, w_qkv, C, 3 * Dh, L, wrow, wtile, [&](int r, int n, float y) {
      qkvh[r * sq + n] = y + vec_at(p, kBQkv, wrow(n));
    });
    if (p.gs != nullptr) {
      // cosine attention: per row, gs over q's L2 norm and 1 over k's, in f32
      for (int r = warp; r < L; r += kWarps) {
        const float* q_row = qkvh + r * sq;
        float q2 = 0.f, k2 = 0.f;
        for (int d = lane; d < Dh; d += 32) {
          q2 += q_row[d] * q_row[d];
          k2 += q_row[Dh + d] * q_row[Dh + d];
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
    for (int i = warp; i < L; i += kWarps) {
      const float* q_src = qkvh + i * sq;
      q_w[lane] = lane < Dh ? q_src[lane] * q_scale[i] : 0.f;
      q_w[lane + 32] = lane + 32 < Dh ? q_src[lane + 32] * q_scale[i] : 0.f;
      __syncwarp();
      float m = -INFINITY;
      for (int j = lane; j < L; j += 32) {
        const float* k_row = qkvh + j * sq + Dh;
        float acc = 0.f;
        for (int d = 0; d < Dh; ++d) acc = fmaf(q_w[d], k_row[d], acc);
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
      for (int j = lane; j < L; j += 32) s_w[j] *= inv;
      __syncwarp();
#pragma unroll
      for (int t = 0; t < 2; ++t) {
        const int d = lane + 32 * t;
        if (d >= Dh) continue;
        float o = 0.f;
        for (int j = 0; j < L; ++j) o = fmaf(s_w[j], qkvh[j * sq + 2 * Dh + d], o);
        o_f[i * lda + h * Dh + d] = o;
      }
      __syncwarp();  // s_w and q_w are rewritten by the next row
    }
    __syncthreads();  // the next head's product rewrites q|k|v
  }

  // ---- projection and the first residual
  auto ident = [](int n) { return n; };
  if (!p.postnorm) {
    block_matmul_fma(o_f, lda, C, w_proj, C, C, L, ident, wtile,
                     [&](int r, int n, float y) { res[r * ldr + n] += y + vec_at(p, kBProj, n); });
    layer_norm_rows(res, ldr, L, C, p, kLn2W, kLn2B, [&](int r, int c, float y) { a_f[r * lda + c] = y; });
    for (int r = warp; r < L; r += kWarps)
      for (int c = lane; c < C; c += 32) res[r * ldr + c] += vec_at(p, kBFc2, c);
  } else {
    block_matmul_fma(o_f, lda, C, w_proj, C, C, L, ident, wtile,
                     [&](int r, int n, float y) { a_f[r * lda + n] = y + vec_at(p, kBProj, n); });
    layer_norm_rows(a_f, lda, L, C, p, kLn1W, kLn1B, [&](int r, int c, float y) { res[r * ldr + c] += y; });
    for (int r = warp; r < L; r += kWarps)
      for (int c = lane; c < C; c += 32) {
        a_f[r * lda + c] = res[r * ldr + c];
        o_f[r * lda + c] = vec_at(p, kBFc2, c);
      }
  }
  __syncthreads();

  // ---- MLP in chunks of hidden units; fc2 sums into res (v1) or o_f (v2)
  float* acc2 = p.postnorm ? o_f : res;
  const int ld2 = p.postnorm ? lda : ldr;
  for (int c0 = 0; c0 < p.hidden; c0 += kHidChunk) {
    const int nc = min(kHidChunk, p.hidden - c0);
    block_matmul_fma(a_f, lda, C, w_fc1, C, nc, L, [&](int n) { return c0 + n; }, wtile, [&](int r, int n, float y) {
      const float u = y + vec_at(p, kBFc1, c0 + n);
      hid[r * sh + n] = 0.5f * u * (1.f + erff(u * 0.70710678118654752f));
    });
    block_matmul_fma(hid, sh, nc, w_fc2 + c0, p.hidden, C, L, ident, wtile,
                     [&](int r, int n, float y) { acc2[r * ld2 + n] += y; });
  }

  if (p.postnorm) {  // res += LN2(y), in place
    layer_norm_rows(o_f, lda, L, C, p, kLn2W, kLn2B, [&](int r, int c, float y) { res[r * ldr + c] += y; });
  }
  float* out = static_cast<float*>(p.out);
  for (int e = threadIdx.x * 4; e < L * C; e += kThreads * 4) {
    const int r = e / C, c = e % C;
    const long long tok = token_at(p.geo, origin, r, L);
    if (tok >= 0) *reinterpret_cast<float4*>(out + tok * C + c) = *reinterpret_cast<const float4*>(res + r * ldr + c);
  }
}

// ============================ bf16: wgmma ============================

constexpr int kG = 2;                    // windows per group: one per warpgroup
constexpr int kBlockThreads = kG * kWarpgroup;
constexpr int kTileBytes = kRows * 128;  // one 64 x 64 swizzled bf16 tile
constexpr int kStageRows = 192;          // a weight stage: 192 rows x 64 k, or three 64 x 64 tiles
constexpr int kStageBytes = kStageRows * 128;
constexpr int kPieceN = 64;  // a qkv piece: the q (or k, or v) columns of up to 64 / Dh heads
constexpr int kChunk = 64;  // hidden units per MLP chunk
constexpr int kMaxStages = 3;
// The vectors the kernel stages in shared memory in f32, 9 C floats:
// ln1_w, ln1_b, b_qkv (3C), b_proj, ln2_w, ln2_b, b_fc2 (b_fc1, whose
// length is the hidden width, is read from device memory).
constexpr int kSharedVecs = 9;

__host__ __device__ constexpr int k_tiles(int C) { return (C + 63) / 64; }
// One window's tiles: kC A, kC O, 3 q|k|v (later the MLP input and the
// output staging), 1 hidden (v2's norms during attention).
__host__ __device__ constexpr int window_bytes(int C) { return (2 * k_tiles(C) + 4) * kTileBytes; }
// Without the ring: alignment slack, both windows, the vectors, the barriers.
__host__ __device__ constexpr int fixed_smem_bytes(int C) {
  return 1024 + kG * window_bytes(C) + kSharedVecs * C * 4 + 2 * kMaxStages * 8;
}
__host__ __device__ constexpr int ring_stages(int C) {
  return (kMaxSmemBytes - fixed_smem_bytes(C)) / kStageBytes < kMaxStages
             ? (kMaxSmemBytes - fixed_smem_bytes(C)) / kStageBytes
             : kMaxStages;
}
__host__ __device__ constexpr int bf16_smem_bytes(int C) { return fixed_smem_bytes(C) + ring_stages(C) * kStageBytes; }
static_assert(ring_stages(kMaxC) >= 2, "two weight stages at the widest C");

struct Bf16Block {
  CUtensorMap qkv_map;   // (3C, C), boxes of Dh rows x 64 k
  CUtensorMap proj_map;  // (C, C), boxes of C rows x 64 k
  CUtensorMap fc1_map;   // (hidden, C), boxes of 64 rows x 64 k
  CUtensorMap fc2_map;   // (C, hidden), boxes of C rows x 64 k
  BlockArgs p;
  int stages;
};

// Byte offset of logical (row, 16-byte unit u) in a swizzled 64-column tile.
__device__ __forceinline__ int swz(int row, int u) { return row * 128 + ((u ^ (row & 7)) << 4); }

// bf16 element (row, col) of a set of swizzled tiles, col < 64 * tiles.
__device__ __forceinline__ bf16* tile_elem(unsigned char* tiles, int row, int col) {
  return reinterpret_cast<bf16*>(tiles + (col >> 6) * kTileBytes + swz(row, (col & 63) >> 3) + (col & 7) * 2);
}

__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  return pack_bf16(__float2bfloat16(lo), __float2bfloat16(hi));
}

// acc (+)= A B^T over one 64-deep k-tile: four k16 wgmma issues from the
// descriptors of the A and B tiles.
template <int N>
__device__ __forceinline__ void mma_k_tile(float (&acc)[N / 2], uint64_t da, uint64_t db, bool accumulate) {
#pragma unroll
  for (int ks = 0; ks < 4; ++ks) wgmma_tile<N>(acc, da + 2 * ks, db + 2 * ks, accumulate || ks > 0);
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

// Row statistics of the two rows a thread holds of a 64 x N accumulator
// (register 4 j + e: row lane / 4 + 8 (e / 2) of the warp's 16, column
// 8 j + 2 (lane % 4) + e % 2), over the C < N columns that exist: mean,
// then the variance over the centred values, in f32 by quad shuffles.
template <int N>
__device__ __forceinline__ void quad_stats(const float (&v)[N / 2], int C, float eps, int t, float (&mean)[2],
                                           float (&rstd)[2]) {
  float s[2] = {0.f, 0.f};
#pragma unroll
  for (int j = 0; j < N / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      if (8 * j + 2 * t + (e & 1) < C) s[e >> 1] += v[4 * j + e];
  mean[0] = quad_sum(s[0]) / C;
  mean[1] = quad_sum(s[1]) / C;
  float q[2] = {0.f, 0.f};
#pragma unroll
  for (int j = 0; j < N / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      if (8 * j + 2 * t + (e & 1) < C) {
        const float d = v[4 * j + e] - mean[e >> 1];
        q[e >> 1] += d * d;
      }
  rstd[0] = rsqrtf(quad_sum(q[0]) / C + eps);
  rstd[1] = rsqrtf(quad_sum(q[1]) / C + eps);
}

// LayerNorm (gamma g, beta b in shared memory) of the accumulator's rows
// in place; columns past C become 0.
template <int N>
__device__ __forceinline__ void quad_layer_norm(float (&v)[N / 2], const float* g, const float* b, int C, float eps,
                                                int t) {
  float mean[2], rstd[2];
  quad_stats<N>(v, C, eps, t, mean, rstd);
#pragma unroll
  for (int j = 0; j < N / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int c = 8 * j + 2 * t + (e & 1);
      v[4 * j + e] = c < C ? (v[4 * j + e] - mean[e >> 1]) * rstd[e >> 1] * g[c] + b[c] : 0.f;
    }
}

// LayerNorm of the accumulator's rows, rounded to bf16 into swizzled tiles
// (columns past C as zeros); the accumulator is left as it is.
template <int N>
__device__ __forceinline__ void store_layer_norm(unsigned char* tiles, const float (&v)[N / 2], const float* g,
                                                 const float* b, int C, float eps, int row0, int t) {
  float mean[2], rstd[2];
  quad_stats<N>(v, C, eps, t, mean, rstd);
#pragma unroll
  for (int j = 0; j < N / 8; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int c = 8 * j + 2 * t;
      uint32_t w = 0u;
      if (c < C)
        w = pack2((v[4 * j + 2 * h] - mean[h]) * rstd[h] * g[c] + b[c],
                  (v[4 * j + 2 * h + 1] - mean[h]) * rstd[h] * g[c + 1] + b[c + 1]);
      *reinterpret_cast<uint32_t*>(tile_elem(tiles, row0 + 8 * h, c)) = w;
    }
}

// The accumulator (two rows, N / 4 columns each) rounded to bf16 into
// swizzled tiles; columns past `valid` are written as zeros.
template <int N>
__device__ __forceinline__ void store_tiles(unsigned char* tiles, const float (&v)[N / 2], int row0, int t,
                                            int valid) {
#pragma unroll
  for (int j = 0; j < N / 8; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int c = 8 * j + 2 * t;
      const uint32_t w = c < valid ? pack2(v[4 * j + 2 * h], v[4 * j + 2 * h + 1]) : 0u;
      *reinterpret_cast<uint32_t*>(tile_elem(tiles, row0 + 8 * h, c)) = w;
    }
}

// The bf16 kernel; see the note at the top. Warpgroups 0 and 1 take
// windows 2 g and 2 g + 1 of each group g.
template <int NC, bool kCosine>
__global__ void __launch_bounds__(kBlockThreads, 1) swin_block_bf16_kernel(const __grid_constant__ Bf16Block blk) {
  const BlockArgs& p = blk.p;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* smem = smem_raw + (1024 - smem_addr(smem_raw) % 1024) % 1024;  // the swizzle's alignment
  const int C = p.C, L = p.L, H = p.num_heads, Dh = p.head_dim, hidden = p.hidden;
  const float eps = p.eps;
  const int kC = k_tiles(C), stages = blk.stages;
  constexpr bool cosine = kCosine;  // v2: q and k L2-normalised per head
  const int hp = Dh >= 64 ? 1 : 64 / Dh;  // heads per qkv piece
  const int n_pieces = (H + hp - 1) / hp;
  const int n_chunks = (hidden + kChunk - 1) / kChunk;
  const int n_groups = (p.windows + kG - 1) / kG;
  // Each block takes a contiguous run of groups, and windows are numbered
  // window-major (the same window of consecutive images next to each
  // other), so a block's groups share their bias table while it is in L1.
  const int per_block = (n_groups + (int)gridDim.x - 1) / (int)gridDim.x;
  const int grp_begin = min((int)blockIdx.x * per_block, n_groups);
  const int grp_end = min(grp_begin + per_block, n_groups);
  const unsigned images = (unsigned)p.windows / (unsigned)p.geo.n_windows;
  unsigned char* ring = smem;
  unsigned char* windows = ring + stages * kStageBytes;
  float* vec = reinterpret_cast<float*>(windows + kG * window_bytes(C));  // the staged vectors, f32
  uint64_t* full = reinterpret_cast<uint64_t*>(vec + kSharedVecs * C);
  int* done = reinterpret_cast<int*>(full + stages);  // per stage, the warps done with its current round
  const float *ln1_w = vec, *ln1_b = vec + C, *b_qkv = vec + 2 * C, *b_proj = vec + 5 * C;
  const float *ln2_w = vec + 6 * C, *ln2_b = vec + 7 * C, *b_fc2 = vec + 8 * C;

  // The weight stream: the same steps for every group (qkv pieces by
  // k-tile, proj by k-tile, then fc1 and fc2 of each hidden chunk), stage
  // use i in stage i % stages. issue(i) hands stage use i to TMA.
  const int steps = 3 * n_pieces + kC + 2 * n_chunks;
  const uint32_t uses = (uint32_t)(grp_end - grp_begin) * steps;
  auto expect = [&](int s, int bytes) { mbar_arrive_expect_tx(&full[s], bytes); };
  auto load = [&](int s, int offset, const CUtensorMap* map, int c0, int c1) {
    tma_load_2d(ring + s * kStageBytes + offset, map, &full[s], c0, c1);
  };
  auto issue = [&](uint32_t i) {
    if (i >= uses) return;
    const int s = i % stages;
    int step = i % steps;
    if (step < 3 * n_pieces) {  // the q, k or v rows of a piece's heads, every k-tile
      const int j = step / 3, third = step % 3, heads = min(hp, H - j * hp);
      expect(s, kC * heads * Dh * 128);
      for (int kt = 0; kt < kC; ++kt)
        for (int hl = 0; hl < heads; ++hl)
          load(s, kt * kTileBytes + hl * Dh * 128, &blk.qkv_map, kt * 64, third * C + (j * hp + hl) * Dh);
    } else if ((step -= 3 * n_pieces) < kC) {  // proj, one k-tile
      expect(s, C * 128);
      load(s, 0, &blk.proj_map, step * 64, 0);
    } else if ((step -= kC) % 2 == 0) {  // fc1's 64 rows of a chunk, every k-tile
      expect(s, kC * kTileBytes);
      for (int kt = 0; kt < kC; ++kt) load(s, kt * kTileBytes, &blk.fc1_map, kt * 64, step / 2 * kChunk);
    } else {  // fc2's C rows at the chunk's 64 k
      expect(s, C * 128);
      load(s, 0, &blk.fc2_map, step / 2 * kChunk, 0);
    }
  };

  if (threadIdx.x == 0) {
    asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(&blk.qkv_map)) : "memory");
    asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(&blk.proj_map)) : "memory");
    asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(&blk.fc1_map)) : "memory");
    asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(&blk.fc2_map)) : "memory");
    for (int s = 0; s < stages; ++s) {
      mbar_init(&full[s], 1);  // one arrive with the expected bytes, plus the TMA bytes
      done[s] = 0;
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    for (int s = 0; s < stages; ++s) issue(s);
  }
  // the vectors into shared memory in f32, once per block
  for (int i = threadIdx.x; i < kSharedVecs * C; i += kBlockThreads) {
    const int v = i / C, k = i % C;
    const int which = v == 0 ? kLn1W : v == 1 ? kLn1B : v <= 4 ? kBQkv : v == 5 ? kBProj : v == 6 ? kLn2W
                      : v == 7 ? kLn2B : kBFc2;
    vec[i] = vec_at(p, which, (which == kBQkv ? v - 2 : 0) * C + k);
  }
  __syncthreads();

  const int cw = threadIdx.x / kWarpgroup;  // this warpgroup's window of each group
  const int lane = threadIdx.x % 32;
  unsigned char* win = windows + cw * window_bytes(C);
  unsigned char* a_tiles = win;                          // LN1 x (v1) or x (v2); with o_tiles, v2's h in f32
  unsigned char* o_tiles = a_tiles + kC * kTileBytes;    // the attention output
  unsigned char* qkv_tiles = o_tiles + kC * kTileBytes;  // q | k | v, then the MLP input, then the output
  unsigned char* hid_tile = qkv_tiles + 3 * kTileBytes;  // gelu's output; v2's norms during attention
  float* h_f32 = reinterpret_cast<float*>(a_tiles);      // v2: h over the MLP, (64, C)
  float* norms = reinterpret_cast<float*>(hid_tile);     // v2: [q | k][head of the piece][row]
  const bf16* x = static_cast<const bf16*>(p.x);
  bf16* out = static_cast<bf16*>(p.out);
  const int bar = 1 + cw;
  auto sync_wg = [&]() { named_barrier(bar, kWarpgroup); };
  // The ring as this warpgroup sees it: stage `next` is the next to be
  // waited for, stage `freed` the next to be released.
  uint32_t next = 0, freed = 0;
  auto wait_stage = [&]() {
    mbar_wait(&full[next % stages], (next / stages) & 1);
    return ring + (next++ % stages) * kStageBytes;
  };
  // The eighth warp done with a stage's round refills the stage for its
  // next round: no warp waits for another to release it.
  auto release = [&]() {
    if (lane == 0) {
      const int s = freed % stages;
      if (atomicAdd(&done[s], 1) == 2 * kWarpgroup / 32 - 1) {
        done[s] = 0;
        __threadfence_block();
        issue(freed + stages);
      }
    }
    ++freed;
  };
#pragma unroll 1
  for (int grp = grp_begin; grp < grp_end; ++grp) {
    // The thread's indices, opaque to the compiler within each window, so
    // that the many addresses derived from them are computed where they
    // are used rather than hoisted out of the loop into registers.
    int tid = threadIdx.x;
    asm volatile("" : "+r"(tid));
    const int wt = tid % kWarpgroup, warp = wt / 32, ln = tid % 32, t = tid & 3;
    const int row0 = 16 * warp + ((tid % 32) >> 2);  // this thread's accumulator rows: row0 and row0 + 8
    const unsigned wm = (unsigned)(kG * grp + cw);  // window-major: window wm / images of image wm % images
    const unsigned w = wm % images * (unsigned)p.geo.n_windows + wm / images;
    const bool live = wm < (unsigned)p.windows;
    const int wb = (int)(w % (unsigned)p.geo.n_windows) % p.n_bias;
    const WindowOrigin origin = window_origin(p.geo, w);
    sync_wg();  // the previous window's readers of every buffer are done

    // ---- the window's tokens, 16 bytes a thread, into the A tiles; the
    // columns past C of the A and O tiles become zeros. All of a thread's
    // loads are issued before its first store (a store through a generic
    // pointer would otherwise hold back the next load).
    {
      constexpr int kIters = kRows * 3 * 8 / kWarpgroup;  // 16-byte pieces a thread moves at kC = 3
      uint4 xv[kIters];
#pragma unroll
      for (int k = 0; k < kIters; ++k) {
        const int i = wt + k * kWarpgroup, r = i / (kC * 8), c = 8 * (i % (kC * 8));
        xv[k] = make_uint4(0u, 0u, 0u, 0u);
        const long long tok = live && i < kRows * kC * 8 && c < C ? token_at(p.geo, origin, r, L) : -1;
        if (tok >= 0) xv[k] = __ldg(reinterpret_cast<const uint4*>(x + tok * C + c));
      }
#pragma unroll
      for (int k = 0; k < kIters; ++k) {
        const int i = wt + k * kWarpgroup, r = i / (kC * 8), u = i % (kC * 8);
        if (i >= kRows * kC * 8) break;
        const int at = (u >> 3) * kTileBytes + swz(r, u & 7);
        *reinterpret_cast<uint4*>(a_tiles + at) = xv[k];
        if (8 * u >= C) *reinterpret_cast<uint4*>(o_tiles + at) = xv[k];
      }
    }
    sync_wg();
    if (!p.postnorm) {
      // LN1 in place, two threads a row, each every other 16-byte unit
      const int r = wt >> 1, half = wt & 1;
      float sum = 0.f;
      for (int u = half; u < C / 8; u += 2) {
        const uint4 raw = *reinterpret_cast<const uint4*>(a_tiles + (u >> 3) * kTileBytes + swz(r, u & 7));
        const bf16* e = reinterpret_cast<const bf16*>(&raw);
#pragma unroll
        for (int k = 0; k < 8; ++k) sum += __bfloat162float(e[k]);
      }
      const float mean = (sum + __shfl_xor_sync(0xffffffffu, sum, 1)) / C;
      float sq = 0.f;
      for (int u = half; u < C / 8; u += 2) {
        const uint4 raw = *reinterpret_cast<const uint4*>(a_tiles + (u >> 3) * kTileBytes + swz(r, u & 7));
        const bf16* e = reinterpret_cast<const bf16*>(&raw);
#pragma unroll
        for (int k = 0; k < 8; ++k) {
          const float d = __bfloat162float(e[k]) - mean;
          sq += d * d;
        }
      }
      const float rstd = rsqrtf((sq + __shfl_xor_sync(0xffffffffu, sq, 1)) / C + eps);
      for (int u = half; u < C / 8; u += 2) {
        uint4* dst = reinterpret_cast<uint4*>(a_tiles + (u >> 3) * kTileBytes + swz(r, u & 7));
        uint4 raw = *dst;
        bf16* e = reinterpret_cast<bf16*>(&raw);
#pragma unroll
        for (int k = 0; k < 8; ++k) {
          const int c = 8 * u + k;
          e[k] = __float2bfloat16((__bfloat162float(e[k]) - mean) * rstd * ln1_w[c] + ln1_b[c]);
        }
        *dst = raw;
      }
    }
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");  // generic writes, then wgmma's reads
    sync_wg();

    // ---- qkv by pieces of 64 / Dh heads, each piece's attention after it
    // This thread's bias values of a head, asked for ahead of their use:
    // the piece's first head's once q|k|v is stored, the next head's before
    // the current head's softmax. (Asked for across a product they are
    // spilled: the products leave too few registers.)
    float bv[8][4];
    auto load_bias = [&](int h) {
      const float* bias_h = p.bias + ((long long)wb * H + h) * L * L;
      if (L % 2 == 0 && reinterpret_cast<uintptr_t>(p.bias) % 8 == 0) {  // (c, c + 1) 8-byte aligned: one load
#pragma unroll
        for (int n = 0; n < 8; ++n)
#pragma unroll
          for (int e = 0; e < 4; e += 2) {
            const int r = row0 + 4 * e, c = 8 * n + 2 * t;
            const float2 b2 = r < L && c < L ? __ldg(reinterpret_cast<const float2*>(bias_h + r * L + c))
                                             : make_float2(0.f, 0.f);
            bv[n][e] = b2.x;
            bv[n][e + 1] = b2.y;
          }
      } else {
#pragma unroll
        for (int n = 0; n < 8; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int r = row0 + 8 * (e >> 1), c = 8 * n + 2 * t + (e & 1);
            bv[n][e] = r < L && c < L ? __ldg(bias_h + r * L + c) : 0.f;
          }
      }
    };
#pragma unroll 1
    for (int j = 0; j < n_pieces; ++j) {
      const int heads = min(hp, H - j * hp);
      {
        // q, k and v as three products of N = 64, each over all of K from
        // one stage, the next issued before the last one's epilogue
        float qa[kPieceN / 2], qb[kPieceN / 2];
        auto issue_third = [&](float(&acc)[kPieceN / 2]) {
          unsigned char* st = wait_stage();
          fence_accumulator(acc);
          wgmma_fence();
          for (int kt = 0; kt < kC; ++kt)
            mma_k_tile<kPieceN>(acc, sw128_desc(a_tiles + kt * kTileBytes), sw128_desc(st + kt * kTileBytes), kt > 0);
          wgmma_commit();
          fence_accumulator(acc);
        };
        // + bias in f32, rounded, into the third's tile; the columns of
        // heads past the piece become zeros
        auto finish_third = [&](float(&acc)[kPieceN / 2], int third) {
#pragma unroll
          for (int jj = 0; jj < kPieceN / 8; ++jj) {
            const int c = 8 * jj + 2 * t;
            const bool ok = c < heads * Dh;
            const int n = third * C + j * hp * Dh + c;
            const float b0 = ok ? b_qkv[n] : 0.f, b1 = ok ? b_qkv[n + 1] : 0.f;
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const uint32_t v = ok ? pack2(acc[4 * jj + 2 * h] + b0, acc[4 * jj + 2 * h + 1] + b1) : 0u;
              *reinterpret_cast<uint32_t*>(tile_elem(qkv_tiles + third * kTileBytes, row0 + 8 * h, c)) = v;
            }
          }
        };
        issue_third(qa);
        issue_third(qb);
        wgmma_wait<1>();
        fence_accumulator(qa);
        release();
        finish_third(qa, 0);
        issue_third(qa);
        wgmma_wait<1>();
        fence_accumulator(qb);
        release();
        finish_third(qb, 1);
        wgmma_wait<0>();
        fence_accumulator(qa);
        release();
        finish_third(qa, 2);
      }
      load_bias(j * hp);
      sync_wg();
      if constexpr (cosine) {
        // v2: gs / |q| of every row and 1 / |k| of every key, per head, in f32
        for (int i = wt; i < 2 * heads * kRows; i += kWarpgroup) {
          const int which = i / (heads * kRows), hl = (i / kRows) % heads, r = i % kRows;
          float s2 = 0.f;
          for (int u = 0; u < Dh / 8; ++u) {
            const uint4 raw = *reinterpret_cast<const uint4*>(qkv_tiles + which * kTileBytes +
                                                              swz(r, (hl * Dh) / 8 + u));
            const bf16* e = reinterpret_cast<const bf16*>(&raw);
#pragma unroll
            for (int k = 0; k < 8; ++k) s2 += __bfloat162float(e[k]) * __bfloat162float(e[k]);
          }
          const float inv = 1.f / fmaxf(sqrtf(s2), 1e-12f);
          norms[i] = which == 0 ? p.gs[j * hp + hl] * inv : inv;
        }
        sync_wg();
      }
#pragma unroll 1
      for (int hl = 0; hl < heads; ++hl) {
        const int h = j * hp + hl, col = hl * Dh;
        // S = Q K^T: this warp's 16 rows against the 64 keys
        float s[8][4];
#pragma unroll
        for (int n = 0; n < 8; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
#pragma unroll
        for (int kd = 0; kd < kMaxHeadDim / 16; ++kd) {
          if (16 * kd >= Dh) break;
          uint32_t qf[4];
          ldmatrix_x4(qf, reinterpret_cast<const bf16*>(
                              qkv_tiles + swz(16 * warp + ln % 16, (col + 16 * kd) / 8 + ln / 16)));
#pragma unroll
          for (int jj = 0; jj < 4; ++jj) {
            uint32_t kb[4];
            ldmatrix_x4(kb, reinterpret_cast<const bf16*>(qkv_tiles + kTileBytes +
                                                          swz(16 * jj + ln % 8 + 8 * (ln / 16),
                                                              (col + 16 * kd) / 8 + ln / 8 % 2)));
            mma_bf16(s[2 * jj], qf, kb[0], kb[1]);
            mma_bf16(s[2 * jj + 1], qf, kb[2], kb[3]);
          }
        }
        // scales, bias and key mask; softmax by quads; p rounded to bf16
        float qs[2] = {1.f, 1.f}, m[2] = {-INFINITY, -INFINITY};
        if constexpr (cosine) {
          qs[0] = norms[hl * kRows + row0];
          qs[1] = norms[hl * kRows + row0 + 8];
        }
#pragma unroll
        for (int n = 0; n < 8; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int c = 8 * n + 2 * t + (e & 1);
            float v = -INFINITY;
            if (c < L) {
              const float ki = cosine ? norms[(heads + hl) * kRows + c] : 1.f;
              v = s[n][e] * qs[e >> 1] * ki * p.scale + bv[n][e];
            }
            s[n][e] = v;
            m[e >> 1] = fmaxf(m[e >> 1], v);
          }
        if (hl + 1 < heads) load_bias(h + 1);
        m[0] = quad_max(m[0]);
        m[1] = quad_max(m[1]);
        float sum[2] = {0.f, 0.f};
#pragma unroll
        for (int n = 0; n < 8; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float v = 8 * n + 2 * t + (e & 1) < L ? expf(s[n][e] - m[e >> 1]) : 0.f;
            s[n][e] = v;
            sum[e >> 1] += v;
          }
        const float inv[2] = {1.f / quad_sum(sum[0]), 1.f / quad_sum(sum[1])};
        uint32_t pk[8][2];  // p of (row0, keys 8 n + 2 t, + 1) and (row0 + 8, same keys)
#pragma unroll
        for (int n = 0; n < 8; ++n) {
          pk[n][0] = pack2(s[n][0] * inv[0], s[n][1] * inv[0]);
          pk[n][1] = pack2(s[n][2] * inv[1], s[n][3] * inv[1]);
        }
        // O = P V, the P fragments straight from the registers
        float o[kMaxHeadDim / 8][4];
#pragma unroll
        for (int n = 0; n < kMaxHeadDim / 8; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) o[n][e] = 0.f;
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          const uint32_t a[4] = {pk[2 * kk][0], pk[2 * kk][1], pk[2 * kk + 1][0], pk[2 * kk + 1][1]};
#pragma unroll
          for (int nd = 0; nd < kMaxHeadDim / 16; ++nd) {
            if (16 * nd >= Dh) break;
            uint32_t vb[4];
            ldmatrix_x4_trans(vb, reinterpret_cast<const bf16*>(qkv_tiles + 2 * kTileBytes +
                                                                swz(16 * kk + ln % 8 + 8 * (ln / 8 % 2),
                                                                    (col + 16 * nd) / 8 + ln / 16)));
            mma_bf16(o[2 * nd], a, vb[0], vb[1]);
            mma_bf16(o[2 * nd + 1], a, vb[2], vb[3]);
          }
        }
#pragma unroll
        for (int n = 0; n < kMaxHeadDim / 8; ++n) {
          if (8 * n >= Dh) break;
          const int c = h * Dh + 8 * n + 2 * t;
#pragma unroll
          for (int hh = 0; hh < 2; ++hh)
            *reinterpret_cast<uint32_t*>(tile_elem(o_tiles, row0 + 8 * hh, c)) =
                pack2(o[n][2 * hh], o[n][2 * hh + 1]);
        }
      }
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");  // O's generic writes, then proj's wgmma
      sync_wg();  // every warp is past this piece's q|k|v
    }

    // ---- proj, the first residual and the MLP input
    // over kC k-tiles, one stage each; a stage is released once the
    // products that read it are done
    float acc[NC / 2];
    for (int kt = 0; kt < kC; ++kt) {
      unsigned char* st = wait_stage();
      fence_accumulator(acc);
      wgmma_fence();
      mma_k_tile<NC>(acc, sw128_desc(o_tiles + kt * kTileBytes), sw128_desc(st), kt > 0);
      wgmma_commit();
      fence_accumulator(acc);
      if (kt > 0) {
        wgmma_wait<1>();
        release();
      }
    }
    wgmma_wait<0>();
    fence_accumulator(acc);
    release();
    const long long tok[2] = {live ? token_at(p.geo, origin, row0, L) : -1,
                              live ? token_at(p.geo, origin, row0 + 8, L) : -1};
    uint32_t xr[NC / 8][2];  // x at (row0 + 8 h, 8 j + 2 t and + 1), bf16 pairs, for the residual
#pragma unroll
    for (int jj = 0; jj < NC / 8; ++jj)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int c = 8 * jj + 2 * t;
        xr[jj][h] = tok[h] >= 0 && c < C ? __ldg(reinterpret_cast<const unsigned*>(x + tok[h] * C + c)) : 0u;
      }
#pragma unroll
    for (int jj = 0; jj < NC / 8; ++jj)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = 8 * jj + 2 * t + (e & 1);
        acc[4 * jj + e] = c < C ? acc[4 * jj + e] + b_proj[c] : 0.f;
      }
    if (p.postnorm) quad_layer_norm<NC>(acc, ln1_w, ln1_b, C, eps, t);
#pragma unroll
    for (int jj = 0; jj < NC / 8; ++jj)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float2 xv = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&xr[jj][h]));
        acc[4 * jj + 2 * h] += xv.x;  // h = x + proj, or x + LN1(proj) (v2)
        acc[4 * jj + 2 * h + 1] += xv.y;
      }
    if (p.postnorm) {
      sync_wg();  // every warp's proj has read the O tiles, which h overwrites
#pragma unroll
      for (int jj = 0; jj < NC / 8; ++jj)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int c = 8 * jj + 2 * t;
          if (c < C)
            *reinterpret_cast<float2*>(h_f32 + (row0 + 8 * h) * C + c) =
                make_float2(acc[4 * jj + 2 * h], acc[4 * jj + 2 * h + 1]);
        }
      store_tiles<NC>(qkv_tiles, acc, row0, t, C);  // the MLP input: h itself
#pragma unroll
      for (int i = 0; i < NC / 2; ++i) acc[i] = 0.f;  // fc2 sums into y
    } else {
      store_layer_norm<NC>(qkv_tiles, acc, ln2_w, ln2_b, C, eps, row0, t);  // the MLP input: LN2 h
#pragma unroll
      for (int jj = 0; jj < NC / 8; ++jj)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int c = 8 * jj + 2 * t + (e & 1);
          if (c < C) acc[4 * jj + e] += b_fc2[c];  // fc2 sums onto h + b2
        }
    }
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    sync_wg();

    // ---- the MLP by hidden chunks. fc1 of a chunk into a1, gelu into the
    // hidden tile, then fc2's partial product into acc issued together
    // with the next chunk's fc1, so the two run at once.
    float a1[kChunk / 2];
    auto issue_fc1 = [&]() {
      unsigned char* st = wait_stage();
      fence_accumulator(a1);
      wgmma_fence();
      for (int kt = 0; kt < kC; ++kt)
        mma_k_tile<kChunk>(a1, sw128_desc(qkv_tiles + kt * kTileBytes), sw128_desc(st + kt * kTileBytes), kt > 0);
      wgmma_commit();
      fence_accumulator(a1);
    };
    if (n_chunks > 0) issue_fc1();
#pragma unroll 1
    for (int ch = 0; ch < n_chunks; ++ch) {
      float b1[kChunk / 8][2];  // this thread's columns of b_fc1, asked for before the wait
#pragma unroll
      for (int jj = 0; jj < kChunk / 8; ++jj)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int n = ch * kChunk + 8 * jj + 2 * t + e;
          b1[jj][e] = n < hidden ? param(p.vec[kBFc1], p.param_bf16, n) : 0.f;
        }
      wgmma_wait<0>();  // fc1 of this chunk and fc2 of the last are done
      fence_accumulator(a1);
      fence_accumulator(acc);
      if (ch > 0) release();  // the last chunk's fc2 stage
      release();              // this chunk's fc1 stage
#pragma unroll
      for (int jj = 0; jj < kChunk / 8; ++jj)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float u = a1[4 * jj + e] + b1[jj][e & 1];
          a1[4 * jj + e] = 0.5f * u * (1.f + erff(u * 0.70710678118654752f));
        }
      sync_wg();  // every warp's fc2 of the last chunk has read the hidden tile
      store_tiles<kChunk>(hid_tile, a1, row0, t, kChunk);
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      sync_wg();
      {
        unsigned char* st = wait_stage();
        fence_accumulator(acc);
        wgmma_fence();
        mma_k_tile<NC>(acc, sw128_desc(hid_tile), sw128_desc(st), true);  // fc2's partial product
        wgmma_commit();
        fence_accumulator(acc);
      }
      if (ch + 1 < n_chunks) issue_fc1();
    }
    wgmma_wait<0>();
    fence_accumulator(acc);
    if (n_chunks > 0) release();

    // ---- out = h + y (v1, already in acc) or h + LN2(y + b2) (v2)
    if (p.postnorm) {
#pragma unroll
      for (int jj = 0; jj < NC / 8; ++jj)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int c = 8 * jj + 2 * t + (e & 1);
          if (c < C) acc[4 * jj + e] += b_fc2[c];
        }
      quad_layer_norm<NC>(acc, ln2_w, ln2_b, C, eps, t);
#pragma unroll
      for (int jj = 0; jj < NC / 8; ++jj)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int c = 8 * jj + 2 * t;
          if (c < C) {
            const float2 hv = *reinterpret_cast<const float2*>(h_f32 + (row0 + 8 * h) * C + c);
            acc[4 * jj + 2 * h] += hv.x;
            acc[4 * jj + 2 * h + 1] += hv.y;
          }
        }
    }
    sync_wg();  // every warp's fc1 has read the MLP input, which the output overwrites
    store_tiles<NC>(qkv_tiles, acc, row0, t, C);
    sync_wg();
    for (int i = wt; i < kRows * (C / 8); i += kWarpgroup) {
      const int r = i / (C / 8), u = i % (C / 8);
      const long long tk = live ? token_at(p.geo, origin, r, L) : -1;
      if (tk >= 0)
        *reinterpret_cast<uint4*>(out + tk * C + 8 * u) =
            *reinterpret_cast<const uint4*>(qkv_tiles + (u >> 3) * kTileBytes + swz(r, u & 7));
    }
  }
}

// The N of proj's and fc2's wgmma for a C: C rounded up to 96, 128 or 192.
int proj_width(int C) { return C <= 96 ? 96 : C <= 128 ? 128 : 192; }

template <int NC, bool kCosine>
cudaError_t launch_bf16(const BlockArgs& p, cudaStream_t stream, int* blocks_per_sm) {
  const int smem = bf16_smem_bytes(p.C);
  auto kernel = swin_block_bf16_kernel<NC, kCosine>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  if (blocks_per_sm != nullptr)  // a report: nothing is launched
    return cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks_per_sm, kernel, kBlockThreads, smem);
  Bf16Block blk;
  blk.p = p;
  blk.stages = ring_stages(p.C);
  err = encode_operand(&blk.qkv_map, p.w_qkv, 3LL * p.C, p.C, p.head_dim);
  if (err == cudaSuccess) err = encode_operand(&blk.proj_map, p.w_proj, p.C, p.C, p.C);
  if (err == cudaSuccess) err = encode_operand(&blk.fc1_map, p.w_fc1, p.hidden, p.C, kChunk);
  if (err == cudaSuccess) err = encode_operand(&blk.fc2_map, p.w_fc2, p.C, p.hidden, p.C);
  if (err != cudaSuccess) return err;
  int device = 0, sms = 0;
  err = cudaGetDevice(&device);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  const int groups = (p.windows + kG - 1) / kG;
  const unsigned grid = (unsigned)(groups < sms ? groups : sms);  // persistent: one block per SM
  kernel<<<grid, kBlockThreads, smem, stream>>>(blk);
  return cudaGetLastError();
}

// One instantiation per proj width and per attention form: the cosine
// (v2) code compiled into the v1 kernel cost it 5-12% (PERF.md, PR 8).
template <bool kCosine>
cudaError_t launch_or_query_bf16(const BlockArgs& p, cudaStream_t stream, int* blocks_per_sm) {
  switch (proj_width(p.C)) {
    case 96: return launch_bf16<96, kCosine>(p, stream, blocks_per_sm);
    case 128: return launch_bf16<128, kCosine>(p, stream, blocks_per_sm);
    default: return launch_bf16<192, kCosine>(p, stream, blocks_per_sm);
  }
}

cudaError_t launch_f32(const BlockArgs& p, cudaStream_t stream) {
  const size_t smem = make_layout(p.C, p.head_dim).total;
  int device = 0, max_smem = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&max_smem, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (err != cudaSuccess) return err;
  if (smem > (size_t)max_smem) return cudaErrorInvalidValue;
  err = cudaFuncSetAttribute(swin_block_f32_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  swin_block_f32_kernel<<<p.windows, kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

bool aligned(const void* ptr) { return reinterpret_cast<uintptr_t>(ptr) % 16 == 0; }

}  // namespace

extern "C" {

// One Swin block on the NHWC map x (images, height, width, C), the output
// (same shape) written where x is read. dtype: 0 = float32, 1 = bfloat16;
// param_dtype the same for the eight vectors. The windows: (win_h, win_w)
// over the map padded bottom and right to (pad_h, pad_w), cyclically
// shifted by (shift_h, shift_w) (0 where one window covers a side); n_bias
// 1 or the windows per image. w_qkv (3C, C), w_proj (C, C), w_fc1 (hidden,
// C), w_fc2 (C, hidden) in the input type, torch's (out, in) layout; the
// vectors ln1_w, ln1_b, b_qkv (3C), b_proj, ln2_w, ln2_b, b_fc1 (hidden),
// b_fc2; bias (n_bias, heads, L, L) f32; gs (heads,) f32 or null (null:
// v1; non-null: v2 cosine attention). postnorm: 0 = v1, 1 = v2. All
// contiguous on the current device, x, out and the matrices 16-byte
// aligned. Launches on `stream` and returns the cudaError_t of the launch.
int eqx_swin_block(const void* x, void* out, const void* w_qkv, const void* w_proj, const void* w_fc1,
                   const void* w_fc2, const void* ln1_w, const void* ln1_b, const void* b_qkv, const void* b_proj,
                   const void* ln2_w, const void* ln2_b, const void* b_fc1, const void* b_fc2, const void* bias,
                   const void* gs, int images, int height, int width, int pad_h, int pad_w, int win_h, int win_w,
                   int shift_h, int shift_w, int n_bias, int channels, int hidden, int num_heads, float scale,
                   float eps, int postnorm, int dtype, int param_dtype, void* stream) {
  const int L = win_h * win_w;
  if (images <= 0 || height <= 0 || width <= 0 || win_h <= 0 || win_w <= 0 || pad_h % win_h != 0 ||
      pad_w % win_w != 0 || pad_h < height || pad_h - height >= win_h || pad_w < width || pad_w - width >= win_w ||
      shift_h < 0 || shift_h >= pad_h || shift_w < 0 || shift_w >= pad_w || L > kRows || channels <= 0 ||
      channels > kMaxC || channels % 16 != 0 || hidden % 16 != 0 || hidden <= 0 || num_heads <= 0 ||
      channels % num_heads != 0 || channels / num_heads > kMaxHeadDim || (channels / num_heads) % 16 != 0 ||
      (dtype != 0 && dtype != 1) || (param_dtype != 0 && param_dtype != 1))
    return cudaErrorInvalidValue;
  const long long n_windows = (long long)(pad_h / win_h) * (pad_w / win_w);
  if (n_windows * images > INT_MAX || (n_bias != 1 && n_bias != n_windows)) return cudaErrorInvalidValue;
  for (const void* ptr : {x, (const void*)out, w_qkv, w_proj, w_fc1, w_fc2})
    if (!aligned(ptr)) return cudaErrorInvalidValue;
  BlockArgs p;
  p.x = x;
  p.out = out;
  p.w_qkv = w_qkv;
  p.w_proj = w_proj;
  p.w_fc1 = w_fc1;
  p.w_fc2 = w_fc2;
  const void* vecs[kVecs] = {ln1_w, ln1_b, b_qkv, b_proj, ln2_w, ln2_b, b_fc1, b_fc2};
  for (int i = 0; i < kVecs; ++i) p.vec[i] = vecs[i];
  p.param_bf16 = param_dtype == 1;
  p.bias = static_cast<const float*>(bias);
  p.gs = static_cast<const float*>(gs);
  p.geo = {(int)n_windows, pad_w / win_w, height, width, pad_h, pad_w, win_h, win_w, shift_h, shift_w};
  p.windows = (int)(n_windows * images);
  p.n_bias = n_bias;
  p.L = L;
  p.C = channels;
  p.hidden = hidden;
  p.num_heads = num_heads;
  p.head_dim = channels / num_heads;
  p.scale = scale;
  p.eps = eps;
  p.postnorm = postnorm;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch_f32(p, s);
  return gs != nullptr ? launch_or_query_bf16<true>(p, s, nullptr) : launch_or_query_bf16<false>(p, s, nullptr);
}

// Dynamic shared memory one block needs; for error messages and reports.
long long eqx_swin_block_smem_bytes(int channels, int head_dim, int elem_bytes) {
  return elem_bytes == 2 ? (long long)bf16_smem_bytes(channels) : (long long)make_layout(channels, head_dim).total;
}

// The bf16 design at a C, for reports: info[0] windows a block works on at
// once (G), info[1] weight stages in the ring, info[2] dynamic shared
// memory in bytes, info[3] blocks resident on an SM. Returns a cudaError_t.
int eqx_swin_block_config(int channels, int num_heads, int* info) {
  if (channels <= 0 || channels > kMaxC || channels % 16 != 0 || num_heads <= 0 || channels % num_heads != 0)
    return cudaErrorInvalidValue;
  BlockArgs p = {};
  p.C = channels;
  p.head_dim = channels / num_heads;
  info[0] = kG;
  info[1] = ring_stages(channels);
  info[2] = bf16_smem_bytes(channels);
  return launch_or_query_bf16<false>(p, nullptr, &info[3]);
}

}  // extern "C"
