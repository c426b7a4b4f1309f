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
// f32 design (sm_90a), split TF32 on the same tensor cores (PERF.md §6):
//   - The weights are split once a call (split_weights_kernel, a small
//     launch before the block's) into a scratch buffer the wrapper
//     allocates: each becomes a TF32 hi plane and a lo plane (hi = tf32(w),
//     lo = tf32(w - hi), rounded to nearest; a NaN or an infinity kept in
//     hi), each row's k reordered within groups of 8 as 0, 2, 4, 6, 1, 3, 5,
//     7. No window splits a weight, and the k index t of a product step
//     reads column 2 t of its group, t + 4 column 2 t + 1: the two columns a
//     thread holds of an accumulator row, or reads as one float2.
//   - The bf16 kernel's grid and ring: 256-thread blocks, one 64-row window
//     a warpgroup, G = 2 windows a group, groups walked window-major; the
//     weights by TMA (maps of (k, row, plane)) into four mbarrier-guarded
//     24 KB stages, one 32-float k-tile of up to 96 rows of hi and of lo a
//     stage, refilled by the eighth warp done with it; both windows
//     multiply every stage.
//   - The four products on wgmma m64nNk8 .tf32 with A from registers, split
//     as it is read: each k-step hi lo, lo hi, hi hi into a part that each
//     k-tile starts from zero and adds to the product's sum in f32 (the
//     tensor cores add into their accumulator rounding toward zero). qkv's
//     A from x in device memory (v1: LN1 on the way), by pieces of 64 / Dh
//     heads, q, k and v each a 64-wide product over C; proj's from the
//     heads' outputs in shared memory, NB = 96 (or 64) columns a product,
//     summed over the pieces; fc1's from h (v1: LN2 on the way), 64 wide a
//     hidden chunk; fc2's straight from gelu's registers (the accumulator
//     layout is the A fragment's under the reordered k).
//   - Attention per head in registers, each warp its 16 rows, split TF32 on
//     mma.sync m16n8k8 as the f32 window stage: S from the q and k tiles,
//     v1's scale or v2's f32 norms and the bias on the accumulators, the
//     softmax by quads, e = exp(s - max) split as P V's A fragments with
//     the keys reordered; O / sum written over the head's q columns.
//   - Rows are taken about a pivot, x at the row's first column: LN1 centres
//     x - pivot, h is kept as h - pivot (f32, over the piece tiles once the
//     attention is done), fc2 sums from zero and the pivot comes back once,
//     at the store: a row of 1e3 + N(0, 1) keeps its mean to f32's
//     precision of an O(1) value, and its output is rounded once.
//   Shared memory: per window q, k and v tiles of 64 x 64 f32 (row strides
//   72, 72, 68: conflict-free fragment reads; later h), v2's norms; the
//   ring; the vectors: 219 KB at C = 192, one block an SM.
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
// In f32 the products count three times (split TF32: 165 TFLOP/s of f32
// products) and the bytes twice: 0.584 ms against 0.093 ms of device memory
// (311 MB), still the arithmetic. The f32 kernel takes 4.3 ms there (7x):
// its ablation (PERF.md §6) puts about 1.9 ms in the products and their
// waits (0.4 of it the split's two extra products), 0.9 ms in the attention
// and 0.3 in gelu; the weight stream is hidden. ptxas gives it 255
// registers, with up to 720 bytes of spills at C = 192, where proj's 96
// accumulators stay live across the attention.
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

// ============================ shared by both kernels ============================

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

// ============================ f32: split TF32 on wgmma ============================

// D (+)= A B^T on TF32 operands, k = 8, A from registers: a[0..3] hold A at
// (row g, k t), (g + 8, t), (g, t + 4), (g + 8, t + 4) of the warp's 16 rows
// (g = lane / 4, t = lane % 4), as mma.sync's m16n8k8 A fragment; B by
// descriptor, K-major with the 128-byte swizzle.
__device__ __forceinline__ void wgmma_tf32_rs_m64n64k8(float (&d)[32], const uint32_t (&a)[4], uint64_t desc_b,
                                                        int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\nwgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {"
      "%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,%12,%13,%14,%15,%16,%17,%18,%19,"
      "%20,%21,%22,%23,%24,%25,%26,%27,%28,%29,%30,%31"
      "}, {%32,%33,%34,%35}, %36, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(accumulate));
}

__device__ __forceinline__ void wgmma_tf32_rs_m64n96k8(float (&d)[48], const uint32_t (&a)[4], uint64_t desc_b,
                                                        int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %53, 0;\nwgmma.mma_async.sync.aligned.m64n96k8.f32.tf32.tf32 {"
      "%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,%12,%13,%14,%15,%16,%17,%18,%19,"
      "%20,%21,%22,%23,%24,%25,%26,%27,%28,%29,%30,%31,%32,%33,%34,%35,%36,%37,%38,%39,"
      "%40,%41,%42,%43,%44,%45,%46,%47"
      "}, {%48,%49,%50,%51}, %52, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(accumulate));
}

template <int N>
__device__ __forceinline__ void wgmma_tf32_rs(float (&d)[N / 2], const uint32_t (&a)[4], uint64_t desc_b,
                                              int accumulate) {
  if constexpr (N == 96) {
    wgmma_tf32_rs_m64n96k8(d, a, desc_b, accumulate);
  } else {
    static_assert(N == 64, "f32 block products are 64 or 96 wide");
    wgmma_tf32_rs_m64n64k8(d, a, desc_b, accumulate);
  }
}

// An A fragment (a k-step of 8) split into hi and lo: the thread's values at
// rows (row0, row0 + 8) and columns (c, c + 1), which the pair-major weights
// (below) read as k indices t and t + 4.
__device__ __forceinline__ void split_frag(float2 v0, float2 v1, uint32_t (&hi)[4], uint32_t (&lo)[4]) {
  split_tf32_bits(v0.x, hi[0], lo[0]);
  split_tf32_bits(v1.x, hi[1], lo[1]);
  split_tf32_bits(v0.y, hi[2], lo[2]);
  split_tf32_bits(v1.y, hi[3], lo[3]);
}

// Keeps the compiler from reusing an A fragment's registers before the
// wgmma that reads them is waited for.
__device__ __forceinline__ void fence_frags(uint32_t (&f)[4][4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(f[i][j])::"memory");
}

constexpr int kF32G = 2;  // windows per block: one per warpgroup
constexpr int kF32Threads = kF32G * kWarpgroup;
constexpr int kF32StageRows = 96;                    // weight rows a stage holds, one 32-deep k-tile each
constexpr int kF32LoBytes = kF32StageRows * 128;     // a stage: the hi rows, then the lo rows 12 KB on
constexpr int kF32StageBytes = 2 * kF32LoBytes;
constexpr int kF32MaxStages = 4;
constexpr int kQkLd = 72;  // row stride (floats) of the q and k tiles: float2 reads conflict-free
constexpr int kVLd = 68;   // of the v tile: the P V fragments' scalar reads conflict-free
constexpr int kQkvBytes = kRows * (2 * kQkLd + kVLd) * 4;
constexpr int kF32WindowBytes = kQkvBytes + 2 * 4 * kRows * 4;  // q | k | v (later the MLP input), v2's norms

// proj's and fc2's products: NB columns each (one stage's rows), NC / NB of them.
template <int NC>
struct F32Blocks {
  static constexpr int NB = NC == 128 ? 64 : 96;
  static constexpr int kCount = NC / NB;
};

__host__ __device__ constexpr int f32_fixed_smem_bytes(int C) {
  return 1024 + kF32G * kF32WindowBytes + kSharedVecs * C * 4 + 2 * kF32MaxStages * 8;
}
__host__ __device__ constexpr int f32_ring_stages(int C) {
  return (kMaxSmemBytes - f32_fixed_smem_bytes(C)) / kF32StageBytes < kF32MaxStages
             ? (kMaxSmemBytes - f32_fixed_smem_bytes(C)) / kF32StageBytes
             : kF32MaxStages;
}
__host__ __device__ constexpr int f32_smem_bytes(int C) {
  return f32_fixed_smem_bytes(C) + f32_ring_stages(C) * kF32StageBytes;
}
static_assert(f32_ring_stages(kMaxC) >= 2, "two weight stages at the widest C");
static_assert(kRows * (kMaxC + 8) * 4 <= kQkvBytes, "the MLP input fits where q, k and v were");

struct F32Block {
  CUtensorMap qkv_map;   // the split (3C, C): boxes of 64 rows x 32 k, plane 0 hi, 1 lo
  CUtensorMap proj_map;  // (C, C): boxes of NB rows
  CUtensorMap fc1_map;   // (hidden, C): boxes of 64 rows
  CUtensorMap fc2_map;   // (C, hidden): boxes of NB rows
  BlockArgs p;
  int stages;
};

// One 32-deep k-tile of split products into part (overwritten): for each
// k-step, hi lo, lo hi, then hi hi, A from registers, B from the stage.
template <int N>
__device__ __forceinline__ void mma_k_tile_f32(float (&part)[N / 2], const uint32_t (&ah)[4][4],
                                               const uint32_t (&al)[4][4], const unsigned char* stage) {
  const uint64_t db = sw128_desc(stage), dl = sw128_desc(stage + kF32LoBytes);
#pragma unroll
  for (int ks = 0; ks < 4; ++ks) {
    wgmma_tf32_rs<N>(part, ah[ks], dl + 2 * ks, ks > 0);
    wgmma_tf32_rs<N>(part, al[ks], db + 2 * ks, 1);
    wgmma_tf32_rs<N>(part, ah[ks], db + 2 * ks, 1);
  }
}

// The f32 kernel; see the note at the top. Warpgroup cw takes window
// kF32G g + cw of each group g.
template <int NC, bool kCosine>
__global__ void __launch_bounds__(kF32Threads, 1) swin_block_f32_kernel(const __grid_constant__ F32Block blk) {
  constexpr int NB = F32Blocks<NC>::NB, NBLK = F32Blocks<NC>::kCount;
  const BlockArgs& p = blk.p;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* smem = smem_raw + (1024 - smem_addr(smem_raw) % 1024) % 1024;  // the swizzle's alignment
  const int C = p.C, L = p.L, H = p.num_heads, Dh = p.head_dim, hidden = p.hidden;
  const float eps = p.eps;
  const bool post = p.postnorm;
  const int stages = blk.stages;
  const int kT = (C + kFK - 1) / kFK;       // 32-deep k-tiles of C
  const int hp = Dh >= 64 ? 1 : 64 / Dh;    // heads per qkv piece
  const int pw = hp * Dh;                   // the piece's columns: 64 (48 at Dh = 48)
  const int n_pieces = (H + hp - 1) / hp, n_chunks = (hidden + kChunk - 1) / kChunk;
  const int n_groups = (p.windows + kF32G - 1) / kF32G;
  const int per_block = (n_groups + (int)gridDim.x - 1) / (int)gridDim.x;
  const int grp_begin = min((int)blockIdx.x * per_block, n_groups);
  const int grp_end = min(grp_begin + per_block, n_groups);
  const unsigned images = (unsigned)p.windows / (unsigned)p.geo.n_windows;
  unsigned char* ring = smem;
  unsigned char* windows = ring + stages * kF32StageBytes;
  float* vec = reinterpret_cast<float*>(windows + kF32G * kF32WindowBytes);
  uint64_t* full = reinterpret_cast<uint64_t*>(vec + kSharedVecs * C);
  int* done = reinterpret_cast<int*>(full + stages);
  const float *ln1_w = vec, *ln1_b = vec + C, *b_qkv = vec + 2 * C, *b_proj = vec + 5 * C;
  const float *ln2_w = vec + 6 * C, *ln2_b = vec + 7 * C, *b_fc2 = vec + 8 * C;

  // The weight stream, the same steps for every group: per qkv piece the q,
  // k and v rows of its heads by k-tile, then proj's NBLK blocks at the
  // piece's two k-tiles; per hidden chunk fc1's 64 rows by k-tile, then
  // fc2's NBLK blocks at the chunk's two k-tiles. One step a stage.
  const int piece_steps = 3 * kT + 2 * NBLK, chunk_steps = kT + 2 * NBLK;
  const int steps = n_pieces * piece_steps + n_chunks * chunk_steps;
  const uint32_t uses = (uint32_t)(grp_end - grp_begin) * steps;
  auto load = [&](int s, const CUtensorMap* map, int k, int row, int rows) {
    unsigned char* dst = ring + s * kF32StageBytes;
    mbar_arrive_expect_tx(&full[s], 2 * rows * 128);
    tma_load_3d(dst, map, &full[s], k, row, 0);  // plane 0, hi
    tma_load_3d(dst + kF32LoBytes, map, &full[s], k, row, 1);
  };
  auto issue = [&](uint32_t i) {
    if (i >= uses) return;
    const int s = i % stages;
    int step = i % steps;
    if (step < n_pieces * piece_steps) {
      const int j = step / piece_steps;
      int q = step % piece_steps;
      if (q < 3 * kT) {
        load(s, &blk.qkv_map, (q % kT) * kFK, (q / kT) * C + j * pw, 64);
      } else {
        q -= 3 * kT;
        load(s, &blk.proj_map, j * pw + (q / NBLK) * kFK, (q % NBLK) * NB, NB);
      }
    } else {
      step -= n_pieces * piece_steps;
      const int ch = step / chunk_steps;
      int q = step % chunk_steps;
      if (q < kT) {
        load(s, &blk.fc1_map, q * kFK, ch * kChunk, kChunk);
      } else {
        q -= kT;
        load(s, &blk.fc2_map, ch * kChunk + (q / NBLK) * kFK, (q % NBLK) * NB, NB);
      }
    }
  };

  if (threadIdx.x == 0) {
    asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(&blk.qkv_map)) : "memory");
    asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(&blk.proj_map)) : "memory");
    asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(&blk.fc1_map)) : "memory");
    asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(&blk.fc2_map)) : "memory");
    for (int s = 0; s < stages; ++s) {
      mbar_init(&full[s], 1);
      done[s] = 0;
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    for (int s = 0; s < stages; ++s) issue(s);
  }
  for (int i = threadIdx.x; i < kSharedVecs * C; i += kF32Threads) {
    const int v = i / C, k = i % C;
    const int which = v == 0 ? kLn1W : v == 1 ? kLn1B : v <= 4 ? kBQkv : v == 5 ? kBProj : v == 6 ? kLn2W
                      : v == 7 ? kLn2B : kBFc2;
    vec[i] = vec_at(p, which, (which == kBQkv ? v - 2 : 0) * C + k);
  }
  __syncthreads();

  const int cw = threadIdx.x / kWarpgroup;
  const int lane = threadIdx.x % 32;
  unsigned char* win = windows + cw * kF32WindowBytes;
  float* q_tile = reinterpret_cast<float*>(win);  // q, then each head's output over its q columns
  float* k_tile = q_tile + kRows * kQkLd;
  float* v_tile = k_tile + kRows * kQkLd;
  float* mlp_in = q_tile;  // h - pivot, the MLP input, row stride C + 8, once q, k and v are done
  float* norms = reinterpret_cast<float*>(win + kQkvBytes);  // v2: [q | k][head of the piece][row]
  const int ld_m = C + 8;
  const float* x = static_cast<const float*>(p.x);
  float* out = static_cast<float*>(p.out);
  const int bar = 1 + cw;
  auto sync_wg = [&]() { named_barrier(bar, kWarpgroup); };
  uint32_t next = 0, freed = 0;  // stage uses waited for and released
  auto wait_stage = [&]() {
    mbar_wait(&full[next % stages], (next / stages) & 1);  // TMA has landed the stage
    return ring + (next++ % stages) * kF32StageBytes;
  };
  auto release = [&]() {
    if (lane == 0) {
      const int s = freed % stages;
      if (atomicAdd(&done[s], 1) == kF32G * kWarpgroup / 32 - 1) {
        done[s] = 0;
        __threadfence_block();
        issue(freed + stages);
      }
    }
    ++freed;
  };
  // One k-tile of an N-wide product: wait for its stage, the split products
  // into part, wait for them, release the stage.
  auto product = [&](auto& part, const uint32_t(&ah)[4][4], const uint32_t(&al)[4][4]) {
    constexpr int N = 2 * (int)std::extent<std::remove_reference_t<decltype(part)>>::value;
    const unsigned char* st = wait_stage();
    fence_accumulator(part);
    wgmma_fence();
    mma_k_tile_f32<N>(part, ah, al, st);
    wgmma_commit();
    wgmma_wait<0>();
    fence_accumulator(part);
    release();
  };
  // acc = a 64-wide product over C's kT k-tiles, A from frags(kt, ah, al),
  // one k-tile at a time (issuing the next k-tile before summing the last
  // took 14% longer at swin_t stage 1: PERF.md §6).
  auto sum_products64 = [&](float(&acc)[32], auto&& frags) {
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[i] = 0.f;
#pragma unroll 1
    for (int kt = 0; kt < kT; ++kt) {
      uint32_t ah[4][4], al[4][4];
      frags(kt, ah, al);
      float part[32];
      product(part, ah, al);
      fence_frags(ah);
      fence_frags(al);
#pragma unroll
      for (int i = 0; i < 32; ++i) acc[i] += part[i];
    }
  };

#pragma unroll 1
  for (int grp = grp_begin; grp < grp_end; ++grp) {
    int tid = threadIdx.x;
    asm volatile("" : "+r"(tid));
    const int wt = tid % kWarpgroup, warp = wt / 32, g = (tid % 32) >> 2, t = tid & 3;
    const int row0 = 16 * warp + g;  // this thread's rows: row0 and row0 + 8
    const unsigned wm = (unsigned)(kF32G * grp + cw);
    const unsigned w = wm % images * (unsigned)p.geo.n_windows + wm / images;
    const bool live = wm < (unsigned)p.windows;
    const int wb = (int)(w % (unsigned)p.geo.n_windows) % p.n_bias;
    const WindowOrigin origin = window_origin(p.geo, w);
    const long long tok[2] = {live ? token_at(p.geo, origin, row0, L) : -1,
                              live ? token_at(p.geo, origin, row0 + 8, L) : -1};
    // x at (row0 + 8 h, c and c + 1), zeros for padding and past C
    auto x_pair = [&](int h, int c) {
      return tok[h] >= 0 && c < C ? __ldg(reinterpret_cast<const float2*>(x + tok[h] * C + c))
                                  : make_float2(0.f, 0.f);
    };
    sync_wg();  // the previous window's readers of the tiles are done

    // Each row is taken about a pivot, x at its first column: LN1 centres x -
    // pivot, the residual is kept as h - pivot, and the pivot is added back
    // once, to the output (a row of 1e3 + N(0, 1) keeps its mean to f32's
    // precision of an O(1) value, and the output is rounded once).
    const float pivot[2] = {x_pair(0, 0).x, x_pair(1, 0).x};
    // v1: LN1's row statistics of x - pivot, by quads (the mean, then the
    // variance over the centred values)
    float mean[2] = {0.f, 0.f}, rstd[2] = {0.f, 0.f};
    if (!post) {
      float s[2] = {0.f, 0.f};
#pragma unroll
      for (int j = 0; j < NC / 8; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int c = 8 * j + 2 * t;
          if (c < C) {
            const float2 v = x_pair(h, c);
            s[h] += (v.x - pivot[h]) + (v.y - pivot[h]);
          }
        }
      mean[0] = quad_sum(s[0]) / C;
      mean[1] = quad_sum(s[1]) / C;
      float q[2] = {0.f, 0.f};
#pragma unroll
      for (int j = 0; j < NC / 8; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int c = 8 * j + 2 * t;
          if (c < C) {
            const float2 v = x_pair(h, c);
            const float d0 = (v.x - pivot[h]) - mean[h], d1 = (v.y - pivot[h]) - mean[h];
            q[h] += d0 * d0 + d1 * d1;
          }
        }
      rstd[0] = rsqrtf(quad_sum(q[0]) / C + eps);
      rstd[1] = rsqrtf(quad_sum(q[1]) / C + eps);
    }
    // qkv's A: LN1 x (v1) or x (v2) at k-tile kt, from device memory
    auto qkv_frags = [&](int kt, uint32_t(&ah)[4][4], uint32_t(&al)[4][4]) {
#pragma unroll
      for (int ks = 0; ks < 4; ++ks) {
        const int c = kt * kFK + 8 * ks + 2 * t;
        float2 v[2] = {x_pair(0, c), x_pair(1, c)};
        if (!post && c < C) {
          const float2 gm = *reinterpret_cast<const float2*>(ln1_w + c);
          const float2 bt = *reinterpret_cast<const float2*>(ln1_b + c);
#pragma unroll
          for (int h = 0; h < 2; ++h)
            v[h] = make_float2(((v[h].x - pivot[h]) - mean[h]) * rstd[h] * gm.x + bt.x,
                               ((v[h].y - pivot[h]) - mean[h]) * rstd[h] * gm.y + bt.y);
        }
        split_frag(v[0], v[1], ah[ks], al[ks]);
      }
    };
    // A from this thread's rows of an f32 tile (row stride ld) at k-tile kt,
    // columns past `cols` zero
    auto tile_frags = [&](const float* tile, int ld, int cols, int kt, uint32_t(&ah)[4][4], uint32_t(&al)[4][4]) {
#pragma unroll
      for (int ks = 0; ks < 4; ++ks) {
        const int c = kt * kFK + 8 * ks + 2 * t;
        float2 v0 = make_float2(0.f, 0.f), v1 = v0;
        if (c < cols) {
          v0 = *reinterpret_cast<const float2*>(tile + row0 * ld + c);
          v1 = *reinterpret_cast<const float2*>(tile + (row0 + 8) * ld + c);
        }
        split_frag(v0, v1, ah[ks], al[ks]);
      }
    };

    float acc[NC / 2];  // proj, then (briefly) h - pivot, then fc2
#pragma unroll
    for (int i = 0; i < NC / 2; ++i) acc[i] = 0.f;
    float part_n[NB / 2];

    // This thread's bias values of a head (rows row0, row0 + 8; keys 8 n + 2 t, + 1)
    float bv[8][4];
    auto load_bias = [&](int h) {
      const float* bias_h = p.bias + ((long long)wb * H + h) * L * L;
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = row0 + 8 * (e >> 1), c = 8 * n + 2 * t + (e & 1);
          bv[n][e] = r < L && c < L ? __ldg(bias_h + (r * L + c)) : 0.f;
        }
    };

#pragma unroll 1
    for (int j = 0; j < n_pieces; ++j) {
      const int heads = min(hp, H - j * hp);
      // ---- q, k and v of the piece's heads, each a 64-wide product over C
#pragma unroll 1
      for (int third = 0; third < 3; ++third) {
        float qa[32];
        sum_products64(qa, qkv_frags);
        // + bias in f32 into the third's tile; columns of heads past the piece zero
        float* dst = third == 0 ? q_tile : third == 1 ? k_tile : v_tile;
        const int ld = third == 2 ? kVLd : kQkLd;
#pragma unroll
        for (int jj = 0; jj < 8; ++jj) {
          const int c = 8 * jj + 2 * t;
          const bool ok = c < heads * Dh;
          const int n = third * C + j * pw + c;
          const float b0 = ok ? b_qkv[n] : 0.f, b1 = ok ? b_qkv[n + 1] : 0.f;
#pragma unroll
          for (int h = 0; h < 2; ++h)
            *reinterpret_cast<float2*>(dst + (row0 + 8 * h) * ld + c) =
                ok ? make_float2(qa[4 * jj + 2 * h] + b0, qa[4 * jj + 2 * h + 1] + b1) : make_float2(0.f, 0.f);
        }
      }
      load_bias(j * hp);  // the piece's first head
      sync_wg();
      if constexpr (kCosine) {
        // v2: gs scale / |q| of every row and 1 / |k| of every key, per head, in f32
        for (int i = wt; i < 2 * heads * kRows; i += kWarpgroup) {
          const int which = i / (heads * kRows), hl = (i / kRows) % heads, r = i % kRows;
          const float* src = (which == 0 ? q_tile : k_tile) + r * kQkLd + hl * Dh;
          float s2 = 0.f;
          for (int d = 0; d < Dh; ++d) s2 = fmaf(src[d], src[d], s2);
          const float inv = 1.f / fmaxf(sqrtf(s2), 1e-12f);
          norms[which * 4 * kRows + hl * kRows + r] = which == 0 ? p.gs[j * hp + hl] * p.scale * inv : inv;
        }
        sync_wg();
      }
      // ---- attention per head, each warp its 16 rows; the head's output
      // goes over its q columns (only this thread reads them again)
#pragma unroll 1
      for (int hl = 0; hl < heads; ++hl) {  // the piece's heads
        const int col = hl * Dh;
        float s[8][4];
#pragma unroll
        for (int n = 0; n < 8; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
#pragma unroll
        for (int kd = 0; kd < kMaxHeadDim / 8; ++kd) {
          if (8 * kd >= Dh) break;
          const int c = col + 8 * kd + 2 * t;
          uint32_t ah[4], al[4];
          const float2 q0 = *reinterpret_cast<const float2*>(q_tile + row0 * kQkLd + c);
          const float2 q1 = *reinterpret_cast<const float2*>(q_tile + (row0 + 8) * kQkLd + c);
          split_tf32_bits(q0.x, ah[0], al[0]);
          split_tf32_bits(q1.x, ah[1], al[1]);
          split_tf32_bits(q0.y, ah[2], al[2]);
          split_tf32_bits(q1.y, ah[3], al[3]);
#pragma unroll
          for (int n = 0; n < 8; ++n) {
            const float2 kv = *reinterpret_cast<const float2*>(k_tile + (8 * n + g) * kQkLd + c);
            uint32_t bh0, bl0, bh1, bl1;
            split_tf32_bits(kv.x, bh0, bl0);
            split_tf32_bits(kv.y, bh1, bl1);
            mma_split(s[n], ah, al, bh0, bh1, bl0, bl1);
          }
        }
        // scales, bias and key mask; the softmax by quads
        float qs[2] = {p.scale, p.scale}, m[2] = {-INFINITY, -INFINITY};
        if constexpr (kCosine) {
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
              const float ki = kCosine ? norms[4 * kRows + hl * kRows + c] : 1.f;
              v = s[n][e] * qs[e >> 1] * ki + bv[n][e];
            }
            s[n][e] = v;
            m[e >> 1] = fmaxf(m[e >> 1], v);
          }
        if (hl + 1 < heads) load_bias(j * hp + hl + 1);
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
        // O = e V, e split as the A fragments unmoved (A's k index t is key
        // 2 t of the 8-key group, t + 4 key 2 t + 1; V read the same way)
        float o[kMaxHeadDim / 8][4];
#pragma unroll
        for (int n = 0; n < kMaxHeadDim / 8; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) o[n][e] = 0.f;
#pragma unroll
        for (int kk = 0; kk < 8; ++kk) {
          uint32_t ph[4], pl[4];
          split_tf32_bits(s[kk][0], ph[0], pl[0]);
          split_tf32_bits(s[kk][2], ph[1], pl[1]);
          split_tf32_bits(s[kk][1], ph[2], pl[2]);
          split_tf32_bits(s[kk][3], ph[3], pl[3]);
          const float* v0 = v_tile + (8 * kk + 2 * t) * kVLd + col + g;
#pragma unroll
          for (int n = 0; n < kMaxHeadDim / 8; ++n) {
            if (8 * n >= Dh) break;
            uint32_t bh0, bl0, bh1, bl1;
            split_tf32_bits(v0[8 * n], bh0, bl0);
            split_tf32_bits(v0[kVLd + 8 * n], bh1, bl1);
            mma_split(o[n], ph, pl, bh0, bh1, bl0, bl1);
          }
        }
#pragma unroll
        for (int n = 0; n < kMaxHeadDim / 8; ++n) {
          if (8 * n >= Dh) break;
          const int c = col + 8 * n + 2 * t;
#pragma unroll
          for (int h = 0; h < 2; ++h)
            *reinterpret_cast<float2*>(q_tile + (row0 + 8 * h) * kQkLd + c) =
                make_float2(o[n][2 * h] * inv[h], o[n][2 * h + 1] * inv[h]);
        }
      }
      // ---- proj's part from this piece's output: its two k-tiles, NBLK
      // products each, A from this thread's own rows of the q tile
#pragma unroll 1
      for (int kt = 0; kt < 2; ++kt) {
        uint32_t ah[4][4], al[4][4];
        tile_frags(q_tile, kQkLd, 64, kt, ah, al);
#pragma unroll
        for (int b = 0; b < NBLK; ++b) {
          product(part_n, ah, al);
#pragma unroll
          for (int i = 0; i < NB / 2; ++i) acc[b * NB / 2 + i] += part_n[i];
        }
        fence_frags(ah);
        fence_frags(al);
      }
      sync_wg();  // every warp is past this piece's k and v
    }

    // ---- proj's bias, v2's LN1 and the first residual, kept as h - pivot
    // in the MLP tile (this thread's rows); v1: LN2's statistics of it
#pragma unroll
    for (int jj = 0; jj < NC / 8; ++jj)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = 8 * jj + 2 * t + (e & 1);
        acc[4 * jj + e] = c < C ? acc[4 * jj + e] + b_proj[c] : 0.f;
      }
    if (post) quad_layer_norm<NC>(acc, ln1_w, ln1_b, C, eps, t);
#pragma unroll
    for (int jj = 0; jj < NC / 8; ++jj)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int c = 8 * jj + 2 * t;
        if (c < C) {
          const float2 xv = x_pair(h, c);
          acc[4 * jj + 2 * h] += xv.x - pivot[h];
          acc[4 * jj + 2 * h + 1] += xv.y - pivot[h];
          *reinterpret_cast<float2*>(mlp_in + (row0 + 8 * h) * ld_m + c) =
              make_float2(acc[4 * jj + 2 * h], acc[4 * jj + 2 * h + 1]);
        }
      }
    float mu2[2] = {0.f, 0.f}, rs2[2] = {0.f, 0.f};
    if (!post) quad_stats<NC>(acc, C, eps, t, mu2, rs2);
#pragma unroll
    for (int i = 0; i < NC / 2; ++i) acc[i] = 0.f;  // fc2 sums from zero
    // fc1's A at k-tile kt: LN2 h (v1) or h (v2), from the MLP tile
    auto mlp_frags = [&](int kt, uint32_t(&ah)[4][4], uint32_t(&al)[4][4]) {
#pragma unroll
      for (int ks = 0; ks < 4; ++ks) {
        const int c = kt * kFK + 8 * ks + 2 * t;
        float2 v[2] = {make_float2(0.f, 0.f), make_float2(0.f, 0.f)};
        if (c < C) {
          const float2 gm = *reinterpret_cast<const float2*>(ln2_w + c);
          const float2 bt = *reinterpret_cast<const float2*>(ln2_b + c);
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const float2 d = *reinterpret_cast<const float2*>(mlp_in + (row0 + 8 * h) * ld_m + c);
            v[h] = post ? make_float2(pivot[h] + d.x, pivot[h] + d.y)
                        : make_float2((d.x - mu2[h]) * rs2[h] * gm.x + bt.x, (d.y - mu2[h]) * rs2[h] * gm.y + bt.y);
          }
        }
        split_frag(v[0], v[1], ah[ks], al[ks]);
      }
    };

    // ---- the MLP by hidden chunks: fc1 (64 wide over C), b1 and gelu in
    // registers, which are fc2's A for the chunk's two k-tiles
#pragma unroll 1
    for (int ch = 0; ch < n_chunks; ++ch) {
      float a1[32];
      sum_products64(a1, mlp_frags);
#pragma unroll
      for (int jj = 0; jj < 8; ++jj)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int n = ch * kChunk + 8 * jj + 2 * t + (e & 1);
          const float u = n < hidden ? a1[4 * jj + e] + param(p.vec[kBFc1], p.param_bf16, n) : 0.f;
          a1[4 * jj + e] = 0.5f * u * (1.f + erff(0.70710678118654752f * u));
        }
#pragma unroll
      for (int kt = 0; kt < 2; ++kt) {
        uint32_t ah[4][4], al[4][4];
#pragma unroll
        for (int ks = 0; ks < 4; ++ks) {
          const int J = 4 * kt + ks;
          split_frag(make_float2(a1[4 * J], a1[4 * J + 1]), make_float2(a1[4 * J + 2], a1[4 * J + 3]), ah[ks], al[ks]);
        }
#pragma unroll
        for (int b = 0; b < NBLK; ++b) {
          product(part_n, ah, al);
#pragma unroll
          for (int i = 0; i < NB / 2; ++i) acc[b * NB / 2 + i] += part_n[i];
        }
        fence_frags(ah);
        fence_frags(al);
      }
    }

    // ---- out = pivot + (h - pivot + y), y = fc2 + b2 (v1) or LN2(fc2 + b2) (v2)
#pragma unroll
    for (int jj = 0; jj < NC / 8; ++jj)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = 8 * jj + 2 * t + (e & 1);
        if (c < C) acc[4 * jj + e] += b_fc2[c];
      }
    if (post) quad_layer_norm<NC>(acc, ln2_w, ln2_b, C, eps, t);
#pragma unroll
    for (int jj = 0; jj < NC / 8; ++jj)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int c = 8 * jj + 2 * t;
        if (tok[h] >= 0 && c < C) {
          const float2 hv = *reinterpret_cast<const float2*>(mlp_in + (row0 + 8 * h) * ld_m + c);
          *reinterpret_cast<float2*>(out + tok[h] * C + c) =
              make_float2(pivot[h] + (hv.x + acc[4 * jj + 2 * h]), pivot[h] + (hv.y + acc[4 * jj + 2 * h + 1]));
        }
      }
  }
}

// The four f32 weights split once a call for the f32 kernel: matrix m (rows
// x K) becomes its hi plane then its lo plane, each row's k reordered within
// groups of 8 as 0, 2, 4, 6, 1, 3, 5, 7 ("pair-major"), so that the k index t
// of a product reads column 2 t of the group and t + 4 column 2 t + 1: the
// columns a thread holds of an accumulator row (and reads as a float2).
struct SplitArgs {
  const float* src[4];
  float* dst[4];
  int rows[4], K[4];
};

__global__ void __launch_bounds__(256) split_weights_kernel(SplitArgs a) {
#pragma unroll 1
  for (int m = 0; m < 4; ++m) {
    const long long n = (long long)a.rows[m] * a.K[m];
    const int K = a.K[m];
    const long long step = (long long)gridDim.x * blockDim.x;
    for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n; i += step) {
      const int c = (int)(i % K), u = c & 7;
      const long long src = i - u + (u < 4 ? 2 * u : 2 * u - 7);
      float hi, lo;
      split_tf32(a.src[m][src], hi, lo);
      a.dst[m][i] = hi;
      a.dst[m][n + i] = lo;
    }
  }
}

// TMA map of a split f32 weight (its hi plane, then its lo plane, each rows
// x K, as split_weights_kernel writes them), read in boxes of box_rows x one
// 32-float k-tile of one plane with the 128-byte swizzle; rows and k past
// the edges read as zeros.
cudaError_t encode_split_weight(CUtensorMap* map, const float* base, int rows, int K, int box_rows) {
  const PFN_cuTensorMapEncodeTiled_v12000 encode = encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[3] = {(cuuint64_t)K, (cuuint64_t)rows, 2};
  const cuuint64_t strides[2] = {(cuuint64_t)K * 4, (cuuint64_t)rows * K * 4};
  const cuuint32_t box[3] = {(cuuint32_t)kFK, (cuuint32_t)box_rows, 1};
  const cuuint32_t element_strides[3] = {1, 1, 1};
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3, const_cast<float*>(base), dims, strides, box,
                            element_strides, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                            CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// Floats of the f32 kernel's scratch: the four weights' hi and lo planes.
long long f32_split_floats(int C, int hidden) { return 2LL * (4LL * C * C + 2LL * C * hidden); }

template <int NC, bool kCosine>
cudaError_t launch_f32(const BlockArgs& p, float* split, cudaStream_t stream, int* blocks_per_sm) {
  constexpr int NB = F32Blocks<NC>::NB;
  const int smem = f32_smem_bytes(p.C);
  auto kernel = swin_block_f32_kernel<NC, kCosine>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  if (blocks_per_sm != nullptr)  // a report: nothing is launched
    return cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks_per_sm, kernel, kF32Threads, smem);
  int device = 0, sms = 0;
  err = cudaGetDevice(&device);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  // the weights split once for every window of the call
  const int C = p.C, hid = p.hidden;
  const void* mats[4] = {p.w_qkv, p.w_proj, p.w_fc1, p.w_fc2};
  const int rows[4] = {3 * C, C, hid, C}, ks[4] = {C, C, C, hid};
  SplitArgs sa;
  float* dst = split;
  for (int m = 0; m < 4; ++m) {
    sa.src[m] = static_cast<const float*>(mats[m]);
    sa.dst[m] = dst;
    sa.rows[m] = rows[m];
    sa.K[m] = ks[m];
    dst += 2LL * rows[m] * ks[m];
  }
  split_weights_kernel<<<2 * sms, 256, 0, stream>>>(sa);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  F32Block blk;
  blk.p = p;
  blk.stages = f32_ring_stages(C);
  err = encode_split_weight(&blk.qkv_map, sa.dst[0], 3 * C, C, 64);
  if (err == cudaSuccess) err = encode_split_weight(&blk.proj_map, sa.dst[1], C, C, NB);
  if (err == cudaSuccess) err = encode_split_weight(&blk.fc1_map, sa.dst[2], hid, C, kChunk);
  if (err == cudaSuccess) err = encode_split_weight(&blk.fc2_map, sa.dst[3], C, hid, NB);
  if (err != cudaSuccess) return err;
  int per_sm = 1;  // blocks an SM holds at once
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kF32Threads, smem);
  if (err != cudaSuccess) return err;
  const long long groups = (p.windows + kF32G - 1) / kF32G, slots = (long long)sms * (per_sm > 0 ? per_sm : 1);
  const unsigned grid = (unsigned)(groups < slots ? groups : slots);  // persistent: as many blocks as fit at once
  kernel<<<grid, kF32Threads, smem, stream>>>(blk);
  return cudaGetLastError();
}

template <bool kCosine>
cudaError_t launch_or_query_f32(const BlockArgs& p, float* split, cudaStream_t stream, int* blocks_per_sm) {
  switch (proj_width(p.C)) {
    case 96: return launch_f32<96, kCosine>(p, split, stream, blocks_per_sm);
    case 128: return launch_f32<128, kCosine>(p, split, stream, blocks_per_sm);
    default: return launch_f32<192, kCosine>(p, split, stream, blocks_per_sm);
  }
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
                   float eps, int postnorm, int dtype, int param_dtype, void* scratch, void* stream) {
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
  if (dtype == 0) {
    if (scratch == nullptr || !aligned(scratch)) return cudaErrorInvalidValue;
    float* split = static_cast<float*>(scratch);
    return gs != nullptr ? launch_or_query_f32<true>(p, split, s, nullptr)
                         : launch_or_query_f32<false>(p, split, s, nullptr);
  }
  return gs != nullptr ? launch_or_query_bf16<true>(p, s, nullptr) : launch_or_query_bf16<false>(p, s, nullptr);
}

// Dynamic shared memory one block needs; for error messages and reports.
long long eqx_swin_block_smem_bytes(int channels, int head_dim, int elem_bytes) {
  (void)head_dim;
  return elem_bytes == 2 ? (long long)bf16_smem_bytes(channels) : (long long)f32_smem_bytes(channels);
}

// Floats of device scratch the entry point needs for dtype (0 = float32: the
// weights split into TF32 hi and lo; bfloat16 needs none).
long long eqx_swin_block_scratch_floats(int channels, int hidden, int dtype) {
  return dtype == 0 ? f32_split_floats(channels, hidden) : 0;
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

// The f32 design at a C, as eqx_swin_block_config reports the bf16 one.
int eqx_swin_block_f32_config(int channels, int num_heads, int* info) {
  if (channels <= 0 || channels > kMaxC || channels % 16 != 0 || num_heads <= 0 || channels % num_heads != 0)
    return cudaErrorInvalidValue;
  BlockArgs p = {};
  p.C = channels;
  p.head_dim = channels / num_heads;
  info[0] = kF32G;
  info[1] = f32_ring_stages(channels);
  info[2] = f32_smem_bytes(channels);
  return launch_or_query_f32<false>(p, nullptr, nullptr, &info[3]);
}

}  // extern "C"
