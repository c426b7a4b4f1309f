// Swin window attention read straight out of a fused qkv projection.
//
// Replaces the Pallas TPU kernels _window_qkv_kernel and
// _packed_window_kernel (eqxvision_tpu/ops/attention.py, launched from
// _window_qkv_attention and _packed_window_attention). Both compute one
// function on two layouts; this file computes it on the unpadded one:
//
//   qkv  (B*nW, L, 3*H*Dh) laid out [q heads | k heads | v heads]
//   bias (nWb, H, L, L) f32, window w reads bias[w % nWb]
//   out[bw, i, h*Dh:(h+1)*Dh] = softmax(q_i . K^T * scale + bias[w, h, i]) . V
//
// with the scores and the softmax in f32, the probabilities rounded to the
// input type, and p.V accumulated in f32 and stored in the input type, as
// window_qkv_attention_reference does. With cosine_gs (Swin v2) q and k are
// L2-normalised per head and row (norm floored at 1e-12) and q is
// multiplied by its head's gs, in f32.
// The TPU kernels' 128-lane padding of C, head-masked K/V stacks and
// segment-sum softmax are layout devices of that chip. Here the softmax is
// per head and exact, so no head can underflow against another.
//
// Design. Chosen from the type and the shape (window_path):
// - L <= 64 (every Swin stage), 16-byte aligned qkv and out, and a head dim
//   of 16, 32, 48 or 64 in bf16, 16 or 32 in f32 (a box row of at most 128
//   bytes): the window stage below, window_stage<T, DH, kMode>, which the
//   public attention's (K2) short rows run too, as one head a window
//   (attention.cu, through window_stage.h; kMode says which caller, v1 or
//   cosine, with a bias or without). Its work unit is a tile, one (window,
//   head): 64 query rows (L live), 64 keys and Dh columns, 12 KB of bf16 q,
//   k and v at Dh = 32. Persistent blocks of one warpgroup (128 threads),
//   as many as fit the card, walk over the tiles (win_tile_at): K3/K4's
//   block j takes tiles j, j + grid, ... of the (window, head) order, so
//   that the blocks resident at once read neighbouring heads of the same
//   qkv rows; K2's block j takes a contiguous run of a slab-major order
//   (runs equal to within one tile), so that it copies one or two bias
//   slabs whatever the grid, where the strided walk copied one almost
//   every tile when the grid is not a multiple of the slabs.
//   Thread 0 keeps a ring of kWinStages stages (bf16 two, f32 one) in
//   shared memory filled by TMA (cp.async.bulk.tensor over three 3-D maps,
//   q, k and v, each (cols, L, windows) from its own base with its own row
//   stride: K3 the thirds of one qkv, (C, L, windows) rows 3C apart, K2 its
//   three tensors; the box at column h Dh), guarded by one mbarrier a
//   stage, so that the next tiles' loads are in flight while a tile
//   computes; a tile's stage is refilled with the tile kWinStages further
//   on once every warp is done with it. The box is exactly Dh columns wide
//   (bf16 Dh = 48: 64, the only such width; columns past a map's own read
//   as zeros) with the swizzle that width allows (32, 64 or 128 bytes): a
//   wider box would read the next head's columns, bytes a memory-bound
//   kernel cannot spare. Rows past L read as zeros, not as the next
//   window's rows. The tile's (window, head) bias slab, L x L f32, is
//   copied into shared memory where it differs from the block's last one:
//   read from L2 per score, it took 30% of the kernel's time
//   (scripts/ablate_torch_window_stage.py, PERF.md §6). K2's rows without
//   a bias copy no slab.
//   A row lives in the four lanes of a quad, 32 f32 scores a thread, keys
//   >= L -inf by selects, and the softmax runs in those registers.
//   bf16: S = Q K^T by wgmma m64n64k16 (both operands by descriptor,
//   K-major, descriptors for the box's swizzle). v1 with a bias: the
//   accumulators start at the bias over the scale (the attention stage's
//   kBias method: s = (bias / scale + q . k) scale). v2: the products start
//   at zero; q's and k's inverse row norms (two threads a row, from the
//   tile in shared memory, while the products run) scale the accumulators'
//   rows and columns in f32, q's by gs[h], then the bias is added. Without
//   a bias the products start at zero too. p = e / sum is
//   rounded to bf16 in place as the register A operand of wgmma m64nDk16
//   for P V, with V read MN-major from the stage (the transpose bit).
//   Nothing that writes a wgmma operand register sits under a branch
//   (PERF.md §6: a branch there makes ptxas serialise every wgmma, C7520).
//   The output is rounded to bf16 through the warp's own swizzled staging
//   rows and rows < L written as 16-byte stores at column h Dh of out.
//   f32: each warp its 16 rows; S and P V by split TF32 on mma.sync
//   m16n8k8 (hi + lo, three products; split_tf32_bits keeps a NaN or an
//   infinity in hi) with the fragments read from the swizzled boxes, and
//   e's accumulators as P V's A operand unmoved (the attention stage's key
//   permutation); s = (q . k) scale (v2: times gs[h] / |q| and 1 / |k|)
//   + bias, the bias after the scaled product; O divided by the row sum at
//   its 8-byte stores. The f32 attention stage below took 31% longer at
//   swin_t stages 3-4 and swin_v2_t stage 3 (PERF.md §6).
// - f32 otherwise (L > 64, other head dims, unaligned tensors): the f32
//   attention stage of attention_stage.cuh (split TF32 on mma.sync, one
//   pass, K and V streamed in chunks of 32 keys), with the window's bias per
//   (window, head) and, for v2, q scaled by gs[h] / |q| before its split
//   and the products' columns by 1 / |k|.
// - bf16 otherwise (L > 64, a head dim off the multiples of 16, unaligned
//   tensors, or a v1 scale whose reciprocal is not finite): the CUDA-core
//   kernel window_attention_kernel, one block of 4 warps per (window,
//   head), K and V staged in shared memory, serial per-row FMA chains.
//
// What bounds it. At swin_t stage 3, b128 bf16 (B*nW=512, L=49, H=12,
// Dh=32), one call reads 57.8 MB of qkv and 0.5 MB of bias and writes
// 19.3 MB, 0.023 ms at 3.35 TB/s; its 1.9 GFLOP take 0.002 ms on the tensor
// cores. The bound is device memory: each tile's q, k and v are read once,
// 12 KB in one TMA stage, and the ring keeps up to kWinStages tiles a block
// in flight. Per tile a thread does about ten instructions a score on the
// CUDA cores (bias load, scale, mask, max, exp, sum, pack): 32 scores a
// thread; the bf16 stage runs at 1.5x the bound there (PERF.md §6).
// Limits: head_dim <= 64; on the CUDA-core kernel one head's K and V must
// fit in shared memory (L up to several hundred); the entry point returns
// cudaErrorInvalidValue outside them.

#include "attention_stage.cuh"
#include "window_stage.h"

namespace {

constexpr int kWinMaxHeadDim = 64;

// ---- the window stage: persistent blocks, a TMA ring; bf16 on wgmma, f32 by split TF32 on mma.sync ----
constexpr int kWinThreads = 128;  // one warpgroup
constexpr int kWinRows = 64;      // query rows of a tile, and its keys

template <typename T>
constexpr bool kWinIsF32 = std::is_same<T, float>::value;
// Ring depth, the tiles a block has in flight: two in bf16; one in f32,
// whose three blocks an SM then leave L1 more room (9% faster than two,
// scripts/ablate_torch_window_stage.py; the other blocks hide the loads).
template <typename T>
constexpr int kWinStages = kWinIsF32<T> ? 1 : 2;

// What a window-stage kernel computes, and how its blocks walk the tiles:
// K3/K4's windows, v1 or cosine attention, always with a bias, walked in
// (window, head) order; K2's rows, one head a window, with a bias or
// without, walked slab-major (win_tile_at).
constexpr int kWinV1 = 0, kWinCosine = 1, kRowsBias = 2, kRowsNoBias = 3;

// Columns of a TMA box: the head dim, or 64 for bf16 at Dh = 48 (no
// swizzle is 96 bytes wide).
__host__ __device__ constexpr int win_box_cols(int dh) { return dh == 48 ? 64 : dh; }
// Bytes of a box's row, the swizzle's span: 32, 64 or 128.
template <typename T>
__host__ __device__ constexpr int win_row_bytes(int dh) {
  return win_box_cols(dh) * (int)sizeof(T);
}
template <typename T>
__host__ __device__ constexpr int win_box_bytes(int dh) {
  return kWinRows * win_row_bytes<T>(dh);
}

// Dynamic shared memory of one block: alignment slack, the ring (q, k, v a
// stage), bf16's staging rows (one box), the bias slab, v2's row scales,
// the barriers.
template <typename T>
__host__ __device__ constexpr int win_smem_bytes(int dh) {
  return 1024 + (3 * kWinStages<T> + (kWinIsF32<T> ? 0 : 1)) * win_box_bytes<T>(dh) + kWinRows * kWinRows * 4 +
         2 * kWinRows * 4 + kWinStages<T> * 8;
}

// The 16-byte unit that holds unit u of row r of a box whose rows are RB
// bytes, in the layout TMA writes with the RB-byte swizzle (box aligned to
// 1024 bytes): bits 7.. of the row's offset XOR the unit index.
template <int RB>
__device__ __forceinline__ int win_unit(int r, int u) {
  return u ^ ((r * RB >> 7) & (RB / 16 - 1));
}

// Element (r, c) of an f32 box of RB-byte rows.
template <int RB>
__device__ __forceinline__ float win_f32(const unsigned char* box, int r, int c) {
  return *reinterpret_cast<const float*>(box + r * RB + (win_unit<RB>(r, c >> 2) << 4) + (c & 3) * 4);
}

// wgmma descriptor of a box read K-major (Q and K for S = Q K^T): rows of RB
// bytes, 8-row groups 8 RB apart, the RB-byte swizzle. A k16 step further
// along is +2 (32 bytes).
template <int RB>
__device__ __forceinline__ uint64_t win_desc(const void* tile) {
  constexpr uint64_t mode = RB == 128 ? 1 : RB == 64 ? 2 : 3;
  return (uint64_t)((smem_addr(tile) & 0x3FFFF) >> 4) | (1ull << 16) | ((uint64_t)(8 * RB >> 4) << 32) |
         (mode << 62);
}

// The same box read MN-major (V for P V, the transpose bit): rows along K
// of RB / 2 columns, 8-row groups 8 RB apart (the stride offset); the box
// is one chunk wide, so the leading offset is not used. 16 rows further
// along K is +16 RB bytes.
template <int RB>
__device__ __forceinline__ uint64_t win_mn_desc(const void* tile) {
  constexpr uint64_t mode = RB == 128 ? 1 : RB == 64 ? 2 : 3;
  return (uint64_t)((smem_addr(tile) & 0x3FFFF) >> 4) | ((uint64_t)(kWinRows * RB >> 4) << 16) |
         ((uint64_t)(8 * RB >> 4) << 32) | (mode << 62);
}

// D (+)= A B for a 64 x N tile, N = 16 or 32: A (64 x 16) from registers as
// in wgmma_m64n64k16_rs, B (16 x N) by descriptor, MN-major.
__device__ __forceinline__ void wgmma_m64n16k16_rs(float (&d)[8], const uint32_t (&a)[4], uint64_t desc_b,
                                                   int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\nwgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
      "%0,%1,%2,%3,%4,%5,%6,%7}, {%8,%9,%10,%11}, %12, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(accumulate));
}

__device__ __forceinline__ void wgmma_m64n32k16_rs(float (&d)[16], const uint32_t (&a)[4], uint64_t desc_b,
                                                   int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\nwgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,%12,%13,%14,%15}, {%16,%17,%18,%19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(accumulate));
}

template <int N>
__device__ __forceinline__ void wgmma_win_pv(float (&d)[N / 2], const uint32_t (&a)[4], uint64_t desc_b,
                                             int accumulate) {
  if constexpr (N == 64) {
    wgmma_m64n64k16_rs(d, a, desc_b, accumulate);
  } else if constexpr (N == 32) {
    wgmma_m64n32k16_rs(d, a, desc_b, accumulate);
  } else {
    static_assert(N == 16, "P V is 16, 32 or 64 wide");
    wgmma_m64n16k16_rs(d, a, desc_b, accumulate);
  }
}

// The four accumulators of n8 tile j of a 32-register score row block, as
// mma.sync's D fragment.
__device__ __forceinline__ float (&win_tile(float* s, int j))[4] { return *reinterpret_cast<float(*)[4]>(s + 4 * j); }

struct WinArgs {
  CUtensorMap map[3];  // q, k, v as (cols, L, windows): boxes of win_box_cols(Dh) x 64 rows x 1, swizzled
  void* out;           // (windows, L, C) in the input's type
  const float* bias;   // kBias: (n_bias, H, L, L) f32, window w, head h reads bias[(w % n_windows) % n_bias, h]
  const float* gs;     // kCosine: (H,) f32
  unsigned tiles;      // windows x H, at most INT_MAX
  unsigned reps;       // the slab walk's windows a slab: windows / group
  unsigned group;      // the slab walk's window period (see win_tile_at)
  int seq_len, num_heads, n_windows, n_bias;
  float scale;
  float inv_scale;     // bf16 v1: 1 / scale
  float scale_log2e;   // bf16: scale log2(e)
};

// Tile i of the walk as (window w, head h). The slab walk (K2's rows):
// slab-major, i = (wb H + h) reps + r and w = r group + wb, where group is
// n_bias where it divides n_windows (then window w's slab is (w % group,
// h)), else n_windows (its slab is a function of (w % group, h)), and 1
// without a bias; tiles that share a slab are adjacent, so a block's
// contiguous run of tiles copies one or two slabs whatever the grid.
// Otherwise (K3/K4) (window, head) order, i = w H + h: blocks resident at
// once then read neighbouring heads of the same qkv rows, where the slab
// walk had them read one head's 64 bytes of rows far apart, and took up to
// 1.6x the time (PERF.md §6, PR 14). In 32 bits, which take fewer registers
// than 64.
template <bool kSlabWalk>
__device__ __forceinline__ void win_tile_at(const WinArgs& a, unsigned i, int& w, int& h) {
  const unsigned heads = a.num_heads, s = kSlabWalk ? i / a.reps : i;
  h = (int)(s % heads);
  w = (int)(kSlabWalk ? (i - s * a.reps) * a.group + s / heads : s / heads);
}

// Thread (warp w, lane 4 g + t) holds, in register 4 j + e of a tile's
// scores, query row 16 w + g (e = 0, 1) or 16 w + g + 8 (e = 2, 3) at key
// 8 j + 2 t + e % 2: the layout of wgmma's accumulators and, tile by tile,
// of mma.sync's; the output's registers 4 n + e are columns 8 n + 2 t + e %
// 2 of the same rows.
template <typename T, int DH, int kMode>
__global__ void __launch_bounds__(kWinThreads, kWinIsF32<T> ? 3 : DH > 32 ? 2 : kMode == kWinCosine ? 3 : 4)
    window_stage(const __grid_constant__ WinArgs a) {
  constexpr bool kCosine = kMode == kWinCosine, kBias = kMode != kRowsNoBias;
  constexpr bool kSlabWalk = kMode >= kRowsBias;
  constexpr bool F32 = kWinIsF32<T>;
  constexpr int NS = kWinStages<T>;
  constexpr int BW = win_box_cols(DH), RB = win_row_bytes<T>(DH), BOX = win_box_bytes<T>(DH), U = RB / 16;
  static_assert(RB >= 32 && RB <= 128, "a box row is one swizzle span");
  constexpr float kLog2e = 1.4426950408889634f;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* smem = smem_raw + (1024 - smem_addr(smem_raw) % 1024) % 1024;  // the swizzle's alignment
  unsigned char* ring = smem;                                        // [NS][q, k, v boxes]
  unsigned char* stg = ring + 3 * NS * BOX;                          // bf16: [4 warps][16 rows x RB bytes]
  float* sb = reinterpret_cast<float*>(stg + (F32 ? 0 : BOX));       // the tile's bias slab, L x L
  float* rs = sb + kWinRows * kWinRows;                              // kCosine: q's row scales, k's inverse norms
  uint64_t* full = reinterpret_cast<uint64_t*>(rs + 2 * kWinRows);  // one a stage

  const int L = a.seq_len, H = a.num_heads, C = H * DH;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32, g = lane / 4, t = lane % 4, r0 = 16 * warp;
  // this block's tiles, first + it step: the slab walk's a contiguous run
  // (runs equal to within one tile), else tiles j, j + grid, ...
  const unsigned per = a.tiles / gridDim.x, extra = a.tiles % gridDim.x;
  const unsigned first = kSlabWalk ? blockIdx.x * per + min(blockIdx.x, extra) : blockIdx.x;
  const unsigned step = kSlabWalk ? 1 : gridDim.x;
  const int n_it = (int)(per + (blockIdx.x < extra));

  if (tid == 0) {
    for (int i = 0; i < NS; ++i) mbar_init(&full[i], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // (thread 0) tile it's q, k and v boxes into its stage
  auto issue = [&](int it) {
    int w, h;
    win_tile_at<kSlabWalk>(a, first + it * step, w, h);
    unsigned char* dst = ring + (it % NS) * 3 * BOX;
    uint64_t* bar = &full[it % NS];
    mbar_arrive_expect_tx(bar, 3 * BOX);
#pragma unroll
    for (int x = 0; x < 3; ++x) tma_load_3d(dst + x * BOX, &a.map[x], bar, h * DH, 0, w);
  };
  if (tid == 0 && n_it > 0) {
#pragma unroll
    for (int x = 0; x < 3; ++x)
      asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(&a.map[x])) : "memory");
    for (int it = 0; it < n_it && it < NS; ++it) issue(it);
  }

  // this thread's bias rows in the slab (query rows past L read row L - 1)
  [[maybe_unused]] const float* b0 = sb + min(r0 + g, L - 1) * L;
  [[maybe_unused]] const float* b1 = sb + min(r0 + g + 8, L - 1) * L;
  [[maybe_unused]] int slab = -1;  // the (window, head) slab sb holds
  float s[32], o[BW / 2];
#pragma unroll
  for (int i = 0; i < 32; ++i) s[i] = 0.f;
#pragma unroll
  for (int i = 0; i < BW / 2; ++i) o[i] = 0.f;
  for (int it = 0; it < n_it; ++it) {
    int w, h;
    win_tile_at<kSlabWalk>(a, first + it * step, w, h);
    const int st = it % NS;
    const unsigned char* tq = ring + st * 3 * BOX;
    const unsigned char* tk = tq + BOX;
    const unsigned char* tv = tk + BOX;

    // The tile's bias slab into shared memory where it changed (a block's
    // run of tiles crosses few slabs: the walk puts a slab's tiles side by
    // side); every thread finished reading the last one before the previous
    // tile's final barrier.
    if constexpr (kBias) {
      const int want = (w % a.n_windows) % a.n_bias * H + h;
      if (want != slab) {
        const float* src = a.bias + (long long)want * L * L;
        for (int i = tid; i < L * L; i += kWinThreads) sb[i] = __ldg(src + i);
        named_barrier(1, kWinThreads);
        slab = want;
      }
    }
    if constexpr (kBias && !F32 && !kCosine) {  // bf16 v1: the accumulators start at the bias over the scale
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int key = min(8 * j + 2 * t + e, L - 1);  // keys past L read key L - 1 (masked below)
          s[4 * j + e] = b0[key] * a.inv_scale;
          s[4 * j + 2 + e] = b1[key] * a.inv_scale;
        }
    }
    mbar_wait(&full[st], (it / NS) & 1);

    // kCosine: q's row scales and k's inverse norms into rs, two threads a
    // row, each half its columns
    [[maybe_unused]] auto row_scales = [&]() {
      constexpr int UH = DH * (int)sizeof(T) / 32;  // 16-byte units a half row
      const int r = tid / 2, hf = tid % 2;
      float q2 = 0.f, k2 = 0.f;
#pragma unroll
      for (int i = 0; i < UH; ++i) {
        const int off = r * RB + (win_unit<RB>(r, hf * UH + i) << 4);
        const uint4 qv = *reinterpret_cast<const uint4*>(tq + off);
        const uint4 kv = *reinterpret_cast<const uint4*>(tk + off);
        const uint32_t qw[4] = {qv.x, qv.y, qv.z, qv.w}, kw[4] = {kv.x, kv.y, kv.z, kv.w};
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          if constexpr (F32) {
            const float qf = __uint_as_float(qw[c]), kf = __uint_as_float(kw[c]);
            q2 = fmaf(qf, qf, q2);
            k2 = fmaf(kf, kf, k2);
          } else {
            const float2 qf = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&qw[c]));
            const float2 kf = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&kw[c]));
            q2 = fmaf(qf.x, qf.x, fmaf(qf.y, qf.y, q2));
            k2 = fmaf(kf.x, kf.x, fmaf(kf.y, kf.y, k2));
          }
        }
      }
      q2 += __shfl_xor_sync(0xffffffffu, q2, 1);
      k2 += __shfl_xor_sync(0xffffffffu, k2, 1);
      if (hf == 0) {
        rs[r] = a.gs[h] / fmaxf(sqrtf(q2), 1e-12f) * (F32 ? a.scale : a.scale_log2e);
        rs[kWinRows + r] = 1.f / fmaxf(sqrtf(k2), 1e-12f);
      }
    };

    // S = Q K^T: bf16 on wgmma (onto the bias over the scale in v1, from
    // zero in v2 and without a bias); f32 by split TF32 on mma.sync, each
    // warp its 16 rows
    if constexpr (F32) {
      if constexpr (kCosine) row_scales();  // first: the products' 32 accumulators are not live yet
#pragma unroll
      for (int i = 0; i < 32; ++i) s[i] = 0.f;
#pragma unroll
      for (int ks = 0; ks < DH / 8; ++ks) {
        uint32_t ah[4], al[4];
        split_tf32_bits(win_f32<RB>(tq, r0 + g, 8 * ks + t), ah[0], al[0]);
        split_tf32_bits(win_f32<RB>(tq, r0 + g + 8, 8 * ks + t), ah[1], al[1]);
        split_tf32_bits(win_f32<RB>(tq, r0 + g, 8 * ks + t + 4), ah[2], al[2]);
        split_tf32_bits(win_f32<RB>(tq, r0 + g + 8, 8 * ks + t + 4), ah[3], al[3]);
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          uint32_t bh0, bl0, bh1, bl1;
          split_tf32_bits(win_f32<RB>(tk, 8 * j + g, 8 * ks + t), bh0, bl0);
          split_tf32_bits(win_f32<RB>(tk, 8 * j + g, 8 * ks + t + 4), bh1, bl1);
          mma_split(win_tile(s, j), ah, al, bh0, bh1, bl0, bl1);
        }
      }
    } else {
      fence_accumulator(s);
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < DH / 16; ++ks)
        wgmma_m64n64k16(s, win_desc<RB>(tq) + 2 * ks, win_desc<RB>(tk) + 2 * ks, (kBias && !kCosine) || ks > 0);
      wgmma_commit();
      if constexpr (kCosine) row_scales();  // while the products run
    }
    if constexpr (!F32) {
      wgmma_wait<0>();
      fence_accumulator(s);
    }
    if constexpr (kCosine) named_barrier(1, kWinThreads);  // the row scales

    // The scores: bf16 in log2 units (s scale log2(e), v2 s (gs / |q|) scale
    // log2(e) / |k| + bias log2(e)), f32 in natural ones (s scale + bias, v2
    // s (gs / |q|) scale / |k| + bias); -inf at keys >= L; each row's max
    const int lim = L - 2 * t;  // key 8 j + 2 t + e % 2 is below L iff 8 j + e % 2 < lim
    float mx[2] = {-INFINITY, -INFINITY};
    float qs[2] = {F32 ? a.scale : a.scale_log2e, F32 ? a.scale : a.scale_log2e};
    if constexpr (kCosine) {
      qs[0] = rs[r0 + g];
      qs[1] = rs[r0 + g + 8];
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      [[maybe_unused]] float2 ki;
      if constexpr (kCosine) ki = *reinterpret_cast<const float2*>(rs + kWinRows + 8 * j + 2 * t);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float v = s[4 * j + e] * qs[e >> 1];
        if constexpr (kCosine) v *= (e & 1) ? ki.y : ki.x;
        if constexpr (kBias && (F32 || kCosine)) {
          const float bv = (e >> 1 ? b1 : b0)[min(8 * j + 2 * t + (e & 1), L - 1)];
          v += F32 ? bv : bv * kLog2e;
        }
        v = 8 * j + (e & 1) < lim ? v : -INFINITY;
        s[4 * j + e] = v;
        mx[e >> 1] = fmaxf(mx[e >> 1], v);
      }
    }
    mx[0] = quad_max(mx[0]);
    mx[1] = quad_max(mx[1]);
    float sum[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const float x = F32 ? exp2f((s[i] - mx[(i >> 1) & 1]) * kLog2e) : ex2(s[i] - mx[(i >> 1) & 1]);
      s[i] = x;
      sum[(i >> 1) & 1] += x;
    }
    const float inv[2] = {1.f / quad_sum(sum[0]), 1.f / quad_sum(sum[1])};

    // O = P V. bf16: p = e / sum rounded to bf16 as wgmma's register A
    // operand, V MN-major. f32: e split as mma.sync's A operand unmoved (A's
    // k index t stands for key 2 t, t + 4 for key 2 t + 1; V read with the
    // same permutation), O divided by the sum at the store.
    if constexpr (F32) {
#pragma unroll
      for (int i = 0; i < BW / 2; ++i) o[i] = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        uint32_t ph[4], pl[4];
        split_tf32_bits(s[4 * j], ph[0], pl[0]);
        split_tf32_bits(s[4 * j + 2], ph[1], pl[1]);
        split_tf32_bits(s[4 * j + 1], ph[2], pl[2]);
        split_tf32_bits(s[4 * j + 3], ph[3], pl[3]);
#pragma unroll
        for (int n = 0; n < DH / 8; ++n) {
          uint32_t bh0, bl0, bh1, bl1;
          split_tf32_bits(win_f32<RB>(tv, 8 * j + 2 * t, 8 * n + g), bh0, bl0);
          split_tf32_bits(win_f32<RB>(tv, 8 * j + 2 * t + 1, 8 * n + g), bh1, bl1);
          mma_split(win_tile(o, n), ph, pl, bh0, bh1, bl0, bl1);
        }
      }
    } else {
      uint32_t pa[4][4];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const __nv_bfloat162 v =
              __floats2bfloat162_rn(s[8 * kk + 2 * i] * inv[i & 1], s[8 * kk + 2 * i + 1] * inv[i & 1]);
          pa[kk][i] = *reinterpret_cast<const uint32_t*>(&v);
          asm volatile("" : "+r"(pa[kk][i])::"memory");  // computed before the fence
        }
      fence_accumulator(o);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) wgmma_win_pv<BW>(o, pa[kk], win_mn_desc<RB>(tv + 16 * kk * RB), kk > 0);
      wgmma_commit();
      wgmma_wait<0>();
      fence_accumulator(o);
    }

    // every warp is done with this stage (and the slab, v2's row scales): refill it
    named_barrier(1, kWinThreads);
    if (tid == 0 && it + NS < n_it) issue(it + NS);

    if constexpr (F32) {  // rows < L as 8-byte stores of O / sum
      float* out = static_cast<float*>(a.out);
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        const int row = r0 + g + 8 * hr;
        if (row < L)
#pragma unroll
          for (int n = 0; n < DH / 8; ++n)
            *reinterpret_cast<float2*>(out + ((long long)w * L + row) * C + h * DH + 8 * n + 2 * t) =
                make_float2(o[4 * n + 2 * hr] * inv[hr], o[4 * n + 2 * hr + 1] * inv[hr]);
      }
    } else {  // O rounded to bf16 through this warp's staging rows, rows < L as 16-byte stores
      bf16* out = static_cast<bf16*>(a.out);
      unsigned char* sw = stg + warp * 16 * RB;
#pragma unroll
      for (int j = 0; j < BW / 8; ++j)
#pragma unroll
        for (int hr = 0; hr < 2; ++hr) {
          const int r = g + 8 * hr;
          const __nv_bfloat162 v = __floats2bfloat162_rn(o[4 * j + 2 * hr], o[4 * j + 2 * hr + 1]);
          *reinterpret_cast<__nv_bfloat162*>(sw + r * RB + (win_unit<RB>(r, j) << 4) + 4 * t) = v;
        }
      __syncwarp();
#pragma unroll
      for (int i = 0; i < 16 * U / 32; ++i) {
        const int idx = lane + 32 * i, r = idx / U, u = idx % U, row = r0 + r;
        if (row < L && u < DH / 8)
          *reinterpret_cast<uint4*>(out + ((long long)w * L + row) * C + h * DH + 8 * u) =
              *reinterpret_cast<const uint4*>(sw + r * RB + (win_unit<RB>(r, u) << 4));
      }
      __syncwarp();  // the staging rows are free again
    }
  }
}

// TMA map of a tensor read as (windows, L, cols) with rows `ld` elements
// apart, in T, as (cols, L, windows), in boxes of box_cols x 64 rows x 1
// with the swizzle of that width (box_cols sizeof(T) bytes: 32, 64 or 128);
// rows past L and columns past cols read as zeros.
template <typename T>
cudaError_t encode_window_map(CUtensorMap* map, const void* base, int windows, int seq_len, int cols, long long ld,
                              int box_cols) {
  const PFN_cuTensorMapEncodeTiled_v12000 encode = encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;
  const cuuint64_t row = (cuuint64_t)ld * sizeof(T);
  const cuuint64_t dims[3] = {(cuuint64_t)cols, (cuuint64_t)seq_len, (cuuint64_t)windows};
  const cuuint64_t strides[2] = {row, row * seq_len};
  const cuuint32_t box[3] = {(cuuint32_t)box_cols, (cuuint32_t)kWinRows, 1};
  const cuuint32_t element_strides[3] = {1, 1, 1};
  const size_t span = box_cols * sizeof(T);
  const CUtensorMapSwizzle swizzle = span == 32   ? CU_TENSOR_MAP_SWIZZLE_32B
                                     : span == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
                                                  : CU_TENSOR_MAP_SWIZZLE_128B;
  const CUtensorMapDataType type = kWinIsF32<T> ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  const CUresult r = encode(map, type, 3, const_cast<void*>(base), dims, strides, box, element_strides,
                            CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// Blocks of the window stage's kernel an SM holds, found once (its shared
// memory attribute set first); 0 on an error.
template <typename T, int DH, int kMode>
int window_stage_occupancy() {
  static const int occ = []() {
    auto kernel = window_stage<T, DH, kMode>;
    int n = 0;
    if (cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, win_smem_bytes<T>(DH)) !=
            cudaSuccess ||
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kernel, kWinThreads, win_smem_bytes<T>(DH)) !=
            cudaSuccess)
      return 0;
    return n;
  }();
  return occ;
}

// Blocks the window stage launches for `tiles` tiles on `sms` SMs: as many
// as the card holds at once (persistent), at most one a tile.
long long window_stage_blocks(long long tiles, int sms, int occupancy) {
  const long long resident = (long long)sms * (occupancy > 0 ? occupancy : 1);
  return tiles < resident ? tiles : resident;
}

cudaError_t sm_count(int* sms) {
  int device = 0;
  const cudaError_t err = cudaGetDevice(&device);
  return err == cudaSuccess ? cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, device) : err;
}

template <typename T, int DH, int kMode>
cudaError_t launch_window_stage(const WinArgs& a, cudaStream_t stream) {
  int sms = 0;
  cudaError_t err = sm_count(&sms);
  if (err != cudaSuccess) return err;
  auto kernel = window_stage<T, DH, kMode>;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, win_smem_bytes<T>(DH));
  if (err != cudaSuccess) return err;
  const int occ = window_stage_occupancy<T, DH, kMode>();
  if (occ == 0) return cudaErrorInvalidValue;
  kernel<<<(unsigned)window_stage_blocks(a.tiles, sms, occ), kWinThreads, win_smem_bytes<T>(DH), stream>>>(a);
  return cudaGetLastError();
}

// The head dims each type's window stage takes: bf16 16, 32, 48, 64 (a box
// row of at most 128 bytes); f32 16 and 32. Instantiated for each mode.
template <typename T, int kMode>
cudaError_t launch_window_stage_dh(const WinArgs& a, int head_dim, cudaStream_t stream) {
  switch (head_dim) {
    case 16: return launch_window_stage<T, 16, kMode>(a, stream);
    case 32: return launch_window_stage<T, 32, kMode>(a, stream);
    default: break;
  }
  if constexpr (!kWinIsF32<T>) {
    if (head_dim == 48) return launch_window_stage<T, 48, kMode>(a, stream);
    if (head_dim == 64) return launch_window_stage<T, 64, kMode>(a, stream);
  }
  return cudaErrorInvalidValue;
}

template <typename T, int kMode>
int window_stage_occupancy_dh(int head_dim) {
  switch (head_dim) {
    case 16: return window_stage_occupancy<T, 16, kMode>();
    case 32: return window_stage_occupancy<T, 32, kMode>();
    default: break;
  }
  if constexpr (!kWinIsF32<T>) {
    if (head_dim == 48) return window_stage_occupancy<T, 48, kMode>();
    if (head_dim == 64) return window_stage_occupancy<T, 64, kMode>();
  }
  return 0;
}

// The mode of a call: K2's rows (the slab walk) with or without a bias;
// K3/K4's windows, v1 or cosine, with a bias; -1 for a call no kernel takes.
int window_mode(bool slab_walk, bool cosine, bool bias) {
  if (slab_walk) return cosine ? -1 : bias ? kRowsBias : kRowsNoBias;
  return !bias ? -1 : cosine ? kWinCosine : kWinV1;
}

template <typename T>
int window_stage_occupancy_any(int head_dim, int mode) {
  switch (mode) {
    case kWinV1: return window_stage_occupancy_dh<T, kWinV1>(head_dim);
    case kWinCosine: return window_stage_occupancy_dh<T, kWinCosine>(head_dim);
    case kRowsBias: return window_stage_occupancy_dh<T, kRowsBias>(head_dim);
    case kRowsNoBias: return window_stage_occupancy_dh<T, kRowsNoBias>(head_dim);
    default: return 0;
  }
}

template <typename T>
cudaError_t launch_window_stage_any(const eqx_window::Operands& op, cudaStream_t stream) {
  const bool bias = op.bias != nullptr;
  const int mode = window_mode(op.slab_walk, op.gs != nullptr, bias);
  if (mode < 0) return cudaErrorInvalidValue;
  WinArgs a = {};
  for (int x = 0; x < 3; ++x) {
    const cudaError_t err = encode_window_map<T>(&a.map[x], op.src[x], op.windows, op.seq_len, op.cols, op.ld,
                                                 win_box_cols(op.head_dim));
    if (err != cudaSuccess) return err;
  }
  a.out = op.out;
  a.bias = op.bias;
  a.gs = op.gs;
  const long long tiles = (long long)op.windows * op.num_heads;
  if (tiles > INT_MAX) return cudaErrorInvalidValue;
  a.tiles = (unsigned)tiles;
  a.group = !bias ? 1 : op.n_windows % op.n_bias == 0 ? op.n_bias : op.n_windows;
  a.reps = op.windows / a.group;
  a.seq_len = op.seq_len;
  a.num_heads = op.num_heads;
  a.n_windows = op.n_windows;
  a.n_bias = op.n_bias;
  a.scale = op.scale;
  a.inv_scale = 1.f / op.scale;
  a.scale_log2e = op.scale * 1.4426950408889634f;
  switch (mode) {
    case kWinV1: return launch_window_stage_dh<T, kWinV1>(a, op.head_dim, stream);
    case kWinCosine: return launch_window_stage_dh<T, kWinCosine>(a, op.head_dim, stream);
    case kRowsBias: return launch_window_stage_dh<T, kRowsBias>(a, op.head_dim, stream);
    default: return launch_window_stage_dh<T, kRowsNoBias>(a, op.head_dim, stream);
  }
}

// ---- f32 elsewhere: the attention stage's split-TF32 kernel with the window's bias ----
template <bool kCosine>
cudaError_t launch_window_f32(const FmaArgs<float>& f, int windows, cudaStream_t stream) {
  switch ((f.head_dim + 15) / 16) {
    case 1: return launch_f32<16, kCosine>(f, windows, stream);
    case 2: return launch_f32<32, kCosine>(f, windows, stream);
    case 3: return launch_f32<48, kCosine>(f, windows, stream);
    case 4: return launch_f32<64, kCosine>(f, windows, stream);
    default: return cudaErrorInvalidValue;
  }
}

// ---- bf16 CUDA-core kernel, for the shapes the window stage does not take ----
constexpr int kWarps = 4;

// Row stride of the staged K and V, in elements: at least head_dim, and an
// odd number of 32-bit words.
__host__ __device__ __forceinline__ int kv_stride(int head_dim) {
  int words = (head_dim * 2 + 3) / 4;
  if (words % 2 == 0) words += 1;
  return words * 2;
}

size_t smem_bytes(int seq_len, int head_dim) {
  return 2 * (size_t)seq_len * kv_stride(head_dim) * sizeof(bf16)  // K and V
         + kWarps * (size_t)seq_len * sizeof(float)                // score rows
         + kWarps * (size_t)kWinMaxHeadDim * sizeof(float)         // q rows
         + (size_t)seq_len * sizeof(float);                        // K's inverse norms
}

// Loads one head's row of q or k (columns lane and lane+32; 0 past
// head_dim) in f32 and returns the inverse of its L2 norm, floored at 1e-12.
__device__ __forceinline__ float load_head_row(const bf16* src, int head_dim, int lane, float (&v)[2]) {
#pragma unroll
  for (int t = 0; t < 2; ++t) {
    const int d = lane + 32 * t;
    v[t] = d < head_dim ? __bfloat162float(src[d]) : 0.f;
  }
  return 1.f / fmaxf(sqrtf(warp_sum(v[0] * v[0] + v[1] * v[1])), 1e-12f);
}

__global__ void __launch_bounds__(kWarps * 32)
    window_attention_kernel(const bf16* __restrict__ qkv, const float* __restrict__ bias,
                            const float* __restrict__ gs, bf16* __restrict__ out, int n_windows, int n_bias,
                            int seq_len, int num_heads, int head_dim, float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int L = seq_len, Dh = head_dim;
  const int ks = kv_stride(Dh);
  bf16* k_s = reinterpret_cast<bf16*>(smem);
  bf16* v_s = k_s + (size_t)L * ks;
  float* s_all = reinterpret_cast<float*>(v_s + (size_t)L * ks);
  float* q_all = s_all + kWarps * L;
  float* k_inv = q_all + kWarps * kWinMaxHeadDim;

  const int h = blockIdx.x % num_heads;
  const long long bw = blockIdx.x / num_heads;  // image * nW + window
  const int wb = (int)(bw % n_windows) % n_bias;
  const int D = num_heads * Dh;
  const long long row_stride = 3LL * D;
  const bf16* base = qkv + bw * L * row_stride + h * Dh;
  const float* bias_h = bias + ((long long)wb * num_heads + h) * L * L;
  const bool cosine = gs != nullptr;

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int j = warp; j < L; j += kWarps) {
    const bf16* row = base + j * row_stride;
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
  float* q_w = q_all + warp * kWinMaxHeadDim;
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
      const bf16* k_row = k_s + j * ks;
      float acc = 0.f;
      for (int d = 0; d < Dh; ++d) acc = fmaf(q_w[d], __bfloat162float(k_row[d]), acc);
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
    for (int j = lane; j < L; j += 32) s_w[j] = __bfloat162float(__float2bfloat16(s_w[j] * inv_sum));
    __syncwarp();

    float o[2] = {0.f, 0.f};
    for (int j = 0; j < L; ++j) {
      const float p = s_w[j];
      const bf16* v_row = v_s + j * ks;
#pragma unroll
      for (int t = 0; t < 2; ++t) {
        const int d = lane + 32 * t;
        if (d < Dh) o[t] = fmaf(p, __bfloat162float(v_row[d]), o[t]);
      }
    }
    bf16* dst = out + (bw * L + i) * D + h * Dh;
#pragma unroll
    for (int t = 0; t < 2; ++t) {
      const int d = lane + 32 * t;
      if (d < Dh) dst[d] = __float2bfloat16(o[t]);
    }
    __syncwarp();  // s_w and q_w are rewritten by the next row
  }
}

cudaError_t launch_cuda_cores(const void* qkv, const float* bias, const float* gs, void* out, int windows,
                              int n_windows, int n_bias, int seq_len, int num_heads, int head_dim, float scale,
                              cudaStream_t stream) {
  const size_t smem = smem_bytes(seq_len, head_dim);
  int device = 0, max_smem = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&max_smem, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (err != cudaSuccess) return err;
  if (smem > (size_t)max_smem) return cudaErrorInvalidValue;
  const long long blocks = (long long)windows * num_heads;
  if (blocks > INT_MAX) return cudaErrorInvalidValue;
  err = cudaFuncSetAttribute(window_attention_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  window_attention_kernel<<<(unsigned)blocks, kWarps * 32, smem, stream>>>(
      static_cast<const bf16*>(qkv), bias, gs, static_cast<bf16*>(out), n_windows, n_bias, seq_len, num_heads,
      head_dim, scale);
  return cudaGetLastError();
}

// The kernel eqx_window_attention takes: 0 the bf16 CUDA-core kernel, 1 the
// bf16 window stage (TMA ring, wgmma), 2 the f32 attention stage (split
// TF32, mma.sync), 3 the f32 window stage (TMA ring, split TF32 on mma.sync).
enum WindowPath { kPathCudaCores = 0, kPathStageBf16 = 1, kPathAttentionStageF32 = 2, kPathStageF32 = 3 };
WindowPath window_path(int dtype, int seq_len, int head_dim, bool aligned, bool cosine, float scale) {
  const bool stage = eqx_window::stage_takes(dtype, seq_len, head_dim, aligned, cosine, true, scale);
  if (dtype == 0) return stage ? kPathStageF32 : kPathAttentionStageF32;
  return stage ? kPathStageBf16 : kPathCudaCores;
}

}  // namespace

namespace eqx_window {

bool stage_takes(int dtype, int seq_len, int head_dim, bool aligned, bool cosine, bool bias, float scale) {
  if (seq_len > kWinRows || !aligned) return false;
  if (dtype == 0) return head_dim == 16 || head_dim == 32;
  const bool scale_ok = cosine || !bias || (isfinite(scale) && isfinite(1.f / scale));  // v1 takes bias / scale
  return dtype == 1 && head_dim % 16 == 0 && head_dim <= kWinMaxHeadDim && scale_ok;
}

cudaError_t launch_stage(const Operands& op, int dtype, cudaStream_t stream) {
  const bool aligned = aligned16(op.src[0]) && aligned16(op.src[1]) && aligned16(op.src[2]) && aligned16(op.out);
  if (op.windows <= 0 || op.n_windows <= 0 || op.n_bias <= 0 || op.num_heads <= 0 || op.windows % op.n_windows != 0 ||
      !stage_takes(dtype, op.seq_len, op.head_dim, aligned, op.gs != nullptr, op.bias != nullptr, op.scale))
    return cudaErrorInvalidValue;
  return dtype == 0 ? launch_window_stage_any<float>(op, stream) : launch_window_stage_any<bf16>(op, stream);
}

cudaError_t stage_config(int dtype, int head_dim, bool slab_walk, bool cosine, bool bias, long long tiles, int* out) {
  const bool f32 = dtype == 0;
  const int mode = window_mode(slab_walk, cosine, bias);
  const int occ = f32 ? window_stage_occupancy_any<float>(head_dim, mode)
                      : window_stage_occupancy_any<bf16>(head_dim, mode);
  int sms = 0;
  const cudaError_t err = sm_count(&sms);
  if (err != cudaSuccess) return err;
  out[0] = occ;
  out[1] = (int)stage_smem_bytes(dtype, head_dim);
  out[2] = (int)window_stage_blocks(tiles, sms, occ);
  out[3] = f32 ? kWinStages<float> : kWinStages<bf16>;
  return occ > 0 ? cudaSuccess : cudaErrorInvalidValue;
}

long long stage_smem_bytes(int dtype, int head_dim) {
  return dtype == 0 ? win_smem_bytes<float>(head_dim) : win_smem_bytes<bf16>(head_dim);
}

}  // namespace eqx_window

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. qkv (windows, seq_len, 3*num_heads*head_dim)
// with windows = images * n_windows, bias (n_bias, num_heads, seq_len, seq_len)
// f32, gs (num_heads,) f32 or null (null: v1, non-null: v2 cosine attention),
// out (windows, seq_len, num_heads*head_dim); all contiguous on the current
// device. Window w reads bias[(w % n_windows) % n_bias]. Launches on
// `stream` and returns the cudaError_t of the launch.
int eqx_window_attention(const void* qkv, const void* bias, const void* gs, void* out, int windows, int n_windows,
                         int n_bias, int seq_len, int num_heads, int head_dim, float scale, int dtype, void* stream) {
  if (windows <= 0 || n_windows <= 0 || n_bias <= 0 || seq_len <= 0 || num_heads <= 0 || head_dim <= 0 ||
      head_dim > kWinMaxHeadDim || windows % n_windows != 0 || dtype < 0 || dtype > 1)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* b = static_cast<const float*>(bias);
  const float* g = static_cast<const float*>(gs);
  const int C = num_heads * head_dim;
  switch (window_path(dtype, seq_len, head_dim, aligned16(qkv) && aligned16(out), g != nullptr, scale)) {
    case kPathStageBf16:
    case kPathStageF32: {  // q, k and v as the three thirds of each qkv row
      const size_t elem = dtype == 0 ? sizeof(float) : sizeof(bf16);
      const char* base = static_cast<const char*>(qkv);
      eqx_window::Operands op = {};
      for (int x = 0; x < 3; ++x) op.src[x] = base + x * (size_t)C * elem;
      op.ld = 3LL * C;
      op.cols = C;
      op.out = out;
      op.bias = b;
      op.gs = g;
      op.windows = windows;
      op.n_windows = n_windows;
      op.n_bias = n_bias;
      op.seq_len = seq_len;
      op.num_heads = num_heads;
      op.head_dim = head_dim;
      op.scale = scale;
      op.slab_walk = false;
      return eqx_window::launch_stage(op, dtype, s);
    }
    case kPathAttentionStageF32: {
      const float* base = static_cast<const float*>(qkv);
      FmaArgs<float> f = {};
      f.q = base;
      f.k = base + C;
      f.v = base + 2 * C;
      f.out = static_cast<float*>(out);
      f.bias = b;
      f.gs = g;
      f.ld = 3LL * C;
      f.n_bias = n_bias;
      f.bias_period = n_windows;
      f.bias_ld = seq_len;
      f.seq_len = seq_len;
      f.num_heads = num_heads;
      f.head_dim = head_dim;
      f.scale = scale;
      return g != nullptr ? launch_window_f32<true>(f, windows, s) : launch_window_f32<false>(f, windows, s);
    }
    default:
      return launch_cuda_cores(qkv, b, g, out, windows, n_windows, n_bias, seq_len, num_heads, head_dim, scale, s);
  }
}

// The kernel eqx_window_attention takes at (seq_len, head_dim, dtype, v2)
// for 16-byte aligned tensors and a v1 scale of 1 / sqrt(head_dim), over
// `tiles` (window, head) pairs: out[0] its WindowPath; for the window stage
// out[1] blocks an SM, out[2] dynamic shared memory a block, out[3] blocks
// launched, out[4] ring stages; else zeros. Returns a cudaError_t.
int eqx_window_attention_config(int seq_len, int head_dim, int dtype, int cosine, long long tiles, int* out) {
  if (seq_len <= 0 || head_dim <= 0 || head_dim > kWinMaxHeadDim || dtype < 0 || dtype > 1 || tiles <= 0)
    return cudaErrorInvalidValue;
  for (int i = 0; i < 5; ++i) out[i] = 0;
  out[0] = window_path(dtype, seq_len, head_dim, true, cosine != 0, 1.f / sqrtf((float)head_dim));
  if (out[0] != kPathStageBf16 && out[0] != kPathStageF32) return cudaSuccess;
  return eqx_window::stage_config(dtype, head_dim, false, cosine != 0, true, tiles, out + 1);
}

// Dynamic shared memory one block of the kernel eqx_window_attention takes
// needs (16-byte aligned tensors, a v1 scale of 1 / sqrt(head_dim)); for
// error messages and reports.
long long eqx_window_attention_smem_bytes(int seq_len, int head_dim, int elem_bytes) {
  if (seq_len <= 0 || head_dim <= 0 || head_dim > kWinMaxHeadDim) return 0;
  switch (window_path(elem_bytes == 2 ? 1 : 0, seq_len, head_dim, true, false, 1.f / sqrtf((float)head_dim))) {
    case kPathStageBf16:
    case kPathStageF32: return eqx_window::stage_smem_bytes(elem_bytes == 2 ? 1 : 0, head_dim);
    case kPathAttentionStageF32: return (long long)f32_stage_smem_bytes((head_dim + 15) / 16 * 16, false);
    default: return (long long)smem_bytes(seq_len, head_dim);
  }
}

}  // extern "C"
