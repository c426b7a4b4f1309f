// The attention stage, shared by fused_qkv_attention.cu (K1/K1p, ViT's
// attention in training), attention_half.cu (the third launch of the fused
// attention half, P2/P4) and attention.cu (the public attention, K2, on
// rows longer than 64 tokens and wherever its tensor-core path for short
// rows does not apply):
//
//   qkv (B, L, 3D) laid out [q heads | k heads | v heads], D = H * Dh
//   out[b, i, h*Dh:(h+1)*Dh] = softmax(q_i . K^T * scale + bias[b % Bb, i]) . V
//
// or, for K2, separate q, k, v (B, L, Dh) with H = 1 and D = Dh. The bias
// (Bb, L, L) in f32 is K2's compact one; K1 and the half have none.
// Replaces the Pallas TPU kernels _qkv_attn_kernel and
// _qkv_attn_kernel_pair (eqxvision_tpu/ops/attention.py), the attention
// of the prototypes _attn_kernel of scripts/ablate_vit2.py and
// scripts/ablate_vit4.py, which compute the same function, and, behind
// K2, _attn_kernel and kernel4 (_attention_pallas there). Rounding points
// (attention_stage_reference and attention_reference in ops/attention.py):
// s = (q . k) * scale + bias in f32; p = e / sum(e), e = exp(s - max), in
// f32, rounded to the input type before p . V; p . V accumulated in f32 and
// rounded once.
//
// bf16 with Dh a multiple of 16 runs on Hopper's tensor cores
// (attention_stage_wgmma, sm_90a):
//   - One block of one warpgroup (128 threads) owns an (image, head) and
//     all its query tiles of 64 rows (where B H blocks would leave an SM
//     with fewer than two, as at small batch, the tiles are shared among a
//     few blocks of the head). Its thread 0 loads the head's K and V into
//     shared memory once, by TMA (cp.async.bulk.tensor over 3-D maps of
//     q, k and v, in boxes of 64 columns x 64 rows with the 128-byte
//     swizzle: a Dh = 64 bf16 row is one 128-byte swizzle row; Dh > 64
//     takes two column halves). K1 and the half pass one map of qkv, (3D,
//     L, B), three times, at columns h Dh, D + h Dh and 2D + h Dh; K2 passes
//     three maps (Dh, L, B) at column 0, whose boxes are wider than a row
//     where Dh < 64: TMA fills the columns past Dh with zeros, and the
//     products read only the first Dh. Rows past L read as zeros, not as
//     the next image's rows. The q tiles come the same way into two
//     buffers, the next one loading while this one is used.
//   - S = Q K^T by wgmma m64n64k16 over blocks of 256 keys (four pieces of
//     64), both operands from shared-memory descriptors: K is already
//     K-major for wgmma's B, so nothing is transposed. Where L <= 256 (a
//     kernel of its own) the whole score row, 128 f32 registers a thread,
//     stays in the accumulators, and one pass takes each row's exact max (a
//     row lives in the 4 lanes of a quad: quad shuffles), e = 2^((s - max)
//     log2 e) and its sum, then p = e / sum rounded to bf16 in place as the
//     register A operand of wgmma m64nNk16 for O = P V (N = 64, or 128 for
//     Dh > 64), with V the shared-memory B operand read MN-major (the
//     transpose bit): no transpose copy, and QK^T is computed once. Key
//     columns >= L are -inf before the max, by selects, and the products
//     run over whole blocks, whose key rows past L are zeros in shared
//     memory: nothing that writes a wgmma operand register sits under a
//     branch. (A first version that guarded the products, the packing of
//     P and the softmax by piece, tile and warp made ptxas serialise every
//     wgmma of the kernel, C7520 in the build log, and took twice the
//     time; PERF.md §6.)
//   - The bias (kBias, K2 only): before each block's Q K^T, each thread
//     loads its own scores' bias values (f32, from L2: the compact bias is
//     reused by every row b that shares b % Bb) into the accumulators,
//     times 1 / scale, and the products accumulate onto them (scale-d = 1
//     from the first k16 step): s = (bias / scale + q . k) scale. The bias
//     thus takes no registers beyond the scores' own, where reading it
//     beside the 128 live scores (inside the scale and mask pass) spilled.
//     It moves the f32 rounding: bias / scale is rounded once and added
//     before the products rather than after the scale, a few units in the
//     last place of the larger term. A bias whose magnitude over |scale|
//     exceeds the f32 range reads as +-inf, and a scale of 0, or one whose
//     reciprocal is not finite, takes the CUDA-core stage. Query rows past
//     L read row L - 1. Keys past L are read on past the row's end (into
//     the next row, and after the bias's last row into the room of at
//     least 255 floats that the caller leaves there; never guarded) and
//     then masked to -inf, so that every load is a base register plus a
//     constant offset: clamping each key's index cost 254 registers and
//     spills at Dh >= 96. A thread's two keys 2 t, 2 t + 1 of an 8-key
//     group are one float2 load: the caller lays the bias out with an even
//     row stride (bias_ld, L rounded up to even), which halves the loads
//     and the L1 wavefronts of scalar ones.
//   - Where L > 256: two passes over the blocks, pass 1 the rows' max and
//     sum (a running max, the sum rescaled), pass 2 p and P V. A row whose
//     keys so far are all -inf (only a bias makes them so) is exponentiated
//     against 0 rather than -inf, so its sum stays 0 instead of NaN, and a
//     later finite block takes over; a row that is -inf everywhere gives
//     NaN, as the reference does. K and V stay
//     resident where all of L, rounded up to 256, fits in shared memory
//     (up to 768 keys at Dh <= 64, 256 at Dh > 64); beyond that each
//     block's K (pass 1) or K and V (pass 2) are loaded in turn. Any L.
//   - The epilogue rounds O to bf16 through the warp's own 16 staging rows
//     (XOR-swizzled 16-byte units: no bank conflicts) and writes rows < L
//     as 16-byte stores at column h * Dh of out (B, L, D).
//   - Shared memory at vit_base (L = 197 -> 256 key rows, Dh = 64): K and
//     V 64 KB, two q buffers 16 KB, staging 8 KB: 91 KB, so two blocks
//     (eight warps) share an SM. No producer warp: thread 0 issues every
//     load, so the block needs no setmaxnreg.
// What bounds it: each of qkv's bytes is read once and out written once,
// 4 B L D itemsize bytes (at vit_base b256 310 MB, 0.093 ms at 3.35 TB/s),
// against 4 B H L^2 Dh operations (30.5 GFLOP, 0.031 ms at 989 TFLOP/s);
// K2's compact bias adds Bb L^2 4 bytes (1.9 MB at 12 heads of 197). What
// holds it back in practice is the softmax's work on the CUDA cores
// (scale, mask, max, exp, sum, the bf16 pack: about ten instructions a
// score) beside the products (PERF.md §6); the bias adds half a load and a
// multiply a score, and its reads from L2 through L1.
//
// bf16 with Dh % 16 != 0, and bf16 at a scale the wgmma stage cannot take,
// run a CUDA-core stage in f32 (attention_stage_fma): blocks of 8 warps, 4
// query rows a warp, keys in chunks of 64 staged in f32 in shared memory,
// two passes (a running max and sum, then p rounded to bf16 and P V), the
// same bias and -inf handling. Any L.
//
// f32 runs its own stage (attention_stage_f32): in f32 p's rounding before
// P V is the identity, so one pass with an online softmax computes the same
// function with the f32 sums in another order. Blocks of four warps own 64
// query rows of an (image, head), 16 a warp, and stream K and V in chunks
// of 32 keys double-buffered by cp.async; S = Q K^T and
// P V run on the tensor cores by mma.sync m16n8k8 TF32 in split TF32 (each
// operand hi + lo, three products: about 22 bits of each product kept, as
// the f32 GEMM of gemm_bf16.cuh does), the softmax on the CUDA cores in
// f32 with the bias added after the scaled product. The split TF32 error is
// relative to |q| |k| and |p| |v|, not to a score's magnitude, since the
// bias is not in the products. Head dims round up to 16 (zero columns).
// What bounds it: 0.19 ms of f32 bytes at vit_base b256, against 30.5
// GFLOP of products, 0.18 ms at split TF32's 165 TFLOP/s. What holds it
// back (scripts/ablate_torch_attention_stage.py --dtype float32): the three
// products on mma.sync (one alone takes half the time) and the splits of
// K's and V's fragments, repeated by each of the block's four warps (the
// check that keeps a NaN or an infinity in hi is 8-10% of the stage's
// time). A register-tiled CUDA-core stage in true f32 took 1.1x its time
// and the earlier two-pass one 3.2x (PERF.md §6).
//
// Limits: Dh <= 128; the wgmma stage needs q, k, v and out 16-byte aligned
// and D a multiple of 8 (true when Dh % 16 == 0), and L below 2^31; the
// launchers return cudaErrorInvalidValue otherwise.
#pragma once

#include "gemm_bf16.cuh"

namespace {

using bf16 = __nv_bfloat16;
using eqx_tc::warp_max;

constexpr int kStageMaxHeadDim = 128;

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// ---- CUDA-core stage (bf16 with Dh % 16 != 0 or a scale the wgmma stage cannot take) ----
constexpr int kFmaWarps = 8;
constexpr int kFmaThreads = 32 * kFmaWarps;
constexpr int kFmaRows = 4;  // query rows per warp
constexpr int kFmaQTile = kFmaWarps * kFmaRows;
constexpr int kFmaKeys = 64;  // keys per staged chunk, two per lane

// K's row stride in floats: an odd count, so that 32 lanes reading 32 rows
// at one column hit 32 banks.
__host__ __device__ inline int fma_k_stride(int dh) { return dh | 1; }

size_t fma_smem_bytes(int dh) {
  return sizeof(float) * ((size_t)kFmaQTile * dh + (size_t)kFmaKeys * fma_k_stride(dh) + (size_t)kFmaKeys * dh +
                          (size_t)kFmaQTile * kFmaKeys);
}

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ bf16 from_f32<bf16>(float x) { return __float2bfloat16(x); }

// Operands of the CUDA-core and f32 stages. q, k and v point at image 0,
// head 0, row 0: image b, head h, row i is at (b L + i) ld + h Dh.
template <typename T>
struct FmaArgs {
  const T* q;
  const T* k;
  const T* v;
  T* out;             // (B, L, H Dh)
  const float* bias;  // (n_bias, H, L, bias_ld) f32, image b and head h read bias[(b % bias_period) % n_bias, h]; or null
  const float* gs;    // f32 stage: (H,) f32, Swin v2's cosine attention (see attention_stage_f32); or null
  long long ld;       // row stride of q, k and v in elements: 3 D for qkv, Dh for K2's separate tensors
  int n_bias, bias_period, bias_ld, seq_len, num_heads, head_dim, n_qtiles;
  float scale;
};

// The bias rows of image b, head h (null without a bias): K2's compact bias
// (H = 1, bias_period = n_bias) or a Swin window's (bias_period = nW).
template <typename T>
__device__ __forceinline__ const float* stage_bias(const FmaArgs<T>& a, long long b, int h) {
  if (a.bias == nullptr) return nullptr;
  return a.bias + ((b % a.bias_period) % a.n_bias * a.num_heads + h) * a.seq_len * a.bias_ld;
}

// NI: output columns per lane, ceil(Dh / 32).
template <typename T, int NI>
__global__ void __launch_bounds__(kFmaThreads) attention_stage_fma(const FmaArgs<T> a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int L = a.seq_len, Dh = a.head_dim, ks = fma_k_stride(Dh), n_qtiles = a.n_qtiles;
  const float scale = a.scale;
  float* sQ = reinterpret_cast<float*>(smem);  // kFmaQTile x Dh
  float* sK = sQ + kFmaQTile * Dh;              // kFmaKeys x ks
  float* sV = sK + kFmaKeys * ks;               // kFmaKeys x Dh
  float* sP = sV + kFmaKeys * Dh;               // kFmaQTile x kFmaKeys

  const int qt = blockIdx.x % n_qtiles;
  const int h = (blockIdx.x / n_qtiles) % a.num_heads;
  const long long b = blockIdx.x / ((unsigned)n_qtiles * a.num_heads);
  const int D = a.num_heads * Dh;
  const long long ld = a.ld, off = b * L * ld + h * Dh;
  const T* qb = a.q + off;
  const T* kb = a.k + off;
  const T* vb = a.v + off;
  const int q0 = qt * kFmaQTile;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  // this warp's rows of the bias; rows past L read row L - 1 and are not stored
  const float* bias_b = stage_bias(a, b, h);
  const float* brow[kFmaRows];
#pragma unroll
  for (int r = 0; r < kFmaRows; ++r)
    brow[r] = bias_b == nullptr ? nullptr : bias_b + (long long)min(q0 + warp * kFmaRows + r, L - 1) * a.bias_ld;

  for (int idx = threadIdx.x; idx < kFmaQTile * Dh; idx += kFmaThreads) {
    const int r = idx / Dh, d = idx - r * Dh;
    sQ[idx] = q0 + r < L ? to_f32(qb[(q0 + r) * ld + d]) : 0.f;
  }
  // keys j0 .. j0 + kFmaKeys of K (and V) into shared memory in f32; rows past L zero
  auto stage = [&](int j0, bool with_v) {
    for (int idx = threadIdx.x; idx < kFmaKeys * Dh; idx += kFmaThreads) {
      const int j = idx / Dh, d = idx - j * Dh;
      const bool ok = j0 + j < L;
      const long long at = (ok ? j0 + j : 0) * ld + d;
      sK[j * ks + d] = ok ? to_f32(kb[at]) : 0.f;
      if (with_v) sV[j * Dh + d] = ok ? to_f32(vb[at]) : 0.f;
    }
  };
  const float* q_w = sQ + warp * kFmaRows * Dh;
  // s[r][c] = (q_r . k_{lane + 32 c}) * scale (+ bias), -inf past L
  auto scores = [&](int j0, float (&s)[kFmaRows][2]) {
    float acc[kFmaRows][2] = {};
    for (int d = 0; d < Dh; ++d) {
      const float k0 = sK[lane * ks + d], k1 = sK[(lane + 32) * ks + d];
#pragma unroll
      for (int r = 0; r < kFmaRows; ++r) {
        const float q = q_w[r * Dh + d];
        acc[r][0] = fmaf(q, k0, acc[r][0]);
        acc[r][1] = fmaf(q, k1, acc[r][1]);
      }
    }
#pragma unroll
    for (int r = 0; r < kFmaRows; ++r)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int j = j0 + lane + 32 * c;
        float x = acc[r][c] * scale;
        if (bias_b != nullptr) x += brow[r][min(j, L - 1)];
        s[r][c] = j < L ? x : -INFINITY;
      }
  };

  // pass 1: each row's max and sum of exp(s - max), running over chunks
  float m[kFmaRows], l[kFmaRows];
#pragma unroll
  for (int r = 0; r < kFmaRows; ++r) m[r] = -INFINITY, l[r] = 0.f;
  for (int j0 = 0; j0 < L; j0 += kFmaKeys) {
    __syncthreads();  // every warp is done with the previous chunk
    stage(j0, false);
    __syncthreads();
    float s[kFmaRows][2];
    scores(j0, s);
#pragma unroll
    for (int r = 0; r < kFmaRows; ++r) {
      const float m_new = fmaxf(m[r], warp_max(fmaxf(s[r][0], s[r][1])));
      // a row whose keys so far are all -inf (a -inf bias) is exponentiated
      // against 0, so that its sum stays 0 rather than NaN
      const float m_ref = m_new == -INFINITY ? 0.f : m_new;
      l[r] = l[r] * expf(m[r] - m_ref) + warp_sum(expf(s[r][0] - m_ref) + expf(s[r][1] - m_ref));
      m[r] = m_new;
    }
  }

  // pass 2: p = e / sum rounded to T, O += P V
  float o[kFmaRows][NI] = {};
  float* p_w = sP + warp * kFmaRows * kFmaKeys;
  for (int j0 = 0; j0 < L; j0 += kFmaKeys) {
    __syncthreads();
    stage(j0, true);
    __syncthreads();
    float s[kFmaRows][2];
    scores(j0, s);
#pragma unroll
    for (int r = 0; r < kFmaRows; ++r)
#pragma unroll
      for (int c = 0; c < 2; ++c) p_w[r * kFmaKeys + lane + 32 * c] = to_f32(from_f32<T>(expf(s[r][c] - m[r]) / l[r]));
    __syncwarp();
    const int n = min(kFmaKeys, L - j0);
    for (int j = 0; j < n; ++j) {
#pragma unroll
      for (int i = 0; i < NI; ++i) {
        const int d = lane + 32 * i;
        const float v = d < Dh ? sV[j * Dh + d] : 0.f;
#pragma unroll
        for (int r = 0; r < kFmaRows; ++r) o[r][i] = fmaf(p_w[r * kFmaKeys + j], v, o[r][i]);
      }
    }
    __syncwarp();  // the warp's p are read before the next chunk's are written
  }

#pragma unroll
  for (int r = 0; r < kFmaRows; ++r) {
    const int row = q0 + warp * kFmaRows + r;
    if (row >= L) continue;
    T* dst = a.out + (b * L + row) * D + h * Dh;
#pragma unroll
    for (int i = 0; i < NI; ++i) {
      const int d = lane + 32 * i;
      if (d < Dh) dst[d] = from_f32<T>(o[r][i]);
    }
  }
}

template <typename T, int NI>
cudaError_t launch_fma(FmaArgs<T> a, int batch, cudaStream_t stream) {
  a.n_qtiles = (a.seq_len + kFmaQTile - 1) / kFmaQTile;
  const long long blocks = (long long)batch * a.num_heads * a.n_qtiles;
  if (blocks > INT_MAX) return cudaErrorInvalidValue;
  const size_t smem = fma_smem_bytes(a.head_dim);
  auto kernel = attention_stage_fma<T, NI>;
  const cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kernel<<<(unsigned)blocks, kFmaThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

// The CUDA-core stage on `a` (operands, bias and shape filled in) over
// batch images.
template <typename T>
cudaError_t launch_fma_stage(const FmaArgs<T>& a, int batch, cudaStream_t stream) {
  switch ((a.head_dim + 31) / 32) {
    case 1: return launch_fma<T, 1>(a, batch, stream);
    case 2: return launch_fma<T, 2>(a, batch, stream);
    case 3: return launch_fma<T, 3>(a, batch, stream);
    case 4: return launch_fma<T, 4>(a, batch, stream);
    default: return cudaErrorInvalidValue;
  }
}

// ---- f32 stage: one pass, split TF32 on mma.sync ----
constexpr int kF32StageThreads = 128;  // four warps of 16 query rows
constexpr int kF32StageRows = 64;

// Keys a staged chunk holds: 32, so that at head dims up to 64 three blocks
// share an SM (69,632 bytes of shared memory a block at 64).
constexpr int kF32StageKeys = 32;
// Row stride in floats of Q, K and V in shared memory: with dhp a multiple of
// 16, the fragment reads (8 rows x 4 columns for Q and K, 4 row pairs x 8
// columns for V) each hit 32 distinct banks.
__host__ __device__ constexpr int f32_stage_stride(int dhp) { return dhp + 4; }

size_t f32_stage_smem_bytes(int dhp, bool cosine) {
  // Q's hi and lo, then two buffers of K and V as loaded; with cosine the
  // chunk's inverse key norms
  return sizeof(float) * ((size_t)f32_stage_stride(dhp) * (2 * kF32StageRows + 4 * kF32StageKeys) +
                          (cosine ? kF32StageKeys : 0));
}

__device__ __forceinline__ void cp_async4(void* smem, const void* gmem, bool pred) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst), "l"(gmem), "r"(pred ? 4 : 0));
}

// The f32 stage. A block of four warps owns 64 query rows of an (image,
// head), each warp 16, and streams the head's K and V in chunks of 32 keys,
// double-buffered by cp.async (16-byte pieces where rows allow, else 4-byte
// ones; rows past L and columns past Dh zero-filled). Q is split once into
// hi and lo in shared memory; K, V and P are split in registers as their
// fragments are read. S = Q K^T and O += P V each take three mma.sync
// m16n8k8 TF32 products. One pass with an online softmax: p is not rounded
// in f32, so O is rescaled by exp(m_old - m_new) as the row max grows and
// divided by the row sum at the end. P's accumulator registers serve as
// P V's A operand unmoved: A's k index t stands for key 2 t of the 8-key
// group and t + 4 for key 2 t + 1, and V's fragment is read with the same
// permutation. Key groups of 8 wholly past L are skipped, as are warps
// whose 16 rows are all past L.
// kCosine (Swin v2, the window entry): q and k are L2-normalised per row
// (the norm floored at 1e-12) and q multiplied by gs[h]. Q's rows are
// scaled by gs[h] / |q| in f32 before their split; each chunk's inverse key
// norms go to shared memory once the chunk has landed and scale the
// product's columns: s = (q' . k) / |k| * scale + bias.
template <int DHP, bool kCosine>
__global__ void __launch_bounds__(kF32StageThreads, 1) attention_stage_f32(const FmaArgs<float> a) {
  constexpr int KC = kF32StageKeys, S = f32_stage_stride(DHP), NB = KC / 8, ND = DHP / 8;
  constexpr float kLog2e = 1.4426950408889634f;
  extern __shared__ __align__(16) unsigned char smem[];
  float* sQh = reinterpret_cast<float*>(smem);  // kF32StageRows x S
  float* sQl = sQh + kF32StageRows * S;
  float* sKV = sQl + kF32StageRows * S;  // [2][K KC x S, V KC x S]
  float* sKinv = sKV + 4 * KC * S;       // kCosine: the chunk's inverse key norms

  const int L = a.seq_len, Dh = a.head_dim, n_qtiles = a.n_qtiles;
  const int qt = blockIdx.x % n_qtiles;
  const int h = (blockIdx.x / n_qtiles) % a.num_heads;
  const long long b = blockIdx.x / ((unsigned)n_qtiles * a.num_heads);
  const int D = a.num_heads * Dh;
  const long long ld = a.ld, off = b * L * ld + h * Dh;
  const float* qb = a.q + off;
  const float* kb = a.k + off;
  const float* vb = a.v + off;
  const int q0 = qt * kF32StageRows;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  const bool vec = Dh % 4 == 0 && ld % 4 == 0 && reinterpret_cast<uintptr_t>(kb) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(vb) % 16 == 0;

  // keys j0 .. j0 + KC of K and V into buffer buf
  auto load_kv = [&](int j0, int buf) {
    float* sK = sKV + buf * 2 * KC * S;
    float* sV = sK + KC * S;
    if (vec) {
      constexpr int P = DHP / 4;
      for (int idx = threadIdx.x; idx < KC * P; idx += kF32StageThreads) {
        const int j = idx / P, d = (idx % P) * 4;
        const bool ok = j0 + j < L && d < Dh;
        const long long at = ok ? (long long)(j0 + j) * ld + d : 0;
        cp_async16(sK + j * S + d, kb + at, ok);
        cp_async16(sV + j * S + d, vb + at, ok);
      }
    } else {
      for (int idx = threadIdx.x; idx < KC * DHP; idx += kF32StageThreads) {
        const int j = idx / DHP, d = idx % DHP;
        const bool ok = j0 + j < L && d < Dh;
        const long long at = ok ? (long long)(j0 + j) * ld + d : 0;
        cp_async4(sK + j * S + d, kb + at, ok);
        cp_async4(sV + j * S + d, vb + at, ok);
      }
    }
    cp_async_commit();
  };
  load_kv(0, 0);
  // Q's tile, split once: every load of a thread issued before its stores
  // (kCosine: stored as loaded, then scaled and split below)
  auto store_q = [&](int r, int d, float x) {
    if constexpr (kCosine) {
      sQh[r * S + d] = x;
    } else {
      split_tf32(x, sQh[r * S + d], sQl[r * S + d]);
    }
  };
  if (vec && reinterpret_cast<uintptr_t>(qb) % 16 == 0) {
    constexpr int P = DHP / 4, N = kF32StageRows * P / kF32StageThreads;  // 16-byte pieces: a row's, a thread's
    float4 x[N];
#pragma unroll
    for (int i = 0; i < N; ++i) {
      const int idx = threadIdx.x + kF32StageThreads * i, r = idx / P, d = (idx % P) * 4;
      x[i] = q0 + r < L && d < Dh ? *reinterpret_cast<const float4*>(qb + (long long)(q0 + r) * ld + d)
                                  : make_float4(0.f, 0.f, 0.f, 0.f);
    }
#pragma unroll
    for (int i = 0; i < N; ++i) {
      const int idx = threadIdx.x + kF32StageThreads * i, r = idx / P, d = (idx % P) * 4;
      store_q(r, d, x[i].x);
      store_q(r, d + 1, x[i].y);
      store_q(r, d + 2, x[i].z);
      store_q(r, d + 3, x[i].w);
    }
  } else {
    for (int idx = threadIdx.x; idx < kF32StageRows * DHP; idx += kF32StageThreads) {
      const int r = idx / DHP, d = idx % DHP;
      store_q(r, d, q0 + r < L && d < Dh ? qb[(long long)(q0 + r) * ld + d] : 0.f);
    }
  }
  if constexpr (kCosine) {  // two threads a row, each half of its columns: q' = q gs / |q|, then split
    __syncthreads();
    constexpr int HALF = DHP / 2;
    float* qr = sQh + (threadIdx.x / 2) * S + (threadIdx.x % 2) * HALF;
    float q2 = 0.f;
#pragma unroll
    for (int d = 0; d < HALF; ++d) q2 = fmaf(qr[d], qr[d], q2);
    q2 += __shfl_xor_sync(0xffffffffu, q2, 1);
    const float f = a.gs[h] / fmaxf(sqrtf(q2), 1e-12f);
    float* ql = sQl + (qr - sQh);
#pragma unroll
    for (int d = 0; d < HALF; ++d) split_tf32(qr[d] * f, qr[d], ql[d]);
  }

  const int r0 = warp * 16;  // the warp's rows of the tile: r0 + g and r0 + g + 8
  const bool active = q0 + r0 < L;
  const float* bias_b = stage_bias(a, b, h);
  const float* brow[2];
#pragma unroll
  for (int rr = 0; rr < 2; ++rr)
    brow[rr] = bias_b == nullptr ? nullptr : bias_b + (long long)min(q0 + r0 + g + 8 * rr, L - 1) * a.bias_ld;
  float o[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};

  const int n_chunks = (L + KC - 1) / KC;
  for (int c = 0; c < n_chunks; ++c) {
    const int j0 = c * KC;
    if (c + 1 < n_chunks) {
      load_kv(j0 + KC, (c + 1) & 1);  // its buffer's readers finished at the previous chunk's barrier
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // chunk c (and, at c = 0, Q) is in shared memory
    if constexpr (kCosine) {  // four threads a key, each a quarter of its columns
      constexpr int QUARTER = DHP / 4;
      const float* kr = sKV + (c & 1) * 2 * KC * S + (threadIdx.x / 4) * S + (threadIdx.x % 4) * QUARTER;
      float k2 = 0.f;
#pragma unroll
      for (int d = 0; d < QUARTER; ++d) k2 = fmaf(kr[d], kr[d], k2);
      k2 = quad_sum(k2);
      if (threadIdx.x % 4 == 0) sKinv[threadIdx.x / 4] = 1.f / fmaxf(sqrtf(k2), 1e-12f);
      __syncthreads();
    }
    if (active) {
      const float* sK = sKV + (c & 1) * 2 * KC * S;
      const float* sV = sK + KC * S;
      const int groups = min(KC, L - j0);  // keys of this chunk below L
      float sc[NB][4];
#pragma unroll
      for (int j = 0; j < NB; ++j) sc[j][0] = sc[j][1] = sc[j][2] = sc[j][3] = 0.f;
#pragma unroll
      for (int ks = 0; ks < ND; ++ks) {
        const float* qh = sQh + (r0 + g) * S + 8 * ks + t;
        const float* ql = sQl + (r0 + g) * S + 8 * ks + t;
        const uint32_t ah[4] = {__float_as_uint(qh[0]), __float_as_uint(qh[8 * S]), __float_as_uint(qh[4]),
                                __float_as_uint(qh[8 * S + 4])};
        const uint32_t al[4] = {__float_as_uint(ql[0]), __float_as_uint(ql[8 * S]), __float_as_uint(ql[4]),
                                __float_as_uint(ql[8 * S + 4])};
#pragma unroll
        for (int j = 0; j < NB; ++j) {
          if (8 * j < groups) {
            const float* kr = sK + (8 * j + g) * S + 8 * ks + t;
            uint32_t bh0, bl0, bh1, bl1;
            split_tf32_bits(kr[0], bh0, bl0);
            split_tf32_bits(kr[4], bh1, bl1);
            mma_split(sc[j], ah, al, bh0, bh1, bl0, bl1);
          }
        }
      }
      // s = (q . k) scale + bias, -inf past L; the rows' running max
      float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int j = 0; j < NB; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = j0 + 8 * j + 2 * t + (e & 1), rr = e >> 1;
          float x = sc[j][e] * a.scale;
          if constexpr (kCosine) x *= sKinv[8 * j + 2 * t + (e & 1)];
          if (bias_b != nullptr) x += brow[rr][min(key, L - 1)];
          x = key < L ? x : -INFINITY;
          sc[j][e] = x;
          mx[rr] = fmaxf(mx[rr], x);
        }
      float m_ref[2];
#pragma unroll
      for (int rr = 0; rr < 2; ++rr) {
        const float m_new = fmaxf(m[rr], quad_max(mx[rr]));
        // a row whose keys so far are all -inf (a -inf bias) is exponentiated
        // against 0, so that its sum and O stay 0 rather than NaN
        m_ref[rr] = m_new == -INFINITY ? 0.f : m_new;
        const float alpha = exp2f((m[rr] - m_ref[rr]) * kLog2e);
        l[rr] *= alpha;
#pragma unroll
        for (int n = 0; n < ND; ++n) {
          o[n][2 * rr] *= alpha;
          o[n][2 * rr + 1] *= alpha;
        }
        m[rr] = m_new;
      }
#pragma unroll
      for (int j = 0; j < NB; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float pe = exp2f((sc[j][e] - m_ref[e >> 1]) * kLog2e);
          sc[j][e] = pe;
          l[e >> 1] += pe;
        }
      // O += P V over the chunk's key groups
#pragma unroll
      for (int j = 0; j < NB; ++j) {
        if (8 * j < groups) {
          uint32_t ph[4], pl[4];
          split_tf32_bits(sc[j][0], ph[0], pl[0]);  // row g, key 2 t: A (g, t)
          split_tf32_bits(sc[j][2], ph[1], pl[1]);  // row g + 8, key 2 t: A (g + 8, t)
          split_tf32_bits(sc[j][1], ph[2], pl[2]);  // row g, key 2 t + 1: A (g, t + 4)
          split_tf32_bits(sc[j][3], ph[3], pl[3]);  // row g + 8, key 2 t + 1: A (g + 8, t + 4)
          const float* vr = sV + (8 * j + 2 * t) * S + g;
#pragma unroll
          for (int n = 0; n < ND; ++n) {
            uint32_t bh0, bl0, bh1, bl1;
            split_tf32_bits(vr[8 * n], bh0, bl0);      // key 2 t: B (t, g)
            split_tf32_bits(vr[S + 8 * n], bh1, bl1);  // key 2 t + 1: B (t + 4, g)
            mma_split(o[n], ph, pl, bh0, bh1, bl0, bl1);
          }
        }
      }
    }
    __syncthreads();  // every warp is done with buffer c & 1
  }

  if (!active) return;
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    const int row = q0 + r0 + g + 8 * rr;
    const float inv = 1.f / quad_sum(l[rr]);  // a row that is -inf everywhere: 0 / 0, NaN, as the reference
    if (row >= L) continue;
    float* dst = a.out + ((long long)b * L + row) * D + h * Dh;
#pragma unroll
    for (int n = 0; n < ND; ++n)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int d = 8 * n + 2 * t + e;
        if (d < Dh) dst[d] = o[n][2 * rr + e] * inv;
      }
  }
}

template <int DHP, bool kCosine = false>
cudaError_t launch_f32(FmaArgs<float> a, int batch, cudaStream_t stream) {
  a.n_qtiles = (a.seq_len + kF32StageRows - 1) / kF32StageRows;
  const long long blocks = (long long)batch * a.num_heads * a.n_qtiles;
  if (blocks > INT_MAX) return cudaErrorInvalidValue;
  const size_t smem = f32_stage_smem_bytes(DHP, kCosine);
  auto kernel = attention_stage_f32<DHP, kCosine>;
  const cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kernel<<<(unsigned)blocks, kF32StageThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

// The f32 stage on `a` (operands, bias and shape filled in) over batch
// images, at the head dim rounded up to 16.
cudaError_t launch_f32_stage(const FmaArgs<float>& a, int batch, cudaStream_t stream) {
  switch ((a.head_dim + 15) / 16) {
    case 1: return launch_f32<16>(a, batch, stream);
    case 2: return launch_f32<32>(a, batch, stream);
    case 3: return launch_f32<48>(a, batch, stream);
    case 4: return launch_f32<64>(a, batch, stream);
    case 5: return launch_f32<80>(a, batch, stream);
    case 6: return launch_f32<96>(a, batch, stream);
    case 7: return launch_f32<112>(a, batch, stream);
    case 8: return launch_f32<128>(a, batch, stream);
    default: return cudaErrorInvalidValue;
  }
}

// ---- tensor-core stage (bf16, Dh % 16 == 0): TMA and wgmma ----
constexpr int kStageThreads = 128;  // one warpgroup
constexpr int kStageTile = 64;      // query rows of a tile; keys of a piece and of a TMA box
constexpr int kStageBlock = 256;    // keys whose scores one pass holds in registers
constexpr int kStagePieces = kStageBlock / kStageTile;
constexpr int kStageBox = kStageTile * 128;  // bytes of one box: 64 rows x 64 bf16

// 64-column halves of a head's row.
__host__ __device__ constexpr int stage_halves(int dh) { return dh > 64 ? 2 : 1; }

// Dynamic shared memory of one block holding kv_rows rows of K and of V:
// alignment slack, two q buffers, the staging rows, K, V, four mbarriers.
__host__ __device__ constexpr int stage_wgmma_smem_bytes(int kv_rows, int dh) {
  return 1024 + stage_halves(dh) * (3 * kStageBox + 2 * kv_rows * 128) + 4 * 8;
}

// Key rows the K and V buffers hold, a multiple of the 256-key block: all
// of L where that fits (K and V resident), else one block, loaded in turn.
inline int stage_kv_rows(int seq_len, int dh) {
  const int rows = (seq_len + kStageBlock - 1) / kStageBlock * kStageBlock;
  return stage_wgmma_smem_bytes(rows, dh) <= kMaxSmemBytes ? rows : kStageBlock;
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// wgmma descriptor of an MN-major operand with the 128-byte swizzle, as TMA
// writes a box of it: rows along K of 64 MN-elements (128 bytes), 8-row
// groups 1024 bytes apart (the stride offset), the next 64 MN-elements
// `lbo` bytes further (the leading offset). 16 rows further along K is
// +2048 bytes.
__device__ __forceinline__ uint64_t sw128_mn_desc(const void* tile, uint32_t lbo) {
  return (uint64_t)((smem_addr(tile) & 0x3FFFF) >> 4) | ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)(1024 >> 4) << 32) | (1ull << 62);
}

// D (+)= A B for a 64 x N tile: A (64 x 16) from registers in the layout of
// an mma.sync m16n8k16 A fragment for each warp's 16 rows (a[0]: row g, k
// 2t..2t+1; a[1]: row g + 8; a[2], a[3]: k + 8), B (16 x N) by descriptor,
// MN-major (the transpose bit).
__device__ __forceinline__ void wgmma_m64n64k16_rs(float (&d)[32], const uint32_t (&a)[4], uint64_t desc_b,
                                                    int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\nwgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,%12,%13,%14,%15,%16,%17,%18,%19,"
      "%20,%21,%22,%23,%24,%25,%26,%27,%28,%29,%30,%31"
      "}, {%32,%33,%34,%35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(accumulate));
}

__device__ __forceinline__ void wgmma_m64n128k16_rs(float (&d)[64], const uint32_t (&a)[4], uint64_t desc_b,
                                                    int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\nwgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,%12,%13,%14,%15,%16,%17,%18,%19,"
      "%20,%21,%22,%23,%24,%25,%26,%27,%28,%29,%30,%31,%32,%33,%34,%35,%36,%37,%38,%39,"
      "%40,%41,%42,%43,%44,%45,%46,%47,%48,%49,%50,%51,%52,%53,%54,%55,%56,%57,%58,%59,"
      "%60,%61,%62,%63"
      "}, {%64,%65,%66,%67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(accumulate));
}

template <int N>
__device__ __forceinline__ void wgmma_pv(float (&d)[N / 2], const uint32_t (&a)[4], uint64_t desc_b) {
  if constexpr (N == 128) {
    wgmma_m64n128k16_rs(d, a, desc_b, 1);
  } else {
    static_assert(N == 64, "P V is 64 or 128 wide");
    wgmma_m64n64k16_rs(d, a, desc_b, 1);
  }
}

constexpr int kStageBiasSlack = kStageBlock;  // floats read past the bias's last row, at most 255

struct StageArgs {
  CUtensorMap map[3];  // q, k, v as (columns, L, B): boxes of 64 columns x 64 rows x 1, 128-byte swizzle
  bf16* out;           // (B, L, D)
  const float* bias;   // kBias: (n_bias, L, bias_ld) f32, bias_ld even; image b reads bias[b % n_bias]
  int col[3];          // column of head 0's q, k, v in their maps; head h adds h Dh
  int seq_len, num_heads;
  int n_bias, bias_ld;
  int kv_rows;         // key rows of the K and V buffers, a multiple of 256 (stage_kv_rows)
  int split;           // blocks sharing an (image, head); block j takes its query tiles j, j + split, ...
  float scale_log2e;
  float inv_scale;     // kBias: 1 / scale
};

// kOnePass: L <= 256, one block of keys whose scores stay in registers.
// Thread (warp w, lane 4 g + t) holds, for each n8 tile j of a 64-key piece,
// the scores of query rows 16 w + g (e = 0, 1) and 16 w + g + 8 (e = 2, 3)
// at keys 8 j + 2 t + e % 2 (register 4 j + e). The products run over whole
// blocks of 256 keys, whose rows past L are zeros, and keys past L are
// masked by selects, so no write to a wgmma operand register sits under a
// branch (see the note at the top). kBias: the scores take the compact
// bias of the image, read in the same layout.
template <int DH, bool kOnePass, bool kBias>
__global__ void __launch_bounds__(kStageThreads, 1) attention_stage_wgmma(const __grid_constant__ StageArgs a) {
  constexpr int NH = stage_halves(DH);
  constexpr int DP = 64 * NH;  // P V's width; columns >= DH are not stored
  constexpr int KS = DH / 16;  // k16 steps of Q K^T
  constexpr int P = kStagePieces;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* smem = smem_raw + (1024 - smem_addr(smem_raw) % 1024) % 1024;  // the swizzle's alignment
  const int kv_rows = a.kv_rows;
  const uint32_t kv_half = (uint32_t)kv_rows * 128;  // bytes between the column halves of K (of V)
  unsigned char* sq = smem;                           // [2 buffers][NH] boxes
  unsigned char* so = sq + 2 * NH * kStageBox;        // [4 warps][NH][16 rows x 128 bytes]
  unsigned char* sk = so + NH * kStageBox;            // [NH][kv_rows x 128 bytes]
  unsigned char* sv = sk + NH * kv_half;
  uint64_t* bar = reinterpret_cast<uint64_t*>(sv + NH * kv_half);  // q buffers 0 and 1, K, V

  const int L = a.seq_len, H = a.num_heads, D = H * DH;
  const int first = blockIdx.x % a.split, bh = blockIdx.x / a.split;
  const int h = bh % H, b = bh / H;
  const int n_qt = (L + kStageTile - 1) / kStageTile;
  const int n_it = first < n_qt ? (n_qt - first + a.split - 1) / a.split : 0;  // this block's query tiles
  const int n_blocks = kOnePass ? 1 : (L + kStageBlock - 1) / kStageBlock;
  const int lp = (L + kStageTile - 1) / kStageTile * kStageTile;  // key rows the boxes of K (of V) cover
  const bool resident = kv_rows >= lp;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32, t = lane % 4;
  const float c = a.scale_log2e;

  // Key rows no box writes are zeros: past lp where K and V are resident;
  // all of them first where blocks are loaded in turn (the last block's
  // boxes stop at L).
  const int z0 = resident ? lp : 0, zn = (kv_rows - z0) * 8;  // 16-byte units a half
  for (int i = tid; i < NH * zn; i += kStageThreads) {
    const uint32_t off = i / zn * kv_half + z0 * 128 + i % zn * 16;
    *reinterpret_cast<uint4*>(sk + off) = make_uint4(0u, 0u, 0u, 0u);
    *reinterpret_cast<uint4*>(sv + off) = make_uint4(0u, 0u, 0u, 0u);
  }
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");  // generic writes, then TMA's and wgmma's
  if (tid == 0) {
    for (int i = 0; i < 4; ++i) mbar_init(&bar[i], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // (thread 0) rows r0 .. r0 + n - 1 below L of this head's q (x = 0), k (1)
  // or v (2), in boxes of 64 rows into dst, the column halves `half` bytes apart
  auto load = [&](unsigned char* dst, uint32_t half, int x, int r0, int n, uint64_t* done) {
    const int boxes = min(n / kStageTile, (L - r0 + kStageTile - 1) / kStageTile);
    mbar_arrive_expect_tx(done, boxes * NH * kStageBox);
    for (int hf = 0; hf < NH; ++hf)
      for (int i = 0; i < boxes; ++i)
        tma_load_3d(dst + hf * half + i * kStageBox, &a.map[x], done, a.col[x] + h * DH + 64 * hf,
                    r0 + kStageTile * i, b);
  };
  auto load_q = [&](int it) {
    load(sq + (it & 1) * NH * kStageBox, kStageBox, 0, kStageTile * (first + it * a.split), kStageTile, &bar[it & 1]);
  };
  auto load_kv = [&](int key0, bool with_v) {
    load(sk, kv_half, 1, key0, kv_rows, &bar[2]);
    if (with_v) load(sv, kv_half, 2, key0, kv_rows, &bar[3]);
  };
  if (tid == 0 && n_it > 0) {
    for (int x = 0; x < 3; ++x)
      asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(&a.map[x])) : "memory");
    load_q(0);
    if (resident) load_kv(0, true);
    if (n_it > 1) load_q(1);
  }

  // Where K and V are not resident: the block at key0 into the buffers, once
  // every warp is done with them.
  uint32_t k_phase = 0, v_phase = 0;
  auto stream_kv = [&](int key0, bool with_v) {
    named_barrier(1, kStageThreads);
    if (tid == 0) load_kv(key0, with_v);
    mbar_wait(&bar[2], k_phase);
    k_phase ^= 1;
    if (with_v) {
      mbar_wait(&bar[3], v_phase);
      v_phase ^= 1;
    }
  };

  // kBias: this thread's slot in its warp's staging rows, which hold, while
  // a tile's scores are computed (store() uses the rows only after them),
  // the address of its bias at key 2 t of its first query row, 16 w + g,
  // and the step to its second, 16 w + g + 8 (query rows past L read row
  // L - 1). Kept there rather than in registers, where beside the scores
  // and O the two-pass kernel at Dh = 128 spilled.
  auto bias_slot = [&]() { return so + warp * NH * 2048 + lane * 16; };

  // S = Q K^T (unscaled) for the block of 256 keys at key0, K's rows from
  // kb. kBias: the accumulators start at the bias over the scale, and the
  // products accumulate onto it (the scale then gives s scale + bias).
  auto scores = [&](int key0, const unsigned char* qtile, const unsigned char* kb, float (&s)[P][32]) {
    if constexpr (kBias) {
      const float* bp = *reinterpret_cast<const float* const*>(bias_slot()) + key0;
      const int bias_step = *reinterpret_cast<const int*>(bias_slot() + 8);
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
#pragma unroll
        for (int p = 0; p < P; ++p)
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            const float2 v = __ldg(reinterpret_cast<const float2*>(bp + kStageTile * p + 8 * j));
            s[p][4 * j + 2 * hr] = v.x * a.inv_scale;
            s[p][4 * j + 2 * hr + 1] = v.y * a.inv_scale;
          }
        bp += bias_step;
      }
    }
#pragma unroll
    for (int p = 0; p < P; ++p) fence_accumulator(s[p]);
    wgmma_fence();
#pragma unroll
    for (int p = 0; p < P; ++p)
#pragma unroll
      for (int ks = 0; ks < KS; ++ks) {
        const uint64_t dq = sw128_desc(qtile + ks / 4 * kStageBox) + 2 * (ks % 4);
        const uint64_t dk = sw128_desc(kb + ks / 4 * kv_half + p * kStageBox) + 2 * (ks % 4);
        wgmma_m64n64k16(s[p], dq, dk, kBias || ks > 0);
      }
    wgmma_commit();
    wgmma_wait<0>();
#pragma unroll
    for (int p = 0; p < P; ++p) fence_accumulator(s[p]);
  };

  // s * scale * log2(e) in place, -inf at keys >= L; each row's max over the
  // block (four partial maxima a row, one a piece, then the quad's)
  auto scale_mask = [&](int key0, float (&s)[P][32], float (&mx)[2]) {
    const int lim = L - key0 - 2 * t;  // key 64 p + 8 j + 2 t + e % 2 is below L iff 64 p + 8 j + e % 2 < lim
    float pm[P][2];
#pragma unroll
    for (int p = 0; p < P; ++p) {
      pm[p][0] = pm[p][1] = -INFINITY;
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float v = kStageTile * p + 8 * j + (e & 1) < lim ? s[p][4 * j + e] * c : -INFINITY;
          s[p][4 * j + e] = v;
          pm[p][e >> 1] = fmaxf(pm[p][e >> 1], v);
        }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) mx[r] = quad_max(fmaxf(fmaxf(pm[0][r], pm[1][r]), fmaxf(pm[2][r], pm[3][r])));
  };

  // e = 2^(s - m) in place (0 at masked keys); this thread's part of each row's sum
  auto exponentiate = [&](float (&s)[P][32], const float (&m)[2], float (&sum)[2]) {
    float ps[P][2];
#pragma unroll
    for (int p = 0; p < P; ++p) {
      ps[p][0] = ps[p][1] = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float x = ex2(s[p][4 * j + e] - m[e >> 1]);
          s[p][4 * j + e] = x;
          ps[p][e >> 1] += x;
        }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) sum[r] = (ps[0][r] + ps[1][r]) + (ps[2][r] + ps[3][r]);
  };

  // O += P V over the block: p = e * inv rounded to bf16 as wgmma's register
  // A operand, V's rows of the block from vb
  auto pv = [&](const unsigned char* vb, const float (&s)[P][32], const float (&inv)[2], float (&o)[DP / 2]) {
    uint32_t pa[P][4][4];
#pragma unroll
    for (int p = 0; p < P; ++p)
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const __nv_bfloat162 v =
              __floats2bfloat162_rn(s[p][8 * kk + 2 * i] * inv[i & 1], s[p][8 * kk + 2 * i + 1] * inv[i & 1]);
          pa[p][kk][i] = *reinterpret_cast<const uint32_t*>(&v);
          asm volatile("" : "+r"(pa[p][kk][i])::"memory");  // computed before the fence
        }
    fence_accumulator(o);
    wgmma_fence();
#pragma unroll
    for (int p = 0; p < P; ++p)
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_pv<DP>(o, pa[p][kk], sw128_mn_desc(vb + (kStageTile * p + 16 * kk) * 128, kv_half));
    wgmma_commit();
    wgmma_wait<0>();
    fence_accumulator(o);
  };

  // O rounded to bf16 through this warp's staging rows, then rows < L and
  // columns < DH as 16-byte stores
  auto store = [&](int q0, const float (&o)[DP / 2]) {
    unsigned char* st = so + warp * NH * 2048;
#pragma unroll
    for (int j = 0; j < DP / 8; ++j)
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        const int r = lane / 4 + 8 * hr, u = j % 8;
        const __nv_bfloat162 v = __floats2bfloat162_rn(o[4 * j + 2 * hr], o[4 * j + 2 * hr + 1]);
        *reinterpret_cast<__nv_bfloat162*>(st + j / 8 * 2048 + r * 128 + ((u ^ (r & 7)) << 4) + 4 * t) = v;
      }
    __syncwarp();
#pragma unroll
    for (int hf = 0; hf < NH; ++hf)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = lane / 8 + 4 * i, u = lane % 8;
        const int row = q0 + 16 * warp + r, col = 64 * hf + 8 * u;
        if (row < L && col < DH)
          *reinterpret_cast<uint4*>(a.out + ((long long)b * L + row) * D + h * DH + col) =
              *reinterpret_cast<const uint4*>(st + hf * 2048 + r * 128 + ((u ^ (r & 7)) << 4));
      }
    __syncwarp();  // the staging rows are free again
  };

  float s[P][32], o[DP / 2];
#pragma unroll
  for (int p = 0; p < P; ++p)
#pragma unroll
    for (int i = 0; i < 32; ++i) s[p][i] = 0.f;
  for (int it = 0; it < n_it; ++it) {
    const int q0 = kStageTile * (first + it * a.split);
    const unsigned char* qtile = sq + (it & 1) * NH * kStageBox;
    if constexpr (kBias) {
      const int r0 = min(q0 + 16 * warp + lane / 4, L - 1), r1 = min(q0 + 16 * warp + lane / 4 + 8, L - 1);
      *reinterpret_cast<const float**>(bias_slot()) = a.bias + ((long long)(b % a.n_bias) * L + r0) * a.bias_ld + 2 * t;
      *reinterpret_cast<int*>(bias_slot() + 8) = (r1 - r0) * a.bias_ld;
    }
    mbar_wait(&bar[it & 1], (it >> 1) & 1);
    if (resident) mbar_wait(&bar[2], 0);

    float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
    if constexpr (!kOnePass) {  // pass 1: each row's max and sum of 2^(s - max), running over the blocks
      for (int blk = 0; blk < n_blocks; ++blk) {
        const int key0 = blk * kStageBlock;
        if (!resident) stream_kv(key0, false);
        scores(key0, qtile, sk + (resident ? key0 * 128 : 0), s);
        float mb[2], sum[2];
        scale_mask(key0, s, mb);
        const float mn[2] = {fmaxf(m[0], mb[0]), fmaxf(m[1], mb[1])};
        // kBias: a row whose keys so far are all -inf is exponentiated against
        // 0, so that its sum stays 0 rather than NaN
        const float mr[2] = {kBias && mn[0] == -INFINITY ? 0.f : mn[0], kBias && mn[1] == -INFINITY ? 0.f : mn[1]};
        exponentiate(s, mr, sum);
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          l[r] = l[r] * ex2(m[r] - mr[r]) + sum[r];
          m[r] = mn[r];
        }
      }
    }

#pragma unroll
    for (int i = 0; i < DP / 2; ++i) o[i] = 0.f;
    for (int blk = 0; blk < n_blocks; ++blk) {  // p and P V: the one pass where L <= 256
      const int key0 = blk * kStageBlock;
      if (!kOnePass && !resident) stream_kv(key0, true);
      scores(key0, qtile, sk + (resident ? key0 * 128 : 0), s);
      if (blk == n_blocks - 1) {  // every warp is done with this q buffer: load the tile after next into it
        named_barrier(1, kStageThreads);
        if (tid == 0 && it + 2 < n_it) load_q(it + 2);
      }
      float mb[2], sum[2];
      scale_mask(key0, s, mb);
      if constexpr (kOnePass) {
        m[0] = mb[0];
        m[1] = mb[1];
      }
      exponentiate(s, m, sum);
      if constexpr (kOnePass) {
        l[0] = sum[0];
        l[1] = sum[1];
      }
      const float inv[2] = {1.f / quad_sum(l[0]), 1.f / quad_sum(l[1])};
      if (resident && blk == 0) mbar_wait(&bar[3], 0);
      pv(sv + (resident ? key0 * 128 : 0), s, inv, o);
    }
    store(q0, o);
  }
}

// TMA map of a bf16 tensor (batch, seq_len, cols) as (cols, seq_len, batch),
// read in boxes of 64 columns x 64 rows x 1 with the 128-byte swizzle; rows
// past seq_len and columns past cols read as zeros (a box is wider than a
// row where cols < 64).
cudaError_t encode_stage_map(CUtensorMap* map, const void* base, int batch, int seq_len, int cols) {
  const PFN_cuTensorMapEncodeTiled_v12000 encode = encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;
  const cuuint64_t row = (cuuint64_t)cols * sizeof(bf16);
  const cuuint64_t dims[3] = {(cuuint64_t)cols, (cuuint64_t)seq_len, (cuuint64_t)batch};
  const cuuint64_t strides[2] = {row, row * seq_len};
  const cuuint32_t box[3] = {64, (cuuint32_t)kStageTile, 1};
  const cuuint32_t element_strides[3] = {1, 1, 1};
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(base), dims, strides, box,
                            element_strides, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                            CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

template <int DH, bool kOnePass, bool kBias>
cudaError_t launch_stage_kernel(const StageArgs& a, int blocks, cudaStream_t stream) {
  const int smem = stage_wgmma_smem_bytes(a.kv_rows, DH);
  auto kernel = attention_stage_wgmma<DH, kOnePass, kBias>;
  const cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  kernel<<<blocks, kStageThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

// Blocks per (image, head): one, which loads the head's K and V once for all
// its query tiles, unless `heads` such blocks would leave an SM with fewer
// than two; then each (image, head)'s query tiles are shared among up to one
// block a tile, each loading K and V itself.
inline int stage_split(long long heads, int seq_len, int sms) {
  const long long n_qt = (seq_len + kStageTile - 1) / kStageTile, want = (2LL * sms + heads - 1) / heads;
  return (int)(want < 1 ? 1 : want < n_qt ? want : n_qt);
}

// The wgmma stage over batch x num_heads (image, head) pairs; the caller has
// filled in a's maps, columns, output and bias.
template <int DH, bool kBias>
cudaError_t launch_stage_wgmma(StageArgs& a, int batch, int seq_len, int num_heads, float scale, cudaStream_t stream) {
  int device = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  const int split = stage_split((long long)batch * num_heads, seq_len, sms);
  const bool one_pass = seq_len <= kStageBlock;
  a.seq_len = seq_len;
  a.num_heads = num_heads;
  a.kv_rows = stage_kv_rows(seq_len, DH);
  a.split = split;
  a.scale_log2e = scale * 1.4426950408889634f;
  a.inv_scale = 1.f / scale;
  const long long blocks = (long long)batch * num_heads * split;
  if (blocks > INT_MAX) return cudaErrorInvalidValue;
  return one_pass ? launch_stage_kernel<DH, true, kBias>(a, (int)blocks, stream)
                  : launch_stage_kernel<DH, false, kBias>(a, (int)blocks, stream);
}

template <bool kBias>
cudaError_t launch_stage_wgmma_dh(StageArgs& a, int batch, int seq_len, int num_heads, int head_dim, float scale,
                                  cudaStream_t stream) {
  switch (head_dim) {
    case 16: return launch_stage_wgmma<16, kBias>(a, batch, seq_len, num_heads, scale, stream);
    case 32: return launch_stage_wgmma<32, kBias>(a, batch, seq_len, num_heads, scale, stream);
    case 48: return launch_stage_wgmma<48, kBias>(a, batch, seq_len, num_heads, scale, stream);
    case 64: return launch_stage_wgmma<64, kBias>(a, batch, seq_len, num_heads, scale, stream);
    case 80: return launch_stage_wgmma<80, kBias>(a, batch, seq_len, num_heads, scale, stream);
    case 96: return launch_stage_wgmma<96, kBias>(a, batch, seq_len, num_heads, scale, stream);
    case 112: return launch_stage_wgmma<112, kBias>(a, batch, seq_len, num_heads, scale, stream);
    case 128: return launch_stage_wgmma<128, kBias>(a, batch, seq_len, num_heads, scale, stream);
    default: return cudaErrorInvalidValue;
  }
}

bool stage_uses_wgmma(bool is_bf16, int head_dim) { return is_bf16 && head_dim % 16 == 0; }

// The stage on qkv (batch, seq_len, 3 num_heads head_dim) into out (batch,
// seq_len, num_heads head_dim), in T, on `stream`: K1's and the half's.
template <typename T>
cudaError_t launch_attention_stage(const void* qkv, void* out, int batch, int seq_len, int num_heads, int head_dim,
                                   float scale, cudaStream_t stream) {
  if (batch <= 0 || seq_len <= 0 || num_heads <= 0 || head_dim <= 0 || head_dim > kStageMaxHeadDim)
    return cudaErrorInvalidValue;
  const int D = num_heads * head_dim;
  if constexpr (std::is_same<T, bf16>::value) {
    if (stage_uses_wgmma(true, head_dim)) {
      if (!aligned16(qkv) || !aligned16(out)) return cudaErrorInvalidValue;
      StageArgs a = {};
      const cudaError_t err = encode_stage_map(&a.map[0], qkv, batch, seq_len, 3 * D);
      if (err != cudaSuccess) return err;
      a.map[1] = a.map[2] = a.map[0];
      a.col[0] = 0;
      a.col[1] = D;
      a.col[2] = 2 * D;
      a.out = static_cast<bf16*>(out);
      return launch_stage_wgmma_dh<false>(a, batch, seq_len, num_heads, head_dim, scale, stream);
    }
  }
  const T* base = static_cast<const T*>(qkv);
  FmaArgs<T> f = {};
  f.q = base;
  f.k = base + D;
  f.v = base + 2 * D;
  f.out = static_cast<T*>(out);
  f.ld = 3LL * D;
  f.n_bias = 1;
  f.bias_period = 1;
  f.bias_ld = seq_len;
  f.seq_len = seq_len;
  f.num_heads = num_heads;
  f.head_dim = head_dim;
  f.scale = scale;
  if constexpr (std::is_same<T, float>::value) {
    return launch_f32_stage(f, batch, stream);
  } else {
    return launch_fma_stage<T>(f, batch, stream);
  }
}

// The stage on separate q, k, v (batch, seq_len, head_dim) into out of the
// same shape, in T, with an optional compact f32 bias (n_bias, seq_len,
// bias_ld), bias_ld >= seq_len, batch % n_bias == 0, of which row b reads
// bias[b % n_bias]: K2's. For the wgmma stage bias_ld must be even, the bias
// 8-byte aligned and readable for kStageBiasSlack floats past its end (it
// reads on past a row into masked keys).
template <typename T>
cudaError_t launch_attention_stage_qkv(const void* q, const void* k, const void* v, const float* bias, int n_bias,
                                       int bias_ld, void* out, int batch, int seq_len, int head_dim, float scale,
                                       cudaStream_t stream) {
  if (batch <= 0 || seq_len <= 0 || head_dim <= 0 || head_dim > kStageMaxHeadDim || n_bias <= 0 ||
      batch % n_bias != 0 || bias_ld < seq_len)
    return cudaErrorInvalidValue;
  if constexpr (std::is_same<T, bf16>::value) {
    // the wgmma stage takes the bias as bias / scale (see attention_stage_wgmma)
    const bool bias_over_scale = bias == nullptr || (isfinite(scale) && isfinite(1.f / scale));
    if (stage_uses_wgmma(true, head_dim) && bias_over_scale) {
      if (!aligned16(q) || !aligned16(k) || !aligned16(v) || !aligned16(out)) return cudaErrorInvalidValue;
      if (bias != nullptr && (bias_ld % 2 != 0 || reinterpret_cast<uintptr_t>(bias) % 8 != 0))
        return cudaErrorInvalidValue;  // its rows are read as float2
      StageArgs a = {};
      const void* src[3] = {q, k, v};
      for (int x = 0; x < 3; ++x) {
        const cudaError_t err = encode_stage_map(&a.map[x], src[x], batch, seq_len, head_dim);
        if (err != cudaSuccess) return err;
      }
      a.out = static_cast<bf16*>(out);
      a.bias = bias;
      a.n_bias = n_bias;
      a.bias_ld = bias_ld;
      return bias == nullptr ? launch_stage_wgmma_dh<false>(a, batch, seq_len, 1, head_dim, scale, stream)
                             : launch_stage_wgmma_dh<true>(a, batch, seq_len, 1, head_dim, scale, stream);
    }
  }
  FmaArgs<T> f = {};
  f.q = static_cast<const T*>(q);
  f.k = static_cast<const T*>(k);
  f.v = static_cast<const T*>(v);
  f.out = static_cast<T*>(out);
  f.bias = bias;
  f.ld = head_dim;
  f.n_bias = n_bias;
  f.bias_period = n_bias;
  f.bias_ld = bias_ld;
  f.seq_len = seq_len;
  f.num_heads = 1;
  f.head_dim = head_dim;
  f.scale = scale;
  if constexpr (std::is_same<T, float>::value) {
    return launch_f32_stage(f, batch, stream);
  } else {
    return launch_fma_stage<T>(f, batch, stream);
  }
}

template <int DH, bool kBias>
const void* stage_kernel(bool one_pass) {
  return one_pass ? (const void*)attention_stage_wgmma<DH, true, kBias>
                  : (const void*)attention_stage_wgmma<DH, false, kBias>;
}

// The bf16 wgmma stage's design at (seq_len, head_dim), with or without the
// bias: out[0] blocks an SM can hold, out[1] dynamic shared memory a block,
// out[2] key rows of the K and V buffers, out[3] 1 where one pass, out[4] 1
// where K and V are resident. Returns a cudaError_t; cudaErrorInvalidValue
// where the stage is not the wgmma one.
template <bool kBias>
int attention_stage_config(int seq_len, int head_dim, int* out) {
  if (seq_len <= 0 || head_dim <= 0 || head_dim > kStageMaxHeadDim || !stage_uses_wgmma(true, head_dim))
    return cudaErrorInvalidValue;
  const int rows = stage_kv_rows(seq_len, head_dim), smem = stage_wgmma_smem_bytes(rows, head_dim);
  const bool one_pass = seq_len <= kStageBlock;  // as launch_stage_wgmma chooses
  const void* kernel = nullptr;
  switch (head_dim) {
    case 16: kernel = stage_kernel<16, kBias>(one_pass); break;
    case 32: kernel = stage_kernel<32, kBias>(one_pass); break;
    case 48: kernel = stage_kernel<48, kBias>(one_pass); break;
    case 64: kernel = stage_kernel<64, kBias>(one_pass); break;
    case 80: kernel = stage_kernel<80, kBias>(one_pass); break;
    case 96: kernel = stage_kernel<96, kBias>(one_pass); break;
    case 112: kernel = stage_kernel<112, kBias>(one_pass); break;
    case 128: kernel = stage_kernel<128, kBias>(one_pass); break;
    default: return cudaErrorInvalidValue;
  }
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err == cudaSuccess) err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&out[0], kernel, kStageThreads, smem);
  out[1] = smem;
  out[2] = rows;
  out[3] = one_pass;
  out[4] = rows >= (seq_len + kStageTile - 1) / kStageTile * kStageTile;
  return err;
}

// Dynamic shared memory one block of the stage needs; for error messages and reports.
long long attention_stage_smem_bytes(int seq_len, int head_dim, bool is_bf16) {
  if (seq_len <= 0 || head_dim <= 0 || head_dim > kStageMaxHeadDim) return 0;
  if (stage_uses_wgmma(is_bf16, head_dim)) return stage_wgmma_smem_bytes(stage_kv_rows(seq_len, head_dim), head_dim);
  return is_bf16 ? (long long)fma_smem_bytes(head_dim) : (long long)f32_stage_smem_bytes((head_dim + 15) / 16 * 16, false);
}

}  // namespace
