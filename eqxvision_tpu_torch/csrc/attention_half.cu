// The attention half of a pre-norm ViT block at inference:
//
//   out = x + (attn(LN(x) Wqkv^T + bqkv) Wproj^T + bproj)
//
// over x (B, L, D) viewed as (rows, D), with H heads of Dh = D / H, qkv laid
// out [q heads | k heads | v heads], Wqkv (3D, D) and Wproj (D, D) in
// torch's (out, in) layout.
//
// Replaces the prototype Pallas TPU kernel _attn_kernel of
// scripts/ablate_vit2.py (attn_fused) and of scripts/ablate_vit4.py
// (attn_half_fused), whose bodies are the same. Rounding points, the
// prototype's (attention_half_reference in ops/attention_half.py mirrors
// them):
//   a = LN(x): mean, then the variance over the centred values, in f32;
//       the affine in f32; rounded to x's type.
//   qkv = a Wqkv^T + bqkv: f32 accumulation plus the bias, rounded.
//   per head: s = (q . k) * scale in f32; p = e / sum(e) with
//       e = exp(s - max) in f32, rounded to x's type before p . V; the
//       head's output accumulated in f32 and rounded.
//   out = x + (o Wproj^T + bproj): f32, rounded once.
// The LayerNorm affine and the biases are read in their stored type (f32
// or bf16, all one type) and applied in f32.
//
// Design: four launches on one stream.
//   1. Row statistics of x (gemm_bf16.cuh).
//   2. qkv: the GEMM with the A tile normalised as it lands and the
//      bias-only epilogue, into a (rows, 3D) workspace in x's type.
//   3. The attention stage, from that workspace into a (rows, D) one.
//   4. proj: the GEMM with the bias + residual epilogue, the residual x.
// A one-pass kernel (the prototype's, which holds a whole image's rows in
// VMEM) would keep qkv (L x 3D, 900 KB at L = 197 in bf16) on chip; here it
// goes through device memory: 2 * rows * 4D * itemsize bytes, 0.6 GB at
// vit_base b256, about 0.18 ms of the card's memory rate.
//
// The attention stage. bf16 with Dh a multiple of 16 runs on the tensor
// cores: one block of 4 warps per (batch row, head, tile of 64 queries),
// each warp 16 query rows. The block stages its q tile and the head's K
// and V in shared memory with cp.async straight from the workspace (row
// stride 3D, 16-byte pieces), rows past L zero-filled up to a multiple of
// 16. Where all of L fits (up to 352 keys at Dh = 64, 176 at Dh = 128),
// K and V are staged once; beyond that keys are staged in chunks of that
// size and K is read twice. The normalised-p rounding point needs each
// row's sum before p . V, so the stage makes two passes over tiles of 64
// keys: the first keeps a running max and sum (scores in registers, S =
// Q K^T by mma.sync m16n8k16 with ldmatrix), the second recomputes S and
// takes p = e / sum to bf16 in the registers that feed P . V as the A
// operand (the accumulator layout of S is that of an A fragment); V's
// fragments come from ldmatrix.trans. Key columns past L are set to -inf
// before the max. Other head dims up to 128, and f32, run a CUDA-core
// stage in true f32 (no TF32): blocks of 8 warps, 4 query rows a warp,
// keys in chunks of 64 staged in f32 in shared memory, the same two passes.
//
// What bounds it. 2 * rows * D * 4D GEMM operations and 4 * B * H * L^2 *
// Dh attention operations against x, the weights and out read or written
// once: at vit_base b256 in bf16 238 + 30.5 GFLOP, 0.27 ms at 989 TFLOP/s,
// against 0.05 ms of device memory. This version also recomputes Q K^T in
// its second pass, moves qkv and the attention output through device
// memory, and its attention stage runs mma.sync, a fraction of the card's
// wgmma rate (the two GEMMs are gemm_bf16.cuh's TMA-fed wgmma ones); a
// wgmma stage is later work.
// Limits: D a multiple of 8, D divisible by H, Dh <= 128, in bf16 D at most
// 12,344 (the qkv GEMM's LayerNorm vectors), 16-byte aligned tensors; the
// entry point returns cudaErrorInvalidValue otherwise.

#include "gemm_bf16.cuh"

namespace {

using bf16 = __nv_bfloat16;
using eqx_tc::ldmatrix_x4;
using eqx_tc::ldmatrix_x4_trans;
using eqx_tc::mma_bf16;
using eqx_tc::pack_bf16;
using eqx_tc::warp_max;

constexpr int kMaxHeadDim = 128;

// ---- tensor-core stage (bf16, Dh % 16 == 0) ----
constexpr int kMmaWarps = 4;
constexpr int kMmaThreads = 32 * kMmaWarps;
constexpr int kQTile = 16 * kMmaWarps;  // query rows per block
constexpr int kKeyTile = 64;            // keys per score tile held in registers
constexpr int kMmaSmemBudget = 112 * 1024;

// Row stride of the staged q, K and V in elements: Dh + 8, so that 8
// ldmatrix rows hit 8 distinct 16-byte bank groups.
__host__ __device__ inline int mma_stride(int dh) { return dh + 8; }

// Keys staged at once: all of L, padded to 16, where it fits the budget.
__host__ __device__ inline int mma_chunk(int seq_len, int dh) {
  const int lp = (seq_len + 15) / 16 * 16;
  const int cap = (kMmaSmemBudget - kQTile * mma_stride(dh) * 2) / (4 * mma_stride(dh)) / 16 * 16;
  return lp < cap ? lp : cap;
}

size_t mma_smem_bytes(int seq_len, int dh) {
  return (size_t)(kQTile + 2 * mma_chunk(seq_len, dh)) * mma_stride(dh) * sizeof(bf16);
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// Thread (g, t) of a warp holds, for each n8 tile j of a score tile, the
// scores of rows g (e = 0, 1) and g + 8 (e = 2, 3) at keys 8 j + 2 t + e % 2.
template <int DH>
__global__ void __launch_bounds__(kMmaThreads)
    attention_stage_mma(const bf16* __restrict__ qkv, bf16* __restrict__ out, int seq_len, int num_heads,
                        float scale, int n_qtiles, int chunk) {
  constexpr int S = DH + 8;
  constexpr int kPieces = DH / 8;  // 16-byte pieces of a row
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* sQ = reinterpret_cast<bf16*>(smem);
  bf16* sK = sQ + kQTile * S;
  bf16* sV = sK + chunk * S;

  const int L = seq_len;
  const int qt = blockIdx.x % n_qtiles;
  const int h = (blockIdx.x / n_qtiles) % num_heads;
  const long long b = blockIdx.x / ((unsigned)n_qtiles * num_heads);
  const int D = num_heads * DH;
  const long long ld = 3LL * D;
  const bf16* base = qkv + b * L * ld + h * DH;
  const int q0 = qt * kQTile;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  const int lp = (L + 15) / 16 * 16;
  const int n_chunks = (lp + chunk - 1) / chunk;
  const bool resident = n_chunks == 1;

  // rows r0 .. r0 + n of q (off 0), k (D) or v (2D) into dst; rows past L zero
  auto stage = [&](bf16* dst, int r0, int n, long long off) {
    for (int idx = threadIdx.x; idx < n * kPieces; idx += kMmaThreads) {
      const int r = idx / kPieces, c = (idx % kPieces) * 8;
      const int row = r0 + r;
      const bool ok = row < L;
      cp_async16(dst + r * S + c, base + (ok ? row : 0) * ld + off + c, ok);
    }
  };

  stage(sQ, q0, kQTile, 0);
  stage(sK, 0, min(chunk, lp), D);
  cp_async_commit();
  if (resident) stage(sV, 0, lp, 2LL * D);  // lands while the first pass runs
  cp_async_commit();
  cp_async_wait<1>();
  __syncthreads();

  // this warp's 16 query rows as A fragments, one per 16 of Dh
  uint32_t qf[DH / 16][4];
  {
    const bf16* q_row = sQ + (warp * 16 + lane % 16) * S + 8 * (lane / 16);
#pragma unroll
    for (int kd = 0; kd < DH / 16; ++kd) ldmatrix_x4(qf[kd], q_row + 16 * kd);
  }

  // S = Q K^T (not yet scaled) for keys kt .. kt + 64 of the staged chunk
  // (len keys); pairs of n8 tiles past len are skipped (len is a multiple
  // of 16)
  auto scores = [&](int kt, int len, float (&s)[kKeyTile / 8][4]) {
    const bf16* k_row = sK + (kt + lane % 8 + 8 * (lane / 16)) * S + 8 * (lane / 8 % 2);
#pragma unroll
    for (int j = 0; j < kKeyTile / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
    for (int kd = 0; kd < DH / 16; ++kd) {
#pragma unroll
      for (int jj = 0; jj < kKeyTile / 16; ++jj) {
        if (kt + 16 * jj < len) {
          uint32_t kb[4];
          ldmatrix_x4(kb, k_row + 16 * jj * S + 16 * kd);
          mma_bf16(s[2 * jj], qf[kd], kb[0], kb[1]);
          mma_bf16(s[2 * jj + 1], qf[kd], kb[2], kb[3]);
        }
      }
    }
  };

  // pass 1: each row's max and sum of exp(s - max), running over key tiles
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  for (int c = 0; c < n_chunks; ++c) {
    const int c0 = c * chunk, len = min(chunk, lp - c0);
    if (c > 0) {
      __syncthreads();  // every warp is done with the previous chunk
      stage(sK, c0, len, D);
      cp_async_commit();
      cp_async_wait<0>();
      __syncthreads();
    }
    for (int kt = 0; kt < len; kt += kKeyTile) {
      float s[kKeyTile / 8][4];
      scores(kt, len, s);
      float tm[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int j = 0; j < kKeyTile / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = c0 + kt + 8 * j + 2 * t + (e & 1);
          s[j][e] = kt + 8 * j < len && col < L ? s[j][e] * scale : -INFINITY;
          tm[e / 2] = fmaxf(tm[e / 2], s[j][e]);
        }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        // every tile holds a key below L, so the new max is finite
        const float m_new = fmaxf(m[r], quad_max(tm[r]));
        float sum = 0.f;
#pragma unroll
        for (int j = 0; j < kKeyTile / 8; ++j) sum += expf(s[j][2 * r] - m_new) + expf(s[j][2 * r + 1] - m_new);
        l[r] = l[r] * expf(m[r] - m_new) + sum;
        m[r] = m_new;
      }
    }
  }
  const float inv[2] = {1.f / quad_sum(l[0]), 1.f / quad_sum(l[1])};

  // pass 2: p = e / sum rounded to bf16, O += P V
  float o[DH / 8][4] = {};
  for (int c = 0; c < n_chunks; ++c) {
    const int c0 = c * chunk, len = min(chunk, lp - c0);
    __syncthreads();  // every warp is done with the chunk staged before
    if (resident) {
      cp_async_wait<0>();  // V has landed
    } else {
      stage(sK, c0, len, D);
      stage(sV, c0, len, 2LL * D);
      cp_async_commit();
      cp_async_wait<0>();
    }
    __syncthreads();
    for (int kt = 0; kt < len; kt += kKeyTile) {
      float s[kKeyTile / 8][4];
      scores(kt, len, s);
      uint32_t pk[kKeyTile / 8][2];  // p of (row g, keys 2t, 2t+1) and (row g + 8, same keys)
#pragma unroll
      for (int j = 0; j < kKeyTile / 8; ++j)
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int col = c0 + kt + 8 * j + 2 * t;
          const bool in = kt + 8 * j < len;
          const float p0 = in && col < L ? expf(s[j][2 * r] * scale - m[r]) * inv[r] : 0.f;
          const float p1 = in && col + 1 < L ? expf(s[j][2 * r + 1] * scale - m[r]) * inv[r] : 0.f;
          pk[j][r] = pack_bf16(__float2bfloat16(p0), __float2bfloat16(p1));
        }
#pragma unroll
      for (int kk = 0; kk < kKeyTile / 16; ++kk) {
        if (kt + 16 * kk >= len) break;
        const uint32_t a[4] = {pk[2 * kk][0], pk[2 * kk][1], pk[2 * kk + 1][0], pk[2 * kk + 1][1]};
        const bf16* v_row = sV + (kt + 16 * kk + lane % 8 + 8 * (lane / 8 % 2)) * S + 8 * (lane / 16);
#pragma unroll
        for (int nd = 0; nd < DH / 16; ++nd) {
          uint32_t vb[4];
          ldmatrix_x4_trans(vb, v_row + 16 * nd);
          mma_bf16(o[2 * nd], a, vb[0], vb[1]);
          mma_bf16(o[2 * nd + 1], a, vb[2], vb[3]);
        }
      }
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + warp * 16 + g + 8 * r;
    if (row >= L) continue;
    bf16* dst = out + (b * L + row) * D + h * DH + 2 * t;
#pragma unroll
    for (int j = 0; j < DH / 8; ++j)
      *reinterpret_cast<uint32_t*>(dst + 8 * j) =
          pack_bf16(__float2bfloat16(o[j][2 * r]), __float2bfloat16(o[j][2 * r + 1]));
  }
}

// ---- CUDA-core stage (f32, or bf16 with Dh % 16 != 0) ----
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

// NI: output columns per lane, ceil(Dh / 32).
template <typename T, int NI>
__global__ void __launch_bounds__(kFmaThreads)
    attention_stage_fma(const T* __restrict__ qkv, T* __restrict__ out, int seq_len, int num_heads, int head_dim,
                        float scale, int n_qtiles) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int L = seq_len, Dh = head_dim, ks = fma_k_stride(Dh);
  float* sQ = reinterpret_cast<float*>(smem);  // kFmaQTile x Dh
  float* sK = sQ + kFmaQTile * Dh;              // kFmaKeys x ks
  float* sV = sK + kFmaKeys * ks;               // kFmaKeys x Dh
  float* sP = sV + kFmaKeys * Dh;               // kFmaQTile x kFmaKeys

  const int qt = blockIdx.x % n_qtiles;
  const int h = (blockIdx.x / n_qtiles) % num_heads;
  const long long b = blockIdx.x / ((unsigned)n_qtiles * num_heads);
  const int D = num_heads * Dh;
  const long long ld = 3LL * D;
  const T* base = qkv + b * L * ld + h * Dh;
  const int q0 = qt * kFmaQTile;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  for (int idx = threadIdx.x; idx < kFmaQTile * Dh; idx += kFmaThreads) {
    const int r = idx / Dh, d = idx - r * Dh;
    sQ[idx] = q0 + r < L ? to_f32(base[(q0 + r) * ld + d]) : 0.f;
  }
  // keys j0 .. j0 + kFmaKeys of K (and V) into shared memory in f32; rows past L zero
  auto stage = [&](int j0, bool with_v) {
    for (int idx = threadIdx.x; idx < kFmaKeys * Dh; idx += kFmaThreads) {
      const int j = idx / Dh, d = idx - j * Dh;
      const bool ok = j0 + j < L;
      const T* row = base + (ok ? j0 + j : 0) * ld + d;
      sK[j * ks + d] = ok ? to_f32(row[D]) : 0.f;
      if (with_v) sV[j * Dh + d] = ok ? to_f32(row[2 * D]) : 0.f;
    }
  };
  const float* q_w = sQ + warp * kFmaRows * Dh;
  // s[r][c] = (q_r . k_{lane + 32 c}) * scale, -inf past L
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
      for (int c = 0; c < 2; ++c) s[r][c] = j0 + lane + 32 * c < L ? acc[r][c] * scale : -INFINITY;
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
      // every chunk holds a key below L, so the new max is finite
      const float m_new = fmaxf(m[r], warp_max(fmaxf(s[r][0], s[r][1])));
      l[r] = l[r] * expf(m[r] - m_new) + warp_sum(expf(s[r][0] - m_new) + expf(s[r][1] - m_new));
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
    T* dst = out + (b * L + row) * D + h * Dh;
#pragma unroll
    for (int i = 0; i < NI; ++i) {
      const int d = lane + 32 * i;
      if (d < Dh) dst[d] = from_f32<T>(o[r][i]);
    }
  }
}

template <int DH>
cudaError_t launch_mma(const void* qkv, void* out, int batch, int seq_len, int num_heads, float scale,
                       cudaStream_t stream) {
  const int n_qtiles = (seq_len + kQTile - 1) / kQTile;
  const long long blocks = (long long)batch * num_heads * n_qtiles;
  if (blocks > INT_MAX) return cudaErrorInvalidValue;
  const size_t smem = mma_smem_bytes(seq_len, DH);
  auto kernel = attention_stage_mma<DH>;
  const cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kernel<<<(unsigned)blocks, kMmaThreads, smem, stream>>>(static_cast<const bf16*>(qkv), static_cast<bf16*>(out),
                                                           seq_len, num_heads, scale, n_qtiles, mma_chunk(seq_len, DH));
  return cudaGetLastError();
}

template <typename T, int NI>
cudaError_t launch_fma(const void* qkv, void* out, int batch, int seq_len, int num_heads, int head_dim, float scale,
                       cudaStream_t stream) {
  const int n_qtiles = (seq_len + kFmaQTile - 1) / kFmaQTile;
  const long long blocks = (long long)batch * num_heads * n_qtiles;
  if (blocks > INT_MAX) return cudaErrorInvalidValue;
  const size_t smem = fma_smem_bytes(head_dim);
  auto kernel = attention_stage_fma<T, NI>;
  const cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kernel<<<(unsigned)blocks, kFmaThreads, smem, stream>>>(static_cast<const T*>(qkv), static_cast<T*>(out), seq_len,
                                                           num_heads, head_dim, scale, n_qtiles);
  return cudaGetLastError();
}

bool uses_mma(bool is_bf16, int head_dim) { return is_bf16 && head_dim % 16 == 0; }

template <typename T>
cudaError_t launch_stage(const void* qkv, void* out, int batch, int seq_len, int num_heads, int head_dim, float scale,
                         cudaStream_t stream) {
  if constexpr (std::is_same<T, bf16>::value) {
    if (uses_mma(true, head_dim)) {
      switch (head_dim) {
        case 16: return launch_mma<16>(qkv, out, batch, seq_len, num_heads, scale, stream);
        case 32: return launch_mma<32>(qkv, out, batch, seq_len, num_heads, scale, stream);
        case 48: return launch_mma<48>(qkv, out, batch, seq_len, num_heads, scale, stream);
        case 64: return launch_mma<64>(qkv, out, batch, seq_len, num_heads, scale, stream);
        case 80: return launch_mma<80>(qkv, out, batch, seq_len, num_heads, scale, stream);
        case 96: return launch_mma<96>(qkv, out, batch, seq_len, num_heads, scale, stream);
        case 112: return launch_mma<112>(qkv, out, batch, seq_len, num_heads, scale, stream);
        case 128: return launch_mma<128>(qkv, out, batch, seq_len, num_heads, scale, stream);
        default: return cudaErrorInvalidValue;
      }
    }
  }
  switch ((head_dim + 31) / 32) {
    case 1: return launch_fma<T, 1>(qkv, out, batch, seq_len, num_heads, head_dim, scale, stream);
    case 2: return launch_fma<T, 2>(qkv, out, batch, seq_len, num_heads, head_dim, scale, stream);
    case 3: return launch_fma<T, 3>(qkv, out, batch, seq_len, num_heads, head_dim, scale, stream);
    case 4: return launch_fma<T, 4>(qkv, out, batch, seq_len, num_heads, head_dim, scale, stream);
    default: return cudaErrorInvalidValue;
  }
}

template <typename T>
cudaError_t run(const void* x, const void* ln_w, const void* ln_b, const void* wqkv, const void* bqkv,
                const void* wproj, const void* bproj, void* qkv_buf, void* attn_buf, void* stats_buf, void* out,
                int batch, int seq_len, int dim, int num_heads, float scale, float eps, bool param_bf16,
                cudaStream_t stream) {
  const long long rows = (long long)batch * seq_len;
  float2* stats = static_cast<float2*>(stats_buf);
  cudaError_t err = launch_row_stats<T>(x, stats, rows, dim, eps, stream);
  if (err != cudaSuccess) return err;

  GemmArgs qkv = {};
  qkv.a = x;
  qkv.w = wqkv;
  qkv.out = qkv_buf;
  qkv.M = rows;
  qkv.N = 3 * dim;
  qkv.K = dim;
  qkv.stats = stats;
  qkv.ln_w = ln_w;
  qkv.ln_b = ln_b;
  qkv.bias = bqkv;
  qkv.param_bf16 = param_bf16;
  err = launch_gemm<T, true, kBias>(qkv, stream);
  if (err != cudaSuccess) return err;

  err = launch_stage<T>(qkv_buf, attn_buf, batch, seq_len, num_heads, dim / num_heads, scale, stream);
  if (err != cudaSuccess) return err;

  GemmArgs proj = {};
  proj.a = attn_buf;
  proj.w = wproj;
  proj.out = out;
  proj.M = rows;
  proj.N = dim;
  proj.K = dim;
  proj.bias = bproj;
  proj.residual = x;
  proj.param_bf16 = param_bf16;
  return launch_gemm<T, false, kBiasResidual>(proj, stream);
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16, for x, wqkv, wproj, the scratch qkv_buf
// (rows, 3 * dim) and attn_buf (rows, dim), and out; param_dtype the same
// for ln_w, ln_b (dim,), bqkv (3 * dim,) and bproj (dim,).
// stats_buf holds rows float2. x and out (batch, seq_len, dim), wqkv
// (3 * dim, dim), wproj (dim, dim); all contiguous and 16-byte aligned on
// the current device. Launches four kernels on `stream` and returns the
// first cudaError_t.
int eqx_attention_half(const void* x, const void* ln_w, const void* ln_b, const void* wqkv, const void* bqkv,
                       const void* wproj, const void* bproj, void* qkv_buf, void* attn_buf, void* stats_buf, void* out,
                       int batch, int seq_len, int dim, int num_heads, float scale, float eps, int dtype,
                       int param_dtype, void* stream) {
  if (batch <= 0 || seq_len <= 0 || dim <= 0 || num_heads <= 0 || dim % 8 != 0 || dim % num_heads != 0 ||
      dim / num_heads > kMaxHeadDim || param_dtype < 0 || param_dtype > 1)
    return cudaErrorInvalidValue;
  const void* tensors[] = {x, wqkv, wproj, qkv_buf, attn_buf, stats_buf, out};
  for (const void* t : tensors)
    if (t == nullptr || !aligned16(t)) return cudaErrorInvalidValue;
  if (ln_w == nullptr || ln_b == nullptr || bqkv == nullptr || bproj == nullptr) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool pbf16 = param_dtype == 1;
  if (dtype == 0)
    return run<float>(x, ln_w, ln_b, wqkv, bqkv, wproj, bproj, qkv_buf, attn_buf, stats_buf, out, batch, seq_len, dim,
                      num_heads, scale, eps, pbf16, s);
  if (dtype == 1)
    return run<bf16>(x, ln_w, ln_b, wqkv, bqkv, wproj, bproj, qkv_buf, attn_buf, stats_buf, out, batch, seq_len, dim,
                     num_heads, scale, eps, pbf16, s);
  return cudaErrorInvalidValue;
}

// Dynamic shared memory one block of the attention stage needs; for error
// messages and reports.
long long eqx_attention_half_smem_bytes(int seq_len, int head_dim, int dtype) {
  if (seq_len <= 0 || head_dim <= 0 || head_dim > kMaxHeadDim) return 0;
  return (long long)(uses_mma(dtype == 1, head_dim) ? mma_smem_bytes(seq_len, head_dim) : fma_smem_bytes(head_dim));
}

}  // extern "C"
