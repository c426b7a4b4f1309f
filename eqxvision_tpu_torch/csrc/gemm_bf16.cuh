// GEMM machinery shared by mlp_half.cu, attention_half.cu and
// window_attention_half.cu (swin_block.cu takes its Hopper primitives):
//
//   out[r, n] = epi(sum_k A'[r, k] * W[n, k])
//
// with W in torch's (out, in) layout, k contiguous, and A' either A itself
// or A normalised row by row with precomputed LayerNorm statistics and the
// LayerNorm affine (applied to the A tile once it lands in shared memory).
// Three independent compile-time choices:
//   kNormA  normalise the A tile with the row statistics (yes / no);
//   kEpi    the epilogue on the f32 accumulator: the bias only; the bias
//           then exact-erf gelu; the bias, an optional per-column scale
//           and a residual; or the accumulator rounded to the output type
//           plus the bias rounded to it (a product and its bias added in
//           the input's type, as the JAX Swin computes its windowed qkv).
//   kMaskRows  rows whose flag in row_valid is 0 read A as zeros (their
//           normalised A is 0, not the LayerNorm's shift): the padding
//           tokens of Swin's windows.
// Every epilogue then rounds once to the output type.
//
// bf16 runs on Hopper's tensor cores (sm_90a), warp-specialised:
//   - One producer warp issues TMA loads (cp.async.bulk.tensor) of 128 x 64
//     tiles of A and BN x 64 tiles of W, both with the 128-byte swizzle,
//     into a ring of kStages stages with a full and an empty mbarrier each.
//     W stays in its (N, K) layout, which is K-major for wgmma's B: nothing
//     is transposed. TMA zero-fills rows past M or N and k past K (K = 96
//     is one and a half k-tiles).
//   - Two consumer warpgroups each own 64 rows x BN columns of the output
//     tile and issue wgmma.mma_async m64nBNk16 (f32 accumulation) from
//     shared-memory descriptors: stride 1024 bytes between 8-row groups,
//     32 bytes further per k16 step. setmaxnreg gives the producer's
//     registers to the consumers (40 and 232 a thread).
//   - LayerNorm on A (and kMaskRows), off the producer's path: when a stage
//     lands, each consumer warpgroup normalises its own 64 rows in place, in
//     16-byte pieces (the logical piece of a swizzled row is its physical
//     index XOR row % 8), with gamma and beta of all of K staged once per
//     block in shared memory in f32 and each thread's row statistics in
//     registers; then fence.proxy.async, a warpgroup barrier, and only then
//     its wgmma reads the stage. A' is rounded where the prototypes round
//     it: bf16((x - mean) * rstd * g + b), all in f32. Normalising in
//     place rather than in registers keeps both operands in shared memory
//     for wgmma, and one pass serves both the row's norm and its mask.
//   - Epilogue through shared memory: each warp passes its 16 rows of the
//     accumulator, 32 columns at a time, through its part of a buffer
//     (XOR-swizzled 16-byte units: no bank conflicts on either side), then
//     each lane finishes 8 consecutive columns of a row with the bias and
//     scale staged once per tile, reads the residual and writes the output
//     as 16-byte vectors. What the epilogue and the LayerNorm pass read from
//     device memory is asked for early, so that its latency falls under the
//     products: the bias and scale into registers as a tile starts, the
//     residual into L2 four k-tiles before its end, the row statistics of
//     the next tile before this tile's epilogue.
//   - A persistent grid: one block per SM walks the tiles in order, the
//     column tiles of a row panel adjacent, so that the panel is read from
//     device memory once and from L2 by its neighbours, and the producer
//     loads the next tile's first stages while the consumers run the
//     epilogue (which is why the epilogue has a buffer of its own and does
//     not reuse a drained stage). Measured against one block per tile at
//     vit_base b256 fc1 on an H100: 0.72 against 0.79 ms.
//   - BN: the widest of 256, 128 and 96 with the least padding, so 256 for
//     N = 3072 or 2304, 128 for 1152 or 384, 96 for N = 96 or 192 (where
//     128 would pad by a quarter or a third of each tile); a narrower one
//     where the LayerNorm vectors of a large K would not fit beside a
//     256-wide ring. Measured at convnext_tiny b128's fc2: at N = 192 the
//     96-wide tile takes 0.097 ms against 0.106 for a 256-wide one; at
//     N = 96 it ties a 128-wide one.
// What holds it back (scripts/ablate_torch_gemm.py): a warp's wgmma issue
// waits for the tensor cores, so the LayerNorm pass and the epilogue, which
// run in the issuing warps, run beside no products. At vit_base b256 fc1
// the products alone would take 0.36 ms with the pass and 0.25 without it;
// the epilogue adds 0.36 (gelu 0.12 of it).
// f32 runs on the same tensor cores by split TF32 (gemm_f32_kernel): each
// operand x becomes hi = tf32(x) and lo = tf32(x - hi), rounded to nearest,
// and each product hi hi + hi lo + lo hi (wgmma m64nBNk8 .tf32, f32
// accumulators), which keeps about 22 of f32's 24 bits a product, where one
// TF32 product keeps 11: three TF32 products at 495 TFLOP/s bound it at
// 165 TFLOP/s, against 67 for f32 FMAs on the CUDA cores. Both GEMMs run
// one skeleton, gemm_body (producer warp, two consumer warpgroups of 64
// rows, a persistent grid, the epilogue through shared memory, in f32 as
// 16-byte pieces of four floats); only the consumers' k-loop differs. A
// stage holds 128 x 32 floats of A and BN x 32 of
// W (a 32-float k-tile is one 128-byte swizzle row; three stages, BN 128,
// or 96 where that pads N less), as TMA wrote them, plus A's and W's lo
// halves: once a stage lands, each consumer warpgroup normalises its 64 A
// rows in place (the LayerNorm in f32, gamma and beta read from L1, masked
// rows zeroed) and splits them, hi in place and lo beside, splits half of
// W's rows the same way, and a barrier of both warpgroups hands the stage
// to wgmma. Splitting W in the kernel costs the consumers a pass over W's
// tile per k-tile, beside the products of the stage before, and needs no
// scratch copy of the weights. The tensor cores add each product into their
// accumulator rounding toward zero, so each k-tile's products start from
// zero and are added to the tile's sum in f32; the next stage's split runs
// while they do. At vit_base b256 it reaches 69-85 TFLOP/s of f32 products
// (fc1 with its LayerNorm pass the least; 71-91 before the split kept
// non-finite values), where a register-tiled CUDA-core SGEMM took 47
// (scripts/ablate_torch_gemm_f32.py) and F.linear 52.
// Limits: K and N multiples of 8 for bf16, of 4 for f32, A, W and out
// 16-byte aligned (the callers check them); M below 2^31; in bf16 with
// kNormA, K at most 12,344 (the LayerNorm vectors beside the narrowest
// tile's ring).
//
// Everything here has internal linkage: each source that includes the
// header gets its own copy of the kernels it instantiates.
#pragma once

#include <cuda.h>
#include <cudaTypedefs.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "tensor_core_attention.cuh"

namespace {

using eqx_tc::warp_sum;

constexpr int kGemmThreads = 256;  // row statistics
constexpr int kGemmWarps = kGemmThreads / 32;
// bf16 wgmma GEMM: a producer warpgroup, then two consumer warpgroups
constexpr int kWarpgroup = 128;
constexpr int kBf16Threads = 3 * kWarpgroup;
constexpr int kBM = 128, kBK = 64, kStages = 4;
constexpr int kATileBytes = kBM * kBK * 2;
constexpr int kEpiCols = 32;            // accumulator columns a warpgroup stages at a time
constexpr int kMaxSmemBytes = 232448;   // shared memory one block may opt into (227 KB)
// f32 split-TF32 GEMM: k-tiles of 32 floats (one 128-byte swizzle row),
// three stages of A, A's lo, W and W's lo
constexpr int kFK = 32, kF32Stages = 3;
constexpr int kF32ATileBytes = kBM * kFK * 4;

__host__ __device__ constexpr int gemm_stage_bytes(int bn) { return kATileBytes + bn * kBK * 2; }

// Dynamic shared memory of one bf16 block without the LayerNorm vectors
// (kNormA adds 8 K bytes): alignment slack to 1024 bytes for the swizzle,
// the ring, two epilogue buffers, bias and scale per warpgroup, barriers.
__host__ __device__ constexpr int gemm_smem_bytes(int bn) {
  return 1024 + kStages * gemm_stage_bytes(bn) + 2 * 64 * kEpiCols * 4 + 2 * 2 * bn * 4 + 2 * kStages * 8;
}
constexpr int kGemmSmemBytes = gemm_smem_bytes(256);  // the widest tile's

__host__ __device__ constexpr int gemm_f32_stage_bytes(int bn) { return 2 * kF32ATileBytes + 2 * bn * kFK * 4; }

// Dynamic shared memory of one f32 block: alignment slack, the ring, two
// epilogue buffers, bias and scale per warpgroup, barriers (at BN = 128,
// 216,112 bytes).
__host__ __device__ constexpr int gemm_f32_smem_bytes(int bn) {
  return 1024 + kF32Stages * gemm_f32_stage_bytes(bn) + 2 * 64 * kEpiCols * 4 + 2 * 2 * bn * 4 + 2 * kF32Stages * 8;
}

enum Epilogue { kBias = 0, kBiasGelu = 1, kBiasResidual = 2, kRoundedBias = 3 };

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

// x rounded to T and back.
template <typename T>
__device__ __forceinline__ float round_to(float x);
template <>
__device__ __forceinline__ float round_to<float>(float x) { return x; }
template <>
__device__ __forceinline__ float round_to<__nv_bfloat16>(float x) { return __bfloat162float(__float2bfloat16(x)); }

// Element i of a vector stored in f32 (bf16 == false) or bf16, in f32.
__device__ __forceinline__ float param(const void* p, bool bf16, int i) {
  return bf16 ? __bfloat162float(static_cast<const __nv_bfloat16*>(p)[i]) : static_cast<const float*>(p)[i];
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool pred) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  const int bytes = pred ? 16 : 0;  // 0: the 16 bytes are zero-filled and nothing is read
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(gmem), "r"(bytes));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

struct GemmArgs {
  const void* a;  // (M, K) in T
  const void* w;  // (N, K) in T
  void* out;      // (M, N) in T
  long long M;
  int N, K;
  const float2* stats;   // kNormA: (M,) row mean and rstd of A
  const void* ln_w;      // kNormA: (K,) LayerNorm affine
  const void* ln_b;
  const void* bias;      // (N,)
  const void* scale;     // kBiasResidual: (N,) column scale, or null for 1
  const void* residual;  // kBiasResidual: (M, N) in T
  bool param_bf16;       // ln_w, ln_b, bias and scale are bf16 (else f32)
  const unsigned char* row_valid;  // kMaskRows: (valid_period,) flags, row r reads row_valid[r % valid_period]
  long long valid_period;
};

// The epilogue's arithmetic on one f32 accumulator, with the column's bias
// and scale (1 where there is none) and the row's residual in f32.
template <typename T, int kEpi>
__device__ __forceinline__ float finish(float acc, float bias, float scale, float residual) {
  if constexpr (kEpi == kRoundedBias) {
    return round_to<T>(acc) + round_to<T>(bias);
  } else {
    float y = acc + bias;
    if constexpr (kEpi == kBiasGelu) {
      return 0.5f * y * (1.f + erff(y * 0.70710678118654752f));
    } else if constexpr (kEpi == kBiasResidual) {
      return residual + y * scale;
    } else {
      return y;
    }
  }
}

// (mean, rstd) of each row, one warp per row; rows are 16-byte aligned and
// dim a multiple of 16 / sizeof(T). The mean is summed about the row's
// first value and the variance taken over the centred values, so a row of
// 1e3 + N(0, 1) keeps its variance.
template <typename T>
__global__ void __launch_bounds__(kGemmThreads)
    row_stats_kernel(const T* __restrict__ x, float2* __restrict__ stats, long long rows, int dim, float eps) {
  constexpr int E = 16 / sizeof(T);
  const long long row = (long long)blockIdx.x * kGemmWarps + threadIdx.x / 32;
  if (row >= rows) return;  // whole warps leave together
  const int lane = threadIdx.x % 32, nvec = dim / E;
  const T* src = x + row * dim;
  const uint4* vsrc = reinterpret_cast<const uint4*>(src);
  const float pivot = to_f32(src[0]);
  float sum = 0.f;
  for (int v = lane; v < nvec; v += 32) {
    const uint4 raw = vsrc[v];
    const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
    for (int u = 0; u < E; ++u) sum += to_f32(e[u]) - pivot;
  }
  const float inv_d = 1.f / dim;
  const float mean = pivot + warp_sum(sum) * inv_d;
  float sq = 0.f;
  for (int v = lane; v < nvec; v += 32) {
    const uint4 raw = vsrc[v];
    const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
    for (int u = 0; u < E; ++u) {
      const float c = to_f32(e[u]) - mean;
      sq += c * c;
    }
  }
  const float rstd = rsqrtf(warp_sum(sq) * inv_d + eps);
  if (lane == 0) stats[row] = make_float2(mean, rstd);
}

template <typename T>
cudaError_t launch_row_stats(const void* x, float2* stats, long long rows, int dim, float eps, cudaStream_t stream) {
  const long long blocks = (rows + kGemmWarps - 1) / kGemmWarps;
  if (blocks > INT_MAX) return cudaErrorInvalidValue;
  row_stats_kernel<T><<<(unsigned)blocks, kGemmThreads, 0, stream>>>(static_cast<const T*>(x), stats, rows, dim, eps);
  return cudaGetLastError();
}

// ---- Hopper primitives: mbarriers, TMA, wgmma ----

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t arrivals) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(arrivals) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_addr(bar)) : "memory");
}

__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(bytes)
               : "memory");
}

// Wait for the phase of `parity` to complete. A wait that lasts over 2^34
// cycles (about 9 s) is a deadlock: it traps, so the launch fails rather
// than hold the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_addr(bar);
  uint32_t done;
  long long start = 0;
  while (true) {
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\nselp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
    if (done) return;
    if (start == 0) {
      start = clock64();
    } else if (clock64() - start > (1LL << 34)) {
      __trap();
    }
  }
}

// The box of `map` at (c0 along the contiguous axis, c1 along rows) into
// shared memory; its bytes complete a transaction on `bar`.
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map, uint64_t* bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1, {%3, %4}], [%2];\n"
      :
      : "r"(smem_addr(dst)), "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "r"(c0), "r"(c1)
      : "memory");
}

// The box of `map` at (c0 along the contiguous axis, c1 along rows, c2 along
// the outer axis) into shared memory; its bytes complete a transaction on bar.
__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map, uint64_t* bar, int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1, {%3, %4, %5}], [%2];\n"
      :
      : "r"(smem_addr(dst)), "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

__device__ __forceinline__ void named_barrier(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

template <int kRegs>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kRegs));
}

template <int kRegs>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kRegs));
}

// wgmma descriptor of a K-major operand tile in shared memory with the
// 128-byte swizzle, 1024-byte aligned: rows of 64 bf16 (128 bytes), 8-row
// groups 1024 bytes apart. A k16 step further along is +2 (32 bytes).
__device__ __forceinline__ uint64_t sw128_desc(const void* tile) {
  return (uint64_t)((smem_addr(tile) & 0x3FFFF) >> 4) | (1ull << 16) | ((uint64_t)(1024 >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() { asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory"); }
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keeps the compiler from moving reads or writes of the accumulator across
// the asynchronous wgmma's issue and wait.
template <int R>
__device__ __forceinline__ void fence_accumulator(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// D (+)= A B^T for a 64 x BN tile: A and B by descriptor, D in the wgmma
// accumulator layout (register 4 j + e holds row 16 (warp % 4) + lane / 4
// + 8 (e / 2), column 8 j + 2 (lane % 4) + e % 2); accumulate = 0 overwrites.
__device__ __forceinline__ void wgmma_m64n256k16(float (&d)[128], uint64_t desc_a, uint64_t desc_b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\nwgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,%12,%13,%14,%15,%16,%17,%18,%19,"
      "%20,%21,%22,%23,%24,%25,%26,%27,%28,%29,%30,%31,%32,%33,%34,%35,%36,%37,%38,%39,"
      "%40,%41,%42,%43,%44,%45,%46,%47,%48,%49,%50,%51,%52,%53,%54,%55,%56,%57,%58,%59,"
      "%60,%61,%62,%63,%64,%65,%66,%67,%68,%69,%70,%71,%72,%73,%74,%75,%76,%77,%78,%79,"
      "%80,%81,%82,%83,%84,%85,%86,%87,%88,%89,%90,%91,%92,%93,%94,%95,%96,%97,%98,%99,"
      "%100,%101,%102,%103,%104,%105,%106,%107,%108,%109,%110,%111,%112,%113,%114,%115,%116,%117,%118,%119,"
      "%120,%121,%122,%123,%124,%125,%126,%127}, "
      "%128, %129, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(desc_a), "l"(desc_b), "r"(accumulate));
}

__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[64], uint64_t desc_a, uint64_t desc_b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\nwgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,%12,%13,%14,%15,%16,%17,%18,%19,"
      "%20,%21,%22,%23,%24,%25,%26,%27,%28,%29,%30,%31,%32,%33,%34,%35,%36,%37,%38,%39,"
      "%40,%41,%42,%43,%44,%45,%46,%47,%48,%49,%50,%51,%52,%53,%54,%55,%56,%57,%58,%59,"
      "%60,%61,%62,%63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(desc_a), "l"(desc_b), "r"(accumulate));
}

__device__ __forceinline__ void wgmma_m64n96k16(float (&d)[48], uint64_t desc_a, uint64_t desc_b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %50, 0;\nwgmma.mma_async.sync.aligned.m64n96k16.f32.bf16.bf16 {"
      "%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,%12,%13,%14,%15,%16,%17,%18,%19,"
      "%20,%21,%22,%23,%24,%25,%26,%27,%28,%29,%30,%31,%32,%33,%34,%35,%36,%37,%38,%39,"
      "%40,%41,%42,%43,%44,%45,%46,%47}, "
      "%48, %49, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47])
      : "l"(desc_a), "l"(desc_b), "r"(accumulate));
}

// The widths swin_block.cu adds: its qkv pieces (192) and MLP chunks (64).
__device__ __forceinline__ void wgmma_m64n192k16(float (&d)[96], uint64_t desc_a, uint64_t desc_b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %98, 0;\nwgmma.mma_async.sync.aligned.m64n192k16.f32.bf16.bf16 {"
      "%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,%12,%13,%14,%15,%16,%17,%18,%19,"
      "%20,%21,%22,%23,%24,%25,%26,%27,%28,%29,%30,%31,%32,%33,%34,%35,%36,%37,%38,%39,"
      "%40,%41,%42,%43,%44,%45,%46,%47,%48,%49,%50,%51,%52,%53,%54,%55,%56,%57,%58,%59,"
      "%60,%61,%62,%63,%64,%65,%66,%67,%68,%69,%70,%71,%72,%73,%74,%75,%76,%77,%78,%79,"
      "%80,%81,%82,%83,%84,%85,%86,%87,%88,%89,%90,%91,%92,%93,%94,%95}, "
      "%96, %97, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95])
      : "l"(desc_a), "l"(desc_b), "r"(accumulate));
}

__device__ __forceinline__ void wgmma_m64n64k16(float (&d)[32], uint64_t desc_a, uint64_t desc_b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\nwgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,%12,%13,%14,%15,%16,%17,%18,%19,"
      "%20,%21,%22,%23,%24,%25,%26,%27,%28,%29,%30,%31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(desc_a), "l"(desc_b), "r"(accumulate));
}

template <int BN>
__device__ __forceinline__ void wgmma_tile(float (&d)[BN / 2], uint64_t desc_a, uint64_t desc_b, int accumulate) {
  if constexpr (BN == 256) {
    wgmma_m64n256k16(d, desc_a, desc_b, accumulate);
  } else if constexpr (BN == 192) {
    wgmma_m64n192k16(d, desc_a, desc_b, accumulate);
  } else if constexpr (BN == 128) {
    wgmma_m64n128k16(d, desc_a, desc_b, accumulate);
  } else if constexpr (BN == 64) {
    wgmma_m64n64k16(d, desc_a, desc_b, accumulate);
  } else {
    static_assert(BN == 96, "column tiles are 256, 192, 128, 96 or 64 wide");
    wgmma_m64n96k16(d, desc_a, desc_b, accumulate);
  }
}

// Float index of (row, col) in a warpgroup's 64 x kEpiCols epilogue buffer:
// 16-byte unit col / 4 of the row stored at unit (col / 4) ^ f(row), f(row)
// = 2 (row % 4) + row % 2, so that the float2 writes of the accumulator
// layout (4 rows a half-warp) and the float4 reads of 8-column groups (2 rows
// a quarter-warp) each hit 32 distinct banks.
__device__ __forceinline__ int epi_index(int row, int col) {
  return row * kEpiCols + ((((col >> 2) ^ (((row & 3) << 1) | (row & 1)))) << 2) + (col & 3);
}

// ---- f32: split TF32 ("3xTF32") on wgmma ----
// Each f32 operand x is split into hi = tf32(x) and lo = tf32(x - hi), both
// rounded to nearest (cvt.rna), so that x = hi + lo + r with |r| <= 2^-22
// |x|; each product is hi_a hi_w + hi_a lo_w + lo_a hi_w (lo_a lo_w, below
// 2^-22 of it, is dropped), accumulated in f32 by the tensor cores.

// x rounded to TF32 (the low 13 of its 23 mantissa bits cleared) to
// nearest, ties away from zero, as cvt.rna.tf32.f32 rounds, in two integer
// operations on the full-rate pipe: half of the dropped unit added to the
// magnitude bits carries into the kept ones exactly when the dropped bits
// are at least half a unit. For a finite x only: in a NaN the carry runs on
// through the exponent into the sign (the card's canonical NaN, 0x7FFFFFFF,
// becomes -0).
__device__ __forceinline__ uint32_t tf32_rna_bits(float x) { return (__float_as_uint(x) + 0x1000u) & 0xFFFFE000u; }

// hi = tf32(x), lo = tf32(x - hi), as TF32 operand bits. A NaN or an
// infinity is kept in hi as it is (one comparison and a select), so every
// product with it is non-finite, whatever lo (then rounded from a NaN)
// holds.
__device__ __forceinline__ void split_tf32_bits(float x, uint32_t& hi, uint32_t& lo) {
  hi = fabsf(x) < INFINITY ? tf32_rna_bits(x) : __float_as_uint(x);
  lo = tf32_rna_bits(x - __uint_as_float(hi));
}

__device__ __forceinline__ void split_tf32(float x, float& hi, float& lo) {
  uint32_t h, l;
  split_tf32_bits(x, h, l);
  hi = __uint_as_float(h);
  lo = __uint_as_float(l);
}

// d += a b on TF32 operands, m16n8k8: a (row g, col t), (g + 8, t), (g, t +
// 4), (g + 8, t + 4); b (row t, col g), (t + 4, g); d (g, 2 t), (g, 2 t +
// 1), (g + 8, 2 t), (g + 8, 2 t + 1), with g = lane / 4, t = lane % 4.
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// hi a hi b + hi a lo b + lo a hi b, the small products first.
__device__ __forceinline__ void mma_split(float (&d)[4], const uint32_t (&ah)[4], const uint32_t (&al)[4], uint32_t bh0,
                                          uint32_t bh1, uint32_t bl0, uint32_t bl1) {
  mma_tf32(d, ah, bl0, bl1);
  mma_tf32(d, al, bh0, bh1);
  mma_tf32(d, ah, bh0, bh1);
}

// D (+)= A B^T on TF32 operands, k = 8 (32 bytes of a 128-byte swizzle row,
// so the descriptors and their k-step of +2 are the bf16 ones).
__device__ __forceinline__ void wgmma_tf32_m64n128k8(float (&d)[64], uint64_t desc_a, uint64_t desc_b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\nwgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 {"
      "%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,%12,%13,%14,%15,%16,%17,%18,%19,"
      "%20,%21,%22,%23,%24,%25,%26,%27,%28,%29,%30,%31,%32,%33,%34,%35,%36,%37,%38,%39,"
      "%40,%41,%42,%43,%44,%45,%46,%47,%48,%49,%50,%51,%52,%53,%54,%55,%56,%57,%58,%59,"
      "%60,%61,%62,%63}, "
      "%64, %65, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(desc_a), "l"(desc_b), "r"(accumulate));
}

__device__ __forceinline__ void wgmma_tf32_m64n96k8(float (&d)[48], uint64_t desc_a, uint64_t desc_b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %50, 0;\nwgmma.mma_async.sync.aligned.m64n96k8.f32.tf32.tf32 {"
      "%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,%12,%13,%14,%15,%16,%17,%18,%19,"
      "%20,%21,%22,%23,%24,%25,%26,%27,%28,%29,%30,%31,%32,%33,%34,%35,%36,%37,%38,%39,"
      "%40,%41,%42,%43,%44,%45,%46,%47}, "
      "%48, %49, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47])
      : "l"(desc_a), "l"(desc_b), "r"(accumulate));
}

template <int BN>
__device__ __forceinline__ void wgmma_tf32_tile(float (&d)[BN / 2], uint64_t desc_a, uint64_t desc_b, int accumulate) {
  if constexpr (BN == 128) {
    wgmma_tf32_m64n128k8(d, desc_a, desc_b, accumulate);
  } else {
    static_assert(BN == 96, "f32 column tiles are 128 or 96 wide");
    wgmma_tf32_m64n96k8(d, desc_a, desc_b, accumulate);
  }
}

// Eight f32 values of a row: a lane's piece of the f32 residual.
struct F32x8 {
  float4 h[2];
};

// The kernels' one argument: the operands' TMA maps and the GEMM.
struct GemmMaps {
  CUtensorMap a_map;  // A (M, K): boxes of kBM rows x one k-tile, 128-byte swizzle
  CUtensorMap w_map;  // W (N, K): boxes of BN rows x one k-tile, 128-byte swizzle
  GemmArgs p;
};

// k-tile depth of T's GEMM: 64 bf16 or 32 floats, one 128-byte swizzle row.
template <typename T>
constexpr int kDepth = std::is_same<T, float>::value ? kFK : kBK;

// T's ring: stages, bytes a stage, W's offset in a stage, and the bytes TMA
// writes into one. An f32 stage also holds A's and W's lo halves, which the
// consumers write.
template <typename T, int BN>
struct GemmRing {
  static constexpr bool kF32 = std::is_same<T, float>::value;
  static constexpr int kStageCount = kF32 ? kF32Stages : kStages;
  static constexpr int kStageBytes = kF32 ? gemm_f32_stage_bytes(BN) : gemm_stage_bytes(BN);
  static constexpr int kWOffset = kF32 ? 2 * kF32ATileBytes : kATileBytes;
  static constexpr int kLoadBytes = kF32 ? kF32ATileBytes + BN * kFK * 4 : kStageBytes;
};

// One skeleton for both GEMMs (see the note at the top): warpgroup 0 is the
// producer (one thread issues the loads), warpgroups 1 and 2 the consumers
// of rows 0 .. 63 and 64 .. 127 of each 128 x BN output tile, a persistent
// grid, the epilogue through shared memory. Only the consumers' k-loop
// differs. bf16: the LayerNorm / mask pass in place, then wgmma m64nBNk16
// into the tile's accumulator. f32: each warpgroup normalises and splits
// its own 64 rows of A and half of W's rows (hi in place, lo beside), a
// barrier of both warpgroups hands the stage to wgmma, and each k-tile's
// products are summed into the accumulator in f32.
template <typename T, bool kNormA, int kEpi, bool kMaskRows, int BN>
__device__ __forceinline__ void gemm_body(const GemmMaps& g) {
  using bf16 = __nv_bfloat16;
  using Ring = GemmRing<T, BN>;
  constexpr bool kF32 = Ring::kF32;
  constexpr int kStageN = Ring::kStageCount, kStageBytes = Ring::kStageBytes;
  constexpr bool kTransformA = kNormA || kMaskRows;
  const GemmArgs& p = g.p;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* smem = smem_raw + (1024 - smem_addr(smem_raw) % 1024) % 1024;  // the swizzle's alignment
  float* epi_buf = reinterpret_cast<float*>(smem + kStageN * kStageBytes);  // [2][64 x kEpiCols]
  float* vec = epi_buf + 2 * 64 * kEpiCols;                                 // [2][bias BN, scale BN]
  uint64_t* full = reinterpret_cast<uint64_t*>(vec + 4 * BN);
  uint64_t* empty = full + kStageN;
  float* ln = reinterpret_cast<float*>(empty + kStageN);  // bf16 kNormA: gamma (K), beta (K)

  const int n_cols = (p.N + BN - 1) / BN;
  const long long n_tiles = (p.M + kBM - 1) / kBM * n_cols;
  const int k_tiles = (p.K + kDepth<T> - 1) / kDepth<T>;
  const int wg = threadIdx.x / kWarpgroup;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStageN; ++s) {
      mbar_init(&full[s], 1);   // the producer's arrive, plus the TMA bytes
      mbar_init(&empty[s], 8);  // one arrive per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {
    setmaxnreg_dec<40>();
    if (threadIdx.x == 0) {
      asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(&g.a_map)) : "memory");
      asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(&g.w_map)) : "memory");
      uint32_t it = 0;  // stage uses so far: stage it % kStageN, round it / kStageN
      for (long long tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
        const int m0 = (int)(tile / n_cols) * kBM, n0 = (int)(tile % n_cols) * BN;
        for (int kt = 0; kt < k_tiles; ++kt, ++it) {
          const int s = it % kStageN;
          mbar_wait(&empty[s], ((it / kStageN) & 1) ^ 1);  // round 0 finds the stage free
          unsigned char* stage = smem + s * kStageBytes;
          mbar_arrive_expect_tx(&full[s], Ring::kLoadBytes);
          tma_load_2d(stage, &g.a_map, &full[s], kt * kDepth<T>, m0);
          tma_load_2d(stage + Ring::kWOffset, &g.w_map, &full[s], kt * kDepth<T>, n0);
        }
      }
    }
  } else {
    setmaxnreg_inc<232>();
    const int ct = threadIdx.x - kWarpgroup;  // consumer thread, 0 .. 255
    const int cw = wg - 1;                    // consumer warpgroup: rows 64 cw .. 64 cw + 63 of a tile
    const int wt = ct % kWarpgroup, warp = wt / 32, lane = wt % 32;
    if constexpr (kNormA && !kF32) {
      for (int k = ct; k < p.K; k += 2 * kWarpgroup) {
        ln[k] = param(p.ln_w, p.param_bf16, k);
        ln[p.K + k] = param(p.ln_b, p.param_bf16, k);
      }
      named_barrier(3, 2 * kWarpgroup);
    }
    // The LayerNorm / mask pass (and in f32 the split): this thread's
    // logical 16-byte piece of each k-tile, in rows tr0 + 16 i (i < 4) of
    // the warpgroup's 64, with each row's statistics and flag loaded a tile
    // ahead.
    const int piece = wt % 8, tr0 = wt / 8;
    float2 stat[4], next_stat[4];
    bool reads[4], next_reads[4];
    auto load_rows = [&](long long tile, float2(&st)[4], bool(&ok)[4]) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const long long r = tile / n_cols * kBM + 64 * cw + tr0 + 16 * i;
        // M < 2^31 here, so the flag's index is taken in 32 bits (a 64-bit
        // remainder is a call, whose saved registers spill)
        ok[i] = r < p.M && (!kMaskRows || p.row_valid[(unsigned)r % (unsigned)p.valid_period] != 0);
        st[i] = kNormA && ok[i] ? p.stats[r] : make_float2(0.f, 0.f);
      }
    };
    if constexpr (kTransformA) load_rows(blockIdx.x, stat, reads);
    // the epilogue's columns c = wt + 128 j of the tile: bias and scale
    constexpr int kVec = (BN + kWarpgroup - 1) / kWarpgroup;
    float* sv = vec + cw * 2 * BN;  // [bias BN, scale BN] of the tile, in f32
    float* buf = epi_buf + cw * 64 * kEpiCols;
    T* out = static_cast<T*>(p.out);
    const T* residual = static_cast<const T*>(p.residual);
    // this warpgroup's residual rows into L2 from four k-tiles before the
    // tile's end (earlier, the operand stream evicts them): one 128-byte
    // line of kLine columns a request
    constexpr int kLine = 128 / (int)sizeof(T);
    auto prefetch_residual = [&](int kt, long long m0, int n0) {
      if constexpr (kEpi == kBiasResidual) {
        if (kt == (k_tiles > 4 ? k_tiles - 4 : 0)) {
          for (int j = wt / 64; j * kLine < BN; j += 2) {
            const long long r = m0 + 64 * cw + wt % 64;
            const int n = n0 + kLine * j;
            if (r < p.M && n < p.N) asm volatile("prefetch.global.L2 [%0];\n" ::"l"(residual + r * p.N + n));
          }
        }
      }
    };
    float acc[BN / 2];
    if constexpr (!kF32) {
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
    }
    uint32_t it = 0;
    for (long long tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
      const long long m0 = tile / n_cols * kBM;
      const int n0 = (int)(tile % n_cols) * BN;
      float bias_c[kVec], scale_c[kVec];
#pragma unroll
      for (int j = 0; j < kVec; ++j) {
        const int c = wt + kWarpgroup * j, n = n0 + c;
        const bool ok = c < BN && n < p.N;
        bias_c[j] = ok ? param(p.bias, p.param_bf16, n) : 0.f;
        scale_c[j] = ok && kEpi == kBiasResidual && p.scale ? param(p.scale, p.param_bf16, n) : 1.f;
      }

      if constexpr (kF32) {
        constexpr int kWBytes = BN * kFK * 4;
        // Stage use u (k-tile kt) made ready for wgmma: A rows past M and k
        // past K arrived as zeros (their products meet zero rows of W or are
        // not stored); a masked row becomes zeros; the others are normalised
        // (gamma and beta read from L1); then every value of this
        // warpgroup's A rows and half of W's rows is split, hi in place and
        // lo `lo_at` bytes further. Ends with the fence that orders these
        // writes before wgmma's reads; the caller then waits at barrier 3 for
        // the other warpgroup's half of W.
        auto split_piece = [](float4* at, int lo_at, float4 x) {
          float4 hi, lo;
          split_tf32(x.x, hi.x, lo.x);
          split_tf32(x.y, hi.y, lo.y);
          split_tf32(x.z, hi.z, lo.z);
          split_tf32(x.w, hi.w, lo.w);
          *at = hi;
          *reinterpret_cast<float4*>(reinterpret_cast<unsigned char*>(at) + lo_at) = lo;
        };
        auto prepare = [&](uint32_t u, int kt) {
          const int s = u % kStageN;
          mbar_wait(&full[s], (u / kStageN) & 1);
          unsigned char* stage = smem + s * kStageBytes;
          unsigned char* a_tile = stage + cw * 64 * 128;  // this warpgroup's 64 rows, 1024-byte aligned
          unsigned char* w_tile = stage + Ring::kWOffset;
          const int k = kt * kFK + 4 * piece;
          float4 gam = make_float4(1.f, 1.f, 1.f, 1.f), bet = make_float4(0.f, 0.f, 0.f, 0.f);
          if (kNormA && k < p.K) {  // K % 4 == 0: the piece is wholly in or out
            gam = make_float4(param(p.ln_w, p.param_bf16, k), param(p.ln_w, p.param_bf16, k + 1),
                              param(p.ln_w, p.param_bf16, k + 2), param(p.ln_w, p.param_bf16, k + 3));
            bet = make_float4(param(p.ln_b, p.param_bf16, k), param(p.ln_b, p.param_bf16, k + 1),
                              param(p.ln_b, p.param_bf16, k + 2), param(p.ln_b, p.param_bf16, k + 3));
          }
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int tr = tr0 + 16 * i;
            float4* at = reinterpret_cast<float4*>(a_tile + tr * 128) + (piece ^ (tr % 8));
            float4 x = *at;
            if (kMaskRows && !reads[i]) {
              x = make_float4(0.f, 0.f, 0.f, 0.f);
            } else if (kNormA) {
              const float mean = stat[i].x, rstd = stat[i].y;
              x = make_float4((x.x - mean) * rstd * gam.x + bet.x, (x.y - mean) * rstd * gam.y + bet.y,
                              (x.z - mean) * rstd * gam.z + bet.z, (x.w - mean) * rstd * gam.w + bet.w);
            }
            split_piece(at, kF32ATileBytes, x);
          }
#pragma unroll
          for (int i = 0; i < BN / 32; ++i) {
            const int tr = cw * (BN / 2) + tr0 + 16 * i;
            float4* at = reinterpret_cast<float4*>(w_tile + tr * 128) + (piece ^ (tr % 8));
            split_piece(at, kWBytes, *at);
          }
          asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");  // generic writes, then wgmma's reads
        };
        // One k-tile's products (part): the tensor cores add each product
        // into their accumulator rounding toward zero, an error of up to a
        // unit of the running sum each time, so each k-tile's products start
        // from zero and are added to acc in f32 (round to nearest). Over K =
        // 3072 in one accumulator that bias reached 1e-4.
        float part[BN / 2];
#pragma unroll
        for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
        // k-tile kt's products run while the warpgroup prepares k-tile kt + 1
        prepare(it, 0);
        named_barrier(3, 2 * kWarpgroup);  // both halves of W are split
        for (int kt = 0; kt < k_tiles; ++kt, ++it) {
          prefetch_residual(kt, m0, n0);
          unsigned char* stage = smem + (it % kStageN) * kStageBytes;
          unsigned char* a_tile = stage + cw * 64 * 128;
          unsigned char* w_tile = stage + Ring::kWOffset;
          const uint64_t da = sw128_desc(a_tile), da_lo = sw128_desc(a_tile + kF32ATileBytes);
          const uint64_t dw = sw128_desc(w_tile), dw_lo = sw128_desc(w_tile + kWBytes);
          fence_accumulator(part);
          wgmma_fence();
#pragma unroll
          for (int ks = 0; ks < kFK / 8; ++ks) {
            // the two small products first, then hi hi
            wgmma_tf32_tile<BN>(part, da + 2 * ks, dw_lo + 2 * ks, ks > 0);
            wgmma_tf32_tile<BN>(part, da_lo + 2 * ks, dw + 2 * ks, 1);
            wgmma_tf32_tile<BN>(part, da + 2 * ks, dw + 2 * ks, 1);
          }
          wgmma_commit();
          fence_accumulator(part);
          if (kt + 1 < k_tiles) prepare(it + 1, kt + 1);
          wgmma_wait<0>();
          fence_accumulator(part);
#pragma unroll
          for (int i = 0; i < BN / 2; ++i) acc[i] += part[i];
          if (lane == 0) mbar_arrive(&empty[it % kStageN]);  // this stage's products are done: release it
          if (kt + 1 < k_tiles) named_barrier(3, 2 * kWarpgroup);
        }
      } else {
        for (int kt = 0; kt < k_tiles; ++kt, ++it) {
          prefetch_residual(kt, m0, n0);
          const int s = it % kStageN;
          mbar_wait(&full[s], (it / kStageN) & 1);
          unsigned char* stage = smem + s * kStageBytes;
          unsigned char* a_tile = stage + cw * 64 * 128;  // this warpgroup's 64 rows, 1024-byte aligned
          if constexpr (kTransformA) {
            // rows past M and k past K arrived as zeros and stay so; a masked
            // row becomes zeros; the others are normalised in place
            const int k = kt * kBK + 8 * piece;
            float gam[8], bet[8];
            if (kNormA && k < p.K) {
              const float4* gp = reinterpret_cast<const float4*>(ln + k);
              const float4* bp = reinterpret_cast<const float4*>(ln + p.K + k);
              const float4 g0 = gp[0], g1 = gp[1], b0 = bp[0], b1 = bp[1];
              gam[0] = g0.x, gam[1] = g0.y, gam[2] = g0.z, gam[3] = g0.w;
              gam[4] = g1.x, gam[5] = g1.y, gam[6] = g1.z, gam[7] = g1.w;
              bet[0] = b0.x, bet[1] = b0.y, bet[2] = b0.z, bet[3] = b0.w;
              bet[4] = b1.x, bet[5] = b1.y, bet[6] = b1.z, bet[7] = b1.w;
            }
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              const int tr = tr0 + 16 * i;
              uint4* dst = reinterpret_cast<uint4*>(a_tile + tr * 128) + (piece ^ (tr % 8));
              if (!reads[i]) {
                if (m0 + 64 * cw + tr < p.M) *dst = make_uint4(0u, 0u, 0u, 0u);
              } else if (kNormA && k < p.K) {
                uint4 raw = *dst;
                bf16* v = reinterpret_cast<bf16*>(&raw);
#pragma unroll
                for (int e = 0; e < 8; ++e)
                  v[e] = __float2bfloat16((__bfloat162float(v[e]) - stat[i].x) * stat[i].y * gam[e] + bet[e]);
                *dst = raw;
              }
            }
            asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");  // generic writes, then wgmma's reads
            named_barrier(1 + cw, kWarpgroup);
          }
          const uint64_t da = sw128_desc(a_tile), db = sw128_desc(stage + kATileBytes);
          fence_accumulator(acc);
          wgmma_fence();
#pragma unroll
          for (int ks = 0; ks < kBK / 16; ++ks) wgmma_tile<BN>(acc, da + 2 * ks, db + 2 * ks, kt > 0 || ks > 0);
          wgmma_commit();
          fence_accumulator(acc);
          wgmma_wait<1>();  // the previous stage's products are done: release it
          if (kt > 0 && lane == 0) mbar_arrive(&empty[(it - 1) % kStageN]);
        }
        wgmma_wait<0>();
        fence_accumulator(acc);
        if (lane == 0) mbar_arrive(&empty[(it - 1) % kStageN]);
      }
      if constexpr (kTransformA) {
        if (tile + gridDim.x < n_tiles) load_rows(tile + gridDim.x, next_stat, next_reads);
      }

      // Epilogue. The tile's bias and scale into shared memory (every warp is
      // past the previous tile's epilogue), then each warp passes its own 16
      // rows through the buffer 32 columns at a time: float2 writes in the
      // accumulator layout, then 8 consecutive columns of a row a lane,
      // finished with 16-byte residual reads and output writes (one in bf16,
      // two in f32). The next chunk's residual is read while this one is
      // finished.
      const int cg = lane % 4;
      using Residual8 = typename std::conditional<kF32, F32x8, uint4>::type;
      Residual8 res[2][2] = {};
      auto load_residual = [&](int ch, Residual8(&dst)[2]) {
#pragma unroll
        for (int q = 0; q < 2; ++q) {
          const long long r = m0 + 64 * cw + 16 * warp + lane / 4 + 8 * q;
          const int n = n0 + ch * kEpiCols + 8 * cg;
          if constexpr (kF32) {
#pragma unroll
            for (int h = 0; h < 2; ++h)  // N % 4 == 0: each half wholly in or out
              if (r < p.M && n + 4 * h < p.N) dst[q].h[h] = *reinterpret_cast<const float4*>(residual + r * p.N + n + 4 * h);
          } else {
            if (r < p.M && n < p.N) dst[q] = *reinterpret_cast<const uint4*>(residual + r * p.N + n);
          }
        }
      };
      if constexpr (kEpi == kBiasResidual) load_residual(0, res[0]);
      named_barrier(1 + cw, kWarpgroup);
#pragma unroll
      for (int j = 0; j < kVec; ++j) {
        const int c = wt + kWarpgroup * j;
        if (c < BN) {
          sv[c] = bias_c[j];
          sv[BN + c] = scale_c[j];
        }
      }
      named_barrier(1 + cw, kWarpgroup);
#pragma unroll
      for (int ch = 0; ch < BN / kEpiCols; ++ch) {
#pragma unroll
        for (int j = 0; j < kEpiCols / 8; ++j) {
          const int J = ch * (kEpiCols / 8) + j, col = 8 * j + 2 * (lane % 4);
#pragma unroll
          for (int h = 0; h < 2; ++h)
            *reinterpret_cast<float2*>(buf + epi_index(16 * warp + lane / 4 + 8 * h, col)) =
                make_float2(acc[4 * J + 2 * h], acc[4 * J + 2 * h + 1]);
        }
        __syncwarp();
        if constexpr (kEpi == kBiasResidual) {
          if (ch + 1 < BN / kEpiCols) load_residual(ch + 1, res[(ch + 1) % 2]);
        }
#pragma unroll
        for (int q = 0; q < 2; ++q) {
          const int br = 16 * warp + lane / 4 + 8 * q, c = ch * kEpiCols + 8 * cg;
          const long long r = m0 + 64 * cw + br;
          const int n = n0 + c;
          if constexpr (kF32) {
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              if (r < p.M && n + 4 * h < p.N) {
                const float4 a = *reinterpret_cast<const float4*>(buf + epi_index(br, 8 * cg + 4 * h));
                const float4 b = *reinterpret_cast<const float4*>(sv + c + 4 * h);
                float4 sc = make_float4(1.f, 1.f, 1.f, 1.f), rr = make_float4(0.f, 0.f, 0.f, 0.f);
                if constexpr (kEpi == kBiasResidual) {
                  sc = *reinterpret_cast<const float4*>(sv + BN + c + 4 * h);
                  rr = res[ch % 2][q].h[h];
                }
                *reinterpret_cast<float4*>(out + r * p.N + n + 4 * h) =
                    make_float4(finish<T, kEpi>(a.x, b.x, sc.x, rr.x), finish<T, kEpi>(a.y, b.y, sc.y, rr.y),
                                finish<T, kEpi>(a.z, b.z, sc.z, rr.z), finish<T, kEpi>(a.w, b.w, sc.w, rr.w));
              }
            }
          } else if (r < p.M && n < p.N) {  // N % 8 == 0: the 8 columns are wholly in or out
            const float4 a0 = *reinterpret_cast<const float4*>(buf + epi_index(br, 8 * cg));
            const float4 a1 = *reinterpret_cast<const float4*>(buf + epi_index(br, 8 * cg + 4));
            const float4 b0 = *reinterpret_cast<const float4*>(sv + c);
            const float4 b1 = *reinterpret_cast<const float4*>(sv + c + 4);
            const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
            const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
            float sc[8] = {1.f, 1.f, 1.f, 1.f, 1.f, 1.f, 1.f, 1.f}, rr[8] = {};
            if constexpr (kEpi == kBiasResidual) {
              const float4 s0 = *reinterpret_cast<const float4*>(sv + BN + c);
              const float4 s1 = *reinterpret_cast<const float4*>(sv + BN + c + 4);
              const float s[8] = {s0.x, s0.y, s0.z, s0.w, s1.x, s1.y, s1.z, s1.w};
              const bf16* rv = reinterpret_cast<const bf16*>(&res[ch % 2][q]);
#pragma unroll
              for (int u = 0; u < 8; ++u) {
                sc[u] = s[u];
                rr[u] = __bfloat162float(rv[u]);
              }
            }
            uint4 packed;
            __nv_bfloat162* o = reinterpret_cast<__nv_bfloat162*>(&packed);
#pragma unroll
            for (int u = 0; u < 4; ++u)
              o[u] = __floats2bfloat162_rn(finish<T, kEpi>(a[2 * u], b[2 * u], sc[2 * u], rr[2 * u]),
                                           finish<T, kEpi>(a[2 * u + 1], b[2 * u + 1], sc[2 * u + 1],
                                                           rr[2 * u + 1]));
            *reinterpret_cast<uint4*>(out + r * p.N + n) = packed;
          }
        }
        __syncwarp();  // this warp's rows of the buffer are free again
      }
      if constexpr (kTransformA) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          stat[i] = next_stat[i];
          reads[i] = next_reads[i];
        }
      }
    }
  }
}

// The two GEMMs, named apart for ptxas's report and the profiler.
template <bool kNormA, int kEpi, bool kMaskRows, int BN>
__global__ void __launch_bounds__(kBf16Threads, 1) gemm_bf16_kernel(const __grid_constant__ GemmMaps g) {
  gemm_body<__nv_bfloat16, kNormA, kEpi, kMaskRows, BN>(g);
}

template <bool kNormA, int kEpi, bool kMaskRows, int BN>
__global__ void __launch_bounds__(kBf16Threads, 1) gemm_f32_kernel(const __grid_constant__ GemmMaps g) {
  gemm_body<float, kNormA, kEpi, kMaskRows, BN>(g);
}

// cuTensorMapEncodeTiled, fetched from the driver through the runtime once
// (the library links no libcuda); null where the driver lacks it.
PFN_cuTensorMapEncodeTiled_v12000 encode_tiled() {
  static const PFN_cuTensorMapEncodeTiled_v12000 fn = []() -> PFN_cuTensorMapEncodeTiled_v12000 {
    void* f = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &f, 12000, cudaEnableDefault, &found) !=
            cudaSuccess ||
        found != cudaDriverEntryPointSuccess)
      return nullptr;
    return reinterpret_cast<PFN_cuTensorMapEncodeTiled_v12000>(f);
  }();
  return fn;
}

// TMA map of a (rows, K) matrix of T, k contiguous, read in boxes of
// box_rows x one k-tile (a 128-byte swizzle row); rows and k past the edges
// read as zeros. swin_block.cu maps its bf16 weights with it.
template <typename T = __nv_bfloat16>
cudaError_t encode_operand(CUtensorMap* map, const void* base, long long rows, int K, int box_rows) {
  const PFN_cuTensorMapEncodeTiled_v12000 encode = encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[2] = {(cuuint64_t)K, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)K * sizeof(T)};
  const cuuint32_t box[2] = {(cuuint32_t)kDepth<T>, (cuuint32_t)box_rows};
  const cuuint32_t element_strides[2] = {1, 1};
  const CUtensorMapDataType type =
      std::is_same<T, float>::value ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  const CUresult r = encode(map, type, 2, const_cast<void*>(base), dims, strides, box, element_strides,
                            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                            CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// Column tile of the bf16 GEMM: the widest of 256, 128 and 96 that pads N
// least and whose shared memory (with the LayerNorm vectors under kNormA)
// fits one block; 0 if none does.
int gemm_tile_n(int N, int K, bool norm_a) {
  const int widths[3] = {256, 128, 96};
  int best = 0;
  long long best_padded = 0;
  for (int bn : widths) {
    const long long padded = (long long)(N + bn - 1) / bn * bn;
    if (gemm_smem_bytes(bn) + (norm_a ? 8LL * K : 0) > kMaxSmemBytes) continue;
    if (best == 0 || padded < best_padded) {
      best = bn;
      best_padded = padded;
    }
  }
  return best;
}

template <typename T, bool kNormA, int kEpi, bool kMaskRows, int BN>
cudaError_t launch_gemm_tiles(const GemmArgs& p, cudaStream_t stream) {
  constexpr bool kF32 = std::is_same<T, float>::value;
  GemmMaps g;
  g.p = p;
  cudaError_t err = encode_operand<T>(&g.a_map, p.a, p.M, p.K, kBM);
  if (err == cudaSuccess) err = encode_operand<T>(&g.w_map, p.w, p.N, p.K, BN);
  if (err != cudaSuccess) return err;
  const int smem = kF32 ? gemm_f32_smem_bytes(BN) : gemm_smem_bytes(BN) + (kNormA ? 8 * p.K : 0);
  void (*kernel)(GemmMaps);
  if constexpr (kF32) {
    kernel = gemm_f32_kernel<kNormA, kEpi, kMaskRows, BN>;
  } else {
    kernel = gemm_bf16_kernel<kNormA, kEpi, kMaskRows, BN>;
  }
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  int device = 0, sms = 0;
  err = cudaGetDevice(&device);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  const long long tiles = (p.M + kBM - 1) / kBM * ((p.N + BN - 1) / BN);
  const unsigned grid = (unsigned)(tiles < sms ? tiles : sms);  // persistent: one block per SM
  kernel<<<grid, kBf16Threads, smem, stream>>>(g);
  return cudaGetLastError();
}

template <typename T, bool kNormA, int kEpi, bool kMaskRows = false>
cudaError_t launch_gemm(const GemmArgs& p, cudaStream_t stream) {
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    if (p.M > INT_MAX) return cudaErrorInvalidValue;  // TMA coordinates are 32-bit
    switch (gemm_tile_n(p.N, p.K, kNormA)) {
      case 256: return launch_gemm_tiles<T, kNormA, kEpi, kMaskRows, 256>(p, stream);
      case 128: return launch_gemm_tiles<T, kNormA, kEpi, kMaskRows, 128>(p, stream);
      case 96: return launch_gemm_tiles<T, kNormA, kEpi, kMaskRows, 96>(p, stream);
      default: return cudaErrorInvalidValue;  // kNormA with a K whose LayerNorm vectors do not fit
    }
  } else {
    // TMA coordinates are 32-bit, and its rows 16-byte multiples; the
    // epilogue writes 16-byte pieces
    if (p.M > INT_MAX || p.K % 4 != 0 || p.N % 4 != 0) return cudaErrorInvalidValue;
    // 96-wide tiles where they pad N less than 128-wide ones (N = 96, 192)
    const bool narrow = (long long)(p.N + 95) / 96 * 96 < (long long)(p.N + 127) / 128 * 128;
    return narrow ? launch_gemm_tiles<T, kNormA, kEpi, kMaskRows, 96>(p, stream)
                  : launch_gemm_tiles<T, kNormA, kEpi, kMaskRows, 128>(p, stream);
  }
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

}  // namespace
