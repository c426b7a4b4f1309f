// Scaled dot-product attention with a compact additive bias.
//
// Replaces the Pallas TPU kernels _attn_kernel and the kernel4 closure
// (eqxvision_tpu/ops/attention.py, launched from _attention_pallas) behind
// the public ops.attention. It computes what _attn_compute computes there:
//
//   q, k, v (B, N, Dh); bias (Bb, N, N) with B % Bb == 0, or none
//   out[b, i] = softmax(q_i . K_b^T * scale + bias[b % Bb, i]) . V_b
//
// with the scores, the bias and the softmax in f32, the probabilities
// rounded to v's type before p.V, p.V accumulated in f32 and the output
// stored in q's type. The compact bias is read through its own index,
// b % Bb, and never broadcast into a (B, N, N) copy: that reuse over batch
// repeats is what kernel4 was for. The TPU kernels pad N to the sublane
// and mask the padded keys; here the ragged tail is masked in the kernel
// and nothing is padded in device memory.
//
// Design. Two kernels, chosen from dtype and shape:
// - bf16 with N <= 64 and a head dim that is a multiple of 16 (at most 64):
//   one block of 8 warps per row b on the tensor cores. The block stages
//   q|k|v of row b in shared memory (rows past N zero) and runs the head
//   attention of tensor_core_attention.cuh (S = Q K^T and O = P V with
//   mma.sync, the softmax by one warp per row between them). At swin_t's
//   49-token rows this beats the attention stage, whose 256-key blocks
//   would waste three quarters of their products.
// - otherwise: the attention stage of attention_stage.cuh, the one K1 and
//   the ViT attention half run, on separate q, k, v maps with one head a
//   row (H = 1, D = Dh) and the compact bias: bf16 with Dh a multiple of
//   16 on TMA-fed wgmma (one pass at N <= 256, two beyond, K and V resident
//   where they fit, else loaded block by block); bf16 with other head dims
//   on its CUDA-core stage in two passes over 64-key chunks; f32 on its
//   f32 stage, split TF32 on mma.sync in one pass. All take any N.
//
// What bounds it. It must read q, k, v and the compact bias once and write
// the output once. At swin_t stage 1 through this op (B = 24,576, N = 49,
// Dh = 32, bf16, Bb = 192) that is 0.31 GB, 0.093 ms at 3.35 TB/s, against
// 9.4 GFLOP (0.01 ms on the tensor cores); at vit_base b256 (B = 3,072,
// N = 197, Dh = 64, bf16) 0.31 GB and 0.093 ms against 30.5 GFLOP (0.03
// ms), and its (12, 197, 197) relative-position bias adds 1.9 MB. All are
// bound by device memory; the stage's note says what holds it back.
// Limits: head_dim <= 128, and in bf16 q, k, v and out 16-byte aligned (the
// wrapper copies them there); the entry point returns cudaErrorInvalidValue
// otherwise.

#include "attention_stage.cuh"

namespace {

// bf16 rows of at most 64 tokens with a head dim that is a multiple of 16,
// at most 64: the short-row mma.sync kernel.
bool short_rows(int dtype, int seq_len, int head_dim) {
  return dtype == 1 && seq_len <= eqx_tc::kRows && head_dim % 16 == 0 && head_dim <= 64;
}

// The kernel eqx_attention takes (in bf16 at a scale other than 0): 1 the
// short-row kernel, 2 the attention stage's wgmma kernel, 0 its CUDA-core
// kernel; 3 the stage's f32 kernel (split TF32 on mma.sync, one pass).
enum Path { kStageFma = 0, kShortRows = 1, kStageWgmma = 2, kStageF32 = 3 };
Path attention_path(int dtype, int seq_len, int head_dim) {
  if (dtype == 0) return kStageF32;
  if (short_rows(dtype, seq_len, head_dim)) return kShortRows;
  return stage_uses_wgmma(true, head_dim) ? kStageWgmma : kStageFma;
}

// Row stride of the staged q|k|v: 3 * Dh + 2 elements, an odd number of
// 32-bit words for head dims that are multiples of 16.
__host__ __device__ __forceinline__ int qkv_stride(int head_dim) { return 3 * head_dim + 2; }

size_t smem_bytes_mma(int head_dim) {
  return (size_t)eqx_tc::kRows * qkv_stride(head_dim) * sizeof(__nv_bfloat16)  // q|k|v
         + (size_t)eqx_tc::kRows * eqx_tc::kSs * sizeof(float)                // scores, then p
         + 2 * (size_t)eqx_tc::kRows * sizeof(float);                         // unit row scales of q and k
}

__global__ void __launch_bounds__(eqx_tc::kThreads)
    attention_mma_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                         const __nv_bfloat16* __restrict__ v, const float* __restrict__ bias,
                         __nv_bfloat16* __restrict__ out, int n_bias, int seq_len, int head_dim, float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int L = seq_len, Dh = head_dim, sq = qkv_stride(Dh);
  __nv_bfloat16* qkvh = reinterpret_cast<__nv_bfloat16*>(smem);
  float* s_buf = reinterpret_cast<float*>(smem + (size_t)eqx_tc::kRows * sq * sizeof(__nv_bfloat16));
  float* ones = s_buf + eqx_tc::kRows * eqx_tc::kSs;

  const long long b = blockIdx.x;
  const long long base = b * L * Dh;
  const __nv_bfloat16* src[3] = {q + base, k + base, v + base};
  const int pairs = 3 * Dh / 2;  // 32-bit pieces of a row's q|k|v
  for (int e = threadIdx.x; e < eqx_tc::kRows * pairs; e += eqx_tc::kThreads) {
    const int r = e / pairs, c = (e % pairs) * 2;
    const uint32_t val = r < L ? eqx_tc::ld32(src[c / Dh] + r * Dh + c % Dh) : 0u;
    *reinterpret_cast<uint32_t*>(qkvh + r * sq + c) = val;
  }
  for (int r = threadIdx.x; r < 2 * eqx_tc::kRows; r += eqx_tc::kThreads) ones[r] = 1.f;
  __syncthreads();
  eqx_tc::attention_head_mma(qkvh, sq, Dh, L, ones, ones + eqx_tc::kRows, scale,
                             bias == nullptr ? nullptr : bias + (b % n_bias) * L * L, s_buf, out + base, Dh);
}

cudaError_t launch_mma(const void* q, const void* k, const void* v, const float* bias, void* out, int batch,
                       int n_bias, int seq_len, int head_dim, float scale, cudaStream_t stream) {
  const size_t smem = smem_bytes_mma(head_dim);
  cudaError_t err =
      cudaFuncSetAttribute(attention_mma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  attention_mma_kernel<<<batch, eqx_tc::kThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), bias, static_cast<__nv_bfloat16*>(out), n_bias, seq_len, head_dim,
      scale);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. q, k, v and out (batch, seq_len,
// head_dim), in bf16 16-byte aligned; bias (n_bias, seq_len, bias_ld) f32
// with batch % n_bias == 0 and the row stride and room after it that
// eqx_attention_bias_layout gives, or null; all contiguous on the current
// device. Launches on `stream` and returns the cudaError_t of the launch.
int eqx_attention(const void* q, const void* k, const void* v, const void* bias, int bias_ld, void* out, int batch,
                  int n_bias, int seq_len, int head_dim, float scale, int dtype, void* stream) {
  if (q == nullptr || k == nullptr || v == nullptr || out == nullptr || batch <= 0 || n_bias <= 0 ||
      batch % n_bias != 0 || seq_len <= 0 || head_dim <= 0 || head_dim > kStageMaxHeadDim)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* b = static_cast<const float*>(bias);
  if (dtype == 0)
    return launch_attention_stage_qkv<float>(q, k, v, b, n_bias, bias_ld, out, batch, seq_len, head_dim, scale, s);
  if (dtype != 1) return cudaErrorInvalidValue;
  if (!aligned16(q) || !aligned16(k) || !aligned16(v) || !aligned16(out)) return cudaErrorInvalidValue;
  if (attention_path(dtype, seq_len, head_dim) == kShortRows) {
    if (b != nullptr && bias_ld != seq_len) return cudaErrorInvalidValue;
    return launch_mma(q, k, v, b, out, batch, n_bias, seq_len, head_dim, scale, s);
  }
  return launch_attention_stage_qkv<bf16>(q, k, v, b, n_bias, bias_ld, out, batch, seq_len, head_dim, scale, s);
}

// The kernel eqx_attention takes at (seq_len, head_dim, dtype), with or
// without a bias: out[0] its Path; for the wgmma stage out[1..5] as
// eqx_fused_qkv_attention_config's out[0..4] (blocks an SM, shared memory
// a block, key rows of K and V, one pass, K and V resident), else zeros.
// Returns a cudaError_t.
int eqx_attention_config(int seq_len, int head_dim, int dtype, int with_bias, int* out) {
  if (seq_len <= 0 || head_dim <= 0 || head_dim > kStageMaxHeadDim || dtype < 0 || dtype > 1)
    return cudaErrorInvalidValue;
  for (int i = 0; i < 6; ++i) out[i] = 0;
  out[0] = attention_path(dtype, seq_len, head_dim);
  if (out[0] != kStageWgmma) return cudaSuccess;
  return with_bias ? attention_stage_config<true>(seq_len, head_dim, out + 1)
                   : attention_stage_config<false>(seq_len, head_dim, out + 1);
}

// The bias layout eqx_attention takes at (seq_len, head_dim, dtype):
// out[0] the row stride in floats, out[1] the floats past the bias's end
// that it may read (and then masks). The wgmma stage reads a row's keys in
// pairs, as float2, and on past its end: seq_len rounded up to even, 256;
// the other kernels read the compact bias inside its bounds: seq_len, 0.
void eqx_attention_bias_layout(int seq_len, int head_dim, int dtype, int* out) {
  const bool wgmma = attention_path(dtype, seq_len, head_dim) == kStageWgmma;
  out[0] = wgmma ? (seq_len + 1) / 2 * 2 : seq_len;
  out[1] = wgmma ? kStageBiasSlack : 0;
}

// Dynamic shared memory one block of the kernel eqx_attention takes needs;
// for error messages.
long long eqx_attention_smem_bytes(int seq_len, int head_dim, int elem_bytes) {
  if (attention_path(elem_bytes == 2 ? 1 : 0, seq_len, head_dim) == kShortRows)
    return (long long)smem_bytes_mma(head_dim);
  return attention_stage_smem_bytes(seq_len, head_dim, elem_bytes == 2);
}

}  // extern "C"
