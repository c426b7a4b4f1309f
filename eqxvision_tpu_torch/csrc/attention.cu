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
// Design. Two stages, chosen from dtype and shape (attention_path):
// - rows of at most 64 tokens, bf16 with a head dim of 16, 32, 48 or 64 and
//   f32 with 16 or 32: the window stage of window_attention.cu (declared in
//   window_stage.h), which K3/K4 run, as one head a window: q, k and v read
//   through three TMA maps of their own (Dh, N, B), row b's tile reading
//   bias slab b % Bb (the stage's (w % n_windows) % n_bias with n_windows
//   = n_bias = Bb), or no slab without a bias. Persistent one-warpgroup
//   blocks each walk a contiguous run of rows in slab-major order (one or
//   two slab copies a block at swin_t stage 1's 192 slabs, where K3's
//   strided walk copies one almost every tile), each row's q, k and v on a
//   TMA ring, the slab in shared memory; bf16 S and P V on
//   wgmma with the softmax in the accumulators, f32 by split TF32 on
//   mma.sync. A bf16 bias with a scale whose reciprocal is not finite (the
//   stage adds bias / scale) goes to the attention stage's CUDA-core
//   kernel.
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
#include "window_stage.h"

namespace {

// The kernel eqx_attention takes: 1 the bf16 window stage, 4 the f32
// window stage; else the attention stage's kernels, 2 its wgmma kernel (in
// bf16 at a scale other than 0), 0 its CUDA-core kernel, 3 its f32 kernel
// (split TF32 on mma.sync, one pass).
enum Path { kStageFma = 0, kWindowStage = 1, kStageWgmma = 2, kStageF32 = 3, kWindowStageF32 = 4 };
Path attention_path(int dtype, int seq_len, int head_dim, bool aligned, bool bias, float scale) {
  if (eqx_window::stage_takes(dtype, seq_len, head_dim, aligned, false, bias, scale))
    return dtype == 0 ? kWindowStageF32 : kWindowStage;
  if (dtype == 0) return kStageF32;
  return stage_uses_wgmma(true, head_dim) ? kStageWgmma : kStageFma;
}

// The path at the default scale, 1 / sqrt(head_dim).
Path default_path(int dtype, int seq_len, int head_dim, bool bias) {
  return attention_path(dtype, seq_len, head_dim, true, bias, 1.f / sqrtf((float)head_dim));
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
      batch % n_bias != 0 || seq_len <= 0 || head_dim <= 0 || head_dim > kStageMaxHeadDim || dtype < 0 || dtype > 1)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* b = static_cast<const float*>(bias);
  const bool aligned = aligned16(q) && aligned16(k) && aligned16(v) && aligned16(out);
  const Path path = attention_path(dtype, seq_len, head_dim, aligned, b != nullptr, scale);
  if (path == kWindowStage || path == kWindowStageF32) {  // one head a window, row b reading slab b % Bb
    if (b != nullptr && bias_ld != seq_len) return cudaErrorInvalidValue;
    eqx_window::Operands op = {};
    op.src[0] = q;
    op.src[1] = k;
    op.src[2] = v;
    op.ld = head_dim;
    op.cols = head_dim;
    op.out = out;
    op.bias = b;
    op.windows = batch;
    op.n_windows = n_bias;
    op.n_bias = n_bias;
    op.seq_len = seq_len;
    op.num_heads = 1;
    op.head_dim = head_dim;
    op.scale = scale;
    op.slab_walk = true;
    return eqx_window::launch_stage(op, dtype, s);
  }
  if (dtype == 0)
    return launch_attention_stage_qkv<float>(q, k, v, b, n_bias, bias_ld, out, batch, seq_len, head_dim, scale, s);
  if (!aligned) return cudaErrorInvalidValue;
  return launch_attention_stage_qkv<bf16>(q, k, v, b, n_bias, bias_ld, out, batch, seq_len, head_dim, scale, s);
}

// The kernel eqx_attention takes at (seq_len, head_dim, dtype), with or
// without a bias, for `batch` rows, 16-byte aligned tensors and a scale of
// 1 / sqrt(head_dim): out[0] its Path; for the window stage out[1..4] as
// eqx_window_attention_config's out[1..4] (blocks an SM, shared memory a
// block, blocks launched, ring stages); for the wgmma stage out[1..5] as
// eqx_fused_qkv_attention_config's out[0..4] (blocks an SM, shared memory
// a block, key rows of K and V, one pass, K and V resident); else zeros.
// Returns a cudaError_t.
int eqx_attention_config(int seq_len, int head_dim, int dtype, int with_bias, long long batch, int* out) {
  if (seq_len <= 0 || head_dim <= 0 || head_dim > kStageMaxHeadDim || dtype < 0 || dtype > 1 || batch <= 0)
    return cudaErrorInvalidValue;
  for (int i = 0; i < 6; ++i) out[i] = 0;
  out[0] = default_path(dtype, seq_len, head_dim, with_bias != 0);
  if (out[0] == kWindowStage || out[0] == kWindowStageF32)
    return eqx_window::stage_config(dtype, head_dim, true, false, with_bias != 0, batch, out + 1);
  if (out[0] != kStageWgmma) return cudaSuccess;
  return with_bias ? attention_stage_config<true>(seq_len, head_dim, out + 1)
                   : attention_stage_config<false>(seq_len, head_dim, out + 1);
}

// The bias layout eqx_attention takes at (seq_len, head_dim, dtype):
// out[0] the row stride in floats, out[1] the floats past the bias's end
// that it may read (and then masks). The wgmma stage reads a row's keys in
// pairs, as float2, and on past its end: seq_len rounded up to even, 256;
// the other kernels, the window stage among them (it copies a row's slab
// from inside the bias), read the compact bias inside its bounds: seq_len,
// 0. A scale whose reciprocal is not finite moves no call onto the wgmma
// stage, so the layout does not depend on the scale.
void eqx_attention_bias_layout(int seq_len, int head_dim, int dtype, int* out) {
  const bool wgmma = default_path(dtype, seq_len, head_dim, true) == kStageWgmma;
  out[0] = wgmma ? (seq_len + 1) / 2 * 2 : seq_len;
  out[1] = wgmma ? kStageBiasSlack : 0;
}

// Dynamic shared memory one block of the kernel eqx_attention takes needs;
// for error messages.
long long eqx_attention_smem_bytes(int seq_len, int head_dim, int elem_bytes) {
  const int dtype = elem_bytes == 2 ? 1 : 0;
  if (seq_len <= 0 || head_dim <= 0 || head_dim > kStageMaxHeadDim) return 0;
  const Path path = default_path(dtype, seq_len, head_dim, true);
  if (path == kWindowStage || path == kWindowStageF32) return eqx_window::stage_smem_bytes(dtype, head_dim);
  return attention_stage_smem_bytes(seq_len, head_dim, elem_bytes == 2);
}

}  // extern "C"
