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
// The attention stage is attention_stage.cuh's, the one K1 runs too: bf16
// with Dh a multiple of 16 on TMA-fed wgmma, one block per (image, head)
// that loads the head's K and V once, one pass where L <= 256; bf16 with
// other head dims on a CUDA-core stage; f32 on its f32 stage (split TF32
// on mma.sync, one pass). The GEMMs run in f32 by split TF32 too.
//
// What bounds it. 2 * rows * D * 4D GEMM operations and 4 * B * H * L^2 *
// Dh attention operations against x, the weights and out read or written
// once: at vit_base b256 in bf16 238 + 30.5 GFLOP, 0.27 ms at 989 TFLOP/s,
// against 0.05 ms of device memory. This version moves qkv and the
// attention output through device memory (the two GEMMs are gemm_bf16.cuh's
// TMA-fed wgmma ones).
// Limits: D a multiple of 8, D divisible by H, Dh <= 128, in bf16 D at most
// 12,344 (the qkv GEMM's LayerNorm vectors), 16-byte aligned tensors; the
// entry point returns cudaErrorInvalidValue otherwise.

#include "attention_stage.cuh"

namespace {

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

  err = launch_attention_stage<T>(qkv_buf, attn_buf, batch, seq_len, num_heads, dim / num_heads, scale, stream);
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
      dim / num_heads > kStageMaxHeadDim || param_dtype < 0 || param_dtype > 1)
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
  return attention_stage_smem_bytes(seq_len, head_dim, dtype == 1);
}

}  // extern "C"
