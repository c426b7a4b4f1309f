// The attention half of a Swin v1 block at inference, on windows:
//
//   out = x + (wattn(LN(x) Wqkv^T + bqkv) Wproj^T + bproj)
//
// over x (images, nW, L, C): the block's input already padded to the
// window, rolled by the shift and partitioned, viewed as (rows, C). wattn
// is each window's multi-head attention with H heads of Dh = C / H, scores
// plus bias[w % n_bias] (nWb, H, L, L) f32, the relative-position bias and
// the shift mask. qkv is laid out [q heads | k heads | v heads]; Wqkv
// (3C, C) and Wproj (C, C) in torch's (out, in) layout.
//
// Replaces the prototype Pallas TPU kernel _fused_half_kernel of
// scripts/ablate_swin3.py (fused_attn_half, with_proj=True). Rounding
// points, the prototype's (window_attention_half_reference in
// ops/window_attention_half.py mirrors them):
//   a = LN(x): mean, then the variance over the centred values, in f32;
//       the affine in f32; rounded to x's type. A padding row (valid flag
//       0) gives a = 0: torchvision and the JAX model pad after norm1.
//   qkv = round(a Wqkv^T) + round(bqkv): the f32 product rounded to x's
//       type, the bias rounded to it, and the sum rounded again, as the
//       prototype and the JAX Swin's windowed projection compute it.
//   per window and head: s = (q . k) * scale + bias in f32; p = softmax(s)
//       in f32, rounded to x's type; p . V accumulated in f32 and rounded.
//   out = x + (o Wproj^T + bproj): f32, rounded once.
// The LayerNorm affine and the biases are read in their stored type (f32
// or bf16, all one type) and applied in f32.
//
// Design: four launches on one stream, from parts the repo already has.
//   1. Row statistics of x (gemm_bf16.cuh).
//   2. qkv: the GEMM with the A tile normalised as it lands, padding rows
//      read as zeros where a valid mask is given, and the rounded-bias
//      epilogue, into a (rows, 3C) workspace in x's type.
//   3. The window attention of window_attention.cu, called through its
//      entry point eqx_window_attention on that workspace: bf16 windows of
//      at most 64 tokens with Dh a multiple of 16 on its window stage
//      (persistent blocks, a TMA ring, wgmma), f32 on the attention stage's
//      split-TF32 kernel.
//   4. proj: the GEMM with the bias + residual epilogue, the residual x.
// qkv and the attention output go through device memory: 8 * rows * C *
// itemsize bytes in all, 0.15 GB at swin_t stage 3 b128 in bf16, about
// 0.05 ms of the card's memory rate.
//
// What bounds it. 2 * rows * C * 4C GEMM operations and 4 * rows * L * C
// attention operations against x and out read or written once: at swin_t
// stage 3 b128 in bf16 29.6 + 1.9 GFLOP, 0.032 ms at 989 TFLOP/s, against
// 0.011 ms of device memory. The GEMMs are gemm_bf16.cuh's TMA-fed wgmma
// ones (in f32 by split TF32), the window attention's bf16 stage wgmma too;
// the roll and partition stay outside the kernels.
// Limits: C a multiple of 8, C divisible by H, Dh <= 64, in bf16 C at most
// 12,344 (the qkv GEMM's LayerNorm vectors), 16-byte aligned tensors; the
// entry point returns cudaErrorInvalidValue otherwise.

#include "gemm_bf16.cuh"

extern "C" int eqx_window_attention(const void* qkv, const void* bias, const void* gs, void* out, int windows,
                                    int n_windows, int n_bias, int seq_len, int num_heads, int head_dim, float scale,
                                    int dtype, void* stream);
extern "C" long long eqx_window_attention_smem_bytes(int seq_len, int head_dim, int elem_bytes);

namespace {

constexpr int kMaxHeadDim = 64;  // the window attention's limit

template <typename T>
cudaError_t run(const void* x, const void* ln_w, const void* ln_b, const void* wqkv, const void* bqkv,
                const void* wproj, const void* bproj, const void* bias, const unsigned char* valid, void* qkv_buf,
                void* attn_buf, void* stats_buf, void* out, int images, int n_windows, int n_bias, int seq_len,
                int dim, int num_heads, float scale, float eps, int dtype, bool param_bf16, cudaStream_t stream) {
  const long long windows = (long long)images * n_windows;
  const long long rows = windows * seq_len;
  if (windows > INT_MAX) return cudaErrorInvalidValue;
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
  qkv.row_valid = valid;
  qkv.valid_period = (long long)n_windows * seq_len;
  err = valid != nullptr ? launch_gemm<T, true, kRoundedBias, true>(qkv, stream)
                         : launch_gemm<T, true, kRoundedBias>(qkv, stream);
  if (err != cudaSuccess) return err;

  err = static_cast<cudaError_t>(eqx_window_attention(qkv_buf, bias, nullptr, attn_buf, (int)windows, n_windows,
                                                      n_bias, seq_len, num_heads, dim / num_heads, scale, dtype,
                                                      stream));
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
// for ln_w, ln_b (dim,), bqkv (3 * dim,) and bproj (dim,). bias (n_bias,
// num_heads, seq_len, seq_len) f32; valid (n_windows * seq_len,) bytes,
// nonzero for a token of the image and 0 for padding, or null for none.
// stats_buf holds rows float2. x and out (images, n_windows, seq_len, dim),
// rows = images * n_windows * seq_len; wqkv (3 * dim, dim), wproj (dim,
// dim); all contiguous and 16-byte aligned on the current device.
// Launches four kernels on `stream` and returns the first cudaError_t.
int eqx_window_attention_half(const void* x, const void* ln_w, const void* ln_b, const void* wqkv, const void* bqkv,
                              const void* wproj, const void* bproj, const void* bias, const void* valid, void* qkv_buf,
                              void* attn_buf, void* stats_buf, void* out, int images, int n_windows, int n_bias,
                              int seq_len, int dim, int num_heads, float scale, float eps, int dtype, int param_dtype,
                              void* stream) {
  if (images <= 0 || n_windows <= 0 || n_bias <= 0 || seq_len <= 0 || dim <= 0 || num_heads <= 0 || dim % 8 != 0 ||
      dim % num_heads != 0 || dim / num_heads > kMaxHeadDim || param_dtype < 0 || param_dtype > 1)
    return cudaErrorInvalidValue;
  const void* tensors[] = {x, wqkv, wproj, qkv_buf, attn_buf, stats_buf, out};
  for (const void* t : tensors)
    if (t == nullptr || !aligned16(t)) return cudaErrorInvalidValue;
  if (ln_w == nullptr || ln_b == nullptr || bqkv == nullptr || bproj == nullptr || bias == nullptr)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool pbf16 = param_dtype == 1;
  const unsigned char* v = static_cast<const unsigned char*>(valid);
  if (dtype == 0)
    return run<float>(x, ln_w, ln_b, wqkv, bqkv, wproj, bproj, bias, v, qkv_buf, attn_buf, stats_buf, out, images,
                      n_windows, n_bias, seq_len, dim, num_heads, scale, eps, dtype, pbf16, s);
  if (dtype == 1)
    return run<__nv_bfloat16>(x, ln_w, ln_b, wqkv, bqkv, wproj, bproj, bias, v, qkv_buf, attn_buf, stats_buf, out,
                              images, n_windows, n_bias, seq_len, dim, num_heads, scale, eps, dtype, pbf16, s);
  return cudaErrorInvalidValue;
}

// Dynamic shared memory the largest of the four launches needs for one
// block (the qkv GEMM's at its widest tile, before its LayerNorm vectors,
// 8 * dim bytes); for error messages and reports.
long long eqx_window_attention_half_smem_bytes(int seq_len, int head_dim, int dtype) {
  if (seq_len <= 0 || head_dim <= 0 || head_dim > kMaxHeadDim) return 0;
  const long long stage = eqx_window_attention_smem_bytes(seq_len, head_dim, dtype == 1 ? 2 : 4);
  const long long gemm = dtype == 1 ? kGemmSmemBytes : gemm_f32_smem_bytes(128);
  return stage > gemm ? stage : gemm;
}

}  // extern "C"
