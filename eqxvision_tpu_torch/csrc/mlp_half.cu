// The MLP half of a pre-norm block at inference:
//
//   out = residual + layer_scale * (fc2(gelu(fc1(LN(x)))))
//
// over the last axis of x viewed as (rows, C), with fc1 (4C, C) and fc2
// (C, 4C) in torch's (out, in) layout, k contiguous, as stored.
//
// Replaces four prototype Pallas TPU kernels that compute this one
// function: _cn_mlp_kernel (scripts/ablate_convnext2.py, ConvNeXt, with the
// layer scale and a residual that is not LN's input) and the ViT MLP
// halves _mlp_kernel of scripts/ablate_vit2.py, scripts/ablate_vit3.py and
// scripts/ablate_vit4.py (no layer scale; the residual is x itself).
//
// Rounding points, those of the prototypes (mlp_half_reference in
// ops/mlp_half.py mirrors them):
//   a = LN(x): mean, then the variance over the centred values, in f32;
//       the affine in f32; rounded to x's type.
//   h = gelu(a fc1^T + b1): f32 accumulation, exact erf (erff) in f32,
//       rounded to x's type.
//   out = residual + layer_scale * (h fc2^T + b2): f32, rounded once.
// The LayerNorm affine, the biases and the layer scale are read in their
// stored type (f32 or bf16, all one type) and applied in f32.
//
// Design: three launches on one stream.
//   1. Row statistics: one warp per row writes (mean, rstd) in f32, the
//      mean taken about the row's first value, the variance over the
//      centred values (a row of 1e3 + N(0, 1) keeps its variance).
//   2. fc1: a GEMM whose A tile is x, normalised in shared memory once the
//      tile lands, with b1 and gelu in the epilogue; h goes to device memory
//      in x's type, the prototypes' rounding point.
//   3. fc2: a GEMM on h with b2, the layer scale and the residual in the
//      epilogue.
// A one-pass kernel would keep a rows x C f32 accumulator for fc2 while
// streaming all of W1 and W2 through every row tile: at C = 768 and 64
// rows that is 192 KB of accumulator, which does not fit beside the
// operand tiles; smaller row tiles re-read the weights (9.4 MB at C = 768)
// several GB per call. Two GEMMs read the weights as any GEMM does and pay
// h's round trip instead: 2 * rows * 4C * itemsize bytes.
// The row statistics and both GEMMs are gemm_bf16.cuh's (fc1: A normalised,
// bias + gelu epilogue; fc2: bias + layer scale + residual epilogue). bf16
// runs its Hopper GEMM: TMA-fed operand tiles in a ring of four stages, a
// producer warp and two consumer warpgroups issuing wgmma, the LayerNorm of
// A in the consumers, the epilogue through shared memory with 16-byte
// stores, a persistent grid; 256-wide column tiles for fc1 at 4C = 3072,
// 96-wide ones for fc2 at C = 96 or 192. f32 runs the same skeleton on
// the tensor cores by split TF32 (three TF32 products a product, about 22
// bits of it kept), with 128- or 96-wide column tiles.
//
// What bounds it. 4 * rows * C * 4C operations against reading x, the
// residual and the weights and writing out once: in bf16 at C = 768
// (vit_base b256, 50,432 rows) 476 GFLOP, 0.48 ms at 989 TFLOP/s, against
// 0.07 ms of device memory; at C = 96 (convnext_tiny b128 stage 1, 401,408
// rows) 0.059 ms of math against 0.069 ms of bytes. This version also
// moves h through device memory (at C = 96 its round trip alone is 0.18
// ms), and each GEMM's epilogue runs after its products rather than beside
// the next tile's; h kept on chip for narrow C is later work.
// Limits: C and 4C (any hidden width) multiples of 8, in bf16 C at most
// 12,344 (fc1's LayerNorm vectors), 16-byte aligned tensors; the entry
// point returns cudaErrorInvalidValue otherwise.

#include "gemm_bf16.cuh"

namespace {

template <typename T>
cudaError_t run(const void* x, const void* residual, const void* ln_w, const void* ln_b, const void* w1, const void* b1,
                const void* w2, const void* b2, const void* layer_scale, void* hidden_buf, void* stats_buf, void* out,
                long long rows, int channels, int hidden, float eps, bool param_bf16, cudaStream_t stream) {
  float2* stats = static_cast<float2*>(stats_buf);
  cudaError_t err = launch_row_stats<T>(x, stats, rows, channels, eps, stream);
  if (err != cudaSuccess) return err;

  GemmArgs fc1 = {};
  fc1.a = x;
  fc1.w = w1;
  fc1.out = hidden_buf;
  fc1.M = rows;
  fc1.N = hidden;
  fc1.K = channels;
  fc1.stats = stats;
  fc1.ln_w = ln_w;
  fc1.ln_b = ln_b;
  fc1.bias = b1;
  fc1.param_bf16 = param_bf16;
  err = launch_gemm<T, true, kBiasGelu>(fc1, stream);
  if (err != cudaSuccess) return err;

  GemmArgs fc2 = {};
  fc2.a = hidden_buf;
  fc2.w = w2;
  fc2.out = out;
  fc2.M = rows;
  fc2.N = channels;
  fc2.K = hidden;
  fc2.bias = b2;
  fc2.scale = layer_scale;
  fc2.residual = residual;
  fc2.param_bf16 = param_bf16;
  return launch_gemm<T, false, kBiasResidual>(fc2, stream);
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16, for x, residual, w1, w2, the scratch
// hidden_buf (rows, hidden) and out; param_dtype the same for ln_w, ln_b
// (channels,), b1 (hidden,), b2 and layer_scale (channels,; null for none).
// stats_buf holds rows float2. x, residual and out (rows, channels), w1
// (hidden, channels), w2 (channels, hidden); all contiguous and 16-byte
// aligned on the current device. Launches three kernels on `stream` and
// returns the first cudaError_t.
int eqx_mlp_half(const void* x, const void* residual, const void* ln_w, const void* ln_b, const void* w1,
                 const void* b1, const void* w2, const void* b2, const void* layer_scale, void* hidden_buf,
                 void* stats_buf, void* out, long long rows, int channels, int hidden, float eps, int dtype,
                 int param_dtype, void* stream) {
  if (rows <= 0 || channels <= 0 || hidden <= 0 || channels % 8 != 0 || hidden % 8 != 0 || param_dtype < 0 ||
      param_dtype > 1)
    return cudaErrorInvalidValue;
  const void* tensors[] = {x, residual, w1, w2, hidden_buf, stats_buf, out};
  for (const void* t : tensors)
    if (t == nullptr || !aligned16(t)) return cudaErrorInvalidValue;
  if (ln_w == nullptr || ln_b == nullptr || b1 == nullptr || b2 == nullptr) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool pbf16 = param_dtype == 1;
  if (dtype == 0)
    return run<float>(x, residual, ln_w, ln_b, w1, b1, w2, b2, layer_scale, hidden_buf, stats_buf, out, rows,
                      channels, hidden, eps, pbf16, s);
  if (dtype == 1)
    return run<__nv_bfloat16>(x, residual, ln_w, ln_b, w1, b1, w2, b2, layer_scale, hidden_buf, stats_buf, out, rows,
                              channels, hidden, eps, pbf16, s);
  return cudaErrorInvalidValue;
}

}  // extern "C"
