// Multi-head attention read straight out of a fused qkv projection.
//
// Replaces the Pallas TPU kernels _qkv_attn_kernel and
// _qkv_attn_kernel_pair (eqxvision_tpu/ops/attention.py, launched from
// _fused_qkv_attention). It computes exactly what _fused_qkv_reference
// computes there:
//
//   qkv (B, L, 3*H*Dh) laid out [q heads | k heads | v heads]
//   out[b, i, h*Dh:(h+1)*Dh] = softmax(q_i . K^T * scale) . V
//
// with the scores and the softmax in f32, the probabilities rounded to the
// input type, and p.V accumulated in f32 and stored in the input type.
// The TPU kernels' 128-lane head pairing and their grouping of batch rows
// per program are layout devices of that chip and are not carried over.
//
// The kernel is attention_stage.cuh's, the one the fused attention half
// (attention_half.cu) runs on its qkv workspace and the public attention
// (attention.cu) on its long rows: bf16 with Dh a multiple of 16 on
// TMA-fed wgmma, one block per (image, head) that loads the head's K and V
// once, one pass where L <= 256; bf16 with other head dims on a CUDA-core
// stage; f32 on its f32 stage, split TF32 on mma.sync in one pass. Any L.
// The note there says what bounds it.
// Limits: head_dim <= 128; in bf16 with head_dim % 16 == 0, qkv and out
// 16-byte aligned; the entry point returns cudaErrorInvalidValue otherwise.

#include "attention_stage.cuh"

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. qkv (batch, seq_len, 3*num_heads*head_dim)
// and out (batch, seq_len, num_heads*head_dim) are contiguous on the current
// device. Launches on `stream` and returns the cudaError_t of the launch.
int eqx_fused_qkv_attention(const void* qkv, void* out, int batch, int seq_len, int num_heads, int head_dim,
                            float scale, int dtype, void* stream) {
  if (qkv == nullptr || out == nullptr) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch_attention_stage<float>(qkv, out, batch, seq_len, num_heads, head_dim, scale, s);
  if (dtype == 1) return launch_attention_stage<bf16>(qkv, out, batch, seq_len, num_heads, head_dim, scale, s);
  return cudaErrorInvalidValue;
}

// Dynamic shared memory one block needs; for error messages and reports.
long long eqx_fused_qkv_attention_smem_bytes(int seq_len, int head_dim, int elem_bytes) {
  return attention_stage_smem_bytes(seq_len, head_dim, elem_bytes == 2);
}

// The bf16 stage's blocks per SM, shared memory, key rows, one pass and
// residency at (seq_len, head_dim) into out[0..4]; see attention_stage_config.
int eqx_fused_qkv_attention_config(int seq_len, int head_dim, int* out) {
  return attention_stage_config<false>(seq_len, head_dim, out);
}

const char* eqx_cuda_error_string(int err) { return cudaGetErrorString(static_cast<cudaError_t>(err)); }

}  // extern "C"
