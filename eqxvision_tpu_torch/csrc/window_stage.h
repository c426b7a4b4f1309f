// The window stage of window_attention.cu (window_stage<T, DH, kCosine,
// kBias>) as other sources launch it. attention.cu runs the public
// attention's (K2) rows of at most 64 tokens on it as the one-head case.
// Declared here and defined once, in window_attention.cu, so that the
// kernels are compiled once for the one library both sources link into.
#pragma once

#include <cuda_runtime.h>

namespace eqx_window {

// One call of the stage. q, k and v are each read as (windows, seq_len,
// cols) with rows `ld` elements apart, from their own base; head h's tile
// is columns h head_dim ... of its rows (K3: the three thirds of one qkv,
// cols = H Dh and ld = 3 H Dh; K2: three tensors, cols = ld = Dh). out is
// (windows, seq_len, num_heads head_dim). bias: (n_bias, num_heads,
// seq_len, seq_len) f32, window w reading slab (w % n_windows) % n_bias, or
// null (slab_walk only); gs: (num_heads,) f32 for cosine attention (with a
// bias, not slab_walk), or null. Every tensor 16-byte aligned, in the type
// `dtype` names (0 f32, 1 bf16; the bias and gs f32). slab_walk: the
// blocks walk contiguous runs of a slab-major order (K2's rows, whose q, k
// and v are contiguous), else tiles j, j + grid, ... of the (window, head)
// order (K3/K4, whose heads share the qkv rows).
struct Operands {
  const void* src[3];
  long long ld;
  int cols;
  void* out;
  const float* bias;
  const float* gs;
  int windows, n_windows, n_bias, seq_len, num_heads, head_dim;
  float scale;
  bool slab_walk;
};

// Whether the stage takes a call: seq_len <= 64, 16-byte aligned tensors;
// bf16 head dims 16, 32, 48 and 64, with a bias of cosine attention or of
// v1 at a scale whose reciprocal is finite (v1 adds bias / scale to the
// products), or without a bias at any scale; f32 head dims 16 and 32.
bool stage_takes(int dtype, int seq_len, int head_dim, bool aligned, bool cosine, bool bias, float scale);

// Launches the stage on `stream`; a cudaError_t (cudaErrorInvalidValue for
// a call it does not take).
cudaError_t launch_stage(const Operands& op, int dtype, cudaStream_t stream);

// The design at (dtype, head_dim, slab_walk, cosine, bias) over `tiles`
// (window, head) tiles: out[0] blocks an SM, out[1] dynamic shared memory a
// block, out[2] blocks launched, out[3] ring stages.
cudaError_t stage_config(int dtype, int head_dim, bool slab_walk, bool cosine, bool bias, long long tiles, int* out);

// Dynamic shared memory one block needs.
long long stage_smem_bytes(int dtype, int head_dim);

}  // namespace eqx_window
