// GLA prefill with the q/k/v short convs fused in (inference forward).
//
// Replaces the TPU kernel gla_chunk_conv_pallas (lina_speech_tpu/ops/
// gla_pallas.py:1289, bodies _conv_kernel_infer / _conv_fwd_kernel). The
// kernel, its design and what bounds it are in gla_chunk.cuh (CONV = true).
#include "gla_chunk.cuh"

// C entry point (bound with ctypes in ops/gla_cuda.py). Layouts: xq, xk, gk
// (B, H, T, DK); xv (B, H, T, DV); taps (H*D, 4), tap 0 oldest; s0 (B, H,
// DK, DV) or null for a zero state; o (B, H, T, DV); sf (B, H, DK, DV). All
// contiguous. Return codes as gla::dispatch_chunk.
extern "C" int gla_chunk_conv_fwd(const void* xq, const void* xk, const void* xv,
                                  const void* gk, const void* wq, const void* wk,
                                  const void* wv, const void* s0, void* o, void* sf,
                                  int B, int H, int T, int DK, int DV, float scale,
                                  int io_dtype, int state_dtype, void* stream) {
  return gla::dispatch_chunk<true>(xq, xk, xv, gk, wq, wk, wv, s0, o, sf, B, H, T,
                                   DK, DV, scale, io_dtype, state_dtype, stream);
}
