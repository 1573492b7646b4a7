// GLA prefill and training forward with the q/k/v short convs fused in.
//
// Replaces the TPU kernel gla_chunk_conv_pallas (lina_speech_tpu/ops/
// gla_pallas.py:1289, bodies _conv_kernel_infer / _conv_fwd_kernel). The
// two routes, their design and what bounds them are in gla_chunk.cuh (CONV
// = true) and gla_chunked_fwd.cuh.
#include "gla_chunk.cuh"

// C entry point (bound with ctypes in ops/gla_cuda.py). Layouts: xq, xk, gk
// (B, H, T, DK); xv (B, H, T, DV); taps (H*D, 4), tap 0 oldest; s0 (B, H,
// DK, DV) or null for a zero state; o (B, H, T, DV); sf (B, H, DK, DV). All
// contiguous. route: 0 recurrent, 1 chunked (bf16 IO only). Scratch of the
// chunked route (else null), with nc = ceil(T/64) and Tp = 64 nc: uf, kf, bc
// (B*H, Tp, DK) f32; kt, kl, ul (B*H, Tp, DK) bf16; states (B*H, nc, DK, DV)
// bf16; vb (B*H, Tp, DV) bf16; ebt (B*H, nc, DK) f32; ap (B*H, nc, DK/64, 64,
// 64) f32, null where split is 1; each 16-byte aligned. split: the chunked
// route's output kernel's value-tile groups (ops/gla_cuda.py:fwd_out_split).
// Return codes as gla::dispatch_chunk.
extern "C" int gla_chunk_conv_fwd(const void* xq, const void* xk, const void* xv,
                                  const void* gk, const void* wq, const void* wk,
                                  const void* wv, const void* s0, void* o, void* sf, void* uf,
                                  void* kf, void* bc, void* kt, void* kl, void* ul, void* states,
                                  void* vb, void* ebt, void* ap, int B, int H, int T, int DK,
                                  int DV,
                                  float scale, int io_dtype, int state_dtype, int route,
                                  int split, void* stream) {
  void* const chunked[10] = {uf, kf, bc, kt, kl, ul, states, vb, ebt, ap};
  return gla::dispatch_chunk<true>(xq, xk, xv, gk, wq, wk, wv, s0, o, sf, chunked, B, H, T,
                                   DK, DV, scale, io_dtype, state_dtype, route, split, stream);
}
