// GLA prefill and training forward on post-conv q, k, v: the prefill
// chunks that continue a stream, whose short convs run outside the kernel on
// the carried conv history, and the forward of the layers without
// per-projection convs (simple-GLA, the shared conv, Mamba-2).
//
// Replaces the TPU kernel gla_chunk_pallas (lina_speech_tpu/ops/
// gla_pallas.py:699, body _kernel_infer :198, math _fwd_math :108). The two
// routes, their design and what bounds them are in gla_chunk.cuh (CONV =
// false) and gla_chunked_fwd.cuh.
#include "gla_chunk.cuh"

// C entry point (bound with ctypes in ops/gla_cuda.py). Layouts: q, k, gk
// (B, H, T, DK); v (B, H, T, DV); s0 (B, H, DK, DV) or null for a zero
// state; o (B, H, T, DV); sf (B, H, DK, DV). All contiguous. route, split
// and the chunked route's scratch as gla_chunk_conv_fwd. Return codes as
// gla::dispatch_chunk.
extern "C" int gla_chunk_fwd(const void* q, const void* k, const void* v, const void* gk,
                             const void* s0, void* o, void* sf, void* uf, void* kf, void* bc,
                             void* kt, void* kl, void* ul, void* states, void* vb, void* ebt,
                             void* ap, int B, int H, int T, int DK, int DV, float scale,
                             int io_dtype,
                             int state_dtype, int route, int split, void* stream) {
  void* const chunked[10] = {uf, kf, bc, kt, kl, ul, states, vb, ebt, ap};
  return gla::dispatch_chunk<false>(q, k, v, gk, nullptr, nullptr, nullptr, s0, o, sf, chunked,
                                    B, H, T, DK, DV, scale, io_dtype, state_dtype, route, split,
                                    stream);
}
