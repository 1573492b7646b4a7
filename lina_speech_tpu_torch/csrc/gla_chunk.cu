// GLA prefill on post-conv q, k, v (inference forward): the prefill chunks
// that continue a stream, whose short convs run outside the kernel on the
// carried conv history.
//
// Replaces the TPU kernel gla_chunk_pallas (lina_speech_tpu/ops/
// gla_pallas.py:699, body _kernel_infer :198, math _fwd_math :108). The
// kernel, its design and what bounds it are in gla_chunk.cuh (CONV = false):
// the Pallas kernel's dyadic intra-chunk matmuls exist to feed the MXU and
// are not reproduced; operands stay f32 inside, o is rounded to the IO dtype
// and the final state to the state dtype.
#include "gla_chunk.cuh"

// C entry point (bound with ctypes in ops/gla_cuda.py). Layouts: q, k, gk
// (B, H, T, DK); v (B, H, T, DV); s0 (B, H, DK, DV) or null for a zero
// state; o (B, H, T, DV); sf (B, H, DK, DV). All contiguous. Return codes
// as gla::dispatch_chunk.
extern "C" int gla_chunk_fwd(const void* q, const void* k, const void* v,
                             const void* gk, const void* s0, void* o, void* sf,
                             int B, int H, int T, int DK, int DV, float scale,
                             int io_dtype, int state_dtype, void* stream) {
  return gla::dispatch_chunk<false>(q, k, v, gk, nullptr, nullptr, nullptr, s0, o, sf,
                                    B, H, T, DK, DV, scale, io_dtype, state_dtype,
                                    stream);
}
