// One GLA decode token with the q/k/v short-conv ring updates fused in.
//
// Replaces the TPU kernel gla_decode_conv_fused (lina_speech_tpu/ops/
// gla_pallas.py:1641, body _decode_conv_kernel :1366). The kernel, its
// design and what bounds it are in gla_decode.cuh (CONV = true).
#include "gla_decode.cuh"

// C entry point (bound with ctypes in ops/gla_cuda.py). Layouts: xq, xk, gk
// (B, H, DK); xv (B, H, DV); taps wq, wk (4, H, DK), wv (4, H, DV), tap 0
// oldest; rings cq, ck (4, B, H, DK), cv (4, B, H, DV), index 3 newest;
// state (B, H, DK, DV), updated in place; outputs o (B, H, DV) and the new
// rings. All contiguous; rings and taps in the IO dtype. Return codes as
// gla::dispatch_decode.
extern "C" int gla_decode_conv_step(const void* xq, const void* xk, const void* xv,
                                    const void* gk, const void* wq, const void* wk,
                                    const void* wv, const void* cq, const void* ck,
                                    const void* cv, void* state, void* o,
                                    void* cq_out, void* ck_out, void* cv_out,
                                    int B, int H, int DK, int DV, float scale,
                                    int io_dtype, int state_dtype, void* stream) {
  return gla::dispatch_decode<true>(xq, xk, xv, gk, wq, wk, wv, cq, ck, cv, state, o,
                                    cq_out, ck_out, cv_out, B, H, DK, DV, scale, io_dtype,
                                    state_dtype, stream);
}
