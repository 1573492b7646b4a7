// One GLA decode token on q, k, v as they are (no short convs): the classic
// step of the GLA layers without per-projection convs, and of Mamba-2.
//
// Replaces the TPU kernel gla_decode_fused (lina_speech_tpu/ops/
// gla_pallas.py:1709; _gla_decode_impl :1526, pallas_call :1539, body
// _decode_kernel :1347). The kernel's two bodies, their design and what
// bounds each (bytes: one state read and one state write per token) are in
// gla_decode.cuh (mode kStepGla). The TPU routing that sends tiny batches
// and f32 states to XLA (models/gla_layer.py:667-684) follows from the TPU's
// 8-row block and its VMEM budget; this kernel takes every batch size and
// both state dtypes.
#include "gla_decode.cuh"

// C entry point (bound with ctypes in ops/gla_cuda.py). Layouts: q, k, gk
// (B, H, DK); v (B, H, DV); state (B, H, DK, DV), updated in place; o (B,
// H, DV). All contiguous. route: 0 the tile body; 4, 8 or 16 the wide body
// with that many threads across a row (a state on a 16-byte boundary).
// Return codes as gla::dispatch_decode.
extern "C" int gla_decode_step(const void* q, const void* k, const void* v, const void* gk,
                               void* state, void* o, int B, int H, int DK, int DV,
                               float scale, int io_dtype, int state_dtype, int route,
                               void* stream) {
  return gla::dispatch_decode<gla::kStepGla>(
      q, k, v, gk, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, state, o,
      nullptr, nullptr, nullptr, B, H, DK, DV, scale, io_dtype, state_dtype, route, stream);
}
