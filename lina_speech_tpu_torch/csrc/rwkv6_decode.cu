// One RWKV-6 decode token: the classic step of every RWKV6 layer.
//
// Replaces the TPU kernel rwkv6_decode_fused (lina_speech_tpu/ops/
// gla_pallas.py:1728; _rwkv6_decode_impl :1484 -> pallas_call :1498, body
// _rwkv6_decode_kernel :1468). Per (batch, head):
//
//   o = r (S + diag(u) k^T v),   S <- diag(exp w) S + k^T v
//
// with r, k, v in the IO dtype (converted to f32 with no further
// rounding), w and u in f32, the state in f32 or bf16; o is rounded to the
// IO dtype and S to the state dtype. One state read and one state write,
// in place (the Pallas kernel aliases its state buffer the same way).
//
// What bounds it on the H100: bytes. The state is read once and written
// once per token (b8 h4 dk256 dv256 in f32: 8.4 MB each way per layer),
// against ~3 FLOP per state byte. It is the classic GLA step's template
// (gla_decode.cuh, mode kStepRwkv6) with its two bodies: the wide
// column-tile body, whose threads ask for their state words before the
// prologue, on states above 512 KiB, and the tile body below;
// ops/rwkv6_cuda.py:rwkv6_decode_plan picks one before the launch. The
// readout takes the old state, and the bonus sum_i r_i u_i k_i is a scalar
// a head, formed once in the prologue and added as bonus * v_j. The JAX
// layer sends batches with fewer than 8 (batch * head) rows to XLA (the
// Pallas kernel's 8-row block, models/rwkv6.py:225-236): TPU tuning that
// has no counterpart here, so this kernel takes every batch size.
#include "gla_decode.cuh"

// C entry point (bound with ctypes in ops/rwkv6_cuda.py). Layouts: r, k, w
// (B, H, DK); v (B, H, DV); u (H, DK) f32; w f32; state (B, H, DK, DV),
// updated in place; o (B, H, DV). All contiguous. route: 0 the tile body;
// 4, 8 or 16 the wide body with that many threads across a row (a state on
// a 16-byte boundary). Return codes as gla::dispatch_decode.
extern "C" int rwkv6_decode_step(const void* r, const void* k, const void* v, const void* w,
                                 const void* u, void* state, void* o, int B, int H, int DK,
                                 int DV, int io_dtype, int state_dtype, int route, void* stream) {
  return gla::dispatch_decode<gla::kStepRwkv6>(
      r, k, v, w, u, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, state, o, nullptr,
      nullptr, nullptr, B, H, DK, DV, 1.f, io_dtype, state_dtype, route, stream);
}
