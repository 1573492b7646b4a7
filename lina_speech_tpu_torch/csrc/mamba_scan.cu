// Mamba (v1) selective scan, prefill and training forward: the scan of
// every Mamba-1 mixer over a whole chunk of tokens.
//
// Replaces the TPU kernel mamba_scan_pallas (lina_speech_tpu/ops/
// mamba_pallas.py:468; _fwd_impl :167 -> pallas_call :203, bodies
// _fwd_kernel :40 and _fwd_kernel_infer :77). Per (batch, channel d), with
// a state of n = 16 values:
//
//   h_t = exp(dt_t A_d) * keep_t * h_{t-1} + dt_t x_t B_t
//   y_t = C_t . h_t + D_d x_t
//
// keep_t is 0 where the reset mask is set (the decay is zeroed, the input
// term kept). y is rounded to the IO dtype of x, B and C; dt, A, D and the
// states are f32. The training forward saves nothing: the backward
// (mamba_scan_bwd.cu) recomputes the states from s0, so inference and
// training run this same forward.
//
// Design: the Pallas kernel keeps the (n, d) state of one batch row in VMEM
// and walks time in blocks of 16 on a sequential grid axis. Here the
// sequential axis is a loop inside a block, the blocks split the channels
// in groups of 64, and the walk is the backward's (mamba_common.cuh:
// walk_kernel): 4 lanes a channel, 4 state values and rates a lane in
// registers, the inputs through a cp.async ring 3 segments ahead, the
// decay as the SFU's ex2 with flush to zero, the readout by two shuffles,
// y staged in the ring's tile and written 16 bytes a store a segment
// later. ops/mamba_cuda.py:mamba_scan_plan picks a chunk length L:
//
// - one chunk (L >= t): the walk in mode kWalkY from s0 over the whole
//   length, one launch;
// - chunks, where one chunk's blocks leave the card under-filled (small
//   batch): the walk in mode kWalkSummaries gives every chunk's end state
//   from zero (chunk 0 from s0) and its decay product; carry_kernel turns
//   them into each chunk's start state H_c in place; the walk in mode
//   kWalkY then runs every chunk again from H_c, writing y, and the last
//   chunk writes the final state. Three launches and two exponentials a
//   state value, against a serial chain of L steps instead of t. (The other
//   way to y, a closed-form correction y_t += sum_n C_{t,n} exp(A_n cdt_t)
//   H_{c,n} of a y from zero, takes as many exponentials and a second pass
//   over y; it was not built.)
//
// What bounds it on the H100: the exponentials, one per (b, t, d, n). At
// b8 t512 d2048 n16 (bf16 x, B, C; f32 dt) it moves ~68.6 MB (20.5 us at
// 3.35 TB/s) and takes 134 M exponentials, ~32 us at the SFU's 16 per clock
// per SM (132 SMs at 1.98 GHz); the walk is serial in t, so below b8 (256
// blocks of 256 threads at b8) it is latency-bound and the chunks trade
// exponentials for parallelism.
#include "mamba_common.cuh"

namespace mamba {

template <typename IO>
int launch_fwd(const void* x_, const void* dt_, const void* A_, const void* B_, const void* C_,
               const void* D_, const void* s0_, const void* reset_, void* y_, void* sf_,
               void* hloc_, void* P_, int batch, int T, int Dm, int L, cudaStream_t st) {
  const IO *x = static_cast<const IO*>(x_), *B = static_cast<const IO*>(B_),
           *C = static_cast<const IO*>(C_);
  const float *dt = static_cast<const float*>(dt_), *A = static_cast<const float*>(A_),
              *D = static_cast<const float*>(D_), *s0 = static_cast<const float*>(s0_);
  const uint8_t* reset = static_cast<const uint8_t*>(reset_);
  float *hloc = static_cast<float*>(hloc_), *P = static_cast<float*>(P_);
  const int n_chunk = (T + L - 1) / L;
  const dim3 grid((Dm + kCh - 1) / kCh, n_chunk, batch);
  int err = 0;
  if (n_chunk > 1) {
    if ((err = launch_walk<IO, kWalkSummaries>(grid, st, x, dt, A, B, C, nullptr, s0, reset,
                                               nullptr, nullptr, nullptr, hloc, nullptr, P,
                                               nullptr, nullptr, T, Dm, L)))
      return err;
    if ((err = launch_carry<false>(hloc, nullptr, P, nullptr, batch, n_chunk, Dm, st)))
      return err;
  }
  return launch_walk<IO, kWalkY>(grid, st, x, dt, A, B, C, D, s0, reset, nullptr, nullptr,
                                 nullptr, hloc, nullptr, nullptr, static_cast<IO*>(y_),
                                 static_cast<float*>(sf_), T, Dm, L);
}

}  // namespace mamba

// C entry point (bound with ctypes in ops/mamba_cuda.py). Layouts: x
// (batch, T, Dm) in the IO dtype; dt (batch, T, Dm) f32; A (Dm, N) f32; B,
// C (batch, T, N) in the IO dtype; D (Dm) f32; s0 (batch, Dm, N) f32 or
// null for a zero state; reset (batch, T) bytes (non-zero: reset) or null;
// y (batch, T, Dm) in the IO dtype; sf (batch, Dm, N) f32. x, dt, B, C and
// y 16-byte aligned. L: the chunk length, a multiple of 16 (L >= T: one
// chunk). Scratch with more than one chunk, f32, 16-byte aligned: hloc, P
// (batch, ceil(T/L), Dm, N); else null. All contiguous; T >= 1. Returns
// the first launch's cudaGetLastError() that is not 0, -1 for N != 16, -2
// for an unsupported dtype code, -3 for Dm % 32 != 0, -4 for an L that is
// not a positive multiple of 16.
extern "C" int mamba_scan_fwd(const void* x, const void* dt, const void* A, const void* B,
                              const void* C, const void* D, const void* s0,
                              const void* reset, void* y, void* sf, void* hloc, void* P,
                              int batch, int T, int Dm, int N, int L, int io_dtype,
                              void* stream) {
  if (N != mamba::kN) return -1;
  if (Dm % mamba::kChannels != 0) return -3;
  if (L <= 0 || L % mamba::kSeg != 0) return -4;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  MAMBA_DISPATCH_IO(io_dtype, return mamba::launch_fwd<IO>(x, dt, A, B, C, D, s0, reset, y, sf,
                                                           hloc, P, batch, T, Dm, L, st))
  return -2;
}
