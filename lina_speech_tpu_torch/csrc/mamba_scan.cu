// Mamba (v1) selective scan, prefill and training forward: the scan of
// every Mamba-1 mixer over a whole chunk of tokens.
//
// Replaces the TPU kernel mamba_scan_pallas (lina_speech_tpu/ops/
// mamba_pallas.py:468; _fwd_impl :160 -> pallas_call :203, bodies
// _fwd_kernel :40 and _fwd_kernel_infer :77). Per (batch, channel d), with
// a state of n = 16 values:
//
//   h_t = exp(dt_t A_d) * keep_t * h_{t-1} + dt_t x_t B_t
//   y_t = C_t . h_t + D_d x_t
//
// keep_t is 0 where the reset mask is set (the decay is zeroed, the input
// term kept). y is rounded to the IO dtype of x, B and C; dt, A, D and the
// states are f32.
//
// Design: the Pallas kernel keeps the (n, d) state of one batch row in VMEM
// and walks time in blocks of 16 on a sequential grid axis. Here the
// sequential axis is a loop inside a block and the blocks split the
// channels (mamba_common.cuh): 4 lanes share a channel, each keeping 4 of
// its 16 state values and its 4 rates of A in registers; the readout takes
// two shuffles. A tile of 16 steps of x and dt (read along d), B, C and the
// reset flags is staged in shared memory, and y is gathered there and
// written along d. A ragged t needs no padding. The exponential is exp2f
// (the SFU's ex2) of dt * (A log2 e) in f32. The training forward saves
// nothing: the backward (mamba_scan_bwd.cu) recomputes the states from s0,
// so inference and training run this same kernel.
//
// What bounds it on the H100: the exponentials, one per (b, t, d, n). At
// b8 t512 d2048 n16 (bf16 x, B, C; f32 dt) it moves ~68.6 MB (20.5 us at
// 3.35 TB/s) and takes 134 M exponentials, ~36 us at the SFU's 16 per clock
// per SM (132 SMs at 1.755 GHz); the loop is serial in t, so at b8 (16,384
// channels, 512 blocks of 128 threads) and more so at b1 it is latency
// bound as well.
#include "mamba_common.cuh"

namespace mamba {

template <typename IO>
__global__ void __launch_bounds__(kThreads)
mamba_scan_kernel(const IO* __restrict__ x, const float* __restrict__ dt,
                  const float* __restrict__ A, const IO* __restrict__ B,
                  const IO* __restrict__ C, const float* __restrict__ D,
                  const float* __restrict__ s0, const uint8_t* __restrict__ reset,
                  IO* __restrict__ y, float* __restrict__ sf, int T, int Dm) {
  const int b = blockIdx.y, ch0 = blockIdx.x * kChannels;
  const int tid = threadIdx.x, c = tid / kLanes, k0 = (tid % kLanes) * kPer;
  const int ch = ch0 + c;
  __shared__ Tile<false> tile;
  __shared__ float ys[kTile][kChannels];

  float a2[kPer], h[kPer];
  const size_t srow = ((size_t)b * Dm + ch) * kN + k0;
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    a2[k] = A[(size_t)ch * kN + k0 + k] * kLog2e;
    h[k] = s0 ? s0[srow + k] : 0.f;
  }
  const float d_skip = D[ch];

  for (int t0 = 0; t0 < T; t0 += kTile) {
    const int n = min(kTile, T - t0);  // uniform across the block
    __syncthreads();  // the previous tile's reads and y writes are done
    stage(tile, x, dt, B, C, reset, static_cast<const IO*>(nullptr), b, T, Dm, ch0, t0, n);
    __syncthreads();
    for (int j = 0; j < n; ++j) {
      const float dtv = tile.dt[j][c], xv = tile.x[j][c], dtx = dtv * xv;
      float da[kPer];
      decays(da, a2, dtv, tile.keep[j]);
      float acc = 0.f;
#pragma unroll
      for (int k = 0; k < kPer; ++k) {
        h[k] = da[k] * h[k] + dtx * tile.B[j][k0 + k];
        acc += tile.C[j][k0 + k] * h[k];
      }
      acc = lane_group_sum(acc);
      if (k0 == 0) ys[j][c] = acc + d_skip * xv;
    }
    __syncthreads();
    for (int idx = tid; idx < n * kChannels; idx += kThreads) {
      const int j = idx / kChannels, cc = idx % kChannels;
      y[((size_t)b * T + t0 + j) * Dm + ch0 + cc] = from_f<IO>(ys[j][cc]);
    }
  }
#pragma unroll
  for (int k = 0; k < kPer; ++k) sf[srow + k] = h[k];
}

}  // namespace mamba

// C entry point (bound with ctypes in ops/mamba_cuda.py). Layouts: x
// (batch, T, Dm) in the IO dtype; dt (batch, T, Dm) f32; A (Dm, N) f32; B,
// C (batch, T, N) in the IO dtype; D (Dm) f32; s0 (batch, Dm, N) f32 or
// null for a zero state; reset (batch, T) bytes (non-zero: reset) or null;
// y (batch, T, Dm) in the IO dtype; sf (batch, Dm, N) f32. All contiguous;
// T >= 1. Returns cudaGetLastError() after the launch, -1 for N != 16, -2
// for an unsupported dtype code, -3 for Dm % 32 != 0.
extern "C" int mamba_scan_fwd(const void* x, const void* dt, const void* A, const void* B,
                              const void* C, const void* D, const void* s0,
                              const void* reset, void* y, void* sf, int batch, int T, int Dm,
                              int N, int io_dtype, void* stream) {
  if (N != mamba::kN) return -1;
  if (Dm % mamba::kChannels != 0) return -3;
  const dim3 grid(Dm / mamba::kChannels, batch);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  MAMBA_DISPATCH_IO(io_dtype, {
    mamba::mamba_scan_kernel<IO><<<grid, mamba::kThreads, 0, st>>>(
        static_cast<const IO*>(x), static_cast<const float*>(dt),
        static_cast<const float*>(A), static_cast<const IO*>(B), static_cast<const IO*>(C),
        static_cast<const float*>(D), static_cast<const float*>(s0),
        static_cast<const uint8_t*>(reset), static_cast<IO*>(y), static_cast<float*>(sf), T,
        Dm);
    return static_cast<int>(cudaGetLastError());
  })
  return -2;
}
