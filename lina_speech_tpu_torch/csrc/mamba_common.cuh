// Shared pieces of the Mamba (v1) selective-scan kernels (mamba_scan.cu,
// mamba_scan_bwd.cu): the block shape, the staging of a time tile in shared
// memory and the f32 step.
//
// A block owns kChannels channels of one batch row. Each channel's state
// of kN = 16 values is split over kLanes = 4 neighbouring lanes of a warp,
// each holding kPer = 4 of them in registers, so a warp covers 8 channels
// and a block of 128 threads 32. The time axis is a loop inside the block:
// a tile of kTile steps of x, dt (the block's 32 channels), B, C (all 16
// state columns) and the reset flags is staged in shared memory, x and dt
// read along d, so the global loads are coalesced and their latency is paid
// once per tile.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace mamba {

// dtype codes passed from Python (ops/mamba_cuda.py:_DTYPE_CODE)
constexpr int kF32 = 0;
constexpr int kBF16 = 1;

constexpr int kN = 16;         // state size d_state
constexpr int kLanes = 4;      // lanes per channel
constexpr int kPer = kN / kLanes;  // state values per lane
constexpr int kChannels = 32;  // channels per block
constexpr int kThreads = kChannels * kLanes;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 16;      // time steps per staged tile (and per checkpoint)
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
// round to nearest even, as JAX's f32 -> bf16 astype
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// The sum over the 4 lanes of a channel (lanes 4c .. 4c+3 of a warp); every
// lane of the group gets it. Fixed order, so the same bits every run.
__device__ __forceinline__ float lane_group_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  v += __shfl_xor_sync(0xffffffffu, v, 2);
  return v;
}

// One time tile of the block's inputs, converted to f32 as it arrives.
// keep is 0 at a reset step (the decay is zeroed there), else 1. With kDy
// the tile also holds the output cotangent dy (the backward's reverse walk).
template <bool kDy>
struct Tile {
  float x[kTile][kChannels];
  float dt[kTile][kChannels];
  float B[kTile][kN];
  float C[kTile][kN];
  float keep[kTile];
  float dy[kDy ? kTile : 1][kChannels];
};

// Stage steps [t0, t0 + n) of batch row b into ``tile``. Layouts: x, dt,
// dy (batch, T, Dm); B, C (batch, T, kN); reset (batch, T) bytes or null;
// dy null leaves the tile's dy as it was (the backward's forward re-run).
template <bool kDy, typename IO>
__device__ __forceinline__ void stage(Tile<kDy>& tile, const IO* __restrict__ x,
                                      const float* __restrict__ dt, const IO* __restrict__ B,
                                      const IO* __restrict__ C, const uint8_t* __restrict__ reset,
                                      const IO* __restrict__ dy, int b, int T, int Dm, int ch0,
                                      int t0, int n) {
  const int tid = threadIdx.x;
  const size_t row = (size_t)b * T + t0;
  for (int idx = tid; idx < n * kChannels; idx += kThreads) {
    const int j = idx / kChannels, c = idx % kChannels;
    const size_t off = (row + j) * Dm + ch0 + c;
    tile.x[j][c] = to_f(x[off]);
    tile.dt[j][c] = dt[off];
    if constexpr (kDy) {
      if (dy) tile.dy[j][c] = to_f(dy[off]);
    }
  }
  for (int idx = tid; idx < n * kN; idx += kThreads) {
    const int j = idx / kN, k = idx % kN;
    tile.B[j][k] = to_f(B[(row + j) * kN + k]);
    tile.C[j][k] = to_f(C[(row + j) * kN + k]);
  }
  for (int j = tid; j < n; j += kThreads) tile.keep[j] = (reset && reset[row + j]) ? 0.f : 1.f;
}

// exp(dt A) for this lane's kPer state columns from a2 = A log2(e):
// exp2f (the SFU's ex2) in f32; 0 at a reset step.
__device__ __forceinline__ void decays(float (&da)[kPer], const float (&a2)[kPer], float dt,
                                       float keep) {
#pragma unroll
  for (int k = 0; k < kPer; ++k) da[k] = keep != 0.f ? exp2f(dt * a2[k]) : 0.f;
}

}  // namespace mamba

#define MAMBA_DISPATCH_IO(IO_CODE, ...)                          \
  if ((IO_CODE) == mamba::kF32) {                                \
    using IO = float; __VA_ARGS__;                               \
  } else if ((IO_CODE) == mamba::kBF16) {                        \
    using IO = __nv_bfloat16; __VA_ARGS__;                       \
  } else {                                                       \
    return -2;                                                   \
  }
