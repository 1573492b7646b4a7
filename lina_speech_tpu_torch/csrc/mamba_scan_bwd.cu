// Backward of the Mamba (v1) selective scan (mamba_scan.cu): the training
// of every Mamba-1 mixer.
//
// Replaces the TPU kernel _bwd_kernel (lina_speech_tpu/ops/mamba_pallas.py
// :86, reached through mamba_scan_pallas :468, _vjp_bwd :451 and _bwd_impl
// :212 -> pallas_call :241). From dy (b, t, d) and the final-state
// cotangent dsf (b, d, n) it computes dx (IO dtype), ddt (f32), dB and dC
// (in B's and C's dtype, the IO dtype), dA (d, n) and dD (d) summed over
// the batch, and ds0 (b, d, n) f32. The reset flags get no gradient.
//
// The forward, per (batch, channel): h_t = a_t * h_{t-1} + dt_t x_t B_t
// with a_t = exp(dt_t A) keep_t, y_t = C_t . h_t + D x_t. The reverse walk
// of _bwd_kernel (:119-138), with the state cotangent g seeded by dsf:
//
//   dC_t = sum_d h_t dy_t          dD += dy_t x_t
//   g += C_t dy_t                  e = g * h_{t-1} * a_t
//   dA += e dt_t                   u = sum_n g B_t
//   ddt_t = sum_n e A + u x_t      dx_t = u dt_t + D dy_t
//   dB_t = sum_d g dt_t x_t        g = a_t * g          (ds0 = g at the end)
//
// The TPU kernel reads the block-start states its training forward saved.
// Here the forward saves nothing (inference and training run the same
// kernel), so one block, on the layout of the forward (4 lanes a channel,
// 32 channels a block, mamba_common.cuh):
// 1. re-runs the forward from s0 and writes the state at the start of every
//    segment of 16 steps to scratch (ck: (b, ceil(t/16), d, n) f32, 33.5 MB
//    at b8 t512 d2048), each thread its own 4 values;
// 2. walks the segments in reverse: stages the segment's inputs and dy,
//    recomputes its 16 states from the checkpoint into registers (64 per
//    thread), and walks them back with g in registers.
// dB and dC sum over every channel d, and the blocks split d: a warp sums
// its 8 channels with shuffles, the block its 4 warps in shared memory, and
// each block writes its part (parts: (d/32, b, t, n) f32 each, 16.8 MB at
// b8 t512); dA and dD accumulate per (b, d, n) and (b, d) in registers and
// are written per batch row. sum_parts then adds the parts of dB and dC
// over the blocks, and those of dA and dD over the batch, in a fixed order:
// no atomics, so two runs give the same bits.
//
// What bounds it on the H100: the exponentials, three per (b, t, d, n)
// (the forward re-run, the segment's recomputation and the reverse step);
// at b8 t512 it moves ~121 MB of inputs and outputs (36 us at 3.35 TB/s)
// and takes 402 M exponentials (~109 us at the SFU's rate), and its two
// serial walks are latency bound besides.
#include "mamba_common.cuh"

namespace mamba {

// h_{t0 + j - 1} of a segment: hs[j - 1], or the checkpoint hck for j = 0
__device__ __forceinline__ float prev(const float (&hs)[kTile][kPer], const float (&hck)[kPer],
                                      int j, int k) {
  return j > 0 ? hs[j > 0 ? j - 1 : 0][k] : hck[k];
}

template <typename IO>
__global__ void __launch_bounds__(kThreads)
mamba_scan_bwd_kernel(const IO* __restrict__ x, const float* __restrict__ dt,
                      const float* __restrict__ A, const IO* __restrict__ B,
                      const IO* __restrict__ C, const float* __restrict__ D,
                      const float* __restrict__ s0, const uint8_t* __restrict__ reset,
                      const IO* __restrict__ dy, const float* __restrict__ dsf,
                      IO* __restrict__ dx, float* __restrict__ ddt, float* __restrict__ dBp,
                      float* __restrict__ dCp, float* __restrict__ dAb,
                      float* __restrict__ dDb, float* __restrict__ ds0,
                      float* __restrict__ ck, int T, int Dm) {
  const int b = blockIdx.y, blk = blockIdx.x, ch0 = blk * kChannels;
  const int batch = gridDim.y;
  const int tid = threadIdx.x, c = tid / kLanes, k0 = (tid % kLanes) * kPer;
  const int lane = tid % 32, warp = tid / 32;
  const int ch = ch0 + c;
  const int n_seg = (T + kTile - 1) / kTile;
  __shared__ Tile<true> tile;
  __shared__ float sdx[kTile][kChannels], sddt[kTile][kChannels];
  __shared__ float red[kTile][kWarps][2][kN];  // per-warp sums of dB (0), dC (1)

  float a2[kPer], af[kPer], h[kPer];
  const size_t srow = ((size_t)b * Dm + ch) * kN + k0;
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    af[k] = A[(size_t)ch * kN + k0 + k];
    a2[k] = af[k] * kLog2e;
    h[k] = s0 ? s0[srow + k] : 0.f;
  }
  const float d_skip = D[ch];
  // this thread's checkpoint of segment s: ck[((b * n_seg + s) * Dm + ch) * kN + k0]
  float* ck_row = ck + ((size_t)b * n_seg * Dm + ch) * kN + k0;
  const size_t ck_seg = (size_t)Dm * kN;

  // ---- 1. forward re-run: the state at the start of every segment
  for (int s = 0; s < n_seg; ++s) {
    *reinterpret_cast<float4*>(ck_row + s * ck_seg) = make_float4(h[0], h[1], h[2], h[3]);
    if (s == n_seg - 1) break;  // the last segment's states are recomputed in 2.
    const int t0 = s * kTile;   // a full tile: only the last one can be ragged
    __syncthreads();
    stage(tile, x, dt, B, C, reset, static_cast<const IO*>(nullptr), b, T, Dm, ch0, t0,
          kTile);
    __syncthreads();
#pragma unroll 4
    for (int j = 0; j < kTile; ++j) {
      const float dtv = tile.dt[j][c], dtx = dtv * tile.x[j][c];
      float da[kPer];
      decays(da, a2, dtv, tile.keep[j]);
#pragma unroll
      for (int k = 0; k < kPer; ++k) h[k] = da[k] * h[k] + dtx * tile.B[j][k0 + k];
    }
  }

  // ---- 2. reverse walk
  float g[kPer], dA_acc[kPer] = {0.f, 0.f, 0.f, 0.f};
  float dD_acc = 0.f;
#pragma unroll
  for (int k = 0; k < kPer; ++k) g[k] = dsf ? dsf[srow + k] : 0.f;
  for (int s = n_seg - 1; s >= 0; --s) {
    const int t0 = s * kTile, n = min(kTile, T - t0);
    __syncthreads();  // the previous segment's tile, sdx, sddt and red are consumed
    stage(tile, x, dt, B, C, reset, dy, b, T, Dm, ch0, t0, n);
    const float4 c4 = *reinterpret_cast<const float4*>(ck_row + s * ck_seg);
    const float hck[kPer] = {c4.x, c4.y, c4.z, c4.w};
    __syncthreads();

    // hs[j] = h_{t0 + j}; every index is a constant once the loops are
    // unrolled, so hs stays in registers
    float hs[kTile][kPer];
#pragma unroll
    for (int j = 0; j < kTile; ++j) {
      if (j < n) {
        const float dtv = tile.dt[j][c], dtx = dtv * tile.x[j][c];
        float da[kPer];
        decays(da, a2, dtv, tile.keep[j]);
#pragma unroll
        for (int k = 0; k < kPer; ++k)
          hs[j][k] = da[k] * prev(hs, hck, j, k) + dtx * tile.B[j][k0 + k];
      }
    }
#pragma unroll
    for (int jj = 0; jj < kTile; ++jj) {
      const int j = kTile - 1 - jj;
      if (j < n) {  // uniform across the block: the shuffles below see every lane
        const float dyv = tile.dy[j][c], xv = tile.x[j][c], dtv = tile.dt[j][c];
        const float dtx = dtv * xv;
        float da[kPer], cB[kPer], cC[kPer];
        decays(da, a2, dtv, tile.keep[j]);
        dD_acc += dyv * xv;
        float e_sum = 0.f, u = 0.f;
#pragma unroll
        for (int k = 0; k < kPer; ++k) {
          cC[k] = hs[j][k] * dyv;
          g[k] += tile.C[j][k0 + k] * dyv;
          const float e = g[k] * prev(hs, hck, j, k) * da[k];
          dA_acc[k] += e * dtv;
          e_sum += e * af[k];
          u += g[k] * tile.B[j][k0 + k];
          cB[k] = g[k] * dtx;
          g[k] *= da[k];
        }
        e_sum = lane_group_sum(e_sum);
        u = lane_group_sum(u);
        if (k0 == 0) {
          sddt[j][c] = e_sum + u * xv;
          sdx[j][c] = u * dtv + d_skip * dyv;
        }
        // sum over the warp's 8 channels (lanes 4c + k0/4)
#pragma unroll
        for (int k = 0; k < kPer; ++k) {
#pragma unroll
          for (int off = kLanes; off < 32; off *= 2) {
            cB[k] += __shfl_xor_sync(0xffffffffu, cB[k], off);
            cC[k] += __shfl_xor_sync(0xffffffffu, cC[k], off);
          }
        }
        if (lane < kLanes) {
#pragma unroll
          for (int k = 0; k < kPer; ++k) {
            red[j][warp][0][k0 + k] = cB[k];
            red[j][warp][1][k0 + k] = cC[k];
          }
        }
      }
    }
    __syncthreads();
    for (int idx = tid; idx < n * kChannels; idx += kThreads) {
      const int j = idx / kChannels, cc = idx % kChannels;
      const size_t off = ((size_t)b * T + t0 + j) * Dm + ch0 + cc;
      dx[off] = from_f<IO>(sdx[j][cc]);
      ddt[off] = sddt[j][cc];
    }
    for (int idx = tid; idx < n * 2 * kN; idx += kThreads) {
      const int j = idx / (2 * kN), which = (idx / kN) % 2, k = idx % kN;
      float sum = 0.f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) sum += red[j][w][which][k];
      float* part = which ? dCp : dBp;
      part[(((size_t)blk * batch + b) * T + t0 + j) * kN + k] = sum;
    }
  }
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    if (ds0) ds0[srow + k] = g[k];
    dAb[srow + k] = dA_acc[k];
  }
  if (k0 == 0) dDb[(size_t)b * Dm + ch] = dD_acc;
}

// out[i] = sum over p of parts[p * count + i], p in order.
template <typename OUT>
__global__ void sum_parts(const float* __restrict__ parts, OUT* __restrict__ out, int n_parts,
                          size_t count) {
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= count) return;
  float sum = 0.f;
  for (int p = 0; p < n_parts; ++p) sum += parts[(size_t)p * count + i];
  out[i] = from_f<OUT>(sum);
}

template <typename OUT>
int launch_sum(const float* parts, void* out, int n_parts, size_t count, cudaStream_t stream) {
  const int threads = 256;
  const unsigned blocks = static_cast<unsigned>((count + threads - 1) / threads);
  sum_parts<OUT><<<blocks, threads, 0, stream>>>(parts, static_cast<OUT*>(out), n_parts,
                                                 count);
  return static_cast<int>(cudaGetLastError());
}

template <typename IO>
int launch_bwd(const void* x, const void* dt, const void* A, const void* B, const void* C,
               const void* D, const void* s0, const void* reset, const void* dy,
               const void* dsf, void* dx, void* ddt, void* dB, void* dC, void* dA, void* dD,
               void* ds0, void* ck, void* dBp, void* dCp, void* dAb, void* dDb, int batch, int T,
               int Dm, cudaStream_t stream) {
  const int n_blk = Dm / kChannels;
  const dim3 grid(n_blk, batch);
  float *dBp_ = static_cast<float*>(dBp), *dCp_ = static_cast<float*>(dCp),
        *dAb_ = static_cast<float*>(dAb), *dDb_ = static_cast<float*>(dDb);
  mamba_scan_bwd_kernel<IO><<<grid, kThreads, 0, stream>>>(
      static_cast<const IO*>(x), static_cast<const float*>(dt), static_cast<const float*>(A),
      static_cast<const IO*>(B), static_cast<const IO*>(C), static_cast<const float*>(D),
      static_cast<const float*>(s0), static_cast<const uint8_t*>(reset),
      static_cast<const IO*>(dy), static_cast<const float*>(dsf), static_cast<IO*>(dx),
      static_cast<float*>(ddt), dBp_, dCp_, dAb_, dDb_, static_cast<float*>(ds0),
      static_cast<float*>(ck), T, Dm);
  int err = static_cast<int>(cudaGetLastError());
  if (err) return err;
  const size_t btn = (size_t)batch * T * kN;
  if ((err = launch_sum<IO>(dBp_, dB, n_blk, btn, stream))) return err;
  if ((err = launch_sum<IO>(dCp_, dC, n_blk, btn, stream))) return err;
  if ((err = launch_sum<float>(dAb_, dA, batch, (size_t)Dm * kN, stream))) return err;
  return launch_sum<float>(dDb_, dD, batch, (size_t)Dm, stream);
}

}  // namespace mamba

// C entry point (bound with ctypes in ops/mamba_cuda.py). Inputs as
// mamba_scan_fwd, plus dy (batch, T, Dm) in the IO dtype and dsf (batch,
// Dm, N) f32 or null (zeros). Outputs: dx (batch, T, Dm) in the IO dtype;
// ddt (batch, T, Dm) f32; dB, dC (batch, T, N) in the IO dtype; dA (Dm, N)
// and dD (Dm) f32, summed over the batch; ds0 (batch, Dm, N) f32, or null
// to skip it. Scratch, all f32: ck (batch, ceil(T/16), Dm, N); dBp, dCp
// (Dm/32, batch, T, N); dAb (batch, Dm, N); dDb (batch, Dm). All
// contiguous; T >= 1. Returns the first launch's cudaGetLastError() that is
// not 0, -1 for N != 16, -2 for an unsupported dtype code, -3 for Dm % 32
// != 0.
extern "C" int mamba_scan_bwd(const void* x, const void* dt, const void* A, const void* B,
                              const void* C, const void* D, const void* s0,
                              const void* reset, const void* dy, const void* dsf, void* dx,
                              void* ddt, void* dB, void* dC, void* dA, void* dD, void* ds0,
                              void* ck, void* dBp, void* dCp, void* dAb, void* dDb, int batch,
                              int T, int Dm, int N, int io_dtype, void* stream) {
  if (N != mamba::kN) return -1;
  if (Dm % mamba::kChannels != 0) return -3;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  MAMBA_DISPATCH_IO(io_dtype, return mamba::launch_bwd<IO>(
                                  x, dt, A, B, C, D, s0, reset, dy, dsf, dx, ddt, dB, dC, dA,
                                  dD, ds0, ck, dBp, dCp, dAb, dDb, batch, T, Dm, st))
  return -2;
}
