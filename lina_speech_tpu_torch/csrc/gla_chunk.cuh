// GLA prefill and training forward, with or without the q/k/v short convs
// fused in: one kernel template for each of two routes, instantiated by
// gla_chunk_conv.cu (CONV = true) and gla_chunk.cu (CONV = false).
//
// Per (batch, head), with f32 log-gates g <= 0:
//
//   S_t = diag(exp g_t) S_{t-1} + k_t^T v_t,   o_t = (scale q_t) S_t
//
// CONV = false takes q, k (t, DK) and v (t, DV) as they are. CONV = true
// takes the pre-conv projections xq, xk, xv and the width-4 depthwise
// causal taps, and computes
//
//   q_t = silu(rnd(sum_i wq_i xq_{t-3+i}))               (f32)
//   k_t = silu(rnd(sum_i wk_i xk_{t-3+i}))               (f32)
//   v_t = rnd(silu(rnd(sum_i wv_i xv_{t-3+i})))          (IO dtype)
//
// where rnd() rounds to the IO dtype (the Pallas kernel's rounding points,
// gla_pallas.py:797-798 and :833) and the conv history before t = 0 is zero.
//
// Two routes; ops/gla_cuda.py:gla_chunk_fwd_plan names one before the
// launch and passes it in:
// - chunked (bf16 IO; gla_chunked_fwd.cuh): 64-row chunks whose products
//   run on the tensor cores, as the TPU kernels walk chunks with MXU
//   products;
// - recurrent (f32 IO, and bf16 IO where the card measured it faster:
//   short inputs): gla_chunk_kernel below. A block owns a (DK x 32) f32
//   state tile in registers (lane = value column, each warp a band of DK/8
//   key rows) and walks the time axis in a loop. Every exp argument is a
//   gate <= 0, so it needs no chunk factorization for stability, and a
//   ragged t (down to t = 1) needs no padding. With CONV the block
//   recomputes the q/k convs of all DK channels from a register history,
//   which keeps blocks of one (batch, head) independent.
//
// What bounds the recurrent body on the H100: the serial time loop (one
// dependent update per token, two block barriers per step, ~2.2 us a token
// at t512), not bytes or FLOPs. Inputs are staged in shared memory 16 steps
// at a time (8 in f32) so that global-load latency is paid once per stage
// rather than once per step; the state tile stays in registers. Its one
// launch is what it has over the chunked route's three at a few tokens.
#pragma once

#include <type_traits>

#include "gla_chunked_fwd.cuh"
#include "gla_common.cuh"

namespace gla {

template <typename IO, typename ST, int DK, bool CONV>
__global__ void __launch_bounds__(kThreads)
gla_chunk_kernel(const IO* __restrict__ xq, const IO* __restrict__ xk,
                 const IO* __restrict__ xv, const float* __restrict__ gk,
                 const IO* __restrict__ wq, const IO* __restrict__ wk,
                 const IO* __restrict__ wv, const ST* __restrict__ s0,
                 IO* __restrict__ o, ST* __restrict__ sf,
                 int H, int T, int DV, float scale) {
  constexpr int RPT = DK / kGroups;  // key rows per thread
  const int bh = blockIdx.x;
  const int h = bh % H;
  const int tid = threadIdx.x;
  const int lane = tid % kBV;
  const int grp = tid / kBV;
  const int col = blockIdx.y * kBV + lane;  // value column of this thread
  const int row0 = grp * RPT;

  // steps staged per pass: 16 in bf16, 8 in f32 (static shared memory
  // stays under 48 KB)
  constexpr int STAGE = sizeof(IO) == 2 ? 16 : 8;
  __shared__ IO stq[STAGE * DK], stk[STAGE * DK], stv[STAGE * kBV];
  __shared__ float stg[STAGE * DK];
  __shared__ float sq[DK], sk[DK], seg[DK], sv[kBV];
  __shared__ float part[kGroups][kBV];

  // state tile in registers
  float s[RPT];
  const size_t sbase = (size_t)bh * DK * DV;
#pragma unroll
  for (int r = 0; r < RPT; ++r)
    s[r] = s0 ? to_f(s0[sbase + (size_t)(row0 + r) * DV + col]) : 0.f;

  // thread tid < DK owns q/k channel tid; thread tid < kBV owns the block's
  // value column blockIdx.y * kBV + tid. With CONV each keeps its channel's
  // taps and a three-step input history in registers.
  const bool qk_owner = tid < DK;
  const bool v_owner = tid < kBV;
  const int vcol = blockIdx.y * kBV + tid;
  float tq[kConv] = {}, tk[kConv] = {}, tv[kConv] = {};
  float hq[kConv - 1] = {}, hk[kConv - 1] = {}, hv[kConv - 1] = {};
  if constexpr (CONV) {
    if (qk_owner) {
#pragma unroll
      for (int i = 0; i < kConv; ++i) {
        tq[i] = to_f(wq[(size_t)(h * DK + tid) * kConv + i]);
        tk[i] = to_f(wk[(size_t)(h * DK + tid) * kConv + i]);
      }
    }
    if (v_owner) {
#pragma unroll
      for (int i = 0; i < kConv; ++i) tv[i] = to_f(wv[(size_t)(h * DV + vcol) * kConv + i]);
    }
  }

  const size_t kbase = (size_t)bh * T * DK;
  const size_t vbase = (size_t)bh * T * DV;
  for (int t0 = 0; t0 < T; t0 += STAGE) {
    const int n = min(STAGE, T - t0);  // uniform across the block
    // stage the inputs of STAGE steps in shared memory with coalesced,
    // independent loads: their latency is paid once per stage. The last
    // step of the previous stage ended on a barrier after every read.
    for (int idx = tid; idx < n * DK; idx += kThreads) {
      const size_t off = kbase + (size_t)t0 * DK + idx;
      stq[idx] = xq[off];
      stk[idx] = xk[off];
      stg[idx] = gk[off];
    }
    for (int idx = tid; idx < n * kBV; idx += kThreads) {
      const int j = idx / kBV, c = idx % kBV;
      stv[idx] = xv[vbase + (size_t)(t0 + j) * DV + blockIdx.y * kBV + c];
    }
    __syncthreads();

    for (int j = 0; j < n; ++j) {
      if (qk_owner) {
        const float x_q = to_f(stq[j * DK + tid]);
        const float x_k = to_f(stk[j * DK + tid]);
        if constexpr (CONV) {
          sq[tid] = silu(round_io<IO>(tap_sum(tq, hq, x_q))) * scale;
          sk[tid] = silu(round_io<IO>(tap_sum(tk, hk, x_k)));
          hq[0] = hq[1]; hq[1] = hq[2]; hq[2] = x_q;
          hk[0] = hk[1]; hk[1] = hk[2]; hk[2] = x_k;
        } else {
          sq[tid] = x_q * scale;
          sk[tid] = x_k;
        }
        seg[tid] = expf(stg[j * DK + tid]);
      }
      if (v_owner) {
        const float x_v = to_f(stv[j * kBV + tid]);
        if constexpr (CONV) {
          sv[tid] = round_io<IO>(silu(round_io<IO>(tap_sum(tv, hv, x_v))));
          hv[0] = hv[1]; hv[1] = hv[2]; hv[2] = x_v;
        } else {
          sv[tid] = x_v;
        }
      }
      __syncthreads();

      const float vj = sv[lane];
      float acc = 0.f;
#pragma unroll
      for (int r = 0; r < RPT; ++r) {
        const int i = row0 + r;
        s[r] = seg[i] * s[r] + sk[i] * vj;
        acc += sq[i] * s[r];
      }
      part[grp][lane] = acc;
      __syncthreads();

      if (grp == 0) {
        float out = 0.f;
#pragma unroll
        for (int g = 0; g < kGroups; ++g) out += part[g][lane];
        o[vbase + (size_t)(t0 + j) * DV + col] = from_f<IO>(out);
      }
    }
  }

#pragma unroll
  for (int r = 0; r < RPT; ++r)
    sf[sbase + (size_t)(row0 + r) * DV + col] = from_f<ST>(s[r]);
}

template <typename IO, typename ST, int DK, bool CONV>
int launch_chunk(const void* xq, const void* xk, const void* xv, const void* gk,
                 const void* wq, const void* wk, const void* wv, const void* s0,
                 void* o, void* sf, int B, int H, int T, int DV, float scale,
                 cudaStream_t stream) {
  const dim3 grid(B * H, DV / kBV);
  gla_chunk_kernel<IO, ST, DK, CONV><<<grid, kThreads, 0, stream>>>(
      static_cast<const IO*>(xq), static_cast<const IO*>(xk),
      static_cast<const IO*>(xv), static_cast<const float*>(gk),
      static_cast<const IO*>(wq), static_cast<const IO*>(wk),
      static_cast<const IO*>(wv), static_cast<const ST*>(s0),
      static_cast<IO*>(o), static_cast<ST*>(sf), H, T, DV, scale);
  return static_cast<int>(cudaGetLastError());
}

// Dispatch over routes, dtypes and DK. chunked: the chunked route's scratch
// (ops/gla_cuda.py:_chunked_fwd_sizes) uf, kf, bc, kt, kl, ul, states, vb,
// ebt, ap; null for the recurrent route, and ap null where split is 1.
// split: the output kernel's value-tile groups (chunked_fwd::launch).
// Returns cudaGetLastError() after the launches, -1 for an unsupported DK, -2
// for unsupported dtype codes, -3 for DV % 32 != 0, -4 for the chunked route
// with f32 IO, a split outside 1..ceil(DV/64) or above 1 without ap, or an
// unknown route.
template <bool CONV>
int dispatch_chunk(const void* xq, const void* xk, const void* xv, const void* gk,
                   const void* wq, const void* wk, const void* wv, const void* s0,
                   void* o, void* sf, void* const* chunked, int B, int H, int T, int DK_,
                   int DV, float scale, int io_dtype, int state_dtype, int route, int split,
                   void* stream) {
  if (DV % kBV != 0) return -3;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (route == kChunked) {
    const int v_tiles = (DV + chunked::kTile - 1) / chunked::kTile;
    if (io_dtype != kBF16 || split < 1 || split > v_tiles || (split > 1 && !chunked[9]))
      return -4;
    if (DK_ != 64 && DK_ != 128 && DK_ != 256) return -1;
    using chunked::bf16;
    float* const* f = reinterpret_cast<float* const*>(chunked);  // the f32 scratch
    bf16* const* b = reinterpret_cast<bf16* const*>(chunked);    // the bf16 scratch
    const auto run = [&](auto* s0_, auto* sf_) {
      using ST = std::remove_const_t<std::remove_pointer_t<decltype(s0_)>>;
      return chunked_fwd::launch<ST, CONV>(
          static_cast<const bf16*>(xq), static_cast<const bf16*>(xk),
          static_cast<const bf16*>(xv), static_cast<const float*>(gk),
          static_cast<const bf16*>(wq), static_cast<const bf16*>(wk),
          static_cast<const bf16*>(wv), s0_, static_cast<bf16*>(o), sf_, f[0], f[1], f[2], b[3],
          b[4], b[5], b[6], b[7], f[8], f[9], B, H, T, DK_, DV, scale, split, st);
    };
    if (state_dtype == kF32)
      return run(static_cast<const float*>(s0), static_cast<float*>(sf));
    if (state_dtype == kBF16)
      return run(static_cast<const bf16*>(s0), static_cast<bf16*>(sf));
    return -2;
  }
  if (route != kRecurrent) return -4;
  GLA_DISPATCH_TYPES(io_dtype, state_dtype,
                     GLA_DISPATCH_DK(DK_, return launch_chunk<IO, ST, DK, CONV>(
                         xq, xk, xv, gk, wq, wk, wv, s0, o, sf, B, H, T, DV, scale, st)))
  return -2;
}

}  // namespace gla
