// The two recurrent sweeps of the GLA prefill's backward, with or without
// the q/k/v short convs fused in: one template (CONV), used by
// gla_chunk_conv_bwd.cu (CONV = true) and gla_chunk_bwd.cu (CONV = false).
// Each of those adds its own finishing pass.
//
// The forward (gla_chunk.cuh), per (batch, head), with u_t = scale q_t:
//
//   CONV:  q_t = silu(rnd(conv(xq)_t)), k_t likewise, v_t = rnd(silu(rnd(conv(xv)_t)))
//   else:  q_t, k_t, v_t are the inputs
//   S_t = diag(e^{g_t}) S_{t-1} + k_t^T v_t,      o_t = u_t S_t
//
// The TPU kernels walk 64-row chunks in reverse with MXU products and read
// the chunk states their training forward saved. This is the recurrent form
// of the same function and needs no saved state, so the training forward is
// the inference kernel. With dS_t the total cotangent of S_t:
//
//   dS_t = u_t^T do_t + diag(e^{g_{t+1}}) dS_{t+1}   (after the last step: dsf)
//   dq_t = scale S_t do_t^T,  dk_t = dS_t v_t^T,  dv_t = k_t dS_t
//   ds0  = diag(e^{g_0}) dS_0
//   dg_t = sum_{s>=t} (q_s dq_s - k_s dk_s) + sum_c (dsf . S_final)[., c]
//
// (the last line follows from e^{g_t} S_{t-1} = S_t - k_t^T v_t). Rounding to
// the IO dtype passes gradients straight through, as in the TPU backward.
//
// 1. bwd_dq_kernel: a forward sweep that recomputes (the convs and) S_t from
//    s0 and emits dq_t and the dsf . S_final term;
// 2. bwd_dkv_kernel: a reverse sweep that carries dS and emits dk_t, dv_t
//    and ds0.
//
// In the sweeps a block owns a (DK x 32) tile of one (batch, head) state, as
// the forward does, but with one thread per key ROW holding the row's 32
// columns in registers: the sums over columns (dq, dk) stay inside a thread,
// with CONV each thread convolves its own q/k channel (no exchange, no
// barrier inside a stage of 8 steps), and only dv needs a sum over rows (a
// warp butterfly, then shared memory across warps, once per stage). dq and
// dk are sums over the DV/32 column tiles of a (batch, head): every tile
// writes its part to its own f32 buffer and the finishing pass adds them in
// a fixed order, so gradients are the same from run to run (atomicAdd would
// reorder f32 sums). The parts are 2 * (DV/32) * b*h*t*DK*4 bytes, scratch
// that lives for one call only. A ragged t needs no padding.
//
// What bounds them on the H100: the two serial time loops (one dependent
// update per token), not bytes or FLOPs, as in the forward.
#pragma once

#include <type_traits>

#include "gla_common.cuh"

namespace gla {

constexpr int kBwdStage = 8;           // time steps staged per pass
constexpr int kFinishThreads = 64;     // channels per block in the finishing kernels
constexpr int kFinishSeg = 64;         // time steps per thread in the finishing kernels
constexpr unsigned kFullMask = 0xffffffffu;
static_assert(kBV == 32, "a warp's lanes stand for the 32 columns of a tile");

// d silu(z) / dz
__device__ __forceinline__ float dsilu(float z) {
  const float s = 1.f / (1.f + expf(-z));
  return s * (1.f + z * (1.f - s));
}

// Shared staging of one pass of the sweeps: rows t0-HIST .. t0+n-1 of xq and
// xk (slot [r * DK + tid] is read and written by thread tid only), the gates
// of t0 .. t0+n-1, and the block's 32 value columns: v and do in f32. HIST is
// the conv history (3 steps) with CONV and 0 without.
template <typename IO, int DK, bool CONV>
struct SweepStage {
  static constexpr int HIST = CONV ? kConv - 1 : 0;
  IO xq[(kBwdStage + HIST) * DK];
  IO xk[(kBwdStage + HIST) * DK];
  float g[kBwdStage * DK];
  IO xv[CONV ? (kBwdStage + HIST) * kBV : 1];
  __align__(16) float v[kBwdStage * kBV];
  __align__(16) float dout[kBwdStage * kBV];
  float wv[CONV ? kBV * kConv : 1];
};

template <typename IO, int DK, bool CONV>
__device__ __forceinline__ void load_v_taps(SweepStage<IO, DK, CONV>& st, const IO* wv, int h,
                                            int DV, int col0) {
  if constexpr (CONV) {
    for (int idx = threadIdx.x; idx < kBV * kConv; idx += DK)
      st.wv[idx] = to_f(wv[(size_t)(h * DV + col0) * kConv + idx]);
  }
}

// Fills the stage for steps t0 .. t0+n-1. Ends on a barrier; the caller
// puts one before it (the previous pass still reads v and dout).
template <typename IO, int DK, bool CONV>
__device__ __forceinline__ void fill_stage(SweepStage<IO, DK, CONV>& st, const IO* xq,
                                           const IO* xk, const IO* xv, const float* gk,
                                           const IO* dout, size_t kbase, size_t vbase, int DV,
                                           int col0, int t0, int n) {
  constexpr int HIST = SweepStage<IO, DK, CONV>::HIST;
  const int tid = threadIdx.x;
  for (int r = 0; r < n + HIST; ++r) {
    const int t = t0 - HIST + r;
    st.xq[r * DK + tid] = t >= 0 ? xq[kbase + (size_t)t * DK + tid] : from_f<IO>(0.f);
    st.xk[r * DK + tid] = t >= 0 ? xk[kbase + (size_t)t * DK + tid] : from_f<IO>(0.f);
  }
  for (int r = 0; r < n; ++r) st.g[r * DK + tid] = gk[kbase + (size_t)(t0 + r) * DK + tid];
  for (int idx = tid; idx < n * kBV; idx += DK)
    st.dout[idx] = to_f(dout[vbase + (size_t)(t0 + idx / kBV) * DV + col0 + idx % kBV]);
  if constexpr (CONV) {
    for (int idx = tid; idx < (n + HIST) * kBV; idx += DK) {
      const int t = t0 - HIST + idx / kBV;
      st.xv[idx] = t >= 0 ? xv[vbase + (size_t)t * DV + col0 + idx % kBV] : from_f<IO>(0.f);
    }
    __syncthreads();
    for (int idx = tid; idx < n * kBV; idx += DK) {
      const int j = idx / kBV, c = idx % kBV;
      float z = 0.f;
#pragma unroll
      for (int i = 0; i < kConv; ++i) z = z + st.wv[c * kConv + i] * to_f(st.xv[(j + i) * kBV + c]);
      st.v[idx] = round_io<IO>(silu(round_io<IO>(z)));
    }
  } else {
    for (int idx = tid; idx < n * kBV; idx += DK)
      st.v[idx] = to_f(xv[vbase + (size_t)(t0 + idx / kBV) * DV + col0 + idx % kBV]);
  }
  __syncthreads();
}

// Rounded conv pre-activation of step t0 + j of the calling thread's channel:
// rows j .. j+3 of the staged column are x[t-3 .. t].
template <typename IO, int DK>
__device__ __forceinline__ float conv_pre(const IO* col, const float* w, int j) {
  float z = 0.f;
#pragma unroll
  for (int i = 0; i < kConv; ++i) z = z + w[i] * to_f(col[(j + i) * DK + threadIdx.x]);
  return round_io<IO>(z);
}

// q_t or k_t of step t0 + j of the calling thread's channel: silu of the conv
// with CONV, the staged input without.
template <typename IO, int DK, bool CONV>
__device__ __forceinline__ float qk_at(const IO* col, const float* w, int j) {
  if constexpr (CONV) {
    return silu(conv_pre<IO, DK>(col, w, j));
  } else {
    return to_f(col[j * DK + threadIdx.x]);
  }
}

// ---------------------------------------------------------------- kernel 1
// dqp: (DV/32, B*H, T, DK) parts of dq; dsgp: (DV/32, B*H, DK) parts of
// sum_c dsf . S_final.
template <typename IO, typename ST, int DK, bool CONV>
__global__ void __launch_bounds__(DK)
bwd_dq_kernel(const IO* __restrict__ xq, const IO* __restrict__ xk, const IO* __restrict__ xv,
              const float* __restrict__ gk, const IO* __restrict__ wk,
              const IO* __restrict__ wv, const ST* __restrict__ s0,
              const IO* __restrict__ dout, const ST* __restrict__ dsf,
              float* __restrict__ dqp, float* __restrict__ dsgp, int H, int T, int DV,
              float scale) {
  const int bh = blockIdx.x, h = bh % H, tid = threadIdx.x;
  const int col0 = blockIdx.y * kBV;
  __shared__ SweepStage<IO, DK, CONV> st;

  float s[kBV];
  const size_t srow = ((size_t)bh * DK + tid) * DV + col0;
#pragma unroll
  for (int c = 0; c < kBV; ++c) s[c] = s0 ? to_f(s0[srow + c]) : 0.f;
  float tk[kConv] = {};  // dq needs S_t, hence k_t and v_t, but not q_t
  if constexpr (CONV) {
#pragma unroll
    for (int i = 0; i < kConv; ++i) tk[i] = to_f(wk[(size_t)(h * DK + tid) * kConv + i]);
  }
  load_v_taps(st, wv, h, DV, col0);

  const size_t kbase = (size_t)bh * T * DK, vbase = (size_t)bh * T * DV;
  float* dq_out = dqp + ((size_t)blockIdx.y * gridDim.x + bh) * T * DK + tid;
  for (int t0 = 0; t0 < T; t0 += kBwdStage) {
    const int n = min(kBwdStage, T - t0);
    __syncthreads();
    fill_stage(st, xq, xk, xv, gk, dout, kbase, vbase, DV, col0, t0, n);
    for (int j = 0; j < n; ++j) {
      const float k = qk_at<IO, DK, CONV>(st.xk, tk, j);
      const float eg = expf(st.g[j * DK + tid]);
      const float4* v4 = reinterpret_cast<const float4*>(st.v + j * kBV);
      const float4* d4 = reinterpret_cast<const float4*>(st.dout + j * kBV);
      float acc = 0.f;
#pragma unroll
      for (int c = 0; c < kBV; c += 4) {
        const float4 v = v4[c / 4], d = d4[c / 4];
        s[c] = eg * s[c] + k * v.x;         acc += s[c] * d.x;
        s[c + 1] = eg * s[c + 1] + k * v.y; acc += s[c + 1] * d.y;
        s[c + 2] = eg * s[c + 2] + k * v.z; acc += s[c + 2] * d.z;
        s[c + 3] = eg * s[c + 3] + k * v.w; acc += s[c + 3] * d.w;
      }
      dq_out[(size_t)(t0 + j) * DK] = acc * scale;
    }
  }
  float dsg = 0.f;
  if (dsf) {
#pragma unroll
    for (int c = 0; c < kBV; ++c) dsg += to_f(dsf[srow + c]) * s[c];
  }
  dsgp[((size_t)blockIdx.y * gridDim.x + bh) * DK + tid] = dsg;
}

// ---------------------------------------------------------------- kernel 2
// One stage of the transposing warp sum: lanes with bit OFF set keep the
// upper OFF values, the others the lower, and each adds its partner's. The
// trip counts are template constants, so vals stays in registers.
template <int OFF>
__device__ __forceinline__ void transpose_sum_stage(float (&vals)[kBV], int lane) {
  const bool upper = lane & OFF;
#pragma unroll
  for (int r = 0; r < OFF; ++r) {
    const float send = upper ? vals[r] : vals[r + OFF];
    const float keep = upper ? vals[r + OFF] : vals[r];
    vals[r] = keep + __shfl_xor_sync(kFullMask, send, OFF);
  }
  if constexpr (OFF > 1) transpose_sum_stage<OFF / 2>(vals, lane);
}

// Sum over the warp's 32 lanes of each of the 32 values: 31 shuffles; lane l
// ends with the sum of vals[l] in vals[0].
__device__ __forceinline__ float warp_transpose_sum(float (&vals)[kBV], int lane) {
  transpose_sum_stage<kBV / 2>(vals, lane);
  return vals[0];
}

// dkp: (DV/32, B*H, T, DK) parts of dk; dv: (B*H, T, DV), with CONV in f32
// (the gradient of the conv'd v, which the finishing pass takes further),
// without it in the IO dtype (dv itself); ds0 (B*H, DK, DV) or null.
template <typename IO, typename ST, int DK, bool CONV>
__global__ void __launch_bounds__(DK)
bwd_dkv_kernel(const IO* __restrict__ xq, const IO* __restrict__ xk, const IO* __restrict__ xv,
               const float* __restrict__ gk, const IO* __restrict__ wq,
               const IO* __restrict__ wk, const IO* __restrict__ wv,
               const IO* __restrict__ dout, const ST* __restrict__ dsf,
               float* __restrict__ dkp, std::conditional_t<CONV, float, IO>* __restrict__ dv,
               ST* __restrict__ ds0, int H, int T, int DV, float scale) {
  using DVT = std::conditional_t<CONV, float, IO>;
  constexpr int NW = DK / 32;  // warps
  const int bh = blockIdx.x, h = bh % H, tid = threadIdx.x;
  const int lane = tid % 32, warp = tid / 32;
  const int col0 = blockIdx.y * kBV;
  __shared__ SweepStage<IO, DK, CONV> st;
  __shared__ float dvred[kBwdStage * NW * kBV];

  // carry = diag(e^{g_{t+1}}) dS_{t+1}; dsf after the last step
  float carry[kBV];
  const size_t srow = ((size_t)bh * DK + tid) * DV + col0;
#pragma unroll
  for (int c = 0; c < kBV; ++c) carry[c] = dsf ? to_f(dsf[srow + c]) : 0.f;
  float tq[kConv] = {}, tk[kConv] = {};
  if constexpr (CONV) {
#pragma unroll
    for (int i = 0; i < kConv; ++i) {
      tq[i] = to_f(wq[(size_t)(h * DK + tid) * kConv + i]);
      tk[i] = to_f(wk[(size_t)(h * DK + tid) * kConv + i]);
    }
  }
  load_v_taps(st, wv, h, DV, col0);

  const size_t kbase = (size_t)bh * T * DK, vbase = (size_t)bh * T * DV;
  float* dk_out = dkp + ((size_t)blockIdx.y * gridDim.x + bh) * T * DK + tid;
  for (int t0 = (T - 1) / kBwdStage * kBwdStage; t0 >= 0; t0 -= kBwdStage) {
    const int n = min(kBwdStage, T - t0);
    __syncthreads();
    fill_stage(st, xq, xk, xv, gk, dout, kbase, vbase, DV, col0, t0, n);
    for (int j = n - 1; j >= 0; --j) {
      const float u = qk_at<IO, DK, CONV>(st.xq, tq, j) * scale;
      const float k = qk_at<IO, DK, CONV>(st.xk, tk, j);
      const float eg = expf(st.g[j * DK + tid]);
      const float4* v4 = reinterpret_cast<const float4*>(st.v + j * kBV);
      const float4* d4 = reinterpret_cast<const float4*>(st.dout + j * kBV);
      float vals[kBV];
      float dk = 0.f;
#pragma unroll
      for (int c = 0; c < kBV; c += 4) {
        const float4 v = v4[c / 4], d = d4[c / 4];
        const float vv[4] = {v.x, v.y, v.z, v.w}, dd[4] = {d.x, d.y, d.z, d.w};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float ds = carry[c + e] + u * dd[e];  // dS_t
          dk += ds * vv[e];
          vals[c + e] = k * ds;
          carry[c + e] = eg * ds;
        }
      }
      dk_out[(size_t)(t0 + j) * DK] = dk;
      dvred[(j * NW + warp) * kBV + lane] = warp_transpose_sum(vals, lane);
    }
    __syncthreads();
    for (int idx = tid; idx < n * kBV; idx += DK) {
      const int j = idx / kBV, c = idx % kBV;
      float sum = 0.f;
#pragma unroll
      for (int w = 0; w < NW; ++w) sum += dvred[(j * NW + w) * kBV + c];
      dv[vbase + (size_t)(t0 + j) * DV + col0 + c] = from_f<DVT>(sum);
    }
  }
  if (ds0) {
#pragma unroll
    for (int c = 0; c < kBV; ++c) ds0[srow + c] = from_f<ST>(carry[c]);
  }
}

// Launches the two sweeps (the arguments of kernels 1 and 2); returns the
// first cudaGetLastError() that is not 0.
template <typename IO, typename ST, int DK, bool CONV>
int launch_sweeps(const IO* xq, const IO* xk, const IO* xv, const float* gk, const IO* wq,
                  const IO* wk, const IO* wv, const ST* s0, const IO* dout, const ST* dsf,
                  float* dqp, float* dsgp, float* dkp, std::conditional_t<CONV, float, IO>* dv,
                  ST* ds0, int B, int H, int T, int DV, float scale, cudaStream_t stream) {
  const dim3 tiles(B * H, DV / kBV);
  bwd_dq_kernel<IO, ST, DK, CONV><<<tiles, DK, 0, stream>>>(xq, xk, xv, gk, wk, wv, s0, dout,
                                                           dsf, dqp, dsgp, H, T, DV, scale);
  int err = static_cast<int>(cudaGetLastError());
  if (err) return err;
  bwd_dkv_kernel<IO, ST, DK, CONV><<<tiles, DK, 0, stream>>>(
      xq, xk, xv, gk, wq, wk, wv, dout, dsf, dkp, dv, ds0, H, T, DV, scale);
  return static_cast<int>(cudaGetLastError());
}

// dq and dk of one (step, channel): the sums of the n_parts column tiles'
// parts, each in a fixed order. The thread's walk is bound by load latency,
// so 32 loads are in flight before the first add.
__device__ __forceinline__ void sum_parts(const float* pq, const float* pk, size_t part_stride,
                                          int n_parts, float& dq, float& dk) {
  constexpr int kBatch = 16;
  dq = 0.f;
  dk = 0.f;
  int i = 0;
  for (; i + kBatch <= n_parts; i += kBatch) {
    float vq[kBatch], vk[kBatch];
#pragma unroll
    for (int j = 0; j < kBatch; ++j) {
      vq[j] = pq[(i + j) * part_stride];
      vk[j] = pk[(i + j) * part_stride];
    }
#pragma unroll
    for (int j = 0; j < kBatch; ++j) {
      dq += vq[j];
      dk += vk[j];
    }
  }
  for (; i < n_parts; ++i) {
    dq += pq[i * part_stride];
    dk += pk[i * part_stride];
  }
}

// dg[bh, t, ch] += the totals of the segments after t's, in a fixed order.
// The finishing pass wrote each segment's running sum into dg and its total
// into dgt (segments, B*H, DK). (A template, so that the two sources that
// include this header do not both define its host stub.)
template <int SEG = kFinishSeg>
__global__ void bwd_dg_carry_kernel(float* __restrict__ dg, const float* __restrict__ dgt,
                                    int BH, int T, int DK, int n_seg) {
  const size_t idx = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (size_t)BH * T * DK) return;
  const int ch = idx % DK, t = (idx / DK) % T, bh = idx / ((size_t)DK * T);
  float carry = 0.f;
  for (int s = t / SEG + 1; s < n_seg; ++s) carry += dgt[((size_t)s * BH + bh) * DK + ch];
  dg[idx] += carry;
}

inline int launch_dg_carry(float* dg, const float* dgt, int BH, int T, int DK,
                           cudaStream_t stream) {
  const int n_seg = (T + kFinishSeg - 1) / kFinishSeg;
  if (n_seg <= 1) return 0;
  const size_t total = (size_t)BH * T * DK;
  bwd_dg_carry_kernel<><<<(unsigned)((total + 255) / 256), 256, 0, stream>>>(dg, dgt, BH, T, DK,
                                                                          n_seg);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace gla
