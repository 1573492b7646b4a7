// Backward of the GLA prefill with the q/k/v short convs fused in.
//
// Replaces the TPU kernel _conv_bwd_kernel (lina_speech_tpu/ops/
// gla_pallas.py:861, reached through gla_chunk_conv_pallas :1289 and
// _conv_bwd_impl :1038). From do (b, h, t, dv) and dsf (b, h, dk, dv) it
// computes dxq, dxk, dxv (IO dtype), dg (f32), ds0 (state dtype) and the
// three tap gradients summed over batch and time.
//
// The forward (gla_chunk.cuh), per (batch, head), with u_t = scale q_t:
//
//   q_t = silu(rnd(conv(xq)_t)), k_t likewise, v_t = rnd(silu(rnd(conv(xv)_t)))
//   S_t = diag(e^{g_t}) S_{t-1} + k_t^T v_t,      o_t = u_t S_t
//
// The TPU kernel walks 64-row chunks in reverse with MXU products and reads
// the chunk states the training forward saved. This is the recurrent form
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
// Five kernels, launched one after another on the caller's stream:
// 1. bwd_dq_kernel: a forward sweep that recomputes the convs and S_t from s0
//    and emits dq_t and the dsf . S_final term;
// 2. bwd_dkv_kernel: a reverse sweep that carries dS and emits dk_t, dv_t
//    and ds0;
// 3. bwd_finish_kernel: one thread per (batch, head, channel, segment of 64
//    steps) walks its segment in reverse: the running sum for dg, silu', the
//    transposed conv (dx[s] = sum_j w_{3-j} dz[s+j]; the three dz after the
//    segment are recomputed) and the tap sums over the segment;
// 4. bwd_dg_carry_kernel: adds to dg the totals of the later segments;
// 5. bwd_taps_kernel: the tap gradients summed over batch and segments.
//
// In the sweeps a block owns a (DK x 32) tile of one (batch, head) state, as
// the forward does, but with one thread per key ROW holding the row's 32
// columns in registers: the sums over columns (dq, dk) stay inside a thread,
// each thread convolves its own q/k channel (no exchange, no barrier inside
// a stage of 8 steps), and only dv needs a sum over rows (a warp butterfly,
// then shared memory across warps, once per stage). dq and dk are sums over
// the DV/32 column tiles of a (batch, head): every tile writes its part to
// its own f32 buffer and kernel 3 adds them in a fixed order, so gradients
// are the same from run to run (atomicAdd would reorder f32 sums). The
// parts are 2 * (DV/32) * b*h*t*DK*4 bytes (537 MB at b8 h4 t512), scratch
// that lives for this call only. A ragged t needs no padding.
//
// What bounds it on the H100: the two serial time loops (one dependent
// update per token), not bytes or FLOPs, as in the forward.
#include "gla_common.cuh"

namespace gla {

constexpr int kBwdStage = 8;           // time steps staged per pass
constexpr int kFinishThreads = 64;     // channels per block in bwd_finish_kernel
constexpr int kFinishSeg = 64;         // time steps per thread in bwd_finish_kernel
constexpr unsigned kFullMask = 0xffffffffu;
static_assert(kBV == 32, "a warp's lanes stand for the 32 columns of a tile");

// d silu(z) / dz
__device__ __forceinline__ float dsilu(float z) {
  const float s = 1.f / (1.f + expf(-z));
  return s * (1.f + z * (1.f - s));
}

// Shared staging of one pass of the sweeps: rows t0-3 .. t0+n-1 of xq and xk
// (slot [r * DK + tid] is read and written by thread tid only), the gates of
// t0 .. t0+n-1, and the block's 32 value columns: conv'd v and do in f32.
template <typename IO, int DK>
struct SweepStage {
  IO xq[(kBwdStage + kConv - 1) * DK];
  IO xk[(kBwdStage + kConv - 1) * DK];
  float g[kBwdStage * DK];
  IO xv[(kBwdStage + kConv - 1) * kBV];
  __align__(16) float v[kBwdStage * kBV];
  __align__(16) float dout[kBwdStage * kBV];
  float wv[kBV * kConv];
};

template <typename IO, int DK>
__device__ __forceinline__ void load_v_taps(SweepStage<IO, DK>& st, const IO* wv, int h, int DV,
                                            int col0) {
  for (int idx = threadIdx.x; idx < kBV * kConv; idx += DK)
    st.wv[idx] = to_f(wv[(size_t)(h * DV + col0) * kConv + idx]);
}

// Fills the stage for steps t0 .. t0+n-1. Ends on a barrier; the caller
// puts one before it (the previous pass still reads v and dout).
template <typename IO, int DK>
__device__ __forceinline__ void fill_stage(SweepStage<IO, DK>& st, const IO* xq, const IO* xk,
                                           const IO* xv, const float* gk, const IO* dout,
                                           size_t kbase, size_t vbase, int DV, int col0, int t0,
                                           int n) {
  const int tid = threadIdx.x;
  for (int r = 0; r < n + kConv - 1; ++r) {
    const int t = t0 - (kConv - 1) + r;
    st.xq[r * DK + tid] = t >= 0 ? xq[kbase + (size_t)t * DK + tid] : from_f<IO>(0.f);
    st.xk[r * DK + tid] = t >= 0 ? xk[kbase + (size_t)t * DK + tid] : from_f<IO>(0.f);
  }
  for (int r = 0; r < n; ++r) st.g[r * DK + tid] = gk[kbase + (size_t)(t0 + r) * DK + tid];
  for (int idx = tid; idx < (n + kConv - 1) * kBV; idx += DK) {
    const int t = t0 - (kConv - 1) + idx / kBV;
    st.xv[idx] = t >= 0 ? xv[vbase + (size_t)t * DV + col0 + idx % kBV] : from_f<IO>(0.f);
  }
  for (int idx = tid; idx < n * kBV; idx += DK)
    st.dout[idx] = to_f(dout[vbase + (size_t)(t0 + idx / kBV) * DV + col0 + idx % kBV]);
  __syncthreads();
  for (int idx = tid; idx < n * kBV; idx += DK) {
    const int j = idx / kBV, c = idx % kBV;
    float z = 0.f;
#pragma unroll
    for (int i = 0; i < kConv; ++i) z = z + st.wv[c * kConv + i] * to_f(st.xv[(j + i) * kBV + c]);
    st.v[idx] = round_io<IO>(silu(round_io<IO>(z)));
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

// ---------------------------------------------------------------- kernel 1
// dqp: (DV/32, B*H, T, DK) parts of dq; dsgp: (DV/32, B*H, DK) parts of
// sum_c dsf . S_final.
template <typename IO, typename ST, int DK>
__global__ void __launch_bounds__(DK)
bwd_dq_kernel(const IO* __restrict__ xq, const IO* __restrict__ xk, const IO* __restrict__ xv,
              const float* __restrict__ gk, const IO* __restrict__ wq,
              const IO* __restrict__ wk, const IO* __restrict__ wv,
              const ST* __restrict__ s0, const IO* __restrict__ dout,
              const ST* __restrict__ dsf, float* __restrict__ dqp, float* __restrict__ dsgp,
              int H, int T, int DV, float scale) {
  const int bh = blockIdx.x, h = bh % H, tid = threadIdx.x;
  const int col0 = blockIdx.y * kBV;
  __shared__ SweepStage<IO, DK> st;

  float s[kBV];
  const size_t srow = ((size_t)bh * DK + tid) * DV + col0;
#pragma unroll
  for (int c = 0; c < kBV; ++c) s[c] = s0 ? to_f(s0[srow + c]) : 0.f;
  float tk[kConv];  // dq needs S_t, hence k_t and v_t, but not q_t
#pragma unroll
  for (int i = 0; i < kConv; ++i) tk[i] = to_f(wk[(size_t)(h * DK + tid) * kConv + i]);
  load_v_taps(st, wv, h, DV, col0);

  const size_t kbase = (size_t)bh * T * DK, vbase = (size_t)bh * T * DV;
  float* dq_out = dqp + ((size_t)blockIdx.y * gridDim.x + bh) * T * DK + tid;
  for (int t0 = 0; t0 < T; t0 += kBwdStage) {
    const int n = min(kBwdStage, T - t0);
    __syncthreads();
    fill_stage(st, xq, xk, xv, gk, dout, kbase, vbase, DV, col0, t0, n);
    for (int j = 0; j < n; ++j) {
      const float k = silu(conv_pre<IO, DK>(st.xk, tk, j));
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

// dkp: (DV/32, B*H, T, DK) parts of dk; dvf: (B*H, T, DV) f32, the gradient
// of the conv'd v; ds0 (B*H, DK, DV) or null.
template <typename IO, typename ST, int DK>
__global__ void __launch_bounds__(DK)
bwd_dkv_kernel(const IO* __restrict__ xq, const IO* __restrict__ xk, const IO* __restrict__ xv,
               const float* __restrict__ gk, const IO* __restrict__ wq,
               const IO* __restrict__ wk, const IO* __restrict__ wv,
               const IO* __restrict__ dout, const ST* __restrict__ dsf,
               float* __restrict__ dkp, float* __restrict__ dvf, ST* __restrict__ ds0,
               int H, int T, int DV, float scale) {
  constexpr int NW = DK / 32;  // warps
  const int bh = blockIdx.x, h = bh % H, tid = threadIdx.x;
  const int lane = tid % 32, warp = tid / 32;
  const int col0 = blockIdx.y * kBV;
  __shared__ SweepStage<IO, DK> st;
  __shared__ float dvred[kBwdStage * NW * kBV];

  // carry = diag(e^{g_{t+1}}) dS_{t+1}; dsf after the last step
  float carry[kBV];
  const size_t srow = ((size_t)bh * DK + tid) * DV + col0;
#pragma unroll
  for (int c = 0; c < kBV; ++c) carry[c] = dsf ? to_f(dsf[srow + c]) : 0.f;
  float tq[kConv], tk[kConv];
#pragma unroll
  for (int i = 0; i < kConv; ++i) {
    tq[i] = to_f(wq[(size_t)(h * DK + tid) * kConv + i]);
    tk[i] = to_f(wk[(size_t)(h * DK + tid) * kConv + i]);
  }
  load_v_taps(st, wv, h, DV, col0);

  const size_t kbase = (size_t)bh * T * DK, vbase = (size_t)bh * T * DV;
  float* dk_out = dkp + ((size_t)blockIdx.y * gridDim.x + bh) * T * DK + tid;
  for (int t0 = (T - 1) / kBwdStage * kBwdStage; t0 >= 0; t0 -= kBwdStage) {
    const int n = min(kBwdStage, T - t0);
    __syncthreads();
    fill_stage(st, xq, xk, xv, gk, dout, kbase, vbase, DV, col0, t0, n);
    for (int j = n - 1; j >= 0; --j) {
      const float u = silu(conv_pre<IO, DK>(st.xq, tq, j)) * scale;
      const float k = silu(conv_pre<IO, DK>(st.xk, tk, j));
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
      dvf[vbase + (size_t)(t0 + j) * DV + col0 + c] = sum;
    }
  }
  if (ds0) {
#pragma unroll
    for (int c = 0; c < kBV; ++c) ds0[srow + c] = from_f<ST>(carry[c]);
  }
}

// ---------------------------------------------------------------- kernel 3
// One channel's conv backward, walking time in reverse.
template <typename IO>
struct ConvBwdChannel {
  float w[kConv];   // taps, tap 0 oldest
  float xw[kConv];  // x[t-3 .. t]
  float dz[kConv];  // dz[t .. t+3] once step(t) has run
  float dw[kConv];  // tap gradients summed over time
  const IO* x;      // the channel's x[0]; x[t] at x[t * stride]
  size_t stride;

  // the window starts at step T - 1
  __device__ __forceinline__ void init(const IO* x_, size_t stride_, const IO* taps, int T) {
    x = x_;
    stride = stride_;
#pragma unroll
    for (int i = 0; i < kConv; ++i) {
      w[i] = to_f(taps[i]);
      dz[i] = 0.f;
      dw[i] = 0.f;
      const int t = T - kConv + i;
      xw[i] = t >= 0 ? to_f(x[(size_t)t * stride]) : 0.f;
    }
  }

  // rounded pre-activation of the step the window stands at
  __device__ __forceinline__ float pre() const {
    float z = 0.f;
#pragma unroll
    for (int i = 0; i < kConv; ++i) z = z + w[i] * xw[i];
    return round_io<IO>(z);
  }

  // Takes dy, the gradient of silu(zr) at step t; returns dx[t] and moves
  // the window to step t - 1. A step that is not ``live`` belongs to the
  // next segment: it only feeds dz, and its tap terms are that segment's.
  __device__ __forceinline__ float step(float dy, float zr, int t, bool live) {
    const float d = dy * dsilu(zr);
    if (live) {
#pragma unroll
      for (int i = 0; i < kConv; ++i) dw[i] += d * xw[i];
    }
    dz[3] = dz[2]; dz[2] = dz[1]; dz[1] = dz[0]; dz[0] = d;
    const float dx = w[3] * dz[0] + w[2] * dz[1] + w[1] * dz[2] + w[0] * dz[3];
    xw[3] = xw[2]; xw[2] = xw[1]; xw[1] = xw[0];
    xw[0] = t >= kConv ? to_f(x[(size_t)(t - kConv) * stride]) : 0.f;
    return dx;
  }

  __device__ __forceinline__ void store_taps(float* out) const {
#pragma unroll
    for (int i = 0; i < kConv; ++i) out[i] = dw[i];
  }
};

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

// grid (DK/64 + ceil(DV/64), B*H, ceil(T/64)): the first DK/64 blocks of a
// row take the q and k channels (and dg), the others the v channels; z is the
// time segment. dg gets the running sum within the segment, dgt (segments,
// B*H, DK) the segment's total (the last segment's includes the dsf term).
// dwp: (B * segments, H*(2 DK + DV), 4) tap gradients of one batch row and
// segment, q channels then k then v; or null.
template <typename IO>
__global__ void __launch_bounds__(kFinishThreads)
bwd_finish_kernel(const IO* __restrict__ xq, const IO* __restrict__ xk,
                  const IO* __restrict__ xv, const IO* __restrict__ wq,
                  const IO* __restrict__ wk, const IO* __restrict__ wv,
                  const float* __restrict__ dqp, const float* __restrict__ dkp,
                  const float* __restrict__ dsgp, const float* __restrict__ dvf,
                  IO* __restrict__ dxq, IO* __restrict__ dxk, IO* __restrict__ dxv,
                  float* __restrict__ dg, float* __restrict__ dgt, float* __restrict__ dwp,
                  int H, int T, int DK, int DV) {
  const int bh = blockIdx.y, b = bh / H, h = bh % H, BH = gridDim.y;
  const int seg = blockIdx.z, n_seg = gridDim.z;
  const int t_lo = seg * kFinishSeg, t_hi = min(T, t_lo + kFinishSeg);
  const int t_start = min(T, t_hi + kConv - 1) - 1;  // dz of three later steps
  const int n_parts = DV / kBV;
  const int qk_blocks = DK / kFinishThreads;
  float* dw_row =
      dwp ? dwp + ((size_t)b * n_seg + seg) * H * (2 * DK + DV) * kConv : nullptr;
  if ((int)blockIdx.x < qk_blocks) {
    const int ch = blockIdx.x * kFinishThreads + threadIdx.x;
    const size_t base = (size_t)bh * T * DK + ch;
    const size_t part = (size_t)BH * T * DK;
    ConvBwdChannel<IO> cq, ck;
    cq.init(xq + base, DK, wq + (size_t)(h * DK + ch) * kConv, t_start + 1);
    ck.init(xk + base, DK, wk + (size_t)(h * DK + ch) * kConv, t_start + 1);
    float acc = 0.f;
    if (seg == n_seg - 1)
      for (int i = 0; i < n_parts; ++i) acc += dsgp[((size_t)i * BH + bh) * DK + ch];
    for (int t = t_start; t >= t_lo; --t) {
      const bool live = t < t_hi;
      float dq, dk;
      sum_parts(dqp + base + (size_t)t * DK, dkp + base + (size_t)t * DK, part, n_parts, dq,
                dk);
      const float zq = cq.pre(), zk = ck.pre();
      const float dx_q = cq.step(dq, zq, t, live), dx_k = ck.step(dk, zk, t, live);
      if (live) {
        acc += silu(zq) * dq - silu(zk) * dk;
        dg[base + (size_t)t * DK] = acc;
        dxq[base + (size_t)t * DK] = from_f<IO>(dx_q);
        dxk[base + (size_t)t * DK] = from_f<IO>(dx_k);
      }
    }
    dgt[((size_t)seg * BH + bh) * DK + ch] = acc;
    if (dw_row) {
      cq.store_taps(dw_row + (size_t)(h * DK + ch) * kConv);
      ck.store_taps(dw_row + (size_t)(H * DK + h * DK + ch) * kConv);
    }
  } else {
    const int ch = (blockIdx.x - qk_blocks) * kFinishThreads + threadIdx.x;
    if (ch >= DV) return;
    const size_t base = (size_t)bh * T * DV + ch;
    ConvBwdChannel<IO> cv;
    cv.init(xv + base, DV, wv + (size_t)(h * DV + ch) * kConv, t_start + 1);
    for (int t = t_start; t >= t_lo; --t) {
      const bool live = t < t_hi;
      const float dy = dvf[base + (size_t)t * DV];
      const float zv = cv.pre();
      const float dx_v = cv.step(dy, zv, t, live);
      if (live) dxv[base + (size_t)t * DV] = from_f<IO>(dx_v);
    }
    if (dw_row) cv.store_taps(dw_row + (size_t)(2 * H * DK + h * DV + ch) * kConv);
  }
}

// ---------------------------------------------------------------- kernel 4
// dg[bh, t, ch] += the totals of the segments after t's, in a fixed order.
__global__ void bwd_dg_carry_kernel(float* __restrict__ dg, const float* __restrict__ dgt,
                                    int BH, int T, int DK, int n_seg) {
  const size_t idx = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (size_t)BH * T * DK) return;
  const int ch = idx % DK, t = (idx / DK) % T, bh = idx / ((size_t)DK * T);
  float carry = 0.f;
  for (int s = t / kFinishSeg + 1; s < n_seg; ++s) carry += dgt[((size_t)s * BH + bh) * DK + ch];
  dg[idx] += carry;
}

// ---------------------------------------------------------------- kernel 5
// dw[i] = sum_r dwp[r, i] over the rows (batch x segment), rounded to the
// taps' dtype.
template <typename IO>
__global__ void bwd_taps_kernel(const float* __restrict__ dwp, IO* __restrict__ dw, int rows,
                                int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float s = 0.f;
  for (int r = 0; r < rows; ++r) s += dwp[(size_t)r * n + i];
  dw[i] = from_f<IO>(s);
}

template <typename IO, typename ST, int DK>
int launch_bwd(const void* xq, const void* xk, const void* xv, const void* gk, const void* wq,
               const void* wk, const void* wv, const void* s0, const void* dout,
               const void* dsf, void* dxq, void* dxk, void* dxv, void* dg, void* ds0, void* dw,
               void* dqp, void* dkp, void* dsgp, void* dvf, void* dgt, void* dwp, int B, int H,
               int T, int DV, float scale, cudaStream_t stream) {
  const IO *xq_ = static_cast<const IO*>(xq), *xk_ = static_cast<const IO*>(xk),
           *xv_ = static_cast<const IO*>(xv), *wq_ = static_cast<const IO*>(wq),
           *wk_ = static_cast<const IO*>(wk), *wv_ = static_cast<const IO*>(wv),
           *do_ = static_cast<const IO*>(dout);
  const float* gk_ = static_cast<const float*>(gk);
  const ST* dsf_ = static_cast<const ST*>(dsf);
  float *dqp_ = static_cast<float*>(dqp), *dkp_ = static_cast<float*>(dkp),
        *dsgp_ = static_cast<float*>(dsgp), *dvf_ = static_cast<float*>(dvf),
        *dgt_ = static_cast<float*>(dgt), *dwp_ = static_cast<float*>(dwp),
        *dg_ = static_cast<float*>(dg);
  const dim3 tiles(B * H, DV / kBV);
  bwd_dq_kernel<IO, ST, DK><<<tiles, DK, 0, stream>>>(
      xq_, xk_, xv_, gk_, wq_, wk_, wv_, static_cast<const ST*>(s0), do_, dsf_, dqp_, dsgp_,
      H, T, DV, scale);
  int err = static_cast<int>(cudaGetLastError());
  if (err) return err;
  bwd_dkv_kernel<IO, ST, DK><<<tiles, DK, 0, stream>>>(
      xq_, xk_, xv_, gk_, wq_, wk_, wv_, do_, dsf_, dkp_, dvf_, static_cast<ST*>(ds0),
      H, T, DV, scale);
  err = static_cast<int>(cudaGetLastError());
  if (err) return err;
  const int n_seg = (T + kFinishSeg - 1) / kFinishSeg;
  const dim3 channels(DK / kFinishThreads + (DV + kFinishThreads - 1) / kFinishThreads, B * H,
                      n_seg);
  bwd_finish_kernel<IO><<<channels, kFinishThreads, 0, stream>>>(
      xq_, xk_, xv_, wq_, wk_, wv_, dqp_, dkp_, dsgp_, dvf_, static_cast<IO*>(dxq),
      static_cast<IO*>(dxk), static_cast<IO*>(dxv), dg_, dgt_, dwp_, H, T, DK, DV);
  err = static_cast<int>(cudaGetLastError());
  if (err) return err;
  if (n_seg > 1) {
    const size_t total = (size_t)B * H * T * DK;
    bwd_dg_carry_kernel<<<(unsigned)((total + 255) / 256), 256, 0, stream>>>(dg_, dgt_, B * H, T,
                                                                            DK, n_seg);
    err = static_cast<int>(cudaGetLastError());
  }
  if (err || !dw) return err;
  const int n = H * (2 * DK + DV) * kConv;
  bwd_taps_kernel<IO><<<(n + 255) / 256, 256, 0, stream>>>(dwp_, static_cast<IO*>(dw),
                                                           B * n_seg, n);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace gla

// C entry point (bound with ctypes in ops/gla_cuda.py). Inputs as
// gla_chunk_conv_fwd, plus dout (B, H, T, DV) in the IO dtype and dsf (B, H,
// DK, DV) in the state dtype or null (zeros). Outputs: dxq, dxk (B, H, T, DK)
// and dxv (B, H, T, DV) in the IO dtype; dg (B, H, T, DK) f32; ds0 (B, H, DK,
// DV) in the state dtype, or null to skip it; dw (H * (2 DK + DV), 4) in the
// IO dtype, the q taps' gradient, then k's, then v's, or null to skip them
// (dwp is then null too). Scratch, all f32: dqp and dkp (DV/32, B, H, T, DK),
// dsgp (DV/32, B, H, DK), dvf (B, H, T, DV), dgt (ceil(T/64), B, H, DK), dwp
// (B * ceil(T/64), H * (2 DK + DV), 4). All contiguous; T >= 1. Returns the first launch's cudaGetLastError() that is
// not 0, -1 for an unsupported DK, -2 for unsupported dtype codes, -3 for
// DV % 32 != 0.
extern "C" int gla_chunk_conv_bwd(const void* xq, const void* xk, const void* xv,
                                  const void* gk, const void* wq, const void* wk,
                                  const void* wv, const void* s0, const void* dout,
                                  const void* dsf, void* dxq, void* dxk, void* dxv, void* dg,
                                  void* ds0, void* dw, void* dqp, void* dkp, void* dsgp,
                                  void* dvf, void* dgt, void* dwp, int B, int H, int T, int DK_,
                                  int DV,
                                  float scale, int io_dtype, int state_dtype, void* stream) {
  if (DV % gla::kBV != 0) return -3;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  GLA_DISPATCH_TYPES(io_dtype, state_dtype,
                     GLA_DISPATCH_DK(DK_, return gla::launch_bwd<IO, ST, DK>(
                         xq, xk, xv, gk, wq, wk, wv, s0, dout, dsf, dxq, dxk, dxv, dg, ds0, dw,
                         dqp, dkp, dsgp, dvf, dgt, dwp, B, H, T, DV, scale, st)))
  return -2;
}
