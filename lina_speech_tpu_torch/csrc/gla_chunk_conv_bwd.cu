// Backward of the GLA prefill with the q/k/v short convs fused in.
//
// Replaces the TPU kernel _conv_bwd_kernel (lina_speech_tpu/ops/
// gla_pallas.py:861, reached through gla_chunk_conv_pallas :1289 and
// _conv_bwd_impl :1038). From do (b, h, t, dv) and dsf (b, h, dk, dv) it
// computes dxq, dxk, dxv (IO dtype), dg (f32), ds0 (state dtype) and the
// three tap gradients summed over batch and time.
//
// Two routes compute dq, dk and dv of the post-conv q, k, v, the dsf .
// S_final term and ds0, one for each IO dtype; ops/gla_cuda.py:
// gla_chunk_conv_bwd_plan names it and passes it in:
// - recurrent (f32 IO): the two time sweeps of gla_chunk_bwd.cuh (CONV =
//   true; kernels 1 and 2, the math and what bounds them are described
//   there); dq and dk come as dv/32 per-tile parts, 537 MB of f32 at b8 h4
//   t512 dk256 dv512;
// - chunked (bf16 IO): the four kernels of gla_chunked_bwd.cuh, 64-row
//   chunks on the tensor cores; dq and dk come as one part each.
// Both end in the conv's finishing pass:
// 3. bwd_finish_kernel: one thread per (batch, head, channel, segment of 64
//    steps) walks its segment in reverse: the running sum for dg, silu', the
//    transposed conv (dx[s] = sum_j w_{3-j} dz[s+j]; the three dz after the
//    segment are recomputed) and the tap sums over the segment;
// 4. bwd_dg_carry_kernel (gla_chunk_bwd.cuh): adds to dg the totals of the
//    later segments;
// 5. bwd_taps_kernel: the tap gradients summed over batch and segments.
#include "gla_chunk_bwd.cuh"
#include "gla_chunked_bwd.cuh"

namespace gla {

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

// grid (DK/64 + ceil(DV/64), B*H, ceil(T/64)): the first DK/64 blocks of a
// row take the q and k channels (and dg), the others the v channels; z is the
// time segment. dg gets the running sum within the segment, dgt (segments,
// B*H, DK) the segment's total (the last segment's includes the dsf term).
// dqp, dkp: n_parts parts of dq and dk, (n_parts, B*H, T, DK); dsgp: n_sg
// parts of the dsf term, (n_sg, B*H, DK). dwp: (B * segments, H*(2 DK +
// DV), 4) tap gradients of one batch row and segment, q channels then k
// then v; or null.
template <typename IO>
__global__ void __launch_bounds__(kFinishThreads)
bwd_finish_kernel(const IO* __restrict__ xq, const IO* __restrict__ xk,
                  const IO* __restrict__ xv, const IO* __restrict__ wq,
                  const IO* __restrict__ wk, const IO* __restrict__ wv,
                  const float* __restrict__ dqp, const float* __restrict__ dkp,
                  const float* __restrict__ dsgp, const float* __restrict__ dvf,
                  IO* __restrict__ dxq, IO* __restrict__ dxk, IO* __restrict__ dxv,
                  float* __restrict__ dg, float* __restrict__ dgt, float* __restrict__ dwp,
                  int H, int T, int DK, int DV, int n_parts, int n_sg) {
  const int bh = blockIdx.y, b = bh / H, h = bh % H, BH = gridDim.y;
  const int seg = blockIdx.z, n_seg = gridDim.z;
  const int t_lo = seg * kFinishSeg, t_hi = min(T, t_lo + kFinishSeg);
  const int t_start = min(T, t_hi + kConv - 1) - 1;  // dz of three later steps
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
      for (int i = 0; i < n_sg; ++i) acc += dsgp[((size_t)i * BH + bh) * DK + ch];
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

// chunked: the chunked route's scratch (ops/gla_cuda.py:gla_chunk_conv_bwd),
// uf, kf, bc, kt, kl, ul, ull, states, states_lo, dstates, dstates_lo, vb,
// ebt; null for the recurrent route
template <typename IO, typename ST, int DK>
int launch_bwd(const void* xq, const void* xk, const void* xv, const void* gk, const void* wq,
               const void* wk, const void* wv, const void* s0, const void* dout,
               const void* dsf, void* dxq, void* dxk, void* dxv, void* dg, void* ds0, void* dw,
               void* dqp, void* dkp, void* dsgp, void* dvf, void* dgt, void* dwp,
               void* const* chunked, int B, int H, int T, int DV, float scale, int route,
               cudaStream_t stream) {
  const IO *xq_ = static_cast<const IO*>(xq), *xk_ = static_cast<const IO*>(xk),
           *xv_ = static_cast<const IO*>(xv), *wq_ = static_cast<const IO*>(wq),
           *wk_ = static_cast<const IO*>(wk), *wv_ = static_cast<const IO*>(wv);
  float *dqp_ = static_cast<float*>(dqp), *dkp_ = static_cast<float*>(dkp),
        *dsgp_ = static_cast<float*>(dsgp), *dvf_ = static_cast<float*>(dvf),
        *dgt_ = static_cast<float*>(dgt), *dwp_ = static_cast<float*>(dwp),
        *dg_ = static_cast<float*>(dg);
  int err = 0, n_parts = DV / kBV, n_sg = DV / kBV;
  // Each IO dtype has one body: bf16 the chunked, f32 the recurrent.
  if constexpr (std::is_same_v<IO, __nv_bfloat16>) {
    if (route != kChunked) return -4;
    using chunked::bf16;
    float* const* sf = reinterpret_cast<float* const*>(chunked);  // the f32 scratch
    bf16* const* sb = reinterpret_cast<bf16* const*>(chunked);    // the bf16 scratch
    err = chunked::launch_chunked<ST, true>(
        xq_, xk_, xv_, static_cast<const float*>(gk), wq_, wk_, wv_,
        static_cast<const ST*>(s0), static_cast<const bf16*>(dout),
        static_cast<const ST*>(dsf), static_cast<ST*>(ds0), dqp_, dkp_, dsgp_, dvf_, sf[0],
        sf[1], sf[2], sb[3], sb[4], sb[5], sb[6], sb[7], sb[8], sb[9], sb[10], sb[11], sf[12], B,
        H, T, DK, DV, scale, stream);
    n_parts = 1;
    n_sg = (DV + chunked::kTile - 1) / chunked::kTile + 1;
  } else {
    if (route != kRecurrent) return -4;
    err = launch_sweeps<IO, ST, DK, true>(
        xq_, xk_, xv_, static_cast<const float*>(gk), wq_, wk_, wv_, static_cast<const ST*>(s0),
        static_cast<const IO*>(dout), static_cast<const ST*>(dsf), dqp_, dsgp_, dkp_, dvf_,
        static_cast<ST*>(ds0), B, H, T, DV, scale, stream);
  }
  if (err) return err;
  const int n_seg = (T + kFinishSeg - 1) / kFinishSeg;
  const dim3 channels(DK / kFinishThreads + (DV + kFinishThreads - 1) / kFinishThreads, B * H,
                      n_seg);
  bwd_finish_kernel<IO><<<channels, kFinishThreads, 0, stream>>>(
      xq_, xk_, xv_, wq_, wk_, wv_, dqp_, dkp_, dsgp_, dvf_, static_cast<IO*>(dxq),
      static_cast<IO*>(dxk), static_cast<IO*>(dxv), dg_, dgt_, dwp_, H, T, DK, DV, n_parts,
      n_sg);
  err = static_cast<int>(cudaGetLastError());
  if (err) return err;
  err = launch_dg_carry(dg_, dgt_, B * H, T, DK, stream);
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
// (dwp is then null too). route: 0 recurrent (f32 IO), 1 chunked (bf16 IO).
// Scratch, f32 unless said: dqp and dkp (P, B, H, T, DK) and dsgp (Q, B, H,
// DK) with P = Q = DV/32 (recurrent) or P = 1, Q = ceil(DV/64) + 1 (chunked); dvf
// (B, H, T, DV), dgt (ceil(T/64), B, H, DK), dwp (B * ceil(T/64), H * (2 DK +
// DV), 4); for the chunked route only (else null), with nc = ceil(T/64) and
// Tp = 64 nc: uf, kf, bc (B*H, Tp, DK), kt, kl, ul, ull (B*H, Tp, DK) bf16,
// states, states_lo, dstates and dstates_lo (B*H, nc, DK, DV) bf16, vb (B*H,
// Tp, DV) bf16, ebt (B*H, nc, DK).
// All contiguous, do 16-byte aligned for the chunked route; T >= 1. Returns
// the first launch's cudaGetLastError() that is not 0, -1 for an
// unsupported DK, -2 for unsupported dtype codes, -3 for DV % 32 != 0, -4
// for a route that is not the IO dtype's.
extern "C" int gla_chunk_conv_bwd(const void* xq, const void* xk, const void* xv,
                                  const void* gk, const void* wq, const void* wk,
                                  const void* wv, const void* s0, const void* dout,
                                  const void* dsf, void* dxq, void* dxk, void* dxv, void* dg,
                                  void* ds0, void* dw, void* dqp, void* dkp, void* dsgp,
                                  void* dvf, void* dgt, void* dwp, void* uf, void* kf, void* bc,
                                  void* kt, void* kl, void* ul, void* ull, void* states,
                                  void* states_lo, void* dstates, void* dstates_lo, void* vb,
                                  void* ebt, int B, int H, int T, int DK_, int DV, float scale,
                                  int io_dtype, int state_dtype, int route, void* stream) {
  if (DV % gla::kBV != 0) return -3;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  void* const chunked[13] = {uf,     kf,        bc,      kt,         kl, ul, ull,
                             states, states_lo, dstates, dstates_lo, vb, ebt};
  GLA_DISPATCH_TYPES(io_dtype, state_dtype,
                     GLA_DISPATCH_DK(DK_, return gla::launch_bwd<IO, ST, DK>(
                         xq, xk, xv, gk, wq, wk, wv, s0, dout, dsf, dxq, dxk, dxv, dg, ds0, dw,
                         dqp, dkp, dsgp, dvf, dgt, dwp, chunked, B, H, T, DV, scale, route,
                         st)))
  return -2;
}
