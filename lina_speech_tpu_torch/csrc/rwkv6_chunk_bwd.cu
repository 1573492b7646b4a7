// Backward of the RWKV-6 prefill (rwkv6_chunk.cu): the training of every
// RWKV6 layer.
//
// Replaces the TPU kernel _bwd_kernel (lina_speech_tpu/ops/rwkv6_pallas.py
// :137, reached through rwkv6_chunk_pallas :565, _vjp_bwd and _bwd_impl
// :335 -> pallas_call :354). From do (b, h, t, dv) and dsf (b, h, dk, dv) it
// computes dr, dk, dv (IO dtype), dw (f32), du (h, dk) f32 and ds0 (state
// dtype).
//
// The forward, per (batch, head): o_t = r_t (S_{t-1} + diag(u) k_t^T v_t),
// S_t = diag(e^{w_t}) S_{t-1} + k_t^T v_t. With D_t the total cotangent of
// S_t (D_{t_last} = dsf) and vdo_t = v_t . do_t, the readout enters the
// reverse sweep one step late:
//
//   D_{t-1} = diag(e^{w_t}) D_t + r_t^T do_t          (ds0 = D_{-1})
//   dr_t = S_{t-1} do_t^T + u k_t vdo_t
//   dk_t = D_t v_t^T      + u r_t vdo_t
//   dv_t = k_t D_t + (r_t . (u k_t)) do_t
//   du   = sum over batch and time of r_t k_t vdo_t
//
// The bonus is a per-token local term. The decay w_j reaches the inclusive
// cumsum b_t for t >= j (k side and the final state) but the exclusive one
// for t > j (r side, the readout sees S_{t-1}), so dw has two parts:
//
//   dw_j = sum_{t>=j} (-k_t dkS_t) + sum_{t>j} r_t drS_t + [dsf . S_final]
//
// with drS, dkS the state parts of dr and dk (without the bonus) and the
// last term summed over the value columns (the module docstring of
// rwkv6_pallas.py derives the same split).
//
// The TPU kernel walks chunks in reverse with MXU products and reads the
// chunk states its training forward saved. This is the recurrent form of
// the same function and needs no saved state (the training forward is the
// inference kernel), as the GLA backward (gla_chunk_bwd.cuh), whose staging
// (SweepStage, fill_stage), warp sums and dw carry it reuses:
// 1. rwkv6_bwd_dr_kernel: a forward sweep that recomputes S_t from s0 and
//    emits the column tiles' parts of drS_t, of vdo_t and of dsf . S_final;
// 2. rwkv6_bwd_dkv_kernel: a reverse sweep that carries D and emits the
//    parts of dkS_t, dv_t (bonus included) and ds0;
// 3. rwkv6_bwd_finish_kernel: one thread per (batch, head, key channel,
//    segment of 64 steps) adds the parts in a fixed order, writes dr and dk,
//    walks its segment in reverse for the running sum of dw, and writes its
//    segment's share of du;
// 4. bwd_dg_carry_kernel (gla_chunk_bwd.cuh): adds to dw the totals of the
//    later segments;
// 5. rwkv6_bwd_du_kernel: du (h, dk), the segments' shares summed over
//    batch and segment in a fixed order, so du is the same from run to run.
// In the sweeps a block owns a (DK x 32) tile of one (batch, head) state
// with one thread per key row holding the row's 32 columns in registers.
// Scratch, f32: drp and dkp (DV/32, b, h, t, DK), vdop (DV/32, b, h, t),
// dsgp (DV/32, b, h, DK), dwt and dup (ceil(t/64), b, h, DK): 268 MB at b8
// h4 t512 dk256 dv256, for one call only.
//
// What bounds it on the H100: the two serial time loops (one dependent
// update per token), not bytes or FLOPs, as in the forward.
#include "gla_chunk_bwd.cuh"

namespace rwkv6 {

using gla::SweepStage;
using gla::fill_stage;
using gla::from_f;
using gla::kBV;
using gla::kBwdStage;
using gla::kFinishSeg;
using gla::kFinishThreads;
using gla::to_f;

// ---------------------------------------------------------------- kernel 1
template <typename IO, typename ST, int DK>
__global__ void __launch_bounds__(DK)
rwkv6_bwd_dr_kernel(const IO* __restrict__ r, const IO* __restrict__ k,
                    const IO* __restrict__ v, const float* __restrict__ w,
                    const ST* __restrict__ s0, const IO* __restrict__ dout,
                    const ST* __restrict__ dsf, float* __restrict__ drp,
                    float* __restrict__ vdop, float* __restrict__ dsgp, int T, int DV) {
  const int bh = blockIdx.x, tid = threadIdx.x;
  const int col0 = blockIdx.y * kBV;
  __shared__ SweepStage<IO, DK, false> st;

  float s[kBV];
  const size_t srow = ((size_t)bh * DK + tid) * DV + col0;
#pragma unroll
  for (int c = 0; c < kBV; ++c) s[c] = s0 ? to_f(s0[srow + c]) : 0.f;

  const size_t kbase = (size_t)bh * T * DK, vbase = (size_t)bh * T * DV;
  const size_t part = (size_t)blockIdx.y * gridDim.x + bh;
  float* dr_out = drp + part * T * DK + tid;
  for (int t0 = 0; t0 < T; t0 += kBwdStage) {
    const int n = min(kBwdStage, T - t0);
    __syncthreads();
    fill_stage(st, r, k, v, w, dout, kbase, vbase, DV, col0, t0, n);
    if (tid < n) {  // this tile's part of v_t . do_t
      float vdo = 0.f;
#pragma unroll
      for (int c = 0; c < kBV; ++c) vdo += st.v[tid * kBV + c] * st.dout[tid * kBV + c];
      vdop[part * T + t0 + tid] = vdo;
    }
    for (int j = 0; j < n; ++j) {
      const float kk = to_f(st.xk[j * DK + tid]);
      const float ew = expf(st.g[j * DK + tid]);
      const float4* v4 = reinterpret_cast<const float4*>(st.v + j * kBV);
      const float4* d4 = reinterpret_cast<const float4*>(st.dout + j * kBV);
      float acc = 0.f;  // S_{t-1} do_t^T: the readout before the update
#pragma unroll
      for (int c = 0; c < kBV; c += 4) {
        const float4 vv = v4[c / 4], d = d4[c / 4];
        acc += s[c] * d.x;     s[c] = ew * s[c] + kk * vv.x;
        acc += s[c + 1] * d.y; s[c + 1] = ew * s[c + 1] + kk * vv.y;
        acc += s[c + 2] * d.z; s[c + 2] = ew * s[c + 2] + kk * vv.z;
        acc += s[c + 3] * d.w; s[c + 3] = ew * s[c + 3] + kk * vv.w;
      }
      dr_out[(size_t)(t0 + j) * DK] = acc;
    }
  }
  float dsg = 0.f;
  if (dsf) {
#pragma unroll
    for (int c = 0; c < kBV; ++c) dsg += to_f(dsf[srow + c]) * s[c];
  }
  dsgp[part * DK + tid] = dsg;
}

// ---------------------------------------------------------------- kernel 2
// dkp: (DV/32, B*H, T, DK) parts of dkS; dv (B*H, T, DV) in the IO dtype;
// ds0 (B*H, DK, DV) or null.
template <typename IO, typename ST, int DK>
__global__ void __launch_bounds__(DK)
rwkv6_bwd_dkv_kernel(const IO* __restrict__ r, const IO* __restrict__ k,
                     const IO* __restrict__ v, const float* __restrict__ w,
                     const float* __restrict__ u, const IO* __restrict__ dout,
                     const ST* __restrict__ dsf, float* __restrict__ dkp,
                     IO* __restrict__ dv, ST* __restrict__ ds0, int H, int T, int DV) {
  constexpr int NW = DK / 32;  // warps
  const int bh = blockIdx.x, h = bh % H, tid = threadIdx.x;
  const int lane = tid % 32, warp = tid / 32;
  const int col0 = blockIdx.y * kBV;
  __shared__ SweepStage<IO, DK, false> st;
  __shared__ float dvred[kBwdStage * NW * kBV];

  // carry = D_t when step t is reached: dsf after the last step
  float carry[kBV];
  const size_t srow = ((size_t)bh * DK + tid) * DV + col0;
#pragma unroll
  for (int c = 0; c < kBV; ++c) carry[c] = dsf ? to_f(dsf[srow + c]) : 0.f;
  const float u_ch = u[h * DK + tid];

  const size_t kbase = (size_t)bh * T * DK, vbase = (size_t)bh * T * DV;
  float* dk_out = dkp + ((size_t)blockIdx.y * gridDim.x + bh) * T * DK + tid;
  for (int t0 = (T - 1) / kBwdStage * kBwdStage; t0 >= 0; t0 -= kBwdStage) {
    const int n = min(kBwdStage, T - t0);
    __syncthreads();
    fill_stage(st, r, k, v, w, dout, kbase, vbase, DV, col0, t0, n);
    for (int j = n - 1; j >= 0; --j) {
      const float rr = to_f(st.xq[j * DK + tid]);
      const float kk = to_f(st.xk[j * DK + tid]);
      const float ew = expf(st.g[j * DK + tid]);
      const float ruk = rr * u_ch * kk;
      const float4* v4 = reinterpret_cast<const float4*>(st.v + j * kBV);
      const float4* d4 = reinterpret_cast<const float4*>(st.dout + j * kBV);
      float vals[kBV];
      float dk = 0.f;
#pragma unroll
      for (int c = 0; c < kBV; c += 4) {
        const float4 vv = v4[c / 4], d = d4[c / 4];
        const float va[4] = {vv.x, vv.y, vv.z, vv.w}, da[4] = {d.x, d.y, d.z, d.w};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float dS = carry[c + e];  // D_t
          dk += dS * va[e];
          vals[c + e] = kk * dS + ruk * da[e];
          carry[c + e] = ew * dS + rr * da[e];  // D_{t-1}
        }
      }
      dk_out[(size_t)(t0 + j) * DK] = dk;
      dvred[(j * NW + warp) * kBV + lane] = gla::warp_transpose_sum(vals, lane);
    }
    __syncthreads();
    for (int idx = tid; idx < n * kBV; idx += DK) {
      const int j = idx / kBV, c = idx % kBV;
      float sum = 0.f;
#pragma unroll
      for (int wi = 0; wi < NW; ++wi) sum += dvred[(j * NW + wi) * kBV + c];
      dv[vbase + (size_t)(t0 + j) * DV + col0 + c] = from_f<IO>(sum);
    }
  }
  if (ds0) {
#pragma unroll
    for (int c = 0; c < kBV; ++c) ds0[srow + c] = from_f<ST>(carry[c]);
  }
}

// ---------------------------------------------------------------- kernel 3
// grid (DK/64, B*H, ceil(T/64)). dw gets the running sum within the
// segment, dwt (segments, B*H, DK) the segment's total (the last segment's
// includes the dsf term), dup (segments, B*H, DK) the segment's share of du.
template <typename IO>
__global__ void __launch_bounds__(kFinishThreads)
rwkv6_bwd_finish_kernel(const IO* __restrict__ r, const IO* __restrict__ k,
                        const float* __restrict__ u, const float* __restrict__ drp,
                        const float* __restrict__ dkp, const float* __restrict__ vdop,
                        const float* __restrict__ dsgp, IO* __restrict__ dr,
                        IO* __restrict__ dk, float* __restrict__ dw, float* __restrict__ dwt,
                        float* __restrict__ dup, int H, int T, int DK, int DV) {
  const int bh = blockIdx.y, BH = gridDim.y;
  const int seg = blockIdx.z, n_seg = gridDim.z;
  const int t_lo = seg * kFinishSeg, t_hi = min(T, t_lo + kFinishSeg);
  const int n_parts = DV / kBV;
  const int ch = blockIdx.x * kFinishThreads + threadIdx.x;
  const size_t base = (size_t)bh * T * DK + ch;
  const size_t part = (size_t)BH * T * DK;
  const float u_ch = u[(bh % H) * DK + ch];
  float acc = 0.f, du = 0.f;
  if (seg == n_seg - 1)
    for (int i = 0; i < n_parts; ++i) acc += dsgp[((size_t)i * BH + bh) * DK + ch];
  for (int t = t_hi - 1; t >= t_lo; --t) {
    const size_t at = base + (size_t)t * DK;
    float drs, dks;
    gla::sum_parts(drp + at, dkp + at, part, n_parts, drs, dks);
    float vdo = 0.f;
    for (int i = 0; i < n_parts; ++i) vdo += vdop[((size_t)i * BH + bh) * T + t];
    const float rr = to_f(r[at]), kk = to_f(k[at]);
    acc -= kk * dks;  // inclusive part: w_t reaches b_t
    dw[at] = acc;
    acc += rr * drs;  // exclusive part: w_t reaches bx_s for s > t only
    du += rr * kk * vdo;
    dr[at] = from_f<IO>(drs + u_ch * kk * vdo);
    dk[at] = from_f<IO>(dks + u_ch * rr * vdo);
  }
  const size_t out = ((size_t)seg * BH + bh) * DK + ch;
  dwt[out] = acc;
  dup[out] = du;
}

// ---------------------------------------------------------------- kernel 5
// du[h, ch] = sum over b, then segments, of dup[seg, b*H + h, ch].
__global__ void rwkv6_bwd_du_kernel(const float* __restrict__ dup, float* __restrict__ du,
                                    int B, int H, int DK, int n_seg) {
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= H * DK) return;
  const int h = idx / DK, ch = idx % DK;
  float sum = 0.f;
  for (int b = 0; b < B; ++b)
    for (int s = 0; s < n_seg; ++s) sum += dup[((size_t)s * B * H + b * H + h) * DK + ch];
  du[idx] = sum;
}

template <typename IO, typename ST, int DK>
int launch_bwd(const void* r, const void* k, const void* v, const void* w, const void* u,
               const void* s0, const void* dout, const void* dsf, void* dr, void* dk, void* dv,
               void* dw, void* du, void* ds0, void* drp, void* dkp, void* vdop, void* dsgp,
               void* dwt, void* dup, int B, int H, int T, int DV, cudaStream_t stream) {
  const IO *r_ = static_cast<const IO*>(r), *k_ = static_cast<const IO*>(k),
           *v_ = static_cast<const IO*>(v), *do_ = static_cast<const IO*>(dout);
  const float *w_ = static_cast<const float*>(w), *u_ = static_cast<const float*>(u);
  const ST* dsf_ = static_cast<const ST*>(dsf);
  float *drp_ = static_cast<float*>(drp), *dkp_ = static_cast<float*>(dkp),
        *vdop_ = static_cast<float*>(vdop), *dsgp_ = static_cast<float*>(dsgp),
        *dw_ = static_cast<float*>(dw), *dwt_ = static_cast<float*>(dwt),
        *dup_ = static_cast<float*>(dup);
  const dim3 tiles(B * H, DV / kBV);
  rwkv6_bwd_dr_kernel<IO, ST, DK><<<tiles, DK, 0, stream>>>(
      r_, k_, v_, w_, static_cast<const ST*>(s0), do_, dsf_, drp_, vdop_, dsgp_, T, DV);
  int err = static_cast<int>(cudaGetLastError());
  if (err) return err;
  rwkv6_bwd_dkv_kernel<IO, ST, DK><<<tiles, DK, 0, stream>>>(
      r_, k_, v_, w_, u_, do_, dsf_, dkp_, static_cast<IO*>(dv), static_cast<ST*>(ds0), H, T,
      DV);
  err = static_cast<int>(cudaGetLastError());
  if (err) return err;
  const int n_seg = (T + kFinishSeg - 1) / kFinishSeg;
  const dim3 channels(DK / kFinishThreads, B * H, n_seg);
  rwkv6_bwd_finish_kernel<IO><<<channels, kFinishThreads, 0, stream>>>(
      r_, k_, u_, drp_, dkp_, vdop_, dsgp_, static_cast<IO*>(dr), static_cast<IO*>(dk), dw_,
      dwt_, dup_, H, T, DK, DV);
  err = static_cast<int>(cudaGetLastError());
  if (err) return err;
  err = gla::launch_dg_carry(dw_, dwt_, B * H, T, DK, stream);
  if (err) return err;
  rwkv6_bwd_du_kernel<<<(H * DK + 255) / 256, 256, 0, stream>>>(
      dup_, static_cast<float*>(du), B, H, DK, n_seg);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace rwkv6

// C entry point (bound with ctypes in ops/rwkv6_cuda.py). Inputs as
// rwkv6_chunk_fwd, plus dout (B, H, T, DV) in the IO dtype and dsf (B, H,
// DK, DV) in the state dtype or null (zeros). Outputs: dr, dk (B, H, T, DK)
// and dv (B, H, T, DV) in the IO dtype; dw (B, H, T, DK) f32; du (H, DK)
// f32; ds0 (B, H, DK, DV) in the state dtype, or null to skip it. Scratch,
// all f32: drp, dkp (DV/32, B, H, T, DK); vdop (DV/32, B, H, T); dsgp (DV/32,
// B, H, DK); dwt, dup (ceil(T/64), B, H, DK). All contiguous; T >= 1.
// Returns the first launch's cudaGetLastError() that is not 0, -1 for an
// unsupported DK, -2 for unsupported dtype codes, -3 for DV % 32 != 0.
extern "C" int rwkv6_chunk_bwd(const void* r, const void* k, const void* v, const void* w,
                               const void* u, const void* s0, const void* dout,
                               const void* dsf, void* dr, void* dk, void* dv, void* dw,
                               void* du, void* ds0, void* drp, void* dkp, void* vdop,
                               void* dsgp, void* dwt, void* dup, int B, int H, int T,
                               int DK_, int DV, int io_dtype, int state_dtype, void* stream) {
  if (DV % gla::kBV != 0) return -3;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  GLA_DISPATCH_TYPES(io_dtype, state_dtype,
                     GLA_DISPATCH_DK(DK_, return rwkv6::launch_bwd<IO, ST, DK>(
                         r, k, v, w, u, s0, dout, dsf, dr, dk, dv, dw, du, ds0, drp, dkp,
                         vdop, dsgp, dwt, dup, B, H, T, DV, st)))
  return -2;
}
