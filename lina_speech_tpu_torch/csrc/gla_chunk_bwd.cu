// Backward of the GLA prefill on post-conv q, k, v: the training of the GLA
// layers without per-projection short convs (simple-GLA, the shared-conv
// layer, the interleaved CrossAttGLA without convs) and of Mamba-2.
//
// Replaces the TPU kernel _bwd_kernel (lina_speech_tpu/ops/gla_pallas.py:210,
// reached through gla_chunk_pallas :699, _vjp_bwd :684 and _bwd_impl :444 ->
// pallas_call :462). From do (b, h, t, dv) and dsf (b, h, dk, dv) it
// computes dq, dk, dv (IO dtype), dg (f32) and ds0 (state dtype).
//
// Two routes compute dq, dk and dv, the dsf . S_final term and ds0;
// ops/gla_cuda.py:gla_chunk_bwd_plan names one and passes it in:
// - recurrent (f32 IO; bf16 IO only where a caller forces it): the two time
//   sweeps of gla_chunk_bwd.cuh (CONV = false; kernels 1 and 2, the math and
//   what bounds them are described there; they need no saved state: the
//   training forward is the inference kernel of gla_chunk.cu). The dk/dv
//   sweep writes dv itself; dq and dk come as DV/32 per-tile parts,
//   2 * (DV/32) * b*h*t*DK*4 bytes: 268 MB at b8 h4 t512 dk256 dv256, 134 MB
//   at b8 h32 t512 dk64 dv64;
// - chunked (bf16 IO): the four kernels of gla_chunked_bwd.cuh (CONV =
//   false), 64-row chunks on the tensor cores; dv_kernel writes dv in bf16,
//   dq and dk come as one f32 part each.
// Both end in the finishing pass:
// 3. bwd_finish_qk_kernel: one thread per (batch, head, key channel,
//    segment of 64 steps) adds the parts of dq and dk in a fixed order and
//    walks its segment in reverse for the running sum of dg;
// 4. bwd_dg_carry_kernel (gla_chunk_bwd.cuh): adds to dg the totals of the
//    later segments.
#include <type_traits>

#include "gla_chunk_bwd.cuh"
#include "gla_chunked_bwd.cuh"

namespace gla {

// grid (DK/64, B*H, ceil(T/64)). dqp, dkp: n_parts parts of dq and dk,
// (n_parts, B*H, T, DK); dsgp: n_sg parts of the dsf term, (n_sg, B*H, DK).
// dg gets the running sum within the segment, dgt (segments, B*H, DK) the
// segment's total (the last segment's includes the dsf term).
template <typename IO>
__global__ void __launch_bounds__(kFinishThreads)
bwd_finish_qk_kernel(const IO* __restrict__ q, const IO* __restrict__ k,
                     const float* __restrict__ dqp, const float* __restrict__ dkp,
                     const float* __restrict__ dsgp, IO* __restrict__ dq, IO* __restrict__ dk,
                     float* __restrict__ dg, float* __restrict__ dgt, int T, int DK, int n_parts,
                     int n_sg) {
  const int bh = blockIdx.y, BH = gridDim.y;
  const int seg = blockIdx.z, n_seg = gridDim.z;
  const int t_lo = seg * kFinishSeg, t_hi = min(T, t_lo + kFinishSeg);
  const int ch = blockIdx.x * kFinishThreads + threadIdx.x;
  const size_t base = (size_t)bh * T * DK + ch;
  const size_t part = (size_t)BH * T * DK;
  float acc = 0.f;
  if (seg == n_seg - 1)
    for (int i = 0; i < n_sg; ++i) acc += dsgp[((size_t)i * BH + bh) * DK + ch];
  for (int t = t_hi - 1; t >= t_lo; --t) {
    const size_t at = base + (size_t)t * DK;
    float dq_t, dk_t;
    sum_parts(dqp + at, dkp + at, part, n_parts, dq_t, dk_t);
    acc += to_f(q[at]) * dq_t - to_f(k[at]) * dk_t;
    dg[at] = acc;
    dq[at] = from_f<IO>(dq_t);
    dk[at] = from_f<IO>(dk_t);
  }
  dgt[((size_t)seg * BH + bh) * DK + ch] = acc;
}

// chunked: the chunked route's scratch (ops/gla_cuda.py:gla_chunk_bwd), uf,
// kf, bc, kt, kl, ul, ull, states, states_lo, dstates, dstates_lo, vb, ebt;
// null for the recurrent route
template <typename IO, typename ST, int DK>
int launch_bwd_plain_qkv(const void* q, const void* k, const void* v, const void* gk,
                         const void* s0, const void* dout, const void* dsf, void* dq, void* dk,
                         void* dv, void* dg, void* ds0, void* dqp, void* dkp, void* dsgp,
                         void* dgt, void* const* chunked, int B, int H, int T, int DV,
                         float scale, int route, cudaStream_t stream) {
  const IO *q_ = static_cast<const IO*>(q), *k_ = static_cast<const IO*>(k);
  float *dqp_ = static_cast<float*>(dqp), *dkp_ = static_cast<float*>(dkp),
        *dsgp_ = static_cast<float*>(dsgp), *dg_ = static_cast<float*>(dg),
        *dgt_ = static_cast<float*>(dgt);
  int err = 0, n_parts = DV / kBV, n_sg = DV / kBV;
  if (route == kChunked) {
    if constexpr (std::is_same_v<IO, __nv_bfloat16>) {
      using chunked::bf16;
      float* const* sf = reinterpret_cast<float* const*>(chunked);  // the f32 scratch
      bf16* const* sb = reinterpret_cast<bf16* const*>(chunked);    // the bf16 scratch
      err = chunked::launch_chunked<ST, false>(
          q_, k_, static_cast<const bf16*>(v), static_cast<const float*>(gk), nullptr, nullptr,
          nullptr, static_cast<const ST*>(s0), static_cast<const bf16*>(dout),
          static_cast<const ST*>(dsf), static_cast<ST*>(ds0), dqp_, dkp_, dsgp_,
          static_cast<bf16*>(dv), sf[0], sf[1], sf[2], sb[3], sb[4], sb[5], sb[6], sb[7], sb[8],
          sb[9], sb[10], sb[11], sf[12], B, H, T, DK, DV, scale, stream);
      n_parts = 1;
      n_sg = (DV + chunked::kTile - 1) / chunked::kTile + 1;
    } else {
      return -4;  // the chunked route takes bf16 IO only
    }
  } else if (route == kRecurrent) {
    err = launch_sweeps<IO, ST, DK, false>(
        q_, k_, static_cast<const IO*>(v), static_cast<const float*>(gk), nullptr, nullptr,
        nullptr, static_cast<const ST*>(s0), static_cast<const IO*>(dout),
        static_cast<const ST*>(dsf), dqp_, dsgp_, dkp_, static_cast<IO*>(dv),
        static_cast<ST*>(ds0), B, H, T, DV, scale, stream);
  } else {
    return -4;
  }
  if (err) return err;
  const dim3 channels(DK / kFinishThreads, B * H, (T + kFinishSeg - 1) / kFinishSeg);
  bwd_finish_qk_kernel<IO><<<channels, kFinishThreads, 0, stream>>>(
      q_, k_, dqp_, dkp_, dsgp_, static_cast<IO*>(dq), static_cast<IO*>(dk), dg_, dgt_, T, DK,
      n_parts, n_sg);
  err = static_cast<int>(cudaGetLastError());
  if (err) return err;
  return launch_dg_carry(dg_, dgt_, B * H, T, DK, stream);
}

}  // namespace gla

// C entry point (bound with ctypes in ops/gla_cuda.py). Inputs as
// gla_chunk_fwd, plus dout (B, H, T, DV) in the IO dtype and dsf (B, H, DK,
// DV) in the state dtype or null (zeros). Outputs: dq, dk (B, H, T, DK) and
// dv (B, H, T, DV) in the IO dtype; dg (B, H, T, DK) f32; ds0 (B, H, DK, DV)
// in the state dtype, or null to skip it. route: 0 recurrent, 1 chunked
// (bf16 IO only). Scratch, f32 unless said: dqp and dkp (P, B, H, T, DK)
// and dsgp (Q, B, H, DK) with P = Q = DV/32 (recurrent) or P = 1, Q =
// ceil(DV/64) + 1 (chunked); dgt (ceil(T/64), B, H, DK); for the chunked
// route only (else null), with nc = ceil(T/64) and Tp = 64 nc: uf, kf, bc
// (B*H, Tp, DK), kt, kl, ul, ull (B*H, Tp, DK) bf16, states, states_lo,
// dstates and dstates_lo (B*H, nc, DK, DV) bf16, vb (B*H, Tp, DV) bf16, ebt
// (B*H, nc, DK). All contiguous, dout 16-byte aligned for the chunked route;
// T >= 1. Returns the first launch's cudaGetLastError() that is not 0, -1
// for an unsupported DK, -2 for unsupported dtype codes, -3 for DV % 32 !=
// 0, -4 for a route the IO dtype does not have.
extern "C" int gla_chunk_bwd(const void* q, const void* k, const void* v, const void* gk,
                             const void* s0, const void* dout, const void* dsf, void* dq,
                             void* dk, void* dv, void* dg, void* ds0, void* dqp, void* dkp,
                             void* dsgp, void* dgt, void* uf, void* kf, void* bc, void* kt,
                             void* kl, void* ul, void* ull, void* states, void* states_lo,
                             void* dstates, void* dstates_lo, void* vb, void* ebt, int B, int H,
                             int T, int DK_, int DV, float scale, int io_dtype, int state_dtype,
                             int route, void* stream) {
  if (DV % gla::kBV != 0) return -3;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  void* const chunked[13] = {uf,     kf,        bc,      kt,         kl, ul, ull,
                             states, states_lo, dstates, dstates_lo, vb, ebt};
  GLA_DISPATCH_TYPES(io_dtype, state_dtype,
                     GLA_DISPATCH_DK(DK_, return gla::launch_bwd_plain_qkv<IO, ST, DK>(
                         q, k, v, gk, s0, dout, dsf, dq, dk, dv, dg, ds0, dqp, dkp, dsgp, dgt,
                         chunked, B, H, T, DV, scale, route, st)))
  return -2;
}
