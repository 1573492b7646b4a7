// One lazy-window GLA decode token with the q/k/v short-conv ring updates
// fused in: the recurrent state is READ ONLY; the token is appended to the
// window buffers at slot p, and gla_fold.cu folds a full window into the
// state.
//
// Replaces the TPU kernel gla_decode_lazy_conv_fused (lina_speech_tpu/ops/
// gla_pallas.py:2197, body _lazy_conv_kernel :1759) without its int8 state
// scale. Per (batch, head), with cc the f32 gate cumsum since the last fold:
//
//   ring <- [ring[1:], x]                         (q, k, v rings, width 4)
//   q = silu(rnd(sum_i wq_i ring_i)) * scale      (f32)
//   k = rnd(silu(rnd(sum_i wk_i ring_i)))         (buffer dtype)
//   v = rnd(silu(rnd(sum_i wv_i ring_i)))         (buffer dtype)
//   cc <- cc + g;  kbuf[p] = k, vbuf[p] = v, cbuf[p] = cc
//   o = (q e^{cc}) S + sum_{j <= p} (q . k_j e^{min(cc - c_j, 0)}) v_j
//
// rnd() rounds to the IO dtype (the Pallas kernel's conv rounding points,
// :1775-1778 and :1791-1792). Slots j > p hold stale tokens of the previous
// window: they are never read. The clamp keeps every exp argument <= 0. The
// readout keeps q e^{cc}, S and k e^{..} in f32: the Pallas kernel's casts
// of those operands to bf16 (:1804-1806) feed the MXU and are not part of
// the function.
//
// What bounds it on the H100: bytes. The state is read once per token (b8
// flagship: 8.4 MB per layer in bf16) and never written; the window buffers
// add (p + 1) * (2 dk + dv) elements per (batch, head). Design: as
// gla_decode_conv.cu, a block owns a (DK x 32) column tile of one (batch,
// head) state, lane = value column. Every block of a (batch, head) needs
// the full q and k and the new cc, so each recomputes them from the OLD
// rings and the OLD cc; the new rings and the new cc go to separate output
// buffers (an in-place update by one block would race with the other
// blocks' reads). Slot p of kbuf / cbuf is written in place by block column
// 0 only, and slot p of vbuf by each block for its own columns; no block
// reads slot p from memory (it holds the token's k, v and cc itself), so
// those writes race with nothing. Warp w owns the window slots j = w, w + 8,
// ...: it computes the weight a_j = q . k_j e^{..} with a shuffle reduction
// and adds a_j v_j to its partial output, so the window costs no pass of its
// own. The state rows and the first two slots of each warp (a window of 16)
// are loaded before the first barrier, so that every global load of the
// token is in flight at once: the step is a chain of load latencies, not of
// bytes, at small batch.
#include "gla_common.cuh"

namespace {

using namespace gla;

constexpr int kPre = 2;  // window slots a warp loads ahead of the barrier

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int m = 16; m > 0; m >>= 1) x += __shfl_xor_sync(0xffffffffu, x, m);
  return x;
}

template <typename IO, typename ST, int DK>
__global__ void __launch_bounds__(kThreads, 2)
gla_decode_lazy_conv_kernel(const IO* __restrict__ xq, const IO* __restrict__ xk,
                            const IO* __restrict__ xv, const float* __restrict__ gk,
                            const IO* __restrict__ wq, const IO* __restrict__ wk,
                            const IO* __restrict__ wv, const IO* __restrict__ cq,
                            const IO* __restrict__ ck, const IO* __restrict__ cv,
                            const ST* __restrict__ state, IO* kbuf, IO* vbuf,
                            float* cbuf, const float* __restrict__ cc,
                            IO* __restrict__ o, IO* __restrict__ cq_out,
                            IO* __restrict__ ck_out, IO* __restrict__ cv_out,
                            float* __restrict__ cc_out, int BH, int H, int DV,
                            int p, float scale) {
  constexpr int RPT = DK / kGroups;
  const int bh = blockIdx.x;
  const int h = bh % H;
  const int tid = threadIdx.x;
  const int lane = tid % kBV;
  const int grp = tid / kBV;  // == warp index (kBV == 32)
  const int col = blockIdx.y * kBV + lane;
  const int row0 = grp * RPT;

  constexpr int EPL = DK / kBV;  // key elements per lane in a slot's dot product
  __shared__ float sq[DK], sk[DK], scc[DK], sv[kBV];
  __shared__ __align__(16) float sqe[DK];
  __shared__ float part[kGroups][kBV];

  // the long-latency loads first: this thread's rows of the state tile
  const ST* srow = state + (size_t)bh * DK * DV + (size_t)row0 * DV + col;
  float s[RPT];
#pragma unroll
  for (int r = 0; r < RPT; ++r) s[r] = to_f(srow[(size_t)r * DV]);

  // rings are (4, BH, D): element (j, bh, c) at j * BH * D + bh * D + c;
  // window buffers (L, BH, D) likewise
  const size_t kstride = (size_t)BH * DK;
  const size_t vstride = (size_t)BH * DV;

  // slot j < p of the window: this lane's share of k_j and c_j, and v_j at
  // this lane's column
  auto load_slot = [&](int j, float (&kj)[EPL], float (&cj)[EPL], float& vj) {
    const size_t base = j * kstride + (size_t)bh * DK + lane;
#pragma unroll
    for (int e = 0; e < EPL; ++e) {
      kj[e] = to_f(kbuf[base + e * kBV]);
      cj[e] = cbuf[base + e * kBV];
    }
    vj = to_f(vbuf[j * vstride + (size_t)bh * DV + col]);
  };
  // a_j v_j with a_j = sum_i q_i k_j,i e^{min(cc_i - c_j,i, 0)}. Slot p is
  // this token: k and v from shared memory, exp argument 0.
  auto slot_term = [&](int j, const float (&kj)[EPL], const float (&cj)[EPL], float vj) {
    float a = 0.f;
    if (j == p) {
#pragma unroll
      for (int e = 0; e < EPL; ++e) a += sq[lane + e * kBV] * sk[lane + e * kBV];
      vj = sv[lane];
    } else {
#pragma unroll
      for (int e = 0; e < EPL; ++e) {
        const int i = lane + e * kBV;
        a += sq[i] * kj[e] * expf(fminf(scc[i] - cj[e], 0.f));
      }
    }
    return warp_sum(a) * vj;
  };

  // this warp's first window slots j = grp, grp + kGroups are loaded ahead
  // of the barrier too
  float pk[kPre][EPL], pc[kPre][EPL], pv[kPre];
#pragma unroll
  for (int u = 0; u < kPre; ++u) {
    const int j = grp + u * kGroups;
    if (j < p) load_slot(j, pk[u], pc[u], pv[u]);
  }

  if (tid < DK) {
    const size_t off = (size_t)bh * DK + tid;
    const float x_q = to_f(xq[off]);
    const float x_k = to_f(xk[off]);
    float hq[kConv - 1], hk[kConv - 1], tq[kConv], tk[kConv];
#pragma unroll
    for (int j = 0; j < kConv - 1; ++j) {
      hq[j] = to_f(cq[(j + 1) * kstride + off]);
      hk[j] = to_f(ck[(j + 1) * kstride + off]);
    }
#pragma unroll
    for (int i = 0; i < kConv; ++i) {
      tq[i] = to_f(wq[(size_t)(i * H + h) * DK + tid]);
      tk[i] = to_f(wk[(size_t)(i * H + h) * DK + tid]);
    }
    const float q = silu(round_io<IO>(tap_sum(tq, hq, x_q))) * scale;
    const IO k_io = from_f<IO>(silu(round_io<IO>(tap_sum(tk, hk, x_k))));
    const float ccn = cc[off] + gk[off];
    sq[tid] = q;
    sqe[tid] = q * expf(ccn);
    sk[tid] = to_f(k_io);
    scc[tid] = ccn;
    if (blockIdx.y == 0) {
#pragma unroll
      for (int j = 0; j < kConv - 1; ++j) {
        cq_out[j * kstride + off] = cq[(j + 1) * kstride + off];
        ck_out[j * kstride + off] = ck[(j + 1) * kstride + off];
      }
      cq_out[(kConv - 1) * kstride + off] = xq[off];
      ck_out[(kConv - 1) * kstride + off] = xk[off];
      kbuf[p * kstride + off] = k_io;
      cbuf[p * kstride + off] = ccn;
      cc_out[off] = ccn;
    }
  }
  if (tid < kBV) {
    const int vcol = blockIdx.y * kBV + tid;
    const size_t off = (size_t)bh * DV + vcol;
    const float x_v = to_f(xv[off]);
    float hv[kConv - 1], tv[kConv];
#pragma unroll
    for (int j = 0; j < kConv - 1; ++j) hv[j] = to_f(cv[(j + 1) * vstride + off]);
#pragma unroll
    for (int i = 0; i < kConv; ++i) tv[i] = to_f(wv[(size_t)(i * H + h) * DV + vcol]);
    const IO v_io = from_f<IO>(silu(round_io<IO>(tap_sum(tv, hv, x_v))));
    sv[tid] = to_f(v_io);
#pragma unroll
    for (int j = 0; j < kConv - 1; ++j) cv_out[j * vstride + off] = cv[(j + 1) * vstride + off];
    cv_out[(kConv - 1) * vstride + off] = xv[off];
    vbuf[p * vstride + off] = v_io;
  }
  __syncthreads();

  // base readout from the read-only state
  // (the warp's band of q e^{cc}, four rows per shared-memory load)
  float acc = 0.f;
  const float4* qe = reinterpret_cast<const float4*>(&sqe[row0]);
#pragma unroll
  for (int r = 0; r < RPT; r += 4) {
    const float4 q4 = qe[r / 4];
    acc += q4.x * s[r] + q4.y * s[r + 1] + q4.z * s[r + 2] + q4.w * s[r + 3];
  }

  // window: o += a_j v_j over this warp's slots j <= p; those past the
  // loaded-ahead ones (a window longer than kPre * kGroups) are loaded here
#pragma unroll
  for (int u = 0; u < kPre; ++u) {
    const int j = grp + u * kGroups;
    if (j <= p) acc += slot_term(j, pk[u], pc[u], pv[u]);
  }
  for (int j = grp + kPre * kGroups; j <= p; j += kGroups) {
    float kj[EPL], cj[EPL], vj = 0.f;
    if (j < p) load_slot(j, kj, cj, vj);
    acc += slot_term(j, kj, cj, vj);
  }
  part[grp][lane] = acc;
  __syncthreads();

  if (grp == 0) {
    float out = 0.f;
#pragma unroll
    for (int g = 0; g < kGroups; ++g) out += part[g][lane];
    o[(size_t)bh * DV + col] = from_f<IO>(out);
  }
}

template <typename IO, typename ST, int DK>
int launch(const void* xq, const void* xk, const void* xv, const void* gk,
           const void* wq, const void* wk, const void* wv, const void* cq,
           const void* ck, const void* cv, const void* state, void* kbuf,
           void* vbuf, void* cbuf, const void* cc, void* o, void* cq_out,
           void* ck_out, void* cv_out, void* cc_out, int B, int H, int DV, int p,
           float scale, cudaStream_t stream) {
  const dim3 grid(B * H, DV / kBV);
  gla_decode_lazy_conv_kernel<IO, ST, DK><<<grid, kThreads, 0, stream>>>(
      static_cast<const IO*>(xq), static_cast<const IO*>(xk),
      static_cast<const IO*>(xv), static_cast<const float*>(gk),
      static_cast<const IO*>(wq), static_cast<const IO*>(wk),
      static_cast<const IO*>(wv), static_cast<const IO*>(cq),
      static_cast<const IO*>(ck), static_cast<const IO*>(cv),
      static_cast<const ST*>(state), static_cast<IO*>(kbuf), static_cast<IO*>(vbuf),
      static_cast<float*>(cbuf), static_cast<const float*>(cc), static_cast<IO*>(o),
      static_cast<IO*>(cq_out), static_cast<IO*>(ck_out), static_cast<IO*>(cv_out),
      static_cast<float*>(cc_out), B * H, H, DV, p, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// C entry point (bound with ctypes in ops/gla_cuda.py). Layouts: xq, xk, gk,
// cc (B, H, DK); xv (B, H, DV); taps wq, wk (4, H, DK), wv (4, H, DV), tap 0
// oldest; rings cq, ck (4, B, H, DK), cv (4, B, H, DV), index 3 newest;
// state (B, H, DK, DV), read only; window buffers kbuf (L, B, H, DK), vbuf
// (L, B, H, DV) in the IO dtype and cbuf (L, B, H, DK) f32, slot p written
// in place; cc f32; outputs o (B, H, DV), the new rings and the new cc. All
// contiguous. Returns cudaGetLastError() after the launch, -1 for an
// unsupported DK, -2 for unsupported dtype codes, -3 for DV % 32 != 0, -4
// for p outside the window.
extern "C" int gla_decode_lazy_conv_step(
    const void* xq, const void* xk, const void* xv, const void* gk, const void* wq,
    const void* wk, const void* wv, const void* cq, const void* ck, const void* cv,
    const void* state, void* kbuf, void* vbuf, void* cbuf, const void* cc, void* o,
    void* cq_out, void* ck_out, void* cv_out, void* cc_out, int B, int H, int DK,
    int DV, int L, int p, float scale, int io_dtype, int state_dtype, void* stream) {
  if (DV % gla::kBV != 0) return -3;
  if (p < 0 || p >= L) return -4;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  GLA_DISPATCH_TYPES(io_dtype, state_dtype,
                     GLA_DISPATCH_DK(DK, return launch<IO, ST, DK>(
                         xq, xk, xv, gk, wq, wk, wv, cq, ck, cv, state, kbuf, vbuf,
                         cbuf, cc, o, cq_out, ck_out, cv_out, cc_out, B, H, DV, p,
                         scale, st)))
  return -2;
}
