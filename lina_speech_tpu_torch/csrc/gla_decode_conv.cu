// One GLA decode token with the q/k/v short-conv ring updates fused in.
//
// Replaces the TPU kernel gla_decode_conv_fused (lina_speech_tpu/ops/
// gla_pallas.py:1641, body _decode_conv_kernel :1366). Per (batch, head):
//
//   ring <- [ring[1:], x]                      (q, k, v rings, width 4)
//   y    = rnd(silu(rnd(sum_i w_i ring_i)))    (tap sum f32, rnd = IO dtype)
//   S    = diag(exp g) S + k^T v,   o = (scale q) S
//
// as the Pallas kernel rounds it (gla_pallas.py:1389-1393).
//
// What bounds it on the H100: bytes. The state is read once and written
// once per token (b8 flagship: 8.4 MB each way per layer in bf16), against
// ~2 FLOP per state byte. Design: a block owns a (DK x 32) column tile of
// one (batch, head) state; lane = value column so a warp reads and writes
// 32 consecutive state elements per key row, and each element is read and
// written by the same thread, so the state is updated in place. Every
// block of a (batch, head) needs the full q/k conv outputs, so each
// recomputes them from the OLD rings; the new rings go to separate output
// buffers (an in-place ring shift by one block would race with the other
// blocks' reads). Block column 0 writes the q/k rings; each block writes
// its own columns of the v ring. __launch_bounds__(256, 2) caps registers
// at 128 so two blocks share an SM and more state loads are in flight.
#include "gla_common.cuh"

namespace {

using namespace gla;

template <typename IO, typename ST, int DK>
__global__ void __launch_bounds__(kThreads, 2)
gla_decode_conv_kernel(const IO* __restrict__ xq, const IO* __restrict__ xk,
                       const IO* __restrict__ xv, const float* __restrict__ gk,
                       const IO* __restrict__ wq, const IO* __restrict__ wk,
                       const IO* __restrict__ wv, const IO* __restrict__ cq,
                       const IO* __restrict__ ck, const IO* __restrict__ cv,
                       ST* state, IO* __restrict__ o, IO* __restrict__ cq_out,
                       IO* __restrict__ ck_out, IO* __restrict__ cv_out,
                       int BH, int H, int DV, float scale) {
  constexpr int RPT = DK / kGroups;
  const int bh = blockIdx.x;
  const int h = bh % H;
  const int tid = threadIdx.x;
  const int lane = tid % kBV;
  const int grp = tid / kBV;
  const int col = blockIdx.y * kBV + lane;
  const int row0 = grp * RPT;

  __shared__ float sq[DK], sk[DK], seg[DK], sv[kBV];
  __shared__ float part[kGroups][kBV];

  // rings are (4, BH, D): element (j, bh, c) at j * BH * D + bh * D + c
  if (tid < DK) {
    const size_t kstride = (size_t)BH * DK;
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
    sq[tid] = round_io<IO>(silu(round_io<IO>(tap_sum(tq, hq, x_q)))) * scale;
    sk[tid] = round_io<IO>(silu(round_io<IO>(tap_sum(tk, hk, x_k))));
    seg[tid] = expf(gk[off]);
    if (blockIdx.y == 0) {
#pragma unroll
      for (int j = 0; j < kConv - 1; ++j) {
        cq_out[j * kstride + off] = cq[(j + 1) * kstride + off];
        ck_out[j * kstride + off] = ck[(j + 1) * kstride + off];
      }
      cq_out[(kConv - 1) * kstride + off] = xq[off];
      ck_out[(kConv - 1) * kstride + off] = xk[off];
    }
  }
  if (tid < kBV) {
    const int vcol = blockIdx.y * kBV + tid;
    const size_t vstride = (size_t)BH * DV;
    const size_t off = (size_t)bh * DV + vcol;
    const float x_v = to_f(xv[off]);
    float hv[kConv - 1], tv[kConv];
#pragma unroll
    for (int j = 0; j < kConv - 1; ++j) hv[j] = to_f(cv[(j + 1) * vstride + off]);
#pragma unroll
    for (int i = 0; i < kConv; ++i) tv[i] = to_f(wv[(size_t)(i * H + h) * DV + vcol]);
    sv[tid] = round_io<IO>(silu(round_io<IO>(tap_sum(tv, hv, x_v))));
#pragma unroll
    for (int j = 0; j < kConv - 1; ++j) cv_out[j * vstride + off] = cv[(j + 1) * vstride + off];
    cv_out[(kConv - 1) * vstride + off] = xv[off];
  }
  __syncthreads();

  const float vj = sv[lane];
  ST* srow = state + (size_t)bh * DK * DV + (size_t)row0 * DV + col;
  float s[RPT];
#pragma unroll
  for (int r = 0; r < RPT; ++r) s[r] = to_f(srow[(size_t)r * DV]);
  float acc = 0.f;
#pragma unroll
  for (int r = 0; r < RPT; ++r) {
    const int i = row0 + r;
    s[r] = seg[i] * s[r] + sk[i] * vj;
    acc += sq[i] * s[r];
    srow[(size_t)r * DV] = from_f<ST>(s[r]);
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
           const void* ck, const void* cv, void* state, void* o, void* cq_out,
           void* ck_out, void* cv_out, int B, int H, int DV, float scale,
           cudaStream_t stream) {
  const dim3 grid(B * H, DV / kBV);
  gla_decode_conv_kernel<IO, ST, DK><<<grid, kThreads, 0, stream>>>(
      static_cast<const IO*>(xq), static_cast<const IO*>(xk),
      static_cast<const IO*>(xv), static_cast<const float*>(gk),
      static_cast<const IO*>(wq), static_cast<const IO*>(wk),
      static_cast<const IO*>(wv), static_cast<const IO*>(cq),
      static_cast<const IO*>(ck), static_cast<const IO*>(cv),
      static_cast<ST*>(state), static_cast<IO*>(o), static_cast<IO*>(cq_out),
      static_cast<IO*>(ck_out), static_cast<IO*>(cv_out), B * H, H, DV, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// C entry point (bound with ctypes in ops/gla_cuda.py). Layouts: xq, xk, gk
// (B, H, DK); xv (B, H, DV); taps wq, wk (4, H, DK), wv (4, H, DV), tap 0
// oldest; rings cq, ck (4, B, H, DK), cv (4, B, H, DV), index 3 newest;
// state (B, H, DK, DV), updated in place; outputs o (B, H, DV) and the new
// rings. All contiguous; rings and taps in the IO dtype. Returns
// cudaGetLastError() after the launch, or -1/-2/-3 as gla_chunk_conv_fwd.
extern "C" int gla_decode_conv_step(const void* xq, const void* xk, const void* xv,
                                    const void* gk, const void* wq, const void* wk,
                                    const void* wv, const void* cq, const void* ck,
                                    const void* cv, void* state, void* o,
                                    void* cq_out, void* ck_out, void* cv_out,
                                    int B, int H, int DK, int DV, float scale,
                                    int io_dtype, int state_dtype, void* stream) {
  if (DV % gla::kBV != 0) return -3;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  GLA_DISPATCH_TYPES(io_dtype, state_dtype,
                     GLA_DISPATCH_DK(DK, return launch<IO, ST, DK>(
                         xq, xk, xv, gk, wq, wk, wv, cq, ck, cv, state, o, cq_out,
                         ck_out, cv_out, B, H, DV, scale, st)))
  return -2;
}
