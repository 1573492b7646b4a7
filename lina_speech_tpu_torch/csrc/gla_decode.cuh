// One classic decode token of a gated linear recurrence: one kernel
// template of two bodies (routes) and three modes, instantiated by
// gla_decode_conv.cu (kStepGlaConv), gla_decode.cu (kStepGla) and
// rwkv6_decode.cu (kStepRwkv6). Per (batch, head):
//
//   kStepGlaConv:  ring <- [ring[1:], x]                    (q, k, v rings, width 4)
//                  y    = rnd(silu(rnd(sum_i w_i ring_i)))  (tap sum f32, rnd = IO dtype)
//                  S = diag(exp g) S + k^T v,   o = (scale q) S
//   kStepGla:      the same on q, k, v as they are
//   kStepRwkv6:    o = r (S + diag(u) k^T v),   S <- diag(exp w) S + k^T v
//
// kStepGla takes q, k and v as they are, cast to f32 from the IO dtype
// with no further rounding (the Pallas _decode_kernel, gla_pallas.py:1347);
// kStepGlaConv rounds as the Pallas _decode_conv_kernel does
// (gla_pallas.py:1389-1393). The GLA modes read o from the updated f32 S
// before S is rounded to the state dtype. kStepRwkv6 (the Pallas
// _rwkv6_decode_kernel, gla_pallas.py:1468) reads o from the OLD S and adds
// the bonus (sum_i r_i u_i k_i) v_j, a scalar a head formed once in the
// prologue; it has no scale and no rings, and its per-row decay e^w comes
// from f32 w as GLA's e^g from f32 g. o is rounded to the IO dtype. Every
// body and mode forms each state element as fma(e^g, S, k v) in f32 (no
// contraction left to the compiler), so the routes give the state in equal
// bits; o's sums run in other orders.
//
// What bounds it on the H100: bytes. The state is read once and written
// once per token (b8 flagship: 8.4 MB each way per layer in bf16, 5.0 us at
// 3.35 TB/s), against ~2.5 operations per state byte; at small batch, the
// chain of dependent memory round trips. The state is updated in place (the
// Pallas kernel's input_output_aliases={4: 1}): each element is read and
// written by the same thread. Both bodies give a block a column tile of one
// (batch, head) state, all dk rows; with the convs every block of a head
// needs the full q/k conv outputs, so each forms them from the OLD rings
// (from L2 after the first), and the new rings go to separate output
// buffers (an in-place ring shift by one block would race with the other
// blocks' reads); column tile 0 writes the q/k rings, each block its
// columns of the v ring. ops/gla_cuda.py:gla_decode_plan (and
// ops/rwkv6_cuda.py:rwkv6_decode_plan, the same rule) picks the body from
// shapes and dtypes before the launch:
//
// Wide route (states above 512 KiB): a block of kThreads threads owns a
// column tile TPR x 16 bytes wide (TPR = 4, 8 or 16 threads across a row:
// 32, 64 or 128 bf16 columns, 16, 32 or 64 f32), the route code. Thread
// (row phase p, column group g) owns the 16-byte word of columns g of the
// rows i = p, p + kThreads / TPR, ..., and asks for all of them before it
// reads anything else, so the state's loads and the conv prologue's are in
// flight together: the step costs one round trip, then the update in
// registers and one 16-byte store a word. The readout parts of the row
// phases meet in shared memory and are added in phase order. A narrow tile
// (small TPR) gives more blocks at small batch, where a wave of blocks
// leaves SMs idle; a wide one repeats the head's prologue fewer times once
// the grid fills the card. The plan picks TPR from the grid's size.
//
// Tile route (the kernel's first design; states up to 512 KiB, where its
// shorter prologue ties or wins): a block owns a (DK x 32) column tile;
// lane = value column, so a warp reads and writes 32 consecutive state
// elements per key row, two bytes a lane, and the state is loaded after the
// prologue (two round trips). __launch_bounds__(256, 2) caps registers at
// 128 so two blocks share an SM and more state loads are in flight.
//
// Tried and dropped on the card (PERF.md §6): a thread block cluster a
// head, each block staging 32 key rows of the state in shared memory by
// bulk copies (cp.async.bulk), pushing its readout parts to the owner of
// each column slice with st.async and writing its rows back by one bulk
// store; it formed each row's q and k once a head, but its chain (slab in,
// update, bulk store, parts pushed) lost to the wide route at every shape
// swept but one; streaming the slab in bands through a ring did not help.
#pragma once

#include <cstdint>

#include "gla_common.cuh"

namespace gla {

constexpr int kDecodeTile = 0;  // route code of the tile body (ops/gla_cuda.py:_DECODE_ROUTE_CODE)

// the template's modes
constexpr int kStepGla = 0;      // GLA on q, k, v as they are
constexpr int kStepGlaConv = 1;  // GLA with the q/k/v short convs fused in
constexpr int kStepRwkv6 = 2;    // RWKV6: readout of the old state, the u bonus

// The sum over a warp of v, the same bits on every lane (fixed order).
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int m = 16; m > 0; m >>= 1) v += __shfl_xor_sync(0xffffffffu, v, m);
  return v;
}

// S' = e^g S + k v, the one rounding order of both bodies
__device__ __forceinline__ float decay_update(float e, float s, float k, float v) {
  return __fmaf_rn(e, s, __fmul_rn(k, v));
}

// RWKV: sum_i r_i u_i k_i, the bonus of a head, from its warp parts in order
template <int DK>
__device__ __forceinline__ float head_bonus(const float (&sbon)[DK / 32]) {
  float b = 0.f;
#pragma unroll
  for (int w = 0; w < DK / 32; ++w) b += sbon[w];
  return b;
}

// ------------------------------------------------------------ tile route
template <typename IO, typename ST, int DK, int MODE>
__global__ void __launch_bounds__(kThreads, 2)
gla_decode_kernel(const IO* __restrict__ xq, const IO* __restrict__ xk,
                  const IO* __restrict__ xv, const float* __restrict__ gk,
                  const float* __restrict__ bonus, const IO* __restrict__ wq,
                  const IO* __restrict__ wk, const IO* __restrict__ wv,
                  const IO* __restrict__ cq,
                  const IO* __restrict__ ck, const IO* __restrict__ cv,
                  ST* state, IO* __restrict__ o, IO* __restrict__ cq_out,
                  IO* __restrict__ ck_out, IO* __restrict__ cv_out,
                  int BH, int H, int DV, float scale) {
  constexpr bool CONV = MODE == kStepGlaConv, RWKV = MODE == kStepRwkv6;
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
  __shared__ float sbon[DK / 32];  // RWKV: the bonus's warp parts

  // rings are (4, BH, D): element (j, bh, c) at j * BH * D + bh * D + c
  if (tid < DK) {
    const size_t kstride = (size_t)BH * DK;
    const size_t off = (size_t)bh * DK + tid;
    const float x_q = to_f(xq[off]);
    const float x_k = to_f(xk[off]);
    const float u_i = RWKV ? bonus[(size_t)h * DK + tid] : 0.f;
    if constexpr (CONV) {
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
      if (blockIdx.y == 0) {
#pragma unroll
        for (int j = 0; j < kConv - 1; ++j) {
          cq_out[j * kstride + off] = cq[(j + 1) * kstride + off];
          ck_out[j * kstride + off] = ck[(j + 1) * kstride + off];
        }
        cq_out[(kConv - 1) * kstride + off] = xq[off];
        ck_out[(kConv - 1) * kstride + off] = xk[off];
      }
    } else {
      sq[tid] = RWKV ? x_q : x_q * scale;
      sk[tid] = x_k;
    }
    seg[tid] = expf(gk[off]);
    if constexpr (RWKV) {  // the shuffles after every load of the prologue is asked for
      const float part_sum = warp_sum(x_q * u_i * x_k);
      if (tid % 32 == 0) sbon[tid / 32] = part_sum;
    }
  }
  if (tid < kBV) {
    const int vcol = blockIdx.y * kBV + tid;
    const size_t vstride = (size_t)BH * DV;
    const size_t off = (size_t)bh * DV + vcol;
    const float x_v = to_f(xv[off]);
    if constexpr (CONV) {
      float hv[kConv - 1], tv[kConv];
#pragma unroll
      for (int j = 0; j < kConv - 1; ++j) hv[j] = to_f(cv[(j + 1) * vstride + off]);
#pragma unroll
      for (int i = 0; i < kConv; ++i) tv[i] = to_f(wv[(size_t)(i * H + h) * DV + vcol]);
      sv[tid] = round_io<IO>(silu(round_io<IO>(tap_sum(tv, hv, x_v))));
#pragma unroll
      for (int j = 0; j < kConv - 1; ++j) cv_out[j * vstride + off] = cv[(j + 1) * vstride + off];
      cv_out[(kConv - 1) * vstride + off] = xv[off];
    } else {
      sv[tid] = x_v;
    }
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
    if (RWKV) acc += sq[i] * s[r];  // the old state
    s[r] = decay_update(seg[i], s[r], sk[i], vj);
    if (!RWKV) acc += sq[i] * s[r];
    srow[(size_t)r * DV] = from_f<ST>(s[r]);
  }
  part[grp][lane] = acc;
  __syncthreads();
  if (grp == 0) {
    float out = 0.f;
#pragma unroll
    for (int g = 0; g < kGroups; ++g) out += part[g][lane];
    if constexpr (RWKV) out += head_bonus<DK>(sbon) * vj;
    o[(size_t)bh * DV + col] = from_f<IO>(out);
  }
}

template <typename IO, typename ST, int DK, int MODE>
int launch_decode_tile(const void* xq, const void* xk, const void* xv, const void* gk,
                const void* u, const void* wq, const void* wk, const void* wv,
                const void* cq, const void* ck, const void* cv, void* state, void* o,
                void* cq_out, void* ck_out, void* cv_out, int B, int H, int DV, float scale,
                cudaStream_t stream) {
  const dim3 grid(B * H, DV / kBV);
  gla_decode_kernel<IO, ST, DK, MODE><<<grid, kThreads, 0, stream>>>(
      static_cast<const IO*>(xq), static_cast<const IO*>(xk),
      static_cast<const IO*>(xv), static_cast<const float*>(gk),
      static_cast<const float*>(u), static_cast<const IO*>(wq),
      static_cast<const IO*>(wk), static_cast<const IO*>(wv), static_cast<const IO*>(cq),
      static_cast<const IO*>(ck), static_cast<const IO*>(cv),
      static_cast<ST*>(state), static_cast<IO*>(o), static_cast<IO*>(cq_out),
      static_cast<IO*>(ck_out), static_cast<IO*>(cv_out), B * H, H, DV, scale);
  return static_cast<int>(cudaGetLastError());
}

// ------------------------------------------------------------ wide route
template <typename IO, typename ST, int DK, int MODE, int TPR>
__global__ void __launch_bounds__(kThreads, 2)
gla_decode_wide_kernel(const IO* __restrict__ xq, const IO* __restrict__ xk,
                       const IO* __restrict__ xv, const float* __restrict__ gk,
                       const float* __restrict__ bonus, const IO* __restrict__ wq,
                       const IO* __restrict__ wk, const IO* __restrict__ wv,
                       const IO* __restrict__ cq,
                       const IO* __restrict__ ck, const IO* __restrict__ cv,
                       ST* state, IO* __restrict__ o, IO* __restrict__ cq_out,
                       IO* __restrict__ ck_out, IO* __restrict__ cv_out,
                       int BH, int H, int DV, float scale) {
  constexpr bool CONV = MODE == kStepGlaConv, RWKV = MODE == kStepRwkv6;
  constexpr int VC = Word<ST>::N;
  constexpr int WC = TPR * VC;      // the block's columns
  constexpr int RP = kThreads / TPR;  // rows the block covers in one pass
  constexpr int RPT = DK / RP;      // rows a thread owns
  const int bh = blockIdx.x;
  const int h = bh % H;
  const int tid = threadIdx.x;
  const int cg = tid % TPR;
  const int rp = tid / TPR;
  const int c0 = blockIdx.y * WC;
  const int col = c0 + cg * VC;  // this thread's first column
  const bool live = col < DV;

  __shared__ float sq[DK], sk[DK], seg[DK], sv[WC];
  __shared__ float part[RP][WC];
  __shared__ float sbon[DK / 32];  // RWKV: the bonus's warp parts

  // the state's words first: nothing they wait for (rows rp, rp + RP, ...)
  ST* base = state + (size_t)bh * DK * DV + col;
  uint4 raw[RPT];
#pragma unroll
  for (int r = 0; r < RPT; ++r)
    if (live) raw[r] = *reinterpret_cast<const uint4*>(base + (size_t)(rp + r * RP) * DV);

  // rings are (4, BH, D): element (j, bh, c) at j * BH * D + bh * D + c
  if (tid < DK) {
    const size_t kstride = (size_t)BH * DK;
    const size_t off = (size_t)bh * DK + tid;
    const float x_q = to_f(xq[off]);
    const float x_k = to_f(xk[off]);
    const float u_i = RWKV ? bonus[(size_t)h * DK + tid] : 0.f;
    if constexpr (CONV) {
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
      if (blockIdx.y == 0) {
#pragma unroll
        for (int j = 0; j < kConv - 1; ++j) {
          cq_out[j * kstride + off] = from_f<IO>(hq[j]);
          ck_out[j * kstride + off] = from_f<IO>(hk[j]);
        }
        cq_out[(kConv - 1) * kstride + off] = from_f<IO>(x_q);
        ck_out[(kConv - 1) * kstride + off] = from_f<IO>(x_k);
      }
    } else {
      sq[tid] = RWKV ? x_q : x_q * scale;
      sk[tid] = x_k;
    }
    seg[tid] = expf(gk[off]);
    if constexpr (RWKV) {  // the shuffles after every load of the prologue is asked for
      const float part_sum = warp_sum(x_q * u_i * x_k);
      if (tid % 32 == 0) sbon[tid / 32] = part_sum;
    }
  }
  for (int c = kThreads - 1 - tid; c < WC; c += kThreads) {
    if (c0 + c >= DV) continue;
    const size_t vstride = (size_t)BH * DV;
    const size_t off = (size_t)bh * DV + c0 + c;
    const float x_v = to_f(xv[off]);
    if constexpr (CONV) {
      float hv[kConv - 1], tv[kConv];
#pragma unroll
      for (int j = 0; j < kConv - 1; ++j) hv[j] = to_f(cv[(j + 1) * vstride + off]);
#pragma unroll
      for (int i = 0; i < kConv; ++i) tv[i] = to_f(wv[(size_t)(i * H + h) * DV + c0 + c]);
      sv[c] = round_io<IO>(silu(round_io<IO>(tap_sum(tv, hv, x_v))));
#pragma unroll
      for (int j = 0; j < kConv - 1; ++j) cv_out[j * vstride + off] = from_f<IO>(hv[j]);
      cv_out[(kConv - 1) * vstride + off] = from_f<IO>(x_v);
    } else {
      sv[c] = x_v;
    }
  }
  __syncthreads();

  float acc[VC];
#pragma unroll
  for (int e = 0; e < VC; ++e) acc[e] = 0.f;
  if (live) {
    float v[VC];
#pragma unroll
    for (int e = 0; e < VC; ++e) v[e] = sv[cg * VC + e];
#pragma unroll
    for (int r = 0; r < RPT; ++r) {
      const int i = rp + r * RP;
      const float eg = seg[i], kk = sk[i], q = sq[i];
      float f[VC];
      Word<ST>::unpack(raw[r], f);
#pragma unroll
      for (int e = 0; e < VC; ++e) {
        if (RWKV) acc[e] += q * f[e];  // the old state
        f[e] = decay_update(eg, f[e], kk, v[e]);
        if (!RWKV) acc[e] += q * f[e];
      }
      *reinterpret_cast<uint4*>(base + (size_t)i * DV) = Word<ST>::pack(f);
    }
  }
#pragma unroll
  for (int e = 0; e < VC; ++e) part[rp][cg * VC + e] = acc[e];
  __syncthreads();
  for (int c = tid; c < WC && c0 + c < DV; c += kThreads) {
    float out = 0.f;
#pragma unroll
    for (int g = 0; g < RP; ++g) out += part[g][c];
    if constexpr (RWKV) out += head_bonus<DK>(sbon) * sv[c];
    o[(size_t)bh * DV + c0 + c] = from_f<IO>(out);
  }
}

template <int TPR, typename IO, typename ST, int DK, int MODE>
int launch_decode_wide(const void* xq, const void* xk, const void* xv, const void* gk,
                       const void* u, const void* wq, const void* wk, const void* wv,
                       const void* cq, const void* ck, const void* cv, void* state, void* o,
                       void* cq_out, void* ck_out, void* cv_out, int B, int H, int DV, float scale,
                       cudaStream_t stream) {
  constexpr int WC = TPR * Word<ST>::N;
  const dim3 grid(B * H, (DV + WC - 1) / WC);
  gla_decode_wide_kernel<IO, ST, DK, MODE, TPR><<<grid, kThreads, 0, stream>>>(
      static_cast<const IO*>(xq), static_cast<const IO*>(xk),
      static_cast<const IO*>(xv), static_cast<const float*>(gk),
      static_cast<const float*>(u), static_cast<const IO*>(wq),
      static_cast<const IO*>(wk), static_cast<const IO*>(wv), static_cast<const IO*>(cq),
      static_cast<const IO*>(ck), static_cast<const IO*>(cv),
      static_cast<ST*>(state), static_cast<IO*>(o), static_cast<IO*>(cq_out),
      static_cast<IO*>(ck_out), static_cast<IO*>(cv_out), B * H, H, DV, scale);
  return static_cast<int>(cudaGetLastError());
}

// One launch on route ``route``: 0 the tile body, 4, 8 or 16 the wide body
// with that many threads across a row; -7 for another code.
template <typename IO, typename ST, int DK, int MODE>
int launch_decode(const void* xq, const void* xk, const void* xv, const void* gk,
                  const void* u, const void* wq, const void* wk, const void* wv,
                  const void* cq, const void* ck, const void* cv, void* state, void* o,
                  void* cq_out, void* ck_out, void* cv_out, int B, int H, int DV, float scale,
                  int route, cudaStream_t stream) {
#define DECODE_ARGS                                                                 \
  xq, xk, xv, gk, u, wq, wk, wv, cq, ck, cv, state, o, cq_out, ck_out, cv_out, B, H, DV, \
      scale, stream
  switch (route) {
    case kDecodeTile: return launch_decode_tile<IO, ST, DK, MODE>(DECODE_ARGS);
    case 4: return launch_decode_wide<4, IO, ST, DK, MODE>(DECODE_ARGS);
    case 8: return launch_decode_wide<8, IO, ST, DK, MODE>(DECODE_ARGS);
    case 16: return launch_decode_wide<16, IO, ST, DK, MODE>(DECODE_ARGS);
    default: return -7;
  }
#undef DECODE_ARGS
}

// Dispatch over dtypes and DK for the mode MODE (u: kStepRwkv6's bonus, (H,
// DK) f32; null in the GLA modes). Returns cudaGetLastError() after the launch,
// -1 for an unsupported DK, -2 for unsupported dtype codes, -3 for DV % 32
// != 0, -6 for a state off a 16-byte boundary on a wide route (it is read
// and written in 16-byte words), -7 for an unknown route code.
template <int MODE>
int dispatch_decode(const void* xq, const void* xk, const void* xv, const void* gk,
                    const void* u, const void* wq, const void* wk, const void* wv,
                    const void* cq, const void* ck, const void* cv, void* state, void* o,
                    void* cq_out, void* ck_out, void* cv_out, int B, int H, int DK_, int DV,
                    float scale, int io_dtype, int state_dtype, int route, void* stream) {
  if (DV % kBV != 0 || DV < kBV) return -3;
  if (route != kDecodeTile && reinterpret_cast<uintptr_t>(state) % 16 != 0) return -6;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  GLA_DISPATCH_TYPES(io_dtype, state_dtype,
                     GLA_DISPATCH_DK(DK_, return launch_decode<IO, ST, DK, MODE>(
                         xq, xk, xv, gk, u, wq, wk, wv, cq, ck, cv, state, o, cq_out, ck_out,
                         cv_out, B, H, DV, scale, route, st)))
  return -2;
}

}  // namespace gla
