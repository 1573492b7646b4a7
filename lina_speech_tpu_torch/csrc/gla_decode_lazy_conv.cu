// One lazy-window GLA decode token with the q/k/v short-conv ring updates
// fused in: the recurrent state is READ ONLY; the token is appended to the
// window buffers at slot p, and gla_fold.cu folds a full window into the
// state.
//
// Replaces the TPU kernel gla_decode_lazy_conv_fused (lina_speech_tpu/ops/
// gla_pallas.py:2197, body _lazy_conv_kernel :1759), its int8 state route
// included. Per (batch, head), with cc the f32 gate cumsum since the last fold:
//
//   ring <- [ring[1:], x]                         (q, k, v rings, width 4)
//   q = silu(rnd(sum_i wq_i ring_i)) * scale      (f32)
//   k = rnd(silu(rnd(sum_i wk_i ring_i)))         (buffer dtype)
//   v = rnd(silu(rnd(sum_i wv_i ring_i)))         (buffer dtype)
//   cc <- cc + g;  kbuf[p] = k, vbuf[p] = v, cbuf[p] = cc
//   o = (q e^{cc}) S + sum_{j <= p} (q . k_j e^{min(cc - c_j, 0)}) v_j
//
// With an int8 state S_q and its f32 row scales s_scale (b, h, dk) the row
// scale rides the query: o = (q e^{cc} s_scale) S_q + the same window terms
// (:1802-1810); the int8 element is converted in registers.
//
// rnd() rounds to the IO dtype (the Pallas kernel's conv rounding points,
// :1775-1778 and :1791-1792). Slots j > p hold stale tokens of the previous
// window: they are never read. The clamp keeps every exp argument <= 0. The
// readout keeps q e^{cc}, S and k e^{..} in f32: the Pallas kernel's casts
// of those operands to bf16 (:1804-1806) feed the MXU and are not part of
// the function.
//
// What bounds it on the H100: bytes, and at small batch latency. The state
// is read once per token (b8 flagship: 8.4 MB per layer in bf16, 4.2 MB in
// int8, 2.5 and 1.3 us at 3.35 TB/s) and never written; the live window adds
// (p + 1) (2 dk + dv) elements per (batch, head). The work is 2 dk dv
// operations per 2 or 1 state bytes, far below the card's ratio. Two bodies
// (routes) compute it, chosen by ops/gla_cuda.py:gla_decode_lazy_plan from
// shapes and dtypes before the launch:
//
// Cluster route (a float state from 24 heads in flight; it takes no int8
// state). Every byte of the state, the live window and the rings is read
// once from device memory, and at b8 the step runs in one wave. A thread
// block cluster of R = dk / 32 blocks owns one (batch, head); block r owns
// kRB = 32 key rows and, for the finish, dv / R value columns (its slice):
// - its rows' q, k and new cc (the conv is elementwise), q e^{cc}, the q
//   and k rings, kbuf[p] and cbuf[p] there, and
//   its part of every window score over its rows, a_j^(r) = sum_i q_i k_j,i
//   e^{min(cc_i - c_j,i, 0)}: no conv, exp or window key is formed or read
//   twice;
// - its rows' slab of the state, RB x dv and contiguous, which lane 0 asks
//   the TMA engine for as one bulk copy into shared memory on an mbarrier
//   (cp.async.bulk), right after the rows' conv inputs are asked for (behind
//   the slab they would wait for it), so the whole state is in flight at
//   once; then its part of the readout at every column of the slab;
// - the parts travel as pushes into their owner's shared memory (st.async,
//   completing on the owner's mbarrier): the score parts to every block,
//   the readout parts to the block whose slice they fall in. The owner adds
//   the R parts in rank order, forms v for its slice (the v ring and
//   vbuf[p] there), adds sum_{j <= p} a_j v_j (each vbuf element read once,
//   the first slots loaded at block start) and writes o. A split cluster
//   barrier only guarantees that every block's mbarrier is initialised
//   before a peer pushes to it; nobody waits on it.
// Tried first and dropped on the card (PERF.md, PR 14): pulling the parts
// through distributed shared memory after a cluster barrier (the barrier
// and the gather came after the state's transfer); a column split, each
// block reading its (dk x slice) tile by per-row bulk copies (256 copies of
// 128 bytes a block: the TMA engine took twice as long) or into registers
// with q formed in every block (128 registers, a second wave at b8); the
// slab in four parts on four mbarriers (no earlier start: the rows' inputs
// land with the slab); a cap of 64 registers for four blocks an SM (spills,
// slower at b1 and b8); an int8 body of 64 rows a block (its state lands in
// half the time, so the chain of exchanges after it dominates: slower than
// the tile route at every shape).
//
// Tile route (an int8 state, or fewer than 24 heads), the PR 3 / PR 5
// design: as gla_decode_conv.cu, a block owns a (DK x 32) column tile of one
// (batch, head) state, lane = value column. Every block of a (batch, head)
// needs the full q and k and the new cc, so each recomputes them from the
// OLD rings and the OLD cc; the new rings and the new cc go to separate
// output buffers (an in-place update by one block would race with the other
// blocks' reads). Slot p of kbuf / cbuf is written in place by block column
// 0 only, and slot p of vbuf by each block for its own columns; no block
// reads slot p from memory (it holds the token's k, v and cc itself), so
// those writes race with nothing. Warp w owns the window slots j = w, w + 8,
// ...: it computes the weight a_j = q . k_j e^{..} with a shuffle reduction
// and adds a_j v_j to its partial output, so the window costs no pass of its
// own. The state rows and the first two slots of each warp (a window of 16)
// are loaded before the first barrier, so that every global load of the
// token is in flight at once: the step is a chain of load latencies, not of
// bytes, at small batch. An int8 state is a byte an element, so there a lane
// owns four neighbouring value columns and loads them as one 32-bit word (a
// warp reads 128 bytes of a row, the block a (DK x 128) tile). Where the
// state's bytes are few (b1) or half (int8), its one chain of latencies
// beats or ties the cluster route's (rows, score pushes, slab, readout,
// readout pushes, window), which only pays once the bytes dominate.
//
// Both routes sum in a fixed order and use no atomics: a second call gives
// equal bits. The cluster route takes dv in tiles of at most kSlabBytes of
// slab (wider heads take several column tiles, grid y, each with its own
// cluster, which then recompute the rows' terms; tile 0 writes the rows'
// outputs).
#include <cooperative_groups.h>

#include <cstdint>

#include "gla_common.cuh"

namespace cg = cooperative_groups;

namespace {

using namespace gla;

constexpr int kI8 = 2;               // state dtype code of a row-quantized int8 state
constexpr int kTileRoute = 0;        // route codes (ops/gla_cuda.py:_LAZY_ROUTE_CODE)
constexpr int kClusterRoute = 1;
constexpr int kRB = 32;              // key rows a block of the cluster route owns
constexpr int kWarps = kThreads / 32;
constexpr int kSlabBytes = 65536;    // most state bytes a block stages
constexpr int kPreK = 2;             // window slots of k and c a warp loads ahead
constexpr int kPreV = 4;             // window slots of v a thread loads ahead

#ifdef LAZY_TIMELINE
// Timeline instrumentation, compiled only by utils/lazy_timeline.py: thread 0
// of each block notes %globaltimer at kTimelineStamps points.
constexpr int kTimelineBlocks = 8192, kTimelineStamps = 7;
__device__ unsigned long long lazy_timeline[kTimelineBlocks][kTimelineStamps];
__device__ __forceinline__ void lazy_stamp(int i) {
  const unsigned b = blockIdx.y * gridDim.x + blockIdx.x;
  if (threadIdx.x == 0 && b < kTimelineBlocks) {
    unsigned long long t;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
    lazy_timeline[b][i] = t;
  }
}
#define LAZY_STAMP(i) lazy_stamp(i)
#else
#define LAZY_STAMP(i)
#endif

// How a thread reads neighbouring state columns from the slab: N of them in
// one 8- or 16-byte shared-memory load, unpacked to f32. A bf16 is the top
// half of its f32.
template <typename ST> struct Vec;
template <> struct Vec<float> {
  static constexpr int N = 4;
  static __device__ __forceinline__ void load(const float* s, float (&f)[N]) {
    const float4 w = *reinterpret_cast<const float4*>(s);
    f[0] = w.x;
    f[1] = w.y;
    f[2] = w.z;
    f[3] = w.w;
  }
};
template <> struct Vec<__nv_bfloat16> {
  static constexpr int N = 4;
  static __device__ __forceinline__ void load(const __nv_bfloat16* s, float (&f)[N]) {
    const uint2 w = *reinterpret_cast<const uint2*>(s);
    f[0] = __uint_as_float(w.x << 16);
    f[1] = __uint_as_float(w.x & 0xffff0000u);
    f[2] = __uint_as_float(w.y << 16);
    f[3] = __uint_as_float(w.y & 0xffff0000u);
  }
};

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int m = 16; m > 0; m >>= 1) x += __shfl_xor_sync(0xffffffffu, x, m);
  return x;
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// the mbarrier the tile's bulk copies complete on (one phase a launch)
__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_addr(bar)));
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
__device__ __forceinline__ void mbar_expect(uint64_t* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_wait(uint64_t* bar) {
  unsigned done = 0;
  while (!done) {
    asm volatile(
        "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(0u)
        : "memory");
  }
}
// bytes (a multiple of 16, both addresses on 16-byte boundaries) from device
// memory into this block's shared memory by the TMA engine
__device__ __forceinline__ void bulk_copy(void* dst, const void* src, unsigned bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::
          "r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}
// this block's shared-memory address ``local`` in block ``rank`` of the cluster
__device__ __forceinline__ unsigned peer_addr(const void* local, int rank) {
  unsigned r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(r) : "r"(smem_addr(local)), "r"(rank));
  return r;
}
// f32 values into a peer's shared memory at ``dst``, completing on its
// mbarrier ``bar`` (both shared::cluster addresses from peer_addr)
__device__ __forceinline__ void push(unsigned dst, float v, unsigned bar) {
  asm volatile("st.async.shared::cluster.mbarrier::complete_tx::bytes.f32 [%0], %1, [%2];\n" ::"r"(dst),
               "f"(v), "r"(bar)
               : "memory");
}
__device__ __forceinline__ void push4(unsigned dst, const float* v, unsigned bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.v4.f32 [%0], {%1, %2, %3, %4}, [%5];\n" ::
          "r"(dst),
      "f"(v[0]), "f"(v[1]), "f"(v[2]), "f"(v[3]), "r"(bar)
      : "memory");
}

// the split cluster barrier of int8_common.cuh: arrive when done with the
// other blocks' shared memory, wait just before leaving
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
}

// ------------------------------------------------------------ tile route
// How a lane holds its share of a state row: CPL neighbouring columns loaded
// as one Raw word and unpacked to f32 when they are used.
template <typename ST> struct Tile {
  static constexpr int kCPL = 1;
  using Raw = ST;
  static __device__ __forceinline__ void unpack(Raw w, float (&f)[1]) { f[0] = to_f(w); }
};
template <> struct Tile<signed char> {
  static constexpr int kCPL = 4;
  using Raw = unsigned int;
  static __device__ __forceinline__ void unpack(Raw w, float (&f)[4]) {
    f[0] = static_cast<float>(static_cast<signed char>(w & 0xff));
    f[1] = static_cast<float>(static_cast<signed char>((w >> 8) & 0xff));
    f[2] = static_cast<float>(static_cast<signed char>((w >> 16) & 0xff));
    f[3] = static_cast<float>(static_cast<signed char>(w >> 24));
  }
};


template <typename IO, typename ST, int DK>
__global__ void __launch_bounds__(kThreads, 2)
lazy_tile_kernel(const IO* __restrict__ xq, const IO* __restrict__ xk,
                            const IO* __restrict__ xv, const float* __restrict__ gk,
                            const IO* __restrict__ wq, const IO* __restrict__ wk,
                            const IO* __restrict__ wv, const IO* __restrict__ cq,
                            const IO* __restrict__ ck, const IO* __restrict__ cv,
                            const ST* __restrict__ state,
                            const float* __restrict__ s_scale, IO* kbuf, IO* vbuf,
                            float* cbuf, const float* __restrict__ cc,
                            IO* __restrict__ o, IO* __restrict__ cq_out,
                            IO* __restrict__ ck_out, IO* __restrict__ cv_out,
                            float* __restrict__ cc_out, int BH, int H, int DV,
                            int p, float scale) {
  constexpr int RPT = DK / kGroups;
  constexpr int CPL = Tile<ST>::kCPL;  // value columns per lane
  constexpr int W = kBV * CPL;         // value columns per block
  using Raw = typename Tile<ST>::Raw;
  const int bh = blockIdx.x;
  const int h = bh % H;
  const int tid = threadIdx.x;
  const int lane = tid % kBV;
  const int grp = tid / kBV;  // == warp index (kBV == 32)
  const int col0 = blockIdx.y * W;      // the block's first column
  const int col = col0 + lane * CPL;    // this lane's first column
  const int row0 = grp * RPT;

  constexpr int EPL = DK / kBV;  // key elements per lane in a slot's dot product
  __shared__ float sq[DK], sk[DK], scc[DK], sv[W];
  __shared__ __align__(16) float sqe[DK];
  __shared__ float part[kGroups][W];

  // the long-latency loads first: this thread's rows of the state tile
  const ST* srow = state + (size_t)bh * DK * DV + (size_t)row0 * DV + col;
  Raw s[RPT];
#pragma unroll
  for (int r = 0; r < RPT; ++r) s[r] = *reinterpret_cast<const Raw*>(srow + (size_t)r * DV);

  // rings are (4, BH, D): element (j, bh, c) at j * BH * D + bh * D + c;
  // window buffers (L, BH, D) likewise
  const size_t kstride = (size_t)BH * DK;
  const size_t vstride = (size_t)BH * DV;

  // slot j < p of the window: this lane's share of k_j and c_j, and v_j at
  // this lane's columns
  auto load_slot = [&](int j, float (&kj)[EPL], float (&cj)[EPL], float (&vj)[CPL]) {
    const size_t base = j * kstride + (size_t)bh * DK + lane;
#pragma unroll
    for (int e = 0; e < EPL; ++e) {
      kj[e] = to_f(kbuf[base + e * kBV]);
      cj[e] = cbuf[base + e * kBV];
    }
#pragma unroll
    for (int c = 0; c < CPL; ++c) vj[c] = to_f(vbuf[j * vstride + (size_t)bh * DV + col + c]);
  };
  // acc += a_j v_j with a_j = sum_i q_i k_j,i e^{min(cc_i - c_j,i, 0)}. Slot p
  // is this token: k and v from shared memory, exp argument 0.
  auto add_slot = [&](int j, const float (&kj)[EPL], const float (&cj)[EPL],
                      const float (&vj)[CPL], float (&acc)[CPL]) {
    float a = 0.f;
    if (j == p) {
#pragma unroll
      for (int e = 0; e < EPL; ++e) a += sq[lane + e * kBV] * sk[lane + e * kBV];
    } else {
#pragma unroll
      for (int e = 0; e < EPL; ++e) {
        const int i = lane + e * kBV;
        a += sq[i] * kj[e] * expf(fminf(scc[i] - cj[e], 0.f));
      }
    }
    a = warp_sum(a);
#pragma unroll
    for (int c = 0; c < CPL; ++c) acc[c] += a * (j == p ? sv[lane * CPL + c] : vj[c]);
  };

  // this warp's first window slots j = grp, grp + kGroups are loaded ahead
  // of the barrier too
  float pk[kPreK][EPL], pc[kPreK][EPL], pv[kPreK][CPL];
#pragma unroll
  for (int u = 0; u < kPreK; ++u) {
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
    // an int8 state's row scale rides the query of the base readout
    sqe[tid] = q * expf(ccn) * (s_scale != nullptr ? s_scale[off] : 1.f);
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
  if (tid < W) {
    const int vcol = col0 + tid;
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
  float acc[CPL];
#pragma unroll
  for (int c = 0; c < CPL; ++c) acc[c] = 0.f;
  const float4* qe = reinterpret_cast<const float4*>(&sqe[row0]);
#pragma unroll
  for (int r = 0; r < RPT; r += 4) {
    const float4 q4 = qe[r / 4];
    const float q[4] = {q4.x, q4.y, q4.z, q4.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float f[CPL];
      Tile<ST>::unpack(s[r + i], f);
#pragma unroll
      for (int c = 0; c < CPL; ++c) acc[c] += q[i] * f[c];
    }
  }

  // window: o += a_j v_j over this warp's slots j <= p; those past the
  // loaded-ahead ones (a window longer than kPreK * kGroups) are loaded here
#pragma unroll
  for (int u = 0; u < kPreK; ++u) {
    const int j = grp + u * kGroups;
    if (j <= p) add_slot(j, pk[u], pc[u], pv[u], acc);
  }
  for (int j = grp + kPreK * kGroups; j <= p; j += kGroups) {
    float kj[EPL], cj[EPL], vj[CPL];
    if (j < p) load_slot(j, kj, cj, vj);
    add_slot(j, kj, cj, vj, acc);
  }
#pragma unroll
  for (int c = 0; c < CPL; ++c) part[grp][lane * CPL + c] = acc[c];
  __syncthreads();

  if (tid < W) {
    float out = 0.f;
#pragma unroll
    for (int g = 0; g < kGroups; ++g) out += part[g][tid];
    o[(size_t)bh * DV + col0 + tid] = from_f<IO>(out);
  }
}

template <typename IO, typename ST, int DK>
int launch_tile(const void* xq, const void* xk, const void* xv, const void* gk,
                const void* wq, const void* wk, const void* wv, const void* cq,
                const void* ck, const void* cv, const void* state, const void* s_scale,
                void* kbuf, void* vbuf, void* cbuf, const void* cc, void* o, void* cq_out,
                void* ck_out, void* cv_out, void* cc_out, int B, int H, int DV, int p,
                float scale, cudaStream_t stream) {
  constexpr int W = kBV * Tile<ST>::kCPL;
  if (DV % W != 0) return -3;
  const dim3 grid(B * H, DV / W);
  lazy_tile_kernel<IO, ST, DK><<<grid, kThreads, 0, stream>>>(
      static_cast<const IO*>(xq), static_cast<const IO*>(xk),
      static_cast<const IO*>(xv), static_cast<const float*>(gk),
      static_cast<const IO*>(wq), static_cast<const IO*>(wk),
      static_cast<const IO*>(wv), static_cast<const IO*>(cq),
      static_cast<const IO*>(ck), static_cast<const IO*>(cv),
      static_cast<const ST*>(state), static_cast<const float*>(s_scale),
      static_cast<IO*>(kbuf), static_cast<IO*>(vbuf),
      static_cast<float*>(cbuf), static_cast<const float*>(cc), static_cast<IO*>(o),
      static_cast<IO*>(cq_out), static_cast<IO*>(ck_out), static_cast<IO*>(cv_out),
      static_cast<float*>(cc_out), B * H, H, DV, p, scale);
  return static_cast<int>(cudaGetLastError());
}

// --------------------------------------------------------- cluster route
// Dynamic shared memory of a block whose tile is w columns wide, at window
// position p: the slab (rows x w), then f32 arrays: the readout parts and
// the score parts the peers push (ngr row groups of R ranks), the scores, v
// at the slice's columns, and the window's groups before they are added.
template <typename ST>
__host__ __device__ __forceinline__ int row_groups(int w) {
  const int ncg = w / Vec<ST>::N;
  return ncg >= kThreads ? 1 : kThreads / ncg;
}
template <typename ST, int DK>
__host__ __device__ __forceinline__ int smem_bytes(int w, int p) {
  constexpr int R = DK / kRB;
  const int sw = w / R;
  return kRB * w * static_cast<int>(sizeof(ST)) +
         (row_groups<ST>(w) * w + (R + 1) * (p + 1) + sw + (sw > kThreads ? sw : kThreads)) * 4;
}

template <typename IO, typename ST, int DK>
__global__ void __launch_bounds__(kThreads)
lazy_cluster_kernel(const IO* __restrict__ xq, const IO* __restrict__ xk,
                 const IO* __restrict__ xv, const float* __restrict__ gk,
                 const IO* __restrict__ wq, const IO* __restrict__ wk,
                 const IO* __restrict__ wv, const IO* __restrict__ cq,
                 const IO* __restrict__ ck, const IO* __restrict__ cv,
                 const ST* __restrict__ state, IO* kbuf, IO* vbuf, float* cbuf,
                 const float* __restrict__ cc, IO* __restrict__ o,
                 IO* __restrict__ cq_out, IO* __restrict__ ck_out, IO* __restrict__ cv_out,
                 float* __restrict__ cc_out, int BH, int H, int DV, int w, int p,
                 float scale) {
  constexpr int RB = kRB;      // the block's rows
  constexpr int RW = RB / 32;  // warps that form them, and rows a lane scores
  constexpr int R = DK / RB;   // blocks of a cluster
  constexpr int VN = Vec<ST>::N;
  extern __shared__ __align__(128) unsigned char dsm[];
  __shared__ float sq[RB], sk[RB], scc[RB], sqe[RB];
  __shared__ __align__(8) uint64_t slab_bar, push_bar;

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int bh = blockIdx.x / R;
  const int h = bh % H;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int r0 = rank * RB;           // the block's first row
  const int c0 = blockIdx.y * w;      // the tile's first column
  const int sw = w / R;               // the block's slice of the tile
  const int s0 = c0 + rank * sw;      // the slice's first column
  const int ngr = row_groups<ST>(w);  // the readout's row groups

  ST* slab = reinterpret_cast<ST*>(dsm);                               // [RB][w]
  float* recv_b = reinterpret_cast<float*>(dsm + RB * w * sizeof(ST));  // [R][ngr][sw]
  float* recv_s = recv_b + ngr * w;                                     // [R][p + 1]
  float* sa = recv_s + R * (p + 1);                                     // [p + 1]
  float* sv = sa + p + 1;                                               // [sw]
  float* red = sv + sw;                                                 // the window's groups

  LAZY_STAMP(0);
  const ST* src = state + ((size_t)bh * DK + r0) * DV + c0;
  const unsigned row_bytes = w * sizeof(ST);
  if (tid == 0) {
    mbar_init(&slab_bar);
    mbar_init(&push_bar);
    mbar_expect(&slab_bar, RB * row_bytes);
    mbar_expect(&push_bar, (ngr * w + R * (p + 1)) * 4);  // what the R blocks push here
  }
  __syncthreads();
  cluster_arrive();  // this block's barriers are ready (peers wait before pushing)

  // rings are (4, BH, D): element (j, bh, c) at j * BH * D + bh * D + c;
  // window buffers (L, BH, D) likewise
  const size_t kstride = (size_t)BH * DK;
  const size_t vstride = (size_t)BH * DV;
  const size_t koff = (size_t)bh * DK + r0 + lane;  // this lane's first row
  const size_t voff = (size_t)bh * DV + s0;         // the slice

  // The rows' conv inputs are asked for before the state's slab, so that
  // they do not queue behind it (warp w < RW: row 32 w + lane).
  const size_t roff = koff + 32 * warp;
  float x_q = 0.f, x_k = 0.f, cc_r = 0.f, g_r = 0.f;
  float hq[kConv - 1], hk[kConv - 1], tq[kConv], tk[kConv];
  if (warp < RW) {
    const int row = r0 + 32 * warp + lane;
    x_q = to_f(xq[roff]);
    x_k = to_f(xk[roff]);
#pragma unroll
    for (int j = 0; j < kConv - 1; ++j) {
      hq[j] = to_f(cq[(j + 1) * kstride + roff]);
      hk[j] = to_f(ck[(j + 1) * kstride + roff]);
    }
#pragma unroll
    for (int i = 0; i < kConv; ++i) {
      tq[i] = to_f(wq[(size_t)(i * H + h) * DK + row]);
      tk[i] = to_f(wk[(size_t)(i * H + h) * DK + row]);
    }
    cc_r = cc[roff];
    g_r = gk[roff];
  }
  // the state's slab, one bulk copy where its rows are contiguous
  if (warp == 0) {
    if (w == DV) {
      if (lane == 0) bulk_copy(slab, src, RB * row_bytes, &slab_bar);
    } else {
      for (int i = lane; i < RB; i += 32)
        bulk_copy(slab + i * w, src + (size_t)i * DV, row_bytes, &slab_bar);
    }
  }

  // window loads, issued before anything waits: k_j and c_j of this lane's
  // rows for the warp's first slots j = warp, warp + kWarps (scores), and v_j
  // at this thread's column for its first slots (the window's terms: the
  // slice's columns are split over ng groups of threads, group g taking the
  // slots j = g, g + ng, ...)
  float pk[kPreK][RW] = {}, pc[kPreK][RW] = {};
#pragma unroll
  for (int u = 0; u < kPreK; ++u) {
    const int j = warp + u * kWarps;
#pragma unroll
    for (int m = 0; m < RW; ++m) {
      if (j < p) {
        pk[u][m] = to_f(kbuf[j * kstride + koff + 32 * m]);
        pc[u][m] = cbuf[j * kstride + koff + 32 * m];
      }
    }
  }
  const bool wide = sw >= kThreads;
  const int ng = wide ? 1 : kThreads / sw;
  const int g = wide ? 0 : tid / sw;
  const int col = wide ? tid : tid % sw;  // this thread's first column of the slice
  const bool vact = g < ng && col < sw;
  float pv[kPreV] = {};
#pragma unroll
  for (int u = 0; u < kPreV; ++u) {
    const int j = g + u * ng;
    if (vact && j < p) pv[u] = to_f(vbuf[j * vstride + voff + col]);
  }

  // v of the slice's columns, by the last threads (the first warps take the
  // rows): the v ring and vbuf[p] there
  for (int c = kThreads - 1 - tid; c < sw; c += kThreads) {
    const size_t off = voff + c;
    const float x_v = to_f(xv[off]);
    float hv[kConv - 1], tv[kConv];
#pragma unroll
    for (int j = 0; j < kConv - 1; ++j) hv[j] = to_f(cv[(j + 1) * vstride + off]);
#pragma unroll
    for (int i = 0; i < kConv; ++i) tv[i] = to_f(wv[(size_t)(i * H + h) * DV + s0 + c]);
    const IO v_io = from_f<IO>(silu(round_io<IO>(tap_sum(tv, hv, x_v))));
    sv[c] = to_f(v_io);
#pragma unroll
    for (int j = 0; j < kConv - 1; ++j) cv_out[j * vstride + off] = from_f<IO>(hv[j]);
    cv_out[(kConv - 1) * vstride + off] = from_f<IO>(x_v);
    vbuf[p * vstride + off] = v_io;
  }

  // the block's rows: q, k and the new cc
  if (warp < RW) {
    const int i = 32 * warp + lane;
    const float q = silu(round_io<IO>(tap_sum(tq, hq, x_q))) * scale;
    const IO k_io = from_f<IO>(silu(round_io<IO>(tap_sum(tk, hk, x_k))));
    const float ccn = cc_r + g_r;
    sq[i] = q;
    sqe[i] = q * expf(ccn);
    sk[i] = to_f(k_io);
    scc[i] = ccn;
    if (blockIdx.y == 0) {  // one column tile writes the rows' outputs
#pragma unroll
      for (int j = 0; j < kConv - 1; ++j) {
        cq_out[j * kstride + roff] = from_f<IO>(hq[j]);
        ck_out[j * kstride + roff] = from_f<IO>(hk[j]);
      }
      cq_out[(kConv - 1) * kstride + roff] = from_f<IO>(x_q);
      ck_out[(kConv - 1) * kstride + roff] = from_f<IO>(x_k);
      kbuf[p * kstride + roff] = k_io;
      cbuf[p * kstride + roff] = ccn;
      cc_out[roff] = ccn;
    }
  }
  __syncthreads();
  LAZY_STAMP(1);
  cluster_wait();  // every peer's barriers are ready

  // this block's part of every window score, pushed to every block of the
  // cluster: warp w takes slots j = w, w + kWarps, ...; slot p is this token
  // (exp argument 0)
  auto score = [&](int j, const float (&kj)[RW], const float (&cj)[RW]) {
    float a = 0.f;
#pragma unroll
    for (int m = 0; m < RW; ++m) {
      const int i = lane + 32 * m;
      a += j == p ? sq[i] * sk[i] : sq[i] * kj[m] * expf(fminf(scc[i] - cj[m], 0.f));
    }
    a = warp_sum(a);
    if (lane < R)
      push(peer_addr(recv_s + rank * (p + 1) + j, lane), a, peer_addr(&push_bar, lane));
  };
#pragma unroll
  for (int u = 0; u < kPreK; ++u) {
    const int j = warp + u * kWarps;
    if (j <= p) score(j, pk[u], pc[u]);
  }
  for (int j = warp + kPreK * kWarps; j <= p; j += kWarps) {
    float kj[RW] = {}, cj[RW] = {};
#pragma unroll
    for (int m = 0; m < RW; ++m) {
      if (j < p) {
        kj[m] = to_f(kbuf[j * kstride + koff + 32 * m]);
        cj[m] = cbuf[j * kstride + koff + 32 * m];
      }
    }
    score(j, kj, cj);
  }
  LAZY_STAMP(2);

  // this block's part of the readout at every column of the tile: thread t
  // takes VN neighbouring columns and the rows i = gr, gr + ngr, ... (a warp
  // reads 256 or 512 consecutive bytes of a row), and pushes its sums to the
  // block that owns those columns
  mbar_wait(&slab_bar);
  LAZY_STAMP(3);
  const int ncg = w / VN;
  const int gr = ncg >= kThreads ? 0 : tid / ncg;
  for (int c = (ncg >= kThreads ? tid : tid % ncg) * VN; gr < ngr && c < w;
       c += kThreads * VN) {
    float acc[VN];
#pragma unroll
    for (int e = 0; e < VN; ++e) acc[e] = 0.f;
#pragma unroll 8
    for (int i = gr; i < RB; i += ngr) {
      const float q = sqe[i];
      float f[VN];
      Vec<ST>::load(slab + i * w + c, f);
#pragma unroll
      for (int e = 0; e < VN; ++e) acc[e] += q * f[e];
    }
    const int owner = c / sw;
    const unsigned bar = peer_addr(&push_bar, owner);
#pragma unroll
    for (int e = 0; e < VN; e += 4)
      push4(peer_addr(recv_b + (rank * ngr + gr) * sw + c - owner * sw + e, owner), acc + e, bar);
  }
  LAZY_STAMP(4);

  // the slice: the scores and the readout added in rank order (rank, then
  // row group), then the window's terms (slot group g)
  mbar_wait(&push_bar);
  for (int j = tid; j <= p; j += kThreads) {
    float a = 0.f;
    for (int q = 0; q < R; ++q) a += recv_s[q * (p + 1) + j];
    sa[j] = a;
  }
  __syncthreads();
  LAZY_STAMP(5);
  for (int c = col, first = 1; vact && c < sw; c += kThreads, first = 0) {
    float acc = 0.f;
    for (int k = g; k < R * ngr; k += ng) acc += recv_b[k * sw + c];
    int j = g;
    if (first) {
#pragma unroll
      for (int u = 0; u < kPreV; ++u, j += ng)
        if (j < p) acc += sa[j] * pv[u];
    }
    for (; j < p; j += ng) acc += sa[j] * to_f(vbuf[j * vstride + voff + c]);
    if (p % ng == g) acc += sa[p] * sv[c];
    if (ng == 1) o[voff + c] = from_f<IO>(acc);
    else red[g * sw + c] = acc;
  }
  if (ng > 1) {
    __syncthreads();
    for (int c = tid; c < sw; c += kThreads) {
      float out = 0.f;
      for (int q = 0; q < ng; ++q) out += red[q * sw + c];
      o[voff + c] = from_f<IO>(out);
    }
  }
  LAZY_STAMP(6);
}

// Columns of a block's tile: dv cut into the fewest equal tiles whose
// columns are a multiple of R x the loads' width and whose slab is at most
// kSlabBytes.
template <typename ST, int DK>
int slab_width(int DV) {
  const int quantum = (DK / kRB) * Vec<ST>::N;
  for (int t = 1; t <= DV / quantum; ++t) {
    const int w = DV / t;
    if (DV % t == 0 && w % quantum == 0 && kRB * w * (int)sizeof(ST) <= kSlabBytes) return w;
  }
  return quantum;
}

template <typename IO, typename ST, int DK>
int launch_cluster(const void* xq, const void* xk, const void* xv, const void* gk,
           const void* wq, const void* wk, const void* wv, const void* cq,
           const void* ck, const void* cv, const void* state, void* kbuf, void* vbuf,
           void* cbuf, const void* cc, void* o, void* cq_out, void* ck_out, void* cv_out,
           void* cc_out, int B, int H, int DV, int p, float scale, cudaStream_t stream) {
  constexpr int R = DK / kRB;
  const int w = slab_width<ST, DK>(DV);
  if (DV % w != 0) return -3;  // DV has no tile of R x the loads' width
  const int smem = smem_bytes<ST, DK>(w, p);
  auto kernel = lazy_cluster_kernel<IO, ST, DK>;
  static int sized = 48 * 1024;  // the most the attribute allows so far
  if (smem > sized) {
    const cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    sized = smem;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(R * B * H, DV / w);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = R;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t e = cudaLaunchKernelEx(
      &cfg, kernel, static_cast<const IO*>(xq), static_cast<const IO*>(xk),
      static_cast<const IO*>(xv), static_cast<const float*>(gk),
      static_cast<const IO*>(wq), static_cast<const IO*>(wk),
      static_cast<const IO*>(wv), static_cast<const IO*>(cq),
      static_cast<const IO*>(ck), static_cast<const IO*>(cv),
      static_cast<const ST*>(state), static_cast<IO*>(kbuf), static_cast<IO*>(vbuf),
      static_cast<float*>(cbuf), static_cast<const float*>(cc), static_cast<IO*>(o),
      static_cast<IO*>(cq_out), static_cast<IO*>(ck_out), static_cast<IO*>(cv_out),
      static_cast<float*>(cc_out), B * H, H, DV, w, p, scale);
  return e != cudaSuccess ? static_cast<int>(e) : static_cast<int>(cudaGetLastError());
}

}  // namespace

// C entry point (bound with ctypes in ops/gla_cuda.py). Layouts: xq, xk, gk,
// cc (B, H, DK); xv (B, H, DV); taps wq, wk (4, H, DK), wv (4, H, DV), tap 0
// oldest; rings cq, ck (4, B, H, DK), cv (4, B, H, DV), index 3 newest;
// state (B, H, DK, DV), read only, on a 16-byte boundary, f32, bf16 or
// (state_dtype 2) int8 with its row scales s_scale (B, H, DK) f32, else
// s_scale null; window buffers kbuf (L, B, H, DK), vbuf (L, B, H, DV) in the
// IO dtype and cbuf (L, B, H, DK) f32, slot p written in place; cc f32;
// outputs o (B, H, DV), the new rings and the new cc. All contiguous.
// Returns cudaGetLastError() after the launch (or the launch's own error: a
// cluster the card cannot place), -1 for an unsupported DK, -2 for
// unsupported dtype codes, -3 for DV % 32 != 0 (% 128 with an int8 state),
// -4 for p outside the window, -5 for an int8 state without scales or
// scales with a float state, -6 for a state off a 16-byte boundary (the
// cluster route), -7 for an unknown route code (0 tile, 1 cluster), -8 for
// an int8 state on the cluster route (the tile route is its only body).
extern "C" int gla_decode_lazy_conv_step(
    const void* xq, const void* xk, const void* xv, const void* gk, const void* wq,
    const void* wk, const void* wv, const void* cq, const void* ck, const void* cv,
    const void* state, const void* s_scale, void* kbuf, void* vbuf, void* cbuf,
    const void* cc, void* o,
    void* cq_out, void* ck_out, void* cv_out, void* cc_out, int B, int H, int DK,
    int DV, int L, int p, float scale, int io_dtype, int state_dtype, int route,
    void* stream) {
  if (DV % gla::kBV != 0 || DV < gla::kBV) return -3;
  if (state_dtype == kI8 && DV % (4 * gla::kBV) != 0) return -3;
  if (p < 0 || p >= L) return -4;
  if ((state_dtype == kI8) != (s_scale != nullptr)) return -5;
  if (route != kTileRoute && route != kClusterRoute) return -7;
  if (route == kClusterRoute && reinterpret_cast<uintptr_t>(state) % 16 != 0) return -6;
  if (route == kClusterRoute && state_dtype == kI8) return -8;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define TILE_LAUNCH(IO_T, ST_T)                                                          \
  GLA_DISPATCH_DK(DK, return launch_tile<IO_T, ST_T, DK>(                                \
      xq, xk, xv, gk, wq, wk, wv, cq, ck, cv, state, s_scale, kbuf, vbuf, cbuf, cc, o,   \
      cq_out, ck_out, cv_out, cc_out, B, H, DV, p, scale, st))
#define LAZY_LAUNCH(IO_T, ST_T)                                                          \
  if (route == kTileRoute) { TILE_LAUNCH(IO_T, ST_T) }                                   \
  GLA_DISPATCH_DK(DK, return launch_cluster<IO_T, ST_T, DK>(                             \
      xq, xk, xv, gk, wq, wk, wv, cq, ck, cv, state, kbuf, vbuf, cbuf, cc, o, cq_out,    \
      ck_out, cv_out, cc_out, B, H, DV, p, scale, st))
  if (state_dtype == kI8) {
    if (io_dtype == gla::kF32) { TILE_LAUNCH(float, signed char) }
    if (io_dtype == gla::kBF16) { TILE_LAUNCH(__nv_bfloat16, signed char) }
    return -2;
  }
  GLA_DISPATCH_TYPES(io_dtype, state_dtype, LAZY_LAUNCH(IO, ST))
#undef LAZY_LAUNCH
#undef TILE_LAUNCH
  return -2;
}

#ifdef LAZY_TIMELINE
// Copies the stamps of the blocks launched since the last call into host
// (kTimelineBlocks x kTimelineStamps u64, zero where a block noted nothing)
// and clears them. Returns a cudaError_t.
extern "C" int gla_decode_lazy_conv_timeline(void* host) {
  cudaError_t e = cudaMemcpyFromSymbol(host, lazy_timeline, sizeof(lazy_timeline));
  if (e != cudaSuccess) return static_cast<int>(e);
  void* dev = nullptr;
  e = cudaGetSymbolAddress(&dev, lazy_timeline);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaMemset(dev, 0, sizeof(lazy_timeline)));
}
#endif
