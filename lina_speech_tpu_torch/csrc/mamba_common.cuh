// Shared pieces of the Mamba (v1) selective-scan kernels (mamba_scan.cu,
// mamba_scan_bwd.cu): the block shape, the staging ring of a time walk, the
// walk itself in four modes, and the carry across time chunks.
//
// A block owns kCh = 64 channels of one batch row and one time chunk. Each
// channel's state of kN = 16 values is split over kLanes = 4 neighbouring
// lanes of a warp, each holding kPer = 4 of them in registers, so a warp
// covers 8 channels and a block of 256 threads 64. The time axis is a loop
// inside the block over 16-step segments; the inputs come through a ring of
// kRing segment tiles in shared memory, kRing - 1 segments ahead, all by
// cp.async (x, dt, B, C as they lie in device memory and the 4-byte words
// that hold the segment's reset flags): a step does few operations, so
// without the copies in flight the walk waits on memory.
//
// The recurrence h_t = a_t h_{t-1} + dt_t x_t B_t (a_t = exp(dt_t A) keep_t)
// is diagonal, so it splits over time chunks of L steps exactly: a chunk's
// walk from a zero state gives its end state h_loc and its decay product P
// = prod a_t (0 if a step resets); the state at chunk c's start is then
// H_c = P_{c-1} H_{c-1} + h_loc_{c-1} (carry_kernel), and each chunk can
// walk again from H_c. The forward (mamba_scan.cu) walks once where one
// chunk fills the card and in chunks below; the backward (mamba_scan_bwd.cu)
// walks for its checkpoints or its chunk summaries first.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace mamba {

// dtype codes passed from Python (ops/mamba_cuda.py:_DTYPE_CODE)
constexpr int kF32 = 0;
constexpr int kBF16 = 1;

constexpr int kN = 16;             // state size d_state
constexpr int kLanes = 4;          // lanes per channel
constexpr int kPer = kN / kLanes;  // state values per lane
constexpr int kChannels = 32;      // the granularity of d (a last group of 32 idles 4 warps)
constexpr int kCh = 64;                   // channels per block
constexpr int kBThreads = kCh * kLanes;   // 256
constexpr int kBWarps = kBThreads / 32;   // 8
constexpr int kSeg = 16;                  // steps per segment and per staged tile
constexpr int kRing = 4;                  // segment tiles of a walk's staging ring
constexpr float kLog2e = 1.4426950408889634f;
static_assert(kSeg * kN == kBThreads, "one B and one C value a thread per segment");

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
// round to nearest even, as JAX's f32 -> bf16 astype
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// The sum over the 4 lanes of a channel (lanes 4c .. 4c+3 of a warp); every
// lane of the group gets it. Fixed order, so the same bits every run.
__device__ __forceinline__ float lane_group_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  v += __shfl_xor_sync(0xffffffffu, v, 2);
  return v;
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Start the copies of x, dt and (unless null) dy of steps [row, row + n)
// into a tile: rows of the block's kLive channels, 16 bytes a copy.
template <int kLive, typename Tile, typename IO>
__device__ __forceinline__ void issue_rows(Tile& tl, const IO* __restrict__ x,
                                           const float* __restrict__ dt,
                                           const IO* __restrict__ dy, size_t row, int Dm,
                                           int ch0, int n) {
  constexpr int kV = 16 / sizeof(IO), xp = kLive / kV, dp = kLive / 4;
  for (int i = threadIdx.x; i < n * xp; i += blockDim.x) {
    const int j = i / xp, p = (i % xp) * kV;
    const size_t off = (row + j) * Dm + ch0 + p;
    cp_async16(&tl.x[j][p], x + off);
    if (dy) cp_async16(&tl.dy[j][p], dy + off);
  }
  for (int i = threadIdx.x; i < n * dp; i += blockDim.x) {
    const int j = i / dp, p = (i % dp) * 4;
    cp_async16(&tl.dt[j][p], dt + (row + j) * Dm + ch0 + p);
  }
}

// exp(dt A) for this lane's kPer state columns from a2 = A log2(e), 0 at a
// reset step: the SFU's ex2 flushing results below 2^-126 to 0 (one
// instruction instead of five; such a decay changes no state by more than
// 1e-38 times its value), a reset as an exponent of -inf (ex2 gives +0)
// instead of a select a column.
__device__ __forceinline__ void decays_ftz(float (&da)[kPer], const float (&a2)[kPer], float dt,
                                           float keep) {
  const float bias = keep != 0.f ? 0.f : -__int_as_float(0x7f800000);
#pragma unroll
  for (int k = 0; k < kPer; ++k)
    asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(da[k]) : "f"(fmaf(dt, a2[k], bias)));
}

// ---- the walk: one chunk of time of one batch row and 64-channel group a
// block (grid: group x chunk x batch), from its start state, in one of four
// modes (what it writes):
constexpr int kWalkCheckpoints = 0;   // the backward's one chunk: the state at every segment
                                      // start (ck); the last segment's steps are not run
constexpr int kWalkBwdSummaries = 1;  // the backward's chunks: ck, the in-chunk dt sum at every
                                      // segment start (cdt), hloc, P, and gloc (below)
constexpr int kWalkSummaries = 2;     // the forward's chunks: hloc and P from a zero state
constexpr int kWalkY = 3;             // the forward: y_t = C_t . h_t + D x_t from the chunk's
                                      // start state (s0, or H_c from hloc after the carry);
                                      // the last chunk writes the final state sf
//
// Every walk starts chunk 0 from s0 (null: zeros) and the others from zero,
// but kWalkY's from H_c. gloc = sum_t (prod_{s<=t} a_s) C_t dy_t is the
// reverse scan of the state cotangent from zero at the chunk's end, in
// closed form from the same decays. Layouts: ck (batch, ceil(T/16), Dm, kN)
// and cdt (batch, ceil(T/16), Dm), segments indexed over the whole length;
// hloc, gloc, P (batch, chunks, Dm, kN); y (batch, T, Dm); sf (batch, Dm,
// kN). kWalkY stages the segment's y in the tile's dy rows (no dy is copied
// in that mode) and writes them to y a segment later, 16 bytes a store.
template <typename IO>
struct __align__(16) FwdTile {
  IO x[kSeg][kCh];
  float dt[kSeg][kCh];
  IO dy[kSeg][kCh];  // dy (kWalkBwdSummaries) or the segment's y (kWalkY)
  IO B[kSeg][kN];
  IO C[kSeg][kN];
  uint32_t rw[kSeg / 4 + 1];  // reset bytes [row & ~3, row + kSeg)
};

template <typename IO>
__device__ __forceinline__ void issue_fwd(FwdTile<IO>& tl, const IO* __restrict__ x,
                                          const float* __restrict__ dt,
                                          const IO* __restrict__ B, const IO* __restrict__ C,
                                          const uint8_t* __restrict__ reset,
                                          const IO* __restrict__ dy, bool with_c, size_t row,
                                          int Dm, int ch0, int live, int n) {
  if (live == kCh)
    issue_rows<kCh>(tl, x, dt, dy, row, Dm, ch0, n);
  else
    issue_rows<kCh / 2>(tl, x, dt, dy, row, Dm, ch0, n);
  constexpr int kV = 16 / sizeof(IO), bp = kN / kV;  // 16-byte pieces of a row of B
  for (int i = threadIdx.x; i < n * bp; i += blockDim.x) {
    const int j = i / bp, p = (i % bp) * kV;
    cp_async16(&tl.B[j][p], B + (row + j) * kN + p);
    if (with_c) cp_async16(&tl.C[j][p], C + (row + j) * kN + p);
  }
  if (reset) {
    const uintptr_t w0 = reinterpret_cast<uintptr_t>(reset + row) & ~uintptr_t(3);
    const int words =
        static_cast<int>((reinterpret_cast<uintptr_t>(reset + row + n - 1) - w0) / 4) + 1;
    if (threadIdx.x < words)
      cp_async4(&tl.rw[threadIdx.x], reinterpret_cast<const void*>(w0 + 4 * threadIdx.x));
  }
}

// y of steps [row, row + n) of the block's live channels, from a tile's dy
// rows, 16 bytes a store.
template <typename IO>
__device__ __forceinline__ void store_y(const FwdTile<IO>& tl, IO* __restrict__ y, size_t row,
                                        int Dm, int ch0, int live, int n) {
  constexpr int kV = 16 / sizeof(IO);
  const int xp = live / kV;
  for (int i = threadIdx.x; i < n * xp; i += blockDim.x) {
    const int j = i / xp, p = (i % xp) * kV;
    *reinterpret_cast<uint4*>(y + (row + j) * Dm + ch0 + p) =
        *reinterpret_cast<const uint4*>(&tl.dy[j][p]);
  }
}

template <typename IO, int kMode>
__global__ void __launch_bounds__(kBThreads)
walk_kernel(const IO* __restrict__ x, const float* __restrict__ dt, const float* __restrict__ A,
            const IO* __restrict__ B, const IO* __restrict__ C, const float* __restrict__ D,
            const float* __restrict__ s0, const uint8_t* __restrict__ reset,
            const IO* __restrict__ dy, float* __restrict__ ck, float* __restrict__ cdt,
            float* __restrict__ hloc, float* __restrict__ gloc, float* __restrict__ P,
            IO* __restrict__ y, float* __restrict__ sf, int T, int Dm, int L) {
  constexpr bool kCk = kMode == kWalkCheckpoints || kMode == kWalkBwdSummaries;
  constexpr bool kG = kMode == kWalkBwdSummaries;
  constexpr bool kSum = kG || kMode == kWalkSummaries;
  constexpr bool kY = kMode == kWalkY;
  const int b = blockIdx.z, c = blockIdx.y, n_chunk = gridDim.y, ch0 = blockIdx.x * kCh;
  const int tid = threadIdx.x, cl = tid / kLanes, k0 = (tid % kLanes) * kPer;
  const int live = min(kCh, Dm - ch0);
  const bool on = cl < live;  // uniform across a warp (live is 32 or 64)
  const int ch = ch0 + (on ? cl : 0);
  const int c0 = c * L, len = min(L, T - c0), n_seg = (len + kSeg - 1) / kSeg;
  // segments whose steps are run: the checkpoint pass needs no state past the last start
  const int n_run = kMode == kWalkCheckpoints ? n_seg - 1 : n_seg;
  const int seg_all = (T + kSeg - 1) / kSeg, seg0 = c0 / kSeg;
  const size_t brow = (size_t)b * T;
  extern __shared__ float4 smem_raw[];
  FwdTile<IO>* tiles = reinterpret_cast<FwdTile<IO>*>(smem_raw);

  float a2[kPer], h[kPer], q[kPer], gl[kPer], cum = 0.f;
  const size_t srow = ((size_t)b * Dm + ch) * kN + k0;
  const size_t crow = (((size_t)b * n_chunk + c) * Dm + ch) * kN + k0;
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    a2[k] = A[(size_t)ch * kN + k0 + k] * kLog2e;
    h[k] = c == 0 ? (s0 ? s0[srow + k] : 0.f) : (kY ? hloc[crow + k] : 0.f);
    q[k] = 1.f;
    gl[k] = 0.f;
  }
  const float d_skip = kY ? D[ch] : 0.f;
  const IO* dy_in = kG ? dy : nullptr;
  auto issue = [&](int s) {  // segment s into its ring slot, one commit group (empty past the end)
    if (s < n_run) {
      const int t0 = c0 + s * kSeg;
      issue_fwd(tiles[s % kRing], x, dt, B, C, reset, dy_in, kG || kY, brow + t0, Dm, ch0, live,
                min(kSeg, c0 + len - t0));
    }
    cp_async_commit();
  };
  for (int s = 0; s < kRing - 1; ++s) issue(s);
  for (int s = 0; s < n_seg; ++s) {
    if (kCk && on) {
      const size_t seg = (size_t)b * seg_all + seg0 + s;
      *reinterpret_cast<float4*>(ck + (seg * Dm + ch) * kN + k0) =
          make_float4(h[0], h[1], h[2], h[3]);
      if (kG && k0 == 0) cdt[seg * Dm + ch] = cum;
    }
    if (s == n_run) break;
    const int t0 = c0 + s * kSeg, n = min(kSeg, c0 + len - t0);
    cp_async_wait<kRing - 2>();
    // segment s has landed for every thread, and every thread is done with segment s - 1
    __syncthreads();
    if (kY && s > 0) store_y(tiles[(s - 1) % kRing], y, brow + t0 - kSeg, Dm, ch0, live, kSeg);
    issue(s + kRing - 1);  // into the slot segment s - 1 used (its y rows are not copied into)
    FwdTile<IO>& tl = tiles[s % kRing];
    const uint8_t* rs = reinterpret_cast<const uint8_t*>(tl.rw) +
                        (reinterpret_cast<uintptr_t>(reset + brow + t0) & 3);
    auto step = [&](int j) {
      const float dtv = tl.dt[j][cl], xv = to_f(tl.x[j][cl]), dtx = dtv * xv;
      float da[kPer];
      decays_ftz(da, a2, dtv, reset && rs[j] ? 0.f : 1.f);
      if (kY) {
        float acc = 0.f;
#pragma unroll
        for (int k = 0; k < kPer; ++k) {
          h[k] = da[k] * h[k] + dtx * to_f(tl.B[j][k0 + k]);
          acc += to_f(tl.C[j][k0 + k]) * h[k];
        }
        acc = lane_group_sum(acc);
        if (k0 == 0) tl.dy[j][cl] = from_f<IO>(acc + d_skip * xv);
      } else if (kG) {
        const float dyv = to_f(tl.dy[j][cl]);
        cum += dtv;
#pragma unroll
        for (int k = 0; k < kPer; ++k) {
          h[k] = da[k] * h[k] + dtx * to_f(tl.B[j][k0 + k]);
          q[k] *= da[k];
          gl[k] += q[k] * (to_f(tl.C[j][k0 + k]) * dyv);
        }
      } else {
#pragma unroll
        for (int k = 0; k < kPer; ++k) {
          h[k] = da[k] * h[k] + dtx * to_f(tl.B[j][k0 + k]);
          if (kSum) q[k] *= da[k];
        }
      }
    };
    if (on) {
      if (n == kSeg) {  // every segment but a ragged last one: constant offsets
#pragma unroll
        for (int j = 0; j < kSeg; ++j) step(j);
      } else {
#pragma unroll 1
        for (int j = 0; j < n; ++j) step(j);
      }
    }
  }
  if (kY) {
    const int s = n_seg - 1, t0 = c0 + s * kSeg;
    __syncthreads();  // the last segment's y rows are complete
    store_y(tiles[s % kRing], y, brow + t0, Dm, ch0, live, c0 + len - t0);
    if (on && c == n_chunk - 1)
      *reinterpret_cast<float4*>(sf + srow) = make_float4(h[0], h[1], h[2], h[3]);
  }
  if (kSum && on) {
    *reinterpret_cast<float4*>(hloc + crow) = make_float4(h[0], h[1], h[2], h[3]);
    *reinterpret_cast<float4*>(P + crow) = make_float4(q[0], q[1], q[2], q[3]);
    if (kG) *reinterpret_cast<float4*>(gloc + crow) = make_float4(gl[0], gl[1], gl[2], gl[3]);
  }
}

// One walk_kernel launch (its dynamic shared memory allowed once a process
// and instantiation, before the first launch); cudaGetLastError() after it.
template <typename IO, int kMode>
int launch_walk(dim3 grid, cudaStream_t st, const IO* x, const float* dt, const float* A,
                const IO* B, const IO* C, const float* D, const float* s0,
                const uint8_t* reset, const IO* dy, float* ck, float* cdt, float* hloc,
                float* gloc, float* P, IO* y, float* sf, int T, int Dm, int L) {
  constexpr int smem = static_cast<int>(kRing * sizeof(FwdTile<IO>));
  static const int set = static_cast<int>(cudaFuncSetAttribute(
      walk_kernel<IO, kMode>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem));
  if (set) return set;
  walk_kernel<IO, kMode><<<grid, kBThreads, smem, st>>>(x, dt, A, B, C, D, s0, reset, dy, ck,
                                                       cdt, hloc, gloc, P, y, sf, T, Dm, L);
  return static_cast<int>(cudaGetLastError());
}

// ---- the carry across chunks, in place: hloc[c] becomes H_c, the state at
// chunk c's start (c >= 1; chunk 0's summary started from s0, so H_1 =
// hloc[0]); with kCotangent gloc[c] becomes G_c, the state cotangent at
// chunk c's end (dsf, or zeros, for the last chunk). One thread a (b, d, n)
// value, serial over chunks only; the loads of kU chunks go out before
// their arithmetic.
template <bool kCotangent>
__global__ void carry_kernel(float* __restrict__ hloc, float* __restrict__ gloc,
                             const float* __restrict__ P, const float* __restrict__ dsf,
                             int n_chunk, int per_b, size_t count) {
  constexpr int kU = 8;
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= count) return;
  const size_t b = i / per_b, base = b * n_chunk * per_b + i % per_b;
  float* hl = hloc + base;
  const float* p = P + base;
  float h = hl[0];
  for (int c0 = 1; c0 < n_chunk; c0 += kU) {
    float hv[kU], pv[kU];
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      if (c0 + u < n_chunk) {
        hv[u] = hl[(size_t)(c0 + u) * per_b];
        pv[u] = p[(size_t)(c0 + u) * per_b];
      }
    }
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      if (c0 + u < n_chunk) {
        hl[(size_t)(c0 + u) * per_b] = h;
        h = pv[u] * h + hv[u];
      }
    }
  }
  if constexpr (kCotangent) {
    float* gl = gloc + base;
    float g = dsf ? dsf[i] : 0.f;
    for (int c0 = n_chunk - 1; c0 >= 0; c0 -= kU) {
      float gv[kU], pv[kU];
#pragma unroll
      for (int u = 0; u < kU; ++u) {
        if (c0 - u >= 0) {
          gv[u] = gl[(size_t)(c0 - u) * per_b];
          pv[u] = p[(size_t)(c0 - u) * per_b];
        }
      }
#pragma unroll
      for (int u = 0; u < kU; ++u) {
        if (c0 - u >= 0) {
          gl[(size_t)(c0 - u) * per_b] = g;
          g = pv[u] * g + gv[u];
        }
      }
    }
  }
}

// carry_kernel over batch * Dm * kN values; cudaGetLastError() after it.
template <bool kCotangent>
int launch_carry(float* hloc, float* gloc, const float* P, const float* dsf, int batch,
                 int n_chunk, int Dm, cudaStream_t st) {
  const size_t count = (size_t)batch * Dm * kN;
  carry_kernel<kCotangent><<<static_cast<unsigned>((count + 255) / 256), 256, 0, st>>>(
      hloc, gloc, P, dsf, n_chunk, Dm * kN, count);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace mamba

#define MAMBA_DISPATCH_IO(IO_CODE, ...)                          \
  if ((IO_CODE) == mamba::kF32) {                                \
    using IO = float; __VA_ARGS__;                               \
  } else if ((IO_CODE) == mamba::kBF16) {                        \
    using IO = __nv_bfloat16; __VA_ARGS__;                       \
  } else {                                                       \
    return -2;                                                   \
  }
