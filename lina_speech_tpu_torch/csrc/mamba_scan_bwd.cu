// Backward of the Mamba (v1) selective scan (mamba_scan.cu): the training
// of every Mamba-1 mixer.
//
// Replaces the TPU kernel _bwd_kernel (lina_speech_tpu/ops/mamba_pallas.py
// :86, reached through mamba_scan_pallas :468, _vjp_bwd :451 and _bwd_impl
// :229 -> pallas_call :241). From dy (b, t, d) and the final-state
// cotangent dsf (b, d, n) it computes dx (IO dtype), ddt (f32), dB and dC
// (in B's and C's dtype, the IO dtype), dA (d, n) and dD (d) summed over
// the batch, and ds0 (b, d, n) f32. The reset flags get no gradient.
//
// The forward, per (batch, channel): h_t = a_t * h_{t-1} + dt_t x_t B_t
// with a_t = exp(dt_t A) keep_t, y_t = C_t . h_t + D x_t. The reverse walk
// of _bwd_kernel (:119-138), with the state cotangent g seeded by dsf:
//
//   dC_t = sum_d h_t dy_t          dD += dy_t x_t
//   g += C_t dy_t                  e = g * h_{t-1} * a_t
//   dA += e dt_t                   u = sum_n g B_t
//   ddt_t = sum_n e A + u x_t      dx_t = u dt_t + D dy_t
//   dB_t = sum_d g dt_t x_t        g = a_t * g          (ds0 = g at the end)
//
// The TPU kernel walks time on a sequential grid axis and reads the block
// -start states its training forward saved. Here blocks run in no order and
// the forward saves nothing (inference and training run one kernel), so the
// recurrence is cut into chunks of L steps (a multiple of the 16-step
// segment; ops/mamba_cuda.py:mamba_scan_bwd_plan picks L) and the chunks
// run in parallel. The recurrence is diagonal, so it splits exactly:
//
// 1. walk_kernel in mode kWalkBwdSummaries (mamba_common.cuh; grid:
//    64-channel group x chunk x batch): each chunk from a zero state (chunk
//    0 from s0) runs its forward once, one exponential a state value, and
//    writes the state at every segment start (ck, local to the chunk) with
//    the chunk's dt sum up to it (cdt), its end state h_loc, its decay
//    product P = prod a_t (0 if a step resets) and, from the same decays,
//    the reverse scan of g from zero at its end in closed form, g_loc =
//    sum_t (prod_{s<=t} a_s) C_t dy_t;
// 2. carry_kernel (mamba_common.cuh; one thread a (b, d, n), serial over
//    chunks only): the state at every chunk's start, H_c = P_{c-1} H_{c-1}
//    + h_loc_{c-1}, and the cotangent at its end, G_c = P_{c+1} G_{c+1} +
//    g_loc_{c+1} from dsf;
// 3. chunk_bwd_kernel (same grid): the segment walk of one chunk, seeded
//    by H_c and G_c: a segment's start state is its local checkpoint plus
//    exp(A cdt) H_c (0 after a reset in the chunk), its 16
//    states are recomputed into shared memory, then walked back with g. dx
//    and ddt go out from the channel's first lane; dB and dC are summed over
//    the warp's 8 channels by a reduce-scatter (7 shuffles for 8 values,
//    each lane keeping one of the 32 (dB or dC, n) sums), over the block's
//    warps in shared memory, and each block writes its group's part; dA and
//    dD accumulate per (b, chunk, d, n) in registers;
// 4. sum_parts adds the dB and dC parts over the channel groups, and those
//    of dA and dD over batch and chunk, in a fixed order: no atomics, so two
//    runs give the same bits.
// With one chunk (L >= t) steps 1-2 shrink to the checkpoint pass from s0
// (walk_kernel in mode kWalkCheckpoints; none for t <= 16) and the body
// walks the whole length.
// Chunks pay where one chunk leaves the card idle (b * d / 64 blocks under
// two an SM): at b8 d2048 one chunk fills it and the plan takes it.
//
// What bounds it on the H100: three exponentials a state value (step 1,
// the recomputation, the reverse step; keeping the decays between the last
// two would take another 64 KB of shared memory a block and halve the
// blocks an SM) and, in the body, about 145 instructions a lane and step (4
// state values; the reduce-scatter and the n-sums take about 40). At b8
// t512 d2048 n16 (bf16 x, B, C, dy; f32 dt) on one chunk that is 403 M
// exponentials (~96 us at the SFU's 16 per clock per SM, 1.98 GHz) and
// ~5.8 G instructions (~174 us at 128 lanes a clock per SM), against ~121
// MB of inputs and outputs (36 us at 3.35 TB/s). Its scratch there is 51.4
// MB (ops/mamba_cuda.py:bwd_scratch_bytes): checkpoints 33.5 MB, the dB and
// dC parts of the 32 channel groups 16.8 MB, dA and dD parts 1.1 MB; the chunked route adds
// cdt and the chunk summaries (2.1 + 3 x 8.4 MB at L64). The body keeps 2
// blocks of 256 threads an SM (128 registers, 101 KB of shared memory).
#include "mamba_common.cuh"

namespace mamba {
namespace bwd {

// One segment of the block's inputs: x, dt and dy of its kCh channels as
// they lie in device memory (copied by cp.async), B and C in f32, keep
// flags (0 at a reset step).
template <typename IO>
struct __align__(16) SegTile {
  IO x[kSeg][kCh];
  float dt[kSeg][kCh];
  IO dy[kSeg][kCh];
  float B[kSeg][kN];
  float C[kSeg][kN];
  float keep[kSeg];
};

// issue_rows for the block's ``live`` channels (64, or 32 in the last group
// when d % 64 == 32), then one commit group.
template <typename Tile, typename IO>
__device__ __forceinline__ void issue_seg(Tile& tl, const IO* __restrict__ x,
                                          const float* __restrict__ dt,
                                          const IO* __restrict__ dy, size_t row, int Dm,
                                          int ch0, int live, int n) {
  if (live == kCh)
    issue_rows<kCh>(tl, x, dt, dy, row, Dm, ch0, n);
  else
    issue_rows<kCh / 2>(tl, x, dt, dy, row, Dm, ch0, n);
  cp_async_commit();
}

// A thread's share of a segment's B, C (one value each) and reset flag,
// loaded into registers as they are and stored into the tile later, so the
// loads' latency overlaps the current segment's work.
template <typename IO>
struct Small {
  IO B, C;
  uint8_t reset;
};

template <typename IO>
__device__ __forceinline__ Small<IO> load_small(const IO* __restrict__ B, const IO* __restrict__ C,
                                                const uint8_t* __restrict__ reset, size_t row,
                                                int n) {
  const int tid = threadIdx.x, j = tid / kN;
  Small<IO> s{};
  if (j < n) {
    s.B = B[(row + j) * kN + tid % kN];
    s.C = C[(row + j) * kN + tid % kN];
  }
  if (reset && tid < n) s.reset = reset[row + tid];
  return s;
}

template <typename IO>
__device__ __forceinline__ void store_small(SegTile<IO>& tl, const Small<IO>& s) {
  const int tid = threadIdx.x;
  tl.B[tid / kN][tid % kN] = to_f(s.B);
  tl.C[tid / kN][tid % kN] = to_f(s.C);
  if (tid < kSeg) tl.keep[tid] = s.reset ? 0.f : 1.f;
}

// Sum over the warp's 8 channels (lane bits 2-4) of this lane's 8 values v:
// three levels, each sending half of what is left to the partner lane.
// Returns the one sum this lane keeps: that of v[kept_index(lane)].
__device__ __forceinline__ float channel_reduce_scatter(const float (&v)[8], int lane) {
  const bool b2 = lane & 4, b3 = lane & 8, b4 = lane & 16;
  float w[4], u[2];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float keep = b2 ? v[i + 4] : v[i], send = b2 ? v[i] : v[i + 4];
    w[i] = keep + __shfl_xor_sync(0xffffffffu, send, 4);
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const float keep = b3 ? w[i + 2] : w[i], send = b3 ? w[i] : w[i + 2];
    u[i] = keep + __shfl_xor_sync(0xffffffffu, send, 8);
  }
  const float keep = b4 ? u[1] : u[0], send = b4 ? u[0] : u[1];
  return keep + __shfl_xor_sync(0xffffffffu, send, 16);
}

__device__ __forceinline__ int kept_index(int lane) {
  return ((lane >> 4) & 1) | ((lane >> 2) & 2) | (lane & 4);
}

// ---- 3. the chunk body: the reverse walk of one chunk's segments from G_c,
// each segment's states recomputed from its checkpoint into shared memory
// (a float4 a thread and step: 64 KB a block, which keeps the registers
// under 128 a thread for two blocks an SM). ck null: zero checkpoints (one segment,
// no s0); Hs null: one chunk (no correction); Gs (batch, chunks, Dm, kN) or
// null for zeros. Parts: dBp, dCp (groups, batch, T, kN); dAp (batch,
// chunks, Dm, kN); dDp (batch, chunks, Dm).
template <typename IO>
struct BodySmem {
  SegTile<IO> tiles[2];
  float red[kSeg][kBWarps][32];  // per-warp sums of dB and dC, one a lane
  float4 hs[kSeg][kBThreads];    // the segment's states, hs[j] = h_{t0 + j}
  int warp_reset[kBWarps];  // each warp's first reset step in the chunk
};

template <typename IO>
__global__ void __launch_bounds__(kBThreads, 2)
chunk_bwd_kernel(const IO* __restrict__ x, const float* __restrict__ dt,
                 const float* __restrict__ A, const IO* __restrict__ B,
                 const IO* __restrict__ C, const float* __restrict__ D,
                 const uint8_t* __restrict__ reset, const IO* __restrict__ dy,
                 const float* __restrict__ ck, const float* __restrict__ cdt,
                 const float* __restrict__ Hs, const float* __restrict__ Gs,
                 IO* __restrict__ dx, float* __restrict__ ddt, float* __restrict__ dBp,
                 float* __restrict__ dCp, float* __restrict__ dAp, float* __restrict__ dDp,
                 float* __restrict__ ds0, int T, int Dm, int L) {
  const int b = blockIdx.z, batch = gridDim.z, c = blockIdx.y, n_chunk = gridDim.y;
  const int ch0 = blockIdx.x * kCh;
  const int tid = threadIdx.x, cl = tid / kLanes, k0 = (tid % kLanes) * kPer;
  const int lane = tid % 32, warp = tid / 32;
  const int live = min(kCh, Dm - ch0);
  const bool on = cl < live;
  const int ch = ch0 + (on ? cl : 0);
  const int c0 = c * L, len = min(L, T - c0), n_seg = (len + kSeg - 1) / kSeg;
  const int seg_all = (T + kSeg - 1) / kSeg, seg0 = c0 / kSeg;
  const size_t brow = (size_t)b * T;
  extern __shared__ float4 smem_raw[];
  BodySmem<IO>& sm = *reinterpret_cast<BodySmem<IO>*>(smem_raw);
  SegTile<IO>* tiles = sm.tiles;

  float a2[kPer], af[kPer], g[kPer], hc[kPer];
  const size_t srow = ((size_t)b * Dm + ch) * kN + k0;
  const size_t crow = (((size_t)b * n_chunk + c) * Dm + ch) * kN + k0;
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    af[k] = A[(size_t)ch * kN + k0 + k];
    a2[k] = af[k] * kLog2e;
    g[k] = Gs ? Gs[crow + k] : 0.f;
    hc[k] = Hs && c > 0 ? Hs[crow + k] : 0.f;
  }
  const float d_skip = D[ch];
  // the chunk's first reset step (its end if none), a min over the block
  // (each thread's first hit, then the warps', then the block's): a
  // checkpoint at or before it carries exp(A cdt) H_c, one after it nothing
  // of H_c
  int first_reset = c0 + len;
  if (Hs && c > 0 && reset) {
    for (int i = tid; i < len; i += kBThreads)
      if (reset[brow + c0 + i]) {
        first_reset = c0 + i;
        break;
      }
  }
  first_reset = __reduce_min_sync(0xffffffffu, first_reset);
  if (lane == 0) sm.warp_reset[warp] = first_reset;
  __syncthreads();
#pragma unroll
  for (int w = 0; w < kBWarps; ++w) first_reset = min(first_reset, sm.warp_reset[w]);
  {
    const int s = n_seg - 1, t0 = c0 + s * kSeg;
    issue_seg(tiles[s & 1], x, dt, dy, brow + t0, Dm, ch0, live, c0 + len - t0);
    store_small(tiles[s & 1], load_small(B, C, reset, brow + t0, c0 + len - t0));
  }

  float dA_acc[kPer] = {0.f, 0.f, 0.f, 0.f};
  float dD_acc = 0.f;
  for (int s = n_seg - 1; s >= 0; --s) {
    const int t0 = c0 + s * kSeg, n = min(kSeg, c0 + len - t0);
    const size_t seg = (size_t)b * seg_all + seg0 + s;
    float hck[kPer], cd = 0.f;
#pragma unroll
    for (int k = 0; k < kPer; ++k) hck[k] = ck ? ck[(seg * Dm + ch) * kN + k0 + k] : 0.f;
    if (Hs) cd = cdt[seg * Dm + ch];
    Small<IO> nxt;
    if (s > 0) {
      issue_seg(tiles[(s - 1) & 1], x, dt, dy, brow + t0 - kSeg, Dm, ch0, live, kSeg);
      nxt = load_small(B, C, reset, brow + t0 - kSeg, kSeg);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const SegTile<IO>& tl = tiles[s & 1];
    if (on) {
      if (Hs && c > 0 && first_reset >= t0) {
#pragma unroll
        for (int k = 0; k < kPer; ++k) hck[k] += exp2f(a2[k] * cd) * hc[k];
      }
      const float h0[kPer] = {hck[0], hck[1], hck[2], hck[3]};  // h_{t0 - 1}
      float4* hs = &sm.hs[0][tid];  // hs[j * kBThreads] = h_{t0 + j}
      auto recompute = [&](int j) {
        const float dtv = tl.dt[j][cl], dtx = dtv * to_f(tl.x[j][cl]);
        float da[kPer];
        decays_ftz(da, a2, dtv, tl.keep[j]);
#pragma unroll
        for (int k = 0; k < kPer; ++k) hck[k] = da[k] * hck[k] + dtx * tl.B[j][k0 + k];
        hs[j * kBThreads] = make_float4(hck[0], hck[1], hck[2], hck[3]);
      };
      // the reverse step at t0 + j, with h_{t0 + j} in hcur (then h_{t0 + j - 1})
      float hcur[kPer];
      float* ddt_seg = ddt + (brow + t0) * Dm + ch;
      IO* dx_seg = dx + (brow + t0) * Dm + ch;
      auto reverse = [&](int j) {
        float hp[kPer];
        if (j > 0) {
          const float4 p4 = hs[(j - 1) * kBThreads];
          hp[0] = p4.x, hp[1] = p4.y, hp[2] = p4.z, hp[3] = p4.w;
        } else {
#pragma unroll
          for (int k = 0; k < kPer; ++k) hp[k] = h0[k];
        }
        const float dyv = to_f(tl.dy[j][cl]), xv = to_f(tl.x[j][cl]), dtv = tl.dt[j][cl];
        const float dtx = dtv * xv;
        float da[kPer], v[8];  // v: this lane's dB terms (0-3) and dC terms (4-7)
        decays_ftz(da, a2, dtv, tl.keep[j]);
        dD_acc += dyv * xv;
        float e_sum = 0.f, u = 0.f;
#pragma unroll
        for (int k = 0; k < kPer; ++k) {
          v[4 + k] = hcur[k] * dyv;
          g[k] += tl.C[j][k0 + k] * dyv;
          const float e = g[k] * hp[k] * da[k];
          dA_acc[k] += e * dtv;
          e_sum += e * af[k];
          u += g[k] * tl.B[j][k0 + k];
          v[k] = g[k] * dtx;
          g[k] *= da[k];
          hcur[k] = hp[k];
        }
        e_sum = lane_group_sum(e_sum);
        u = lane_group_sum(u);
        if (k0 == 0) {
          ddt_seg[(size_t)j * Dm] = e_sum + u * xv;
          dx_seg[(size_t)j * Dm] = from_f<IO>(u * dtv + d_skip * dyv);
        }
        sm.red[j][warp][lane] = channel_reduce_scatter(v, lane);
      };
      // n is uniform across the block: the shuffles see every lane
      if (n == kSeg) {  // every segment but a ragged last one: constant offsets
#pragma unroll
        for (int j = 0; j < kSeg; ++j) recompute(j);
#pragma unroll
        for (int k = 0; k < kPer; ++k) hcur[k] = hck[k];
#pragma unroll
        for (int j = kSeg - 1; j >= 0; --j) reverse(j);
      } else {
#pragma unroll 1
        for (int j = 0; j < n; ++j) recompute(j);
#pragma unroll
        for (int k = 0; k < kPer; ++k) hcur[k] = hck[k];
#pragma unroll 1
        for (int j = n - 1; j >= 0; --j) reverse(j);
      }
    }
    if (s > 0) store_small(tiles[(s - 1) & 1], nxt);
    __syncthreads();
    // the block's part of dB and dC for the segment, its live warps in order
    for (int idx = tid; idx < n * 32; idx += kBThreads) {
      const int j = idx / 32, l = idx % 32, vi = kept_index(l);
      float sum = 0.f;
      for (int w = 0; w < live / 8; ++w) sum += sm.red[j][w][l];
      float* part = vi >= kPer ? dCp : dBp;
      part[(((size_t)blockIdx.x * batch + b) * T + t0 + j) * kN + (l % kLanes) * kPer +
           vi % kPer] = sum;
    }
  }
  if (on) {
    *reinterpret_cast<float4*>(dAp + crow) =
        make_float4(dA_acc[0], dA_acc[1], dA_acc[2], dA_acc[3]);
    if (k0 == 0) dDp[((size_t)b * n_chunk + c) * Dm + ch] = dD_acc;
    if (ds0 && c == 0) {
#pragma unroll
      for (int k = 0; k < kPer; ++k) ds0[srow + k] = g[k];
    }
  }
}

// out[i] = sum over p of parts[p * count + i], p in order.
template <typename OUT>
__global__ void sum_parts(const float* __restrict__ parts, OUT* __restrict__ out, int n_parts,
                          size_t count) {
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= count) return;
  float sum = 0.f;
  for (int p = 0; p < n_parts; ++p) sum += parts[(size_t)p * count + i];
  out[i] = from_f<OUT>(sum);
}

template <typename OUT>
int launch_sum(const float* parts, void* out, int n_parts, size_t count, cudaStream_t stream) {
  const int threads = 256;
  const unsigned blocks = static_cast<unsigned>((count + threads - 1) / threads);
  sum_parts<OUT><<<blocks, threads, 0, stream>>>(parts, static_cast<OUT*>(out), n_parts,
                                                 count);
  return static_cast<int>(cudaGetLastError());
}

template <typename IO>
int launch_bwd(const void* x_, const void* dt_, const void* A_, const void* B_, const void* C_,
               const void* D_, const void* s0_, const void* reset_, const void* dy_,
               const void* dsf_, void* dx, void* ddt, void* dB, void* dC, void* dA, void* dD,
               void* ds0, void* ck_, void* cdt_, void* hloc_, void* gloc_, void* P_, void* dBp_,
               void* dCp_, void* dAp_, void* dDp_, int batch, int T, int Dm, int L,
               cudaStream_t st) {
  const IO *x = static_cast<const IO*>(x_), *B = static_cast<const IO*>(B_),
           *C = static_cast<const IO*>(C_), *dy = static_cast<const IO*>(dy_);
  const float *dt = static_cast<const float*>(dt_), *A = static_cast<const float*>(A_),
              *D = static_cast<const float*>(D_), *s0 = static_cast<const float*>(s0_),
              *dsf = static_cast<const float*>(dsf_);
  const uint8_t* reset = static_cast<const uint8_t*>(reset_);
  float *ck = static_cast<float*>(ck_), *cdt = static_cast<float*>(cdt_),
        *hloc = static_cast<float*>(hloc_), *gloc = static_cast<float*>(gloc_),
        *P = static_cast<float*>(P_), *dBp = static_cast<float*>(dBp_),
        *dCp = static_cast<float*>(dCp_), *dAp = static_cast<float*>(dAp_),
        *dDp = static_cast<float*>(dDp_);
  const int n_chunk = (T + L - 1) / L, n_seg = (T + kSeg - 1) / kSeg;
  const int n_grp = (Dm + kCh - 1) / kCh;
  const dim3 grid(n_grp, n_chunk, batch);
  const float *Hs = nullptr, *Gs = dsf, *ckr = ck;
  int err = 0;
  if (n_chunk > 1) {
    if ((err = launch_walk<IO, kWalkBwdSummaries>(grid, st, x, dt, A, B, C, nullptr, s0, reset, dy,
                                                  ck, cdt, hloc, gloc, P, nullptr, nullptr, T,
                                                  Dm, L)))
      return err;
    if ((err = launch_carry<true>(hloc, gloc, P, dsf, batch, n_chunk, Dm, st))) return err;
    Hs = hloc;
    Gs = gloc;
  } else if (n_seg > 1) {
    if ((err = launch_walk<IO, kWalkCheckpoints>(grid, st, x, dt, A, B, C, nullptr, s0, reset,
                                                 nullptr, ck, nullptr, nullptr, nullptr, nullptr,
                                                 nullptr, nullptr, T, Dm, L)))
      return err;
  } else {
    ckr = s0;  // one segment: its checkpoint is s0
  }
  const int smem = static_cast<int>(sizeof(BodySmem<IO>));
  static bool smem_set = false;  // once a process and IO type, before the first launch
  if (!smem_set) {
    err = static_cast<int>(cudaFuncSetAttribute(
        chunk_bwd_kernel<IO>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem));
    if (err) return err;
    smem_set = true;
  }
  chunk_bwd_kernel<IO><<<grid, kBThreads, smem, st>>>(x, dt, A, B, C, D, reset, dy, ckr, cdt, Hs,
                                                   Gs, static_cast<IO*>(dx),
                                                   static_cast<float*>(ddt), dBp, dCp, dAp,
                                                   dDp, static_cast<float*>(ds0), T, Dm, L);
  if ((err = static_cast<int>(cudaGetLastError()))) return err;
  const size_t btn = (size_t)batch * T * kN;
  if ((err = launch_sum<IO>(dBp, dB, n_grp, btn, st))) return err;
  if ((err = launch_sum<IO>(dCp, dC, n_grp, btn, st))) return err;
  if ((err = launch_sum<float>(dAp, dA, batch * n_chunk, (size_t)Dm * kN, st))) return err;
  return launch_sum<float>(dDp, dD, batch * n_chunk, (size_t)Dm, st);
}

}  // namespace bwd
}  // namespace mamba

// C entry point (bound with ctypes in ops/mamba_cuda.py). Inputs as
// mamba_scan_fwd, plus dy (batch, T, Dm) in the IO dtype and dsf (batch,
// Dm, N) f32 or null (zeros); x, dt and dy 16-byte aligned. Outputs: dx
// (batch, T, Dm) in the IO dtype; ddt (batch, T, Dm) f32; dB, dC (batch,
// T, N) in the IO dtype; dA (Dm, N) and dD (Dm) f32, summed over the batch;
// ds0 (batch, Dm, N) f32, or null to skip it. L: the chunk length, a
// multiple of 16 (L >= T: one chunk). Scratch, all f32, 16-byte aligned:
// ck (batch, ceil(T/16), Dm, N), unused (may be null) for T <= 16 in one
// chunk; with more than one chunk cdt (batch, ceil(T/16), Dm) and hloc,
// gloc, P (batch, ceil(T/L), Dm, N), else null; dBp, dCp (ceil(Dm/64),
// batch, T, N); dAp (batch, ceil(T/L), Dm, N); dDp (batch, ceil(T/L), Dm).
// All contiguous; T >= 1. Returns the first launch's cudaGetLastError()
// that is not 0, -1 for N != 16, -2 for an unsupported dtype code, -3 for
// Dm % 32 != 0, -4 for an L that is not a positive multiple of 16.
extern "C" int mamba_scan_bwd(const void* x, const void* dt, const void* A, const void* B,
                              const void* C, const void* D, const void* s0,
                              const void* reset, const void* dy, const void* dsf, void* dx,
                              void* ddt, void* dB, void* dC, void* dA, void* dD, void* ds0,
                              void* ck, void* cdt, void* hloc, void* gloc, void* P, void* dBp,
                              void* dCp, void* dAp, void* dDp, int batch, int T, int Dm, int N,
                              int L, int io_dtype, void* stream) {
  if (N != mamba::kN) return -1;
  if (Dm % mamba::kChannels != 0) return -3;
  if (L <= 0 || L % mamba::kSeg != 0) return -4;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  MAMBA_DISPATCH_IO(io_dtype, return mamba::bwd::launch_bwd<IO>(
                                  x, dt, A, B, C, D, s0, reset, dy, dsf, dx, ddt, dB, dC, dA,
                                  dD, ds0, ck, cdt, hloc, gloc, P, dBp, dCp, dAp, dDp, batch,
                                  T, Dm, L, st))
  return -2;
}
