// A SwiGLU FFN over int8 weights whose hidden activation never reaches device
// memory: y = (silu(g) * h) @ dequant(W_out)^T + b_out with g, h = split(x @
// dequant(W_in)^T + b_in), gate first.
//
// Replaces the TPU kernel fused_ffn_int8 (lina_speech_tpu/ops/qlinear.py:241,
// body _ffn_kernel :156), with its rounding points (:167-181, :235-238):
//
//   g = (sum_k bf16(x_k) Wg[j, k]) * sg[j] + bg[j]      f32, bias joined in f32
//   h = (sum_k bf16(x_k) Wh[j, k]) * sh[j] + bh[j]      f32
//   gb = bf16(g);  u[j] = bf16(bf16(gb / (1 + e^{-gb})) * bf16(h))   (silu in f32)
//   y[n] = (sum_j u[j] W_out[n, j]) * s_out[n] + b_out[n]            f32 sum
//
// (The unfused route rounds g to bf16 before it adds the bias, so the two
// routes differ in the last bit; a SwiGLU takes this one whenever both of its
// weights are int8 and the mode is weight only.)
//
// What bounds it on the H100: the latency of streaming 4.2 MB of int8 weight
// (W_in 2.80 MB, W_out 1.40 MB at d 1024, hidden 1365) and of one launch.
// At m <= 128 the 6 m d H products are 1.1 GFLOP, about 2 us at half the
// bf16 tensor-core peak, so mma.sync's rate is enough.
//
// Design. A thread block cluster of 8 blocks owns a chunk of 64 hidden units
// for an m-tile of 8 or 16 rows (ops/qlinear.py:fused_ffn_plan; 22 chunks at
// hidden 1365: 176 blocks for each m-tile):
//   phase 1: each rank takes a slice of d (128 columns at d 1024) and forms
//     its part of the 64 gate and 64 value rows of x W_in^T transposed, on the
//     tensor cores (mma.sync m16n8k16, the int8 rows as A converted to bf16
//     pairs, the rows of x as the n8 side; int8_common.cuh). The rank then
//     finishes 8 of the 64 units: it adds the 8 ranks' parts in rank order
//     through distributed shared memory, then scale, bias, silu and the
//     product with the rounding chain above, and keeps u (m x 8, bf16).
//     Every rank then gathers all 64 units' u from the cluster.
//   phase 2: each rank takes a slice of the output channels (128 at d 1024)
//     and forms out^T (channels x m) = W_out[:, units] . u^T, A read from
//     W_out as the Linear holds it, (d, Hp) with the hidden axis contiguous.
//     Its tile is copied into shared memory at block start (cp.async), since
//     it does not depend on u, and lands while phase 1 runs.
//   The chunk's part of the output (m x 128 f32 a rank) goes to scratch;
//   the last of the chunks to finish a (m-tile, channel slice), known from a
//   ticket counter after a memory fence, adds the parts in chunk order and
//   applies scale and bias, and resets its counter. One launch per call, no
//   float atomics: two calls give equal bits. The parts cost 22 m d 4 bytes
//   each way, under the weights' 4.2 MB up to m 46. That last block's sums
//   are the kernel's serial tail, which grows with the m-tile: a tile of 16
//   rows spreads them over more blocks than one of 64, which in trials at
//   m64 took twice as long. The biases are read as f32 or bf16, as the
//   caller holds them. The last chunk is ragged (1365 = 21 * 64 + 21): its
//   missing units read zeros and give u = 0.
#include <cooperative_groups.h>

#include <type_traits>

#include "int8_common.cuh"

namespace cg = cooperative_groups;

namespace {

using namespace q8;

constexpr int kRanks = 8;   // blocks of a cluster
constexpr int kU = 64;      // hidden units a chunk
constexpr int kRows = 2 * kU;  // gate and value rows of W_in a chunk
constexpr int kUnitsPerRank = kU / kRanks;
constexpr int kDMax = 2048;    // widest model the shared memory holds
constexpr int kWoS = kU + 16;  // W_out tile row stride, bytes
constexpr int kUS = kU + 16;   // u row stride, bf16 elements

__host__ __device__ constexpr int round_up(int a, int b) { return (a + b - 1) / b * b; }

// d columns of a rank in phase 1, and output channels of a rank in phase 2
__host__ __device__ constexpr int slice(int D) { return round_up((D + kRanks - 1) / kRanks, 64); }

struct Smem {
  int w_in, x, part, w_out, u_loc, u_all, flag, total;
};

// byte offsets in dynamic shared memory; phase 1's W_in and x tiles share
// their region with phase 1's parts and then with the tail's buffer
__host__ __device__ constexpr Smem smem_layout(int D, int MT) {
  const int sl = slice(D);
  const int tiles = kRows * (sl + 16) + MT * (sl + 16) * 2;
  const int parts = kRows * MT * 4;
  const int w_out = round_up(tiles > parts ? tiles : parts, 16);
  const int u_loc = w_out + round_up(sl * kWoS, 16);
  const int u_all = u_loc + MT * kUnitsPerRank * 2;
  const int flag = u_all + round_up(MT * kUS * 2, 16);
  return Smem{0, kRows * (sl + 16), 0, w_out, u_loc, u_all, flag, flag + 16};
}

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// element i of a bias held as f32 or as bf16 (B_BF16), as the caller has it
template <bool B_BF16>
__device__ __forceinline__ float bias_at(const void* b, int i) {
  if constexpr (B_BF16)
    return __bfloat162float(static_cast<const __nv_bfloat16*>(b)[i]);
  else
    return static_cast<const float*>(b)[i];
}

template <typename X, typename O, int NT, bool ASYNC_X, bool B_BF16>
__global__ void __launch_bounds__(kThreads)
ffn_int8_kernel(const X* __restrict__ x, const signed char* __restrict__ q_in,
                const float* __restrict__ s_in, const void* __restrict__ b_in,
                const signed char* __restrict__ q_out, const float* __restrict__ s_out,
                const void* __restrict__ b_out, float* __restrict__ parts,
                int* __restrict__ tickets, O* __restrict__ out, int M, int D, int Hd, int Hp) {
  constexpr int MT = NT * 8;
  extern __shared__ __align__(16) unsigned char smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int chunk = blockIdx.y, n_chunks = gridDim.y;
  const int j0 = chunk * kU, m0 = blockIdx.z * MT;
  const int sl = slice(D), ws = sl + 16, xs = sl + 16;
  const Smem lay = smem_layout(D, MT);
  signed char* s_win = reinterpret_cast<signed char*>(smem + lay.w_in);
  uint16_t* s_x = reinterpret_cast<uint16_t*>(smem + lay.x);
  float* s_part = reinterpret_cast<float*>(smem + lay.part);
  signed char* s_wout = reinterpret_cast<signed char*>(smem + lay.w_out);
  uint16_t* s_uloc = reinterpret_cast<uint16_t*>(smem + lay.u_loc);
  uint16_t* s_uall = reinterpret_cast<uint16_t*>(smem + lay.u_all);
  int* s_flag = reinterpret_cast<int*>(smem + lay.flag);

  // ---- copies: W_in rows and x columns of this rank's d slice (group 0),
  // then this rank's W_out tile (group 1), all in flight together
  const int k0 = rank * sl;
  for (int idx = tid; idx < kRows * (sl / 16); idx += kThreads) {
    const int r = idx / (sl / 16), c = (idx % (sl / 16)) * 16;
    const int j = j0 + (r % kU), k = k0 + c;
    const bool ok = j < Hd && k < D;
    const size_t row = r < kU ? j : (size_t)Hd + j;
    cp_async16(s_win + r * ws + c, ok ? q_in + row * D + k : q_in, ok);
  }
  if constexpr (ASYNC_X) {
    for (int idx = tid; idx < MT * (sl / 8); idx += kThreads) {
      const int r = idx / (sl / 8), c = (idx % (sl / 8)) * 8;
      const int m = m0 + r, k = k0 + c;
      const bool ok = m < M && k < D;
      cp_async16(s_x + r * xs + c, ok ? x + (size_t)m * D + k : x, ok);
    }
  } else {
#pragma unroll 8
    for (int idx = tid; idx < MT * sl; idx += kThreads) {
      const int r = idx / sl, c = idx % sl;
      const int m = m0 + r, k = k0 + c;
      s_x[r * xs + c] = bf16_bits((m < M && k < D) ? to_f(x[(size_t)m * D + k]) : 0.f);
    }
  }
  cp_async_commit();
  const int c0 = rank * sl;  // this rank's first output channel
  for (int idx = tid; idx < sl * (kU / 16); idx += kThreads) {
    const int r = idx / (kU / 16), c = (idx % (kU / 16)) * 16;
    const int n = c0 + r, j = j0 + c;
    const bool ok = n < D && j < Hp;
    cp_async16(s_wout + r * kWoS + c, ok ? q_out + (size_t)n * Hp + j : q_out, ok);
  }
  cp_async_commit();
  cp_async_wait<1>();
  __syncthreads();

  // ---- phase 1: warp w forms the gate rows 16w .. 16w+15 and the value rows
  // of the same units over this rank's d slice
  {
    float ag[NT][4], ah[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) ag[j][e] = ah[j][e] = 0.f;
    const signed char* wg = s_win + warp * 16 * ws;
    const signed char* wh = s_win + (kU + warp * 16) * ws;
    for (int kk = 0; kk < sl; kk += 16) {
      uint32_t a_g[4], a_h[4];
      a_frag_bf16(wg, ws, kk, lane, a_g);
      a_frag_bf16(wh, ws, kk, lane, a_h);
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const uint2 b = b_frag_bf16(s_x + j * 8 * xs, xs, kk, lane);
        mma_bf16(ag[j], a_g, b.x, b.y);
        mma_bf16(ah[j], a_h, b.x, b.y);
      }
    }
    __syncthreads();  // the tiles' region now takes the parts: part[row][m]
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const int m = j * 8 + 2 * t;
      const int rg = warp * 16 + g, rh = kU + warp * 16 + g;
      s_part[rg * MT + m] = ag[j][0];
      s_part[rg * MT + m + 1] = ag[j][1];
      s_part[(rg + 8) * MT + m] = ag[j][2];
      s_part[(rg + 8) * MT + m + 1] = ag[j][3];
      s_part[rh * MT + m] = ah[j][0];
      s_part[rh * MT + m + 1] = ah[j][1];
      s_part[(rh + 8) * MT + m] = ah[j][2];
      s_part[(rh + 8) * MT + m + 1] = ah[j][3];
    }
  }
  cluster.sync();  // every rank's parts are written and visible across the cluster

  // ---- this rank's 8 units, four rows at a time: the ranks' parts added in
  // rank order (all sixteen loads from the cluster issued first), then the
  // epilogue's rounding chain; u_loc[m][unit]
  for (int e = tid; e < kUnitsPerRank * (MT / 4); e += kThreads) {
    const int jj = e / (MT / 4), m = (e % (MT / 4)) * 4;
    const int uu = rank * kUnitsPerRank + jj, j = j0 + uu;
    float4 pg[kRanks], ph[kRanks];
#pragma unroll
    for (int c = 0; c < kRanks; ++c) {
      const float* rp = cluster.map_shared_rank(s_part, c);
      pg[c] = *reinterpret_cast<const float4*>(rp + uu * MT + m);
      ph[c] = *reinterpret_cast<const float4*>(rp + (kU + uu) * MT + m);
    }
    float sg[4] = {0.f, 0.f, 0.f, 0.f}, sh[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int c = 0; c < kRanks; ++c) {
      sg[0] += pg[c].x; sg[1] += pg[c].y; sg[2] += pg[c].z; sg[3] += pg[c].w;
      sh[0] += ph[c].x; sh[1] += ph[c].y; sh[2] += ph[c].z; sh[3] += ph[c].w;
    }
#pragma unroll
    for (int l = 0; l < 4; ++l) {
      float u = 0.f;
      if (j < Hd) {
        // scale, then bias, each rounded on its own (no fused multiply-add)
        float gf = __fmul_rn(sg[l], s_in[j]), hf = __fmul_rn(sh[l], s_in[Hd + j]);
        if (b_in != nullptr) {
          gf = __fadd_rn(gf, bias_at<B_BF16>(b_in, j));
          hf = __fadd_rn(hf, bias_at<B_BF16>(b_in, Hd + j));
        }
        const float gb = round_bf16(gf);
        const float act = round_bf16(gb * (1.f / (1.f + expf(-gb))));
        u = round_bf16(act * round_bf16(hf));
      }
      s_uloc[(m + l) * kUnitsPerRank + jj] = bf16_bits(u);
    }
  }
  cluster.sync();
  // every rank's 8 units, one 16-byte piece a (rank, row): u_all[m][unit]
#pragma unroll 4
  for (int idx = tid; idx < MT * kRanks; idx += kThreads) {
    const int m = idx / kRanks, c = idx % kRanks;
    const uint16_t* src = cluster.map_shared_rank(s_uloc, c) + m * kUnitsPerRank;
    *reinterpret_cast<uint4*>(s_uall + m * kUS + c * kUnitsPerRank) =
        *reinterpret_cast<const uint4*>(src);
  }
  cluster_arrive();  // done with the other blocks' memory (waited on before leaving)
  cp_async_wait<0>();
  __syncthreads();  // u_all and the W_out tile are in

  // ---- phase 2: warp w takes the rank's 16-channel tiles w, w + 4, ...;
  // the chunk's part goes to parts[chunk][m][channel]
  for (int tile = warp; tile < sl / 16; tile += kWarps) {
    const int cb = c0 + tile * 16;
    if (cb >= D) break;  // D is a multiple of 16: a tile is inside or outside
    float acc[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < kU; kk += 16) {
      uint32_t a[4];
      a_frag_bf16(s_wout + tile * 16 * kWoS, kWoS, kk, lane, a);
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const uint2 b = b_frag_bf16(s_uall + j * 8 * kUS, kUS, kk, lane);
        mma_bf16(acc[j], a, b.x, b.y);
      }
    }
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const int m = m0 + j * 8 + 2 * t, n = cb + g;
      float* p = parts + ((size_t)chunk * M + m) * D + n;
      if (m < M) {
        p[0] = acc[j][0];
        p[8] = acc[j][2];
      }
      if (m + 1 < M) {
        p[D] = acc[j][1];
        p[D + 8] = acc[j][3];
      }
    }
  }

  // ---- the last chunk of this (m-tile, channel slice) adds the parts
  __threadfence();
  __syncthreads();
  int* ticket = tickets + blockIdx.z * kRanks + rank;
  if (tid == 0) *s_flag = atomicAdd(ticket, 1) == n_chunks - 1;
  __syncthreads();
  if (!*s_flag) {
    cluster_wait();
    return;
  }
  __threadfence();
  // Outputs of four columns, each summed in chunk order. When all of them
  // fit (a few rows), every (chunk, output) pair is copied at once into
  // shared memory (phase 1's region, free now; cp.async reads through L2,
  // where the parts are). Else two outputs a thread at a time, sixteen loads
  // in flight for every eight chunks.
  const int rows = min(MT, M - m0), quads = max(0, min(sl, D - c0)) / 4;
  const int total = rows * quads;
  auto finish = [&](int q, float4 tot) {
    const int m = m0 + q / quads, n = c0 + (q % quads) * 4;
    const float tv[4] = {tot.x, tot.y, tot.z, tot.w};
#pragma unroll
    for (int l = 0; l < 4; ++l) {
      float y = __fmul_rn(tv[l], s_out[n + l]);
      if (b_out != nullptr) y = __fadd_rn(y, bias_at<B_BF16>(b_out, n + l));
      out[(size_t)m * D + n + l] = from_f<O>(y);
    }
  };
  auto part_at = [&](int c, int q) {
    return parts + ((size_t)c * M + m0 + q / quads) * D + c0 + (q % quads) * 4;
  };
  if (total * n_chunks * 16 <= lay.w_out) {
    float4* buf = reinterpret_cast<float4*>(smem);
    for (int idx = tid; idx < total * n_chunks; idx += kThreads)
      cp_async16(buf + idx, part_at(idx / total, idx % total), true);
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
    for (int q = tid; q < total; q += kThreads) {
      float4 tot = buf[q];
      for (int c = 1; c < n_chunks; ++c) {
        const float4 v = buf[c * total + q];
        tot.x += v.x;
        tot.y += v.y;
        tot.z += v.z;
        tot.w += v.w;
      }
      finish(q, tot);
    }
  } else {
    for (int q = tid; q < total; q += 2 * kThreads) {
      const bool two = q + kThreads < total;
      float4 t0 = make_float4(0.f, 0.f, 0.f, 0.f), t1 = t0;
#pragma unroll 8
      for (int c = 0; c < n_chunks; ++c) {
        const float4 v0 = __ldcg(reinterpret_cast<const float4*>(part_at(c, q)));
        const float4 v1 =
            two ? __ldcg(reinterpret_cast<const float4*>(part_at(c, q + kThreads))) : t1;
        t0.x += v0.x;
        t0.y += v0.y;
        t0.z += v0.z;
        t0.w += v0.w;
        if (two) {
          t1.x += v1.x;
          t1.y += v1.y;
          t1.z += v1.z;
          t1.w += v1.w;
        }
      }
      finish(q, t0);
      if (two) finish(q + kThreads, t1);
    }
  }
  if (tid == 0) *ticket = 0;  // ready for the next call on this stream
  cluster_wait();
}

template <typename X, typename O, int NT, bool ASYNC_X, bool B_BF16>
int launch(const void* x, const void* q_in, const void* s_in, const void* b_in,
           const void* q_out, const void* s_out, const void* b_out, void* parts, void* tickets,
           void* out, int M, int D, int Hd, int Hp, cudaStream_t stream) {
  auto kernel = ffn_int8_kernel<X, O, NT, ASYNC_X, B_BF16>;
  const int smem = smem_layout(D, NT * 8).total;
  static int sized = 0;  // the largest size the attribute was set for
  if (smem > sized) {
    const cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    sized = smem;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(kRanks, (Hd + kU - 1) / kU, (M + NT * 8 - 1) / (NT * 8));
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = kRanks;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t e = cudaLaunchKernelEx(
      &cfg, kernel, static_cast<const X*>(x), static_cast<const signed char*>(q_in),
      static_cast<const float*>(s_in), b_in, static_cast<const signed char*>(q_out),
      static_cast<const float*>(s_out), b_out, static_cast<float*>(parts), static_cast<int*>(tickets),
      static_cast<O*>(out), M, D, Hd, Hp);
  return e != cudaSuccess ? static_cast<int>(e) : static_cast<int>(cudaGetLastError());
}

template <typename X, typename O, bool B_BF16>
int launch_mt(int mt, const void* x, const void* q_in, const void* s_in, const void* b_in,
              const void* q_out, const void* s_out, const void* b_out, void* parts,
              void* tickets, void* out, int M, int D, int Hd, int Hp, cudaStream_t st) {
  // bf16 x is copied into shared memory as it is, f32 x converted on the way
  constexpr bool kAsync = std::is_same_v<X, __nv_bfloat16>;
#define FFN_LAUNCH(NT)                                                                \
  return launch<X, O, NT, kAsync, B_BF16>(x, q_in, s_in, b_in, q_out, s_out, b_out, parts, \
                                          tickets, out, M, D, Hd, Hp, st)
  switch (mt) {
    case 8: FFN_LAUNCH(1);
    case 16: FFN_LAUNCH(2);
    default: return -5;
  }
#undef FFN_LAUNCH
}

template <typename X, typename O>
int dispatch_bias(int b_dtype, int mt, const void* x, const void* q_in, const void* s_in,
                  const void* b_in, const void* q_out, const void* s_out, const void* b_out,
                  void* parts, void* tickets, void* out, int M, int D, int Hd, int Hp,
                  cudaStream_t st) {
  if (b_dtype == 1)
    return launch_mt<X, O, true>(mt, x, q_in, s_in, b_in, q_out, s_out, b_out, parts, tickets,
                                 out, M, D, Hd, Hp, st);
  return launch_mt<X, O, false>(mt, x, q_in, s_in, b_in, q_out, s_out, b_out, parts, tickets,
                                out, M, D, Hd, Hp, st);
}

}  // namespace

// C entry point (bound with ctypes in ops/qlinear.py). Layouts: x (M, D) in
// the dtype of code x_dtype (0 f32, 1 bf16 on a 16-byte boundary), D a
// multiple of 16 and at most 2048; q_in (2 Hd, D) int8, rows 0..Hd-1 the
// gate; s_in (2 Hd) f32; b_in (2 Hd) or null, and b_out (D) or null, both in
// the dtype of code b_dtype; q_out (D, Hp) int8 as the output Linear holds
// it, Hp the hidden width rounded up to a multiple of 16 with zeros beyond
// Hd; s_out (D) f32; parts: scratch (ceil(Hd / 64), M, D) f32; tickets:
// ceil(M / mt) * 8 int32, zero before the first call and left zero by every
// call; out (M, D) in the dtype of code out_dtype. All contiguous. The plan
// (ops/qlinear.py:fused_ffn_plan): mt the rows of an m-tile (8 or 16).
// Returns cudaGetLastError() after the launch (or the launch's own
// error), -2 for an unsupported dtype code, -3 for an unsupported D or Hp,
// -5 for a bad plan or a misaligned x.
extern "C" int fused_ffn_int8_fwd(const void* x, const void* q_in, const void* s_in,
                                  const void* b_in, const void* q_out, const void* s_out,
                                  const void* b_out, void* parts, void* tickets, void* out,
                                  int M, int D, int Hd, int Hp, int x_dtype, int out_dtype,
                                  int b_dtype, int mt, void* stream) {
  if (D % 16 != 0 || D > kDMax || D < 16) return -3;
  if (Hp % 16 != 0 || Hp < Hd || Hp >= Hd + 16 || Hd < 1) return -3;
  if (M < 1 || (x_dtype == 1 && reinterpret_cast<uintptr_t>(x) % 16 != 0)) return -5;
  if (b_dtype != 0 && b_dtype != 1) return -2;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define FFN_DISPATCH(X, O)                                                                  \
  return dispatch_bias<X, O>(b_dtype, mt, x, q_in, s_in, b_in, q_out, s_out, b_out, parts, \
                             tickets, out, M, D, Hd, Hp, st)
  if (x_dtype == 0 && out_dtype == 0) FFN_DISPATCH(float, float);
  if (x_dtype == 0 && out_dtype == 1) FFN_DISPATCH(float, __nv_bfloat16);
  if (x_dtype == 1 && out_dtype == 0) FFN_DISPATCH(__nv_bfloat16, float);
  if (x_dtype == 1 && out_dtype == 1) FFN_DISPATCH(__nv_bfloat16, __nv_bfloat16);
#undef FFN_DISPATCH
  return -2;
}
