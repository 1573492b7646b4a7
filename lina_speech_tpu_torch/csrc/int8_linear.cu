// y = x @ dequant(q, s)^T with the weight streamed from device memory as int8.
//
// Replaces the TPU kernel int8_linear (lina_speech_tpu/ops/qlinear.py:127;
// bodies _qlin_kernel :54, weight only, and _qlin_kernel_i8 :64, w8a8):
//
//   wonly: y[m, n] = (sum_k bf16(x[m, k]) * q[n, k]) * s[n]        f32 sum
//   w8a8:  sx[m] = max(max_k |x[m, k]|, 1e-12) / 127
//          xq[m, k] = clip(round(x[m, k] / sx[m]), -127, 127)      int8
//          y[m, n] = float(sum_k xq[m, k] * q[n, k]) * sx[m] * s[n]   int32 sum
//
// What bounds it on the H100: the latency of streaming a few MB of int8
// weight and of one launch, not operations. The served paths give it m = 1
// to 128 rows (decode batches, prefill chunks), so each weight byte is used
// at most 128 times: 1024 -> 2048 at m128 is 0.54 GFLOP, about 1 us even at
// half the 989 TFLOP/s bf16 peak, against 0.63 us for its 2.1 MB of weight
// at 3.35 TB/s. mma.sync's rate is therefore enough, and wgmma is not needed.
//
// Two bodies, chosen by the plan from m alone (ops/qlinear.py:
// int8_linear_plan):
//
// m <= 8, the GEMV body: one warp owns one output channel; a lane loads 16
// int8 of its row with one 16-byte load, converts them in registers and
// uses them for every row of the m-tile (1 to 8 rows, staged in shared
// memory as bf16 or int8); fp32 FMAs (wonly) or __dp4a (w8a8) on the CUDA
// cores, sums reduced across the warp with shuffles. Every weight load is in
// flight at once and nothing waits on another block, which is what a few
// rows need: in trials on an H100 it beat the tensor-core body up to m 8.
//
// m > 8, the tensor-core body. The product is taken transposed, y^T (N x m)
// = W (N x Kp) . x^T, so that the weight is the A operand (16 channels a
// fragment) and the rows of x the narrow n8 side (an m-tile of 16 or 32 rows
// is two or four n8 tiles; each A fragment is reused across them). wonly:
// mma.sync m16n8k16 bf16 -> f32; an A register is two neighbouring k of one
// channel, two int8 of the (N, Kp) row, converted to a bf16 pair (int8 is
// exact in bf16, the products exact in f32). w8a8: mma.sync m16n8k32 s8 ->
// s32 on the weight as it is and the quantized rows. A block (4 warps) owns
// 32 or 64 channels and one m-tile. Weight and x tiles come into a ring of 4
// to 8 stages of 64 columns in shared memory by cp.async (16-byte pieces,
// zeros beyond N, Kp, m and K), so the stages are in flight while one is
// multiplied; the row strides are padded (80 or 96 bytes for int8, 160 for
// bf16) so that the eight rows one fragment load touches fall on different
// banks. x that cannot be copied as it is (f32, or a bf16 row that is no
// multiple of 16 bytes) is loaded into registers one stage ahead and
// converted into the ring. To fill the card, K is split across the blocks of
// a thread block cluster (up to 8): every block leaves its sums in shared
// memory, and after the cluster barrier each block adds a share of the
// outputs over the ranks in rank order through distributed shared memory
// (four channels a load, every load in flight before any is added).
//
// What bounds the tensor-core body, read from utils/int8_timeline.py on an
// H100 at m64 1024 -> 2048 (32-row tiles of 64 channels, 8 blocks a
// cluster; medians over the blocks, µs after the first block started): the
// first stage lands at 1.3, the loop is done at 2.8, the first cluster
// barrier passes at 3.6, the sums through distributed shared memory are
// written at 4.9 and the second barrier passes at 5.4 (the latest block at
// 6.4). The latency of the stream and the cluster reduction bound it, not
// the products; at m64 it stays slower than one cuBLAS call on the bf16
// weight. Splitting K over fewer blocks makes each block stream more stages
// in series, which in trials cost more than the smaller reduction saved.
//
// No atomics in either body: two calls give equal bits, and w8a8 is exact up
// to the two scale multiplications, taken in the plain version's order. w8a8
// quantizes the rows of x in a small kernel of its own first (one block a
// row); the call's time counts both launches.
#include <cooperative_groups.h>

#include <type_traits>

#include "int8_common.cuh"

namespace cg = cooperative_groups;

namespace {

using namespace q8;

constexpr int kKT = 64;       // k columns a stage
constexpr int kMaxCluster = 8;

#ifdef Q8_TIMELINE
// Timeline instrumentation, compiled only by utils/int8_timeline.py: thread 0
// of each block notes %globaltimer at six points of the tensor-core body.
constexpr int kTimelineBlocks = 4096, kTimelineStamps = 6;
__device__ unsigned long long q8_timeline[kTimelineBlocks][kTimelineStamps];
__device__ __forceinline__ void q8_stamp(int i) {
  const unsigned b = (blockIdx.z * gridDim.y + blockIdx.y) * gridDim.x + blockIdx.x;
  if (threadIdx.x == 0 && b < kTimelineBlocks) {
    unsigned long long t;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
    q8_timeline[b][i] = t;
  }
}
#define Q8_STAMP(i) q8_stamp(i)
#else
#define Q8_STAMP(i)
#endif

// The tile of a block for an m-tile of NT n8 tiles (MT = 8 NT rows): WC warps
// along the channels with one 16-channel fragment each (BN channels), and
// the rest of the 4 warps along k, each taking every KH-th k step of a
// stage. The 16-row tile keeps blocks narrow (more blocks, a deeper ring);
// the 32-row one widens them, so that the x tile staged for a block serves
// more channels.
template <int NT>
struct Tile {
  static constexpr int MT = NT * 8;
  static constexpr int WC = NT >= 4 ? 4 : 2;
  static constexpr int KH = kWarps / WC;
  static constexpr int BN = WC * 16;
  static constexpr int STAGES = NT <= 2 ? 8 : 4;  // depth of the cp.async ring
};

template <bool W8A8>
struct Layout {
  static constexpr int WS = W8A8 ? kKT + 32 : kKT + 16;  // weight row stride, bytes
  static constexpr int XS = W8A8 ? kKT + 32 : kKT + 16;  // x row stride, elements
  static constexpr int XB = W8A8 ? 1 : 2;                // bytes an x element in the ring
};

template <bool W8A8, int NT>
__host__ __device__ constexpr int stage_bytes() {
  return Tile<NT>::BN * Layout<W8A8>::WS + Tile<NT>::MT * Layout<W8A8>::XS * Layout<W8A8>::XB;
}

template <bool W8A8, int NT>
__host__ __device__ constexpr int smem_bytes() {
  // the ring, reused after the loop for the k groups' sums (KH x MT x (BN + 4))
  using T = Tile<NT>;
  constexpr int ring = T::STAGES * stage_bytes<W8A8, NT>();
  constexpr int red = T::KH * T::MT * (T::BN + 4) * 4;
  return ring > red ? ring : red;
}

// X: the activations as given (float or bf16) in weight-only mode, the
// quantized rows (signed char, (M, Kp)) in w8a8 mode. ASYNC_X: x is copied
// into the ring by cp.async (bf16 rows of whole 16-byte pieces, or the
// quantized rows); else through registers with the conversion to bf16.
template <typename X, typename O, int NT, bool W8A8, bool ASYNC_X>
__global__ void __launch_bounds__(kThreads)
int8_linear_kernel(const X* __restrict__ x, const float* __restrict__ sxs,
                   const signed char* __restrict__ q, const float* __restrict__ s,
                   O* __restrict__ out, int M, int K, int Kp, int N) {
  using L = Layout<W8A8>;
  using T = Tile<NT>;
  using Acc = std::conditional_t<W8A8, int, float>;
  constexpr int MT = T::MT, BN = T::BN, KH = T::KH, S = T::STAGES;
  constexpr int SB = stage_bytes<W8A8, NT>();
  constexpr int kSyncPer = MT * kKT / kThreads;  // x elements a thread stages (sync route)
  extern __shared__ __align__(16) unsigned char smem[];

  cg::cluster_group cluster = cg::this_cluster();
  const int ks = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int cw = warp % T::WC, kh = warp / T::WC;  // the warp's channel group and k group
  const int n0 = blockIdx.y * BN, m0 = blockIdx.z * MT;
  const int n_st = (Kp + kKT - 1) / kKT;
  const int per = (n_st + ks - 1) / ks;
  const int st0 = min(n_st, rank * per);
  const int n_local = min(n_st, st0 + per) - st0;
  Q8_STAMP(0);

  auto slot = [&](int i) { return smem + (i % S) * SB; };
  auto load_async = [&](int i) {
    unsigned char* base = slot(i);
    const int k0 = (st0 + i) * kKT;
#pragma unroll
    for (int idx = tid; idx < BN * (kKT / 16); idx += kThreads) {  // weight: 16-byte pieces
      const int r = idx / (kKT / 16), c = (idx % (kKT / 16)) * 16;
      const int n = n0 + r, k = k0 + c;
      const bool ok = n < N && k < Kp;
      cp_async16(base + r * L::WS + c, ok ? q + (size_t)n * Kp + k : q, ok);
    }
    if constexpr (ASYNC_X) {
      unsigned char* sx = base + BN * L::WS;
      constexpr int kPieces = kKT * L::XB / 16;  // 16-byte pieces of a staged row
      constexpr int kPer = 16 / L::XB;           // elements a piece
      const int row_len = W8A8 ? Kp : K;         // columns of x's rows in device memory
#pragma unroll
      for (int idx = tid; idx < MT * kPieces; idx += kThreads) {
        const int r = idx / kPieces, c = (idx % kPieces) * kPer;
        const int m = m0 + r, k = k0 + c;
        const bool ok = m < M && k < row_len;  // row_len % kPer == 0: whole pieces
        cp_async16(sx + (r * L::XS + c) * L::XB, ok ? x + (size_t)m * row_len + k : x, ok);
      }
    }
  };
  float xr[ASYNC_X ? 1 : kSyncPer];
  auto fetch_x = [&](int i) {  // sync route: this thread's x elements of stage i
    if constexpr (!ASYNC_X) {
      const int k0 = (st0 + i) * kKT;
#pragma unroll
      for (int e = 0; e < kSyncPer; ++e) {
        const int idx = tid + e * kThreads;
        const int m = m0 + idx / kKT, k = k0 + idx % kKT;
        xr[e] = (m < M && k < K) ? to_f(x[(size_t)m * K + k]) : 0.f;
      }
    }
  };
  auto store_x = [&](int i) {
    if constexpr (!ASYNC_X) {
      uint16_t* sx = reinterpret_cast<uint16_t*>(slot(i) + BN * L::WS);
#pragma unroll
      for (int e = 0; e < kSyncPer; ++e) {
        const int idx = tid + e * kThreads;
        sx[(idx / kKT) * L::XS + idx % kKT] = bf16_bits(xr[e]);
      }
    }
  };

  Acc acc[NT][4];
#pragma unroll
  for (int j = 0; j < NT; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0;

#pragma unroll
  for (int i = 0; i < S - 1; ++i) {
    if (i < n_local) {
      load_async(i);
      fetch_x(i);
      store_x(i);
    }
    cp_async_commit();
  }
  for (int i = 0; i < n_local; ++i) {
    cp_async_wait<S - 2>();
    __syncthreads();  // stage i arrived for all; slot (i - 1) % S is free
    if (i == 0) Q8_STAMP(1);
    const int nxt = i + S - 1;
    const bool more = nxt < n_local;
    if (more) {
      load_async(nxt);
      fetch_x(nxt);  // in flight while stage i is multiplied
    }
    cp_async_commit();

    const unsigned char* base = slot(i);
    const signed char* sw = reinterpret_cast<const signed char*>(base) + cw * 16 * L::WS;
    if constexpr (W8A8) {
      const signed char* sx = reinterpret_cast<const signed char*>(base + BN * L::WS);
      const int g = lane >> 2, t = lane & 3;
#pragma unroll
      for (int st = kh; st < kKT / 32; st += KH) {
        const int kk = st * 32 + 8 * t;
        const uint2 lo = *reinterpret_cast<const uint2*>(sw + g * L::WS + kk);
        const uint2 hi = *reinterpret_cast<const uint2*>(sw + (g + 8) * L::WS + kk);
        const uint32_t a[4] = {lo.x, hi.x, lo.y, hi.y};
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          const uint2 b = *reinterpret_cast<const uint2*>(sx + (j * 8 + g) * L::XS + kk);
          mma_s8(acc[j], a, b.x, b.y);
        }
      }
    } else {
      const uint16_t* sx = reinterpret_cast<const uint16_t*>(base + BN * L::WS);
#pragma unroll
      for (int st = kh; st < kKT / 16; st += KH) {
        const int kk = st * 16;
        uint32_t a[4];
        a_frag_bf16(sw, L::WS, kk, lane, a);
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          const uint2 b = b_frag_bf16(sx + j * 8 * L::XS, L::XS, kk, lane);
          mma_bf16(acc[j], a, b.x, b.y);
        }
      }
    }
    if (more) store_x(nxt);
  }
  // red[kh][row][channel] (row stride BN + 4): this block's k groups' sums
  cp_async_wait<0>();
  __syncthreads();  // the ring is free: it holds the sums now
  Q8_STAMP(2);
  constexpr int RS = BN + 4;
  Acc* red = reinterpret_cast<Acc*>(smem);
  {
    const int g = lane >> 2, t = lane & 3, ch = cw * 16 + g;
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const int r = kh * MT + j * 8 + 2 * t;
      red[r * RS + ch] = acc[j][0];
      red[(r + 1) * RS + ch] = acc[j][1];
      red[r * RS + ch + 8] = acc[j][2];
      red[(r + 1) * RS + ch + 8] = acc[j][3];
    }
  }
  cluster.sync();  // every rank's sums are written and visible across the cluster
  Q8_STAMP(3);

  // Each rank adds a share of the tile's outputs (rows below M only), four
  // channels at a time, over the ranks and k groups in order; all of a
  // thread's loads from the cluster are issued before any is added.
  const int E4 = min(MT, M - m0) * (BN / 4);
  const int share = (E4 + ks - 1) / ks;
  const int e1 = min(E4, (rank + 1) * share);
  for (int e = rank * share + tid; e < e1; e += kThreads) {
    const int r = e / (BN / 4), ch = (e % (BN / 4)) * 4;
    using Acc4 = std::conditional_t<W8A8, int4, float4>;
    Acc4 v[KH * kMaxCluster];
#pragma unroll
    for (int c = 0; c < kMaxCluster; ++c) {
      if (c < ks) {
        const Acc* rr = cluster.map_shared_rank(red, c);
#pragma unroll
        for (int h = 0; h < KH; ++h)
          v[c * KH + h] = *reinterpret_cast<const Acc4*>(rr + (h * MT + r) * RS + ch);
      }
    }
    Acc total[4] = {0, 0, 0, 0};
#pragma unroll
    for (int c = 0; c < kMaxCluster; ++c) {
      if (c < ks) {
#pragma unroll
        for (int h = 0; h < KH; ++h) {
          total[0] += v[c * KH + h].x;
          total[1] += v[c * KH + h].y;
          total[2] += v[c * KH + h].z;
          total[3] += v[c * KH + h].w;
        }
      }
    }
    const int m = m0 + r;
#pragma unroll
    for (int l = 0; l < 4; ++l) {
      const int n = n0 + ch + l;
      if (n >= N) break;
      float y;
      if constexpr (W8A8)
        y = __fmul_rn(__fmul_rn(static_cast<float>(total[l]), sxs[m]), s[n]);
      else
        y = __fmul_rn(total[l], s[n]);
      out[(size_t)m * N + n] = from_f<O>(y);
    }
  }
  Q8_STAMP(4);
  cluster.sync();  // no block leaves while another still reads its sums
  Q8_STAMP(5);
}

// ---- the GEMV route (m <= 8): one warp per output channel on the CUDA cores
// (the design of the first port, kept where it measures faster: a block of 8
// warps is 8 channels; a lane loads 16 int8 of its channel's row with one
// 16-byte load and uses them for every row of the m-tile, staged in shared
// memory as bf16 or int8; sums reduced across the warp with shuffles)
constexpr int kGemvThreads = 256;
constexpr int kGemvWarps = kGemvThreads / 32;
constexpr int kGemvKT = 2048;  // columns of x staged per pass

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int m = 16; m > 0; m >>= 1) x += __shfl_xor_sync(0xffffffffu, x, m);
  return x;
}

__device__ __forceinline__ int warp_sum(int x) {
#pragma unroll
  for (int m = 16; m > 0; m >>= 1) x += __shfl_xor_sync(0xffffffffu, x, m);
  return x;
}

// the four int8 of one 32-bit word as floats, lowest byte first
__device__ __forceinline__ void unpack4(uint32_t w, float* f) {
  f[0] = static_cast<float>(static_cast<signed char>(w & 0xff));
  f[1] = static_cast<float>(static_cast<signed char>((w >> 8) & 0xff));
  f[2] = static_cast<float>(static_cast<signed char>((w >> 16) & 0xff));
  f[3] = static_cast<float>(static_cast<signed char>(w >> 24));
}

// Rows m0 .. m0 + MT - 1, columns k0 .. k0 + kt - 1 of x (M, K) into shared
// memory as bf16 bit patterns, zero beyond M and K (kt a multiple of 16):
// eight columns a thread with 16-byte loads where every row of x starts on a
// 16-byte boundary, else one column a thread.
template <typename X, int MT>
__device__ __forceinline__ void gemv_stage_bf16(uint16_t (*sx)[kGemvKT], const X* __restrict__ x,
                                                int M, int K, int m0, int k0, int kt, int tid) {
  if (K % 8 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0) {
    const int per_row = kt / 8;
    for (int idx = tid; idx < MT * per_row; idx += kGemvThreads) {
      const int r = idx / per_row, c = (idx % per_row) * 8;
      const int m = m0 + r, k = k0 + c;
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (m < M && k < K) {  // K % 8 == 0: the eight columns are inside or outside together
        const X* src = x + (size_t)m * K + k;
        if constexpr (sizeof(X) == 2) {
          v = *reinterpret_cast<const uint4*>(src);
        } else {
          const float4 a = *reinterpret_cast<const float4*>(src);
          const float4 b = *reinterpret_cast<const float4*>(src + 4);
          __nv_bfloat162 p0 = __floats2bfloat162_rn(a.x, a.y), p1 = __floats2bfloat162_rn(a.z, a.w);
          __nv_bfloat162 p2 = __floats2bfloat162_rn(b.x, b.y), p3 = __floats2bfloat162_rn(b.z, b.w);
          v = make_uint4(*reinterpret_cast<uint32_t*>(&p0), *reinterpret_cast<uint32_t*>(&p1),
                         *reinterpret_cast<uint32_t*>(&p2), *reinterpret_cast<uint32_t*>(&p3));
        }
      }
      *reinterpret_cast<uint4*>(&sx[r][c]) = v;
    }
    return;
  }
  for (int idx = tid; idx < MT * kt; idx += kGemvThreads) {
    const int r = idx / kt, c = idx % kt, m = m0 + r, k = k0 + c;
    sx[r][c] = bf16_bits((m < M && k < K) ? to_f(x[(size_t)m * K + k]) : 0.f);
  }
}

template <typename X, typename O, int MT>
__global__ void __launch_bounds__(kGemvThreads)
gemv_wonly_kernel(const X* __restrict__ x, const signed char* __restrict__ q,
                  const float* __restrict__ s, O* __restrict__ out, int M, int K, int Kp,
                  int N) {
  __shared__ __align__(16) uint16_t sx[MT][kGemvKT];  // bf16 bit patterns
  const int tid = threadIdx.x, lane = tid % 32;
  const int n = blockIdx.x * kGemvWarps + tid / 32;
  const signed char* qrow = q + (size_t)(n < N ? n : 0) * Kp;
  const float sn = n < N ? s[n] : 0.f;
  const int m0 = blockIdx.y * MT;
  float acc[MT];
#pragma unroll
  for (int r = 0; r < MT; ++r) acc[r] = 0.f;
  for (int k0 = 0; k0 < Kp; k0 += kGemvKT) {
    const int kt = min(kGemvKT, Kp - k0);  // a multiple of 16
    gemv_stage_bf16<X, MT>(sx, x, M, K, m0, k0, kt, tid);
    __syncthreads();
    if (n < N) {
      for (int c = lane * 16; c < kt; c += 32 * 16) {
        const uint4 w = *reinterpret_cast<const uint4*>(qrow + k0 + c);
        float wf[16];
        unpack4(w.x, wf);
        unpack4(w.y, wf + 4);
        unpack4(w.z, wf + 8);
        unpack4(w.w, wf + 12);
#pragma unroll
        for (int r = 0; r < MT; ++r) {
          const uint4* xp = reinterpret_cast<const uint4*>(&sx[r][c]);
          const uint4 xa = xp[0], xb = xp[1];
          const uint32_t xw[8] = {xa.x, xa.y, xa.z, xa.w, xb.x, xb.y, xb.z, xb.w};
          float a = acc[r];
#pragma unroll
          for (int e = 0; e < 8; ++e) {  // a bf16 is the high half of an f32
            a += __uint_as_float(xw[e] << 16) * wf[2 * e];
            a += __uint_as_float(xw[e] & 0xffff0000u) * wf[2 * e + 1];
          }
          acc[r] = a;
        }
      }
    }
    __syncthreads();  // every read of this pass ends before the next overwrites
  }
#pragma unroll
  for (int r = 0; r < MT; ++r) {
    const float total = warp_sum(acc[r]);
    if (lane == 0 && n < N && m0 + r < M) out[(size_t)(m0 + r) * N + n] = from_f<O>(total * sn);
  }
}

template <typename O, int MT>
__global__ void __launch_bounds__(kGemvThreads)
gemv_w8a8_kernel(const signed char* __restrict__ xq, const float* __restrict__ sxs,
                 const signed char* __restrict__ q, const float* __restrict__ s,
                 O* __restrict__ out, int M, int Kp, int N) {
  __shared__ __align__(16) signed char sx[MT][kGemvKT];
  const int tid = threadIdx.x, lane = tid % 32;
  const int n = blockIdx.x * kGemvWarps + tid / 32;
  const signed char* qrow = q + (size_t)(n < N ? n : 0) * Kp;
  const float sn = n < N ? s[n] : 0.f;
  const int m0 = blockIdx.y * MT;
  int acc[MT];
#pragma unroll
  for (int r = 0; r < MT; ++r) acc[r] = 0;
  for (int k0 = 0; k0 < Kp; k0 += kGemvKT) {
    const int kt = min(kGemvKT, Kp - k0);
    for (int idx = tid; idx < MT * (kt / 16); idx += kGemvThreads) {
      const int r = idx / (kt / 16), c = (idx % (kt / 16)) * 16;
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (m0 + r < M) v = *reinterpret_cast<const uint4*>(xq + (size_t)(m0 + r) * Kp + k0 + c);
      *reinterpret_cast<uint4*>(&sx[r][c]) = v;
    }
    __syncthreads();
    if (n < N) {
      for (int c = lane * 16; c < kt; c += 32 * 16) {
        const uint4 w = *reinterpret_cast<const uint4*>(qrow + k0 + c);
#pragma unroll
        for (int r = 0; r < MT; ++r) {
          const uint4 xv = *reinterpret_cast<const uint4*>(&sx[r][c]);
          int a = acc[r];
          a = __dp4a(static_cast<int>(xv.x), static_cast<int>(w.x), a);
          a = __dp4a(static_cast<int>(xv.y), static_cast<int>(w.y), a);
          a = __dp4a(static_cast<int>(xv.z), static_cast<int>(w.z), a);
          a = __dp4a(static_cast<int>(xv.w), static_cast<int>(w.w), a);
          acc[r] = a;
        }
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int r = 0; r < MT; ++r) {
    const int total = warp_sum(acc[r]);
    if (lane == 0 && n < N && m0 + r < M)
      out[(size_t)(m0 + r) * N + n] =
          from_f<O>(__fmul_rn(__fmul_rn(static_cast<float>(total), sxs[m0 + r]), s[n]));
  }
}

// ---- w8a8 pre-pass: row quantization of x ----
template <typename X>
__global__ void __launch_bounds__(kThreads)
quantize_rows_kernel(const X* __restrict__ x, signed char* __restrict__ xq,
                     float* __restrict__ sx, int K, int Kp) {
  __shared__ float smax[kWarps];
  const int m = blockIdx.x;
  const int tid = threadIdx.x;
  const X* row = x + (size_t)m * K;
  float mx = 0.f;
  for (int k = tid; k < K; k += kThreads) mx = fmaxf(mx, fabsf(to_f(row[k])));
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, d));
  if (tid % 32 == 0) smax[tid / 32] = mx;
  __syncthreads();
  mx = smax[0];
#pragma unroll
  for (int w = 1; w < kWarps; ++w) mx = fmaxf(mx, smax[w]);
  const float scale = fmaxf(mx, 1e-12f) / 127.f;
  if (tid == 0) sx[m] = scale;
  for (int k = tid; k < Kp; k += kThreads) {
    float v = 0.f;
    if (k < K) v = fminf(fmaxf(rintf(to_f(row[k]) / scale), -127.f), 127.f);
    xq[(size_t)m * Kp + k] = static_cast<signed char>(v);
  }
}

template <typename X, typename O, int NT, bool W8A8, bool ASYNC_X>
int launch(const void* x, const float* sx, const void* q, const void* s, void* out, int M,
           int K, int Kp, int N, int ks, cudaStream_t stream) {
  auto kernel = int8_linear_kernel<X, O, NT, W8A8, ASYNC_X>;
  constexpr int smem = smem_bytes<W8A8, NT>();
  static bool sized = false;  // one attribute call per instantiation
  if (!sized) {
    const cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    sized = true;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(ks, (N + Tile<NT>::BN - 1) / Tile<NT>::BN, (M + NT * 8 - 1) / (NT * 8));
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = ks;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t e = cudaLaunchKernelEx(
      &cfg, kernel, static_cast<const X*>(x), sx, static_cast<const signed char*>(q),
      static_cast<const float*>(s), static_cast<O*>(out), M, K, Kp, N);
  return e != cudaSuccess ? static_cast<int>(e) : static_cast<int>(cudaGetLastError());
}

template <typename X, typename O, bool W8A8, bool ASYNC_X>
int launch_mt(const void* x, const float* sx, const void* q, const void* s, void* out, int M,
              int K, int Kp, int N, int mt, int ks, cudaStream_t st) {
  switch (mt) {
    case 16: return launch<X, O, 2, W8A8, ASYNC_X>(x, sx, q, s, out, M, K, Kp, N, ks, st);
    case 32: return launch<X, O, 4, W8A8, ASYNC_X>(x, sx, q, s, out, M, K, Kp, N, ks, st);
    default: return -5;
  }
}

template <typename X, typename O, int MT>
int launch_gemv(const void* x, const void* q, const void* s, void* out, void* xq, void* sx,
                int M, int K, int Kp, int N, int mode, cudaStream_t st) {
  const dim3 grid((N + kGemvWarps - 1) / kGemvWarps, (M + MT - 1) / MT);
  if (mode == 0) {
    gemv_wonly_kernel<X, O, MT><<<grid, kGemvThreads, 0, st>>>(
        static_cast<const X*>(x), static_cast<const signed char*>(q),
        static_cast<const float*>(s), static_cast<O*>(out), M, K, Kp, N);
    return static_cast<int>(cudaGetLastError());
  }
  quantize_rows_kernel<X><<<M, kThreads, 0, st>>>(
      static_cast<const X*>(x), static_cast<signed char*>(xq), static_cast<float*>(sx), K, Kp);
  const int err = static_cast<int>(cudaGetLastError());
  if (err != 0) return err;
  gemv_w8a8_kernel<O, MT><<<grid, kGemvThreads, 0, st>>>(
      static_cast<const signed char*>(xq), static_cast<const float*>(sx),
      static_cast<const signed char*>(q), static_cast<const float*>(s), static_cast<O*>(out), M,
      Kp, N);
  return static_cast<int>(cudaGetLastError());
}

template <typename X, typename O>
int dispatch(const void* x, const void* q, const void* s, void* out, void* xq, void* sx, int M,
             int K, int Kp, int N, int mode, int route, int mt, int ks, int async_x,
             cudaStream_t st) {
  if (route == 1) {
    switch (mt) {
      case 1: return launch_gemv<X, O, 1>(x, q, s, out, xq, sx, M, K, Kp, N, mode, st);
      case 2: return launch_gemv<X, O, 2>(x, q, s, out, xq, sx, M, K, Kp, N, mode, st);
      case 4: return launch_gemv<X, O, 4>(x, q, s, out, xq, sx, M, K, Kp, N, mode, st);
      case 8: return launch_gemv<X, O, 8>(x, q, s, out, xq, sx, M, K, Kp, N, mode, st);
      default: return -5;
    }
  }
  if (mode == 0) {
    if constexpr (std::is_same_v<X, __nv_bfloat16>) {
      if (async_x)
        return launch_mt<X, O, false, true>(x, nullptr, q, s, out, M, K, Kp, N, mt, ks, st);
    }
    return launch_mt<X, O, false, false>(x, nullptr, q, s, out, M, K, Kp, N, mt, ks, st);
  }
  quantize_rows_kernel<X><<<M, kThreads, 0, st>>>(
      static_cast<const X*>(x), static_cast<signed char*>(xq), static_cast<float*>(sx), K, Kp);
  const int err = static_cast<int>(cudaGetLastError());
  if (err != 0) return err;
  return launch_mt<signed char, O, true, true>(xq, static_cast<const float*>(sx), q, s, out, M,
                                               K, Kp, N, mt, ks, st);
}

}  // namespace

// C entry point (bound with ctypes in ops/qlinear.py). Layouts: x (M, K) in
// the dtype of code x_dtype (0 f32, 1 bf16); q (N, Kp) int8, Kp a multiple of
// 16 with K <= Kp < K + 16 and zeros beyond K; s (N) f32; out (M, N) in the
// dtype of code out_dtype; mode 0 weight only, 1 w8a8, which also needs the
// scratch xq (M, Kp) int8 and sx (M) f32. All contiguous. The plan
// (ops/qlinear.py:int8_linear_plan): route 1 the GEMV body with an m-tile of
// mt = 1, 2, 4 or 8 rows; route 0 the tensor-core body with mt = 16 or 32
// rows and ks blocks of a cluster along K (1 to 8), async_x 1 copying bf16 x
// as it is (weight only, K a multiple of 8, x on a 16-byte boundary).
// Returns cudaGetLastError() after the launches (or the launch's own error),
// -2 for an unsupported dtype code or mode, -3 for a bad Kp, -4 for missing
// w8a8 scratch, -5 for a bad plan.
extern "C" int int8_linear_fwd(const void* x, const void* q, const void* s, void* out, void* xq,
                               void* sx, int M, int K, int Kp, int N, int x_dtype,
                               int out_dtype, int mode, int route, int mt, int ks, int async_x,
                               void* stream) {
  if (Kp % 16 != 0 || Kp < K || Kp >= K + 16) return -3;
  if (mode != 0 && mode != 1) return -2;
  if (mode == 1 && (xq == nullptr || sx == nullptr)) return -4;
  if (route != 0 && route != 1) return -5;
  if (ks < 1 || ks > kMaxCluster || M < 1 || N < 1 || (route == 1 && ks != 1)) return -5;
  if (async_x && (route != 0 || mode != 0 || x_dtype != 1 || K % 8 != 0 ||
                  reinterpret_cast<uintptr_t>(x) % 16 != 0))
    return -5;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define Q8_DISPATCH(X, O) \
  return dispatch<X, O>(x, q, s, out, xq, sx, M, K, Kp, N, mode, route, mt, ks, async_x, st)
  if (x_dtype == 0 && out_dtype == 0) Q8_DISPATCH(float, float);
  if (x_dtype == 0 && out_dtype == 1) Q8_DISPATCH(float, __nv_bfloat16);
  if (x_dtype == 1 && out_dtype == 0) Q8_DISPATCH(__nv_bfloat16, float);
  if (x_dtype == 1 && out_dtype == 1) Q8_DISPATCH(__nv_bfloat16, __nv_bfloat16);
#undef Q8_DISPATCH
  return -2;
}

#ifdef Q8_TIMELINE
// Copies the stamps of the blocks launched since the last call into host
// (kTimelineBlocks x kTimelineStamps u64, zero where a block noted nothing)
// and clears them. Returns a cudaError_t.
extern "C" int int8_linear_timeline(void* host) {
  cudaError_t e = cudaMemcpyFromSymbol(host, q8_timeline, sizeof(q8_timeline));
  if (e != cudaSuccess) return static_cast<int>(e);
  void* dev = nullptr;
  e = cudaGetSymbolAddress(&dev, q8_timeline);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaMemset(dev, 0, sizeof(q8_timeline)));
}
#endif
