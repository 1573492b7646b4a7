// The chunked route of the GLA backward, for bf16 IO, with (CONV) or
// without the q/k/v short convs: the two recurrent sweeps of
// gla_chunk_bwd.cuh (one dependent rank-1 update per token) replaced by
// 64-row chunks whose products run on the tensor cores (mma.sync m16n8k16,
// bf16 operands, f32 sums), as the TPU kernels _conv_bwd_kernel
// (lina_speech_tpu/ops/gla_pallas.py:861) and _bwd_kernel (:210), math in
// _bwd_math :261, walk 64-row chunks with MXU products. Every product
// operand is rounded to bf16, as the TPU kernel rounds to its IO dtype,
// save those of the products that feed dq and dk: the decayed operands of
// the state walks, the states and cotangents, and G's and H's dA and
// split-decay factors enter as two bf16 parts (the rounded value and the
// rest, two or three mma a k-step). dg is sum_{s>=t} (q dq - k dk), a difference of near-equal
// terms: with those operands rounded once, the flagship's gate gradients
// parted from the plain path's by more than chip_smoke.py holds them to
// (tests/test_torch_chunk_bwd.py: test_two_part_operands_keep_the_gate_
// gradient). Every sum is f32. The plain version of the same decomposition
// is ops/gla_cuda.py:gla_chunk_conv_bwd_chunked_plain (CONV) and
// gla_chunk_bwd_chunked_plain.
//
// Per (batch, head), u = scale q, chunk c of rows t, bc the in-chunk
// inclusive sums of the gates g <= 0 and btot their total (a ragged last
// chunk is padded with zero inputs and zero gates):
//
// 1. prep_kernel: with CONV the convs, silu and rounding points of the
//    forward (as ConvBwdChannel::pre), else q, k, v as they are; bc, and the
//    decayed operands k e^{btot - bc} and u e^{bc} in two bf16 parts;
//    e^{btot} per chunk and key channel.
// 2. state_kernel, one launch of two halves (state_walk): a block holds a 64
//    x 64 f32 tile of S in its mma accumulators and walks the chunks forward
//    from s0, S <- e^{btot} S + (k e^{btot - bc})^T v, storing each chunk's
//    start state (two bf16 parts) and the row sums of dsf . e^{btot} S of
//    the last chunk's start state S (the decay's part of dsf . S_final);
//    the other half walks back from dsf, dS <- e^{btot} dS + (u e^{bc})^T
//    do, storing each chunk's end-state cotangent (two parts) and, at the
//    end, ds0. The forward's chunked route runs the first half alone.
// 3. dqk_kernel, parallel over (key tile, chunk, batch*head): the inter
//    terms do . S^T and v . dS^T and dA = do . v^T, summed over the value
//    tiles inside the block, then G and H (below); dq = scale (e^{bc} do S^T
//    + G), dk = e^{btot - bc} v dS^T + H leave the block once, in f32. The
//    last chunk's blocks add up the rest of dsf . S_final, sum_t k_t e^{btot
//    - bc_t} (v_t dsf^T), from the very f32 values that enter dk: the
//    finishing pass takes dg as sum_{s>=t} (q dq - k dk) + dsf . S_final,
//    and where the exact dg is 0 (one step from a zero state) the two sides
//    then cancel to f32 rounding instead of leaving bf16 rounding behind.
// 4. dv_kernel, parallel over (chunk, batch*head): A (below) summed over
//    the key tiles, then dv = (k e^{btot - bc}) dS + A^T do for every value
//    tile, in f32 for the conv's finishing pass, else in bf16 (the output).
// The finishing pass of gla_chunk_conv_bwd.cu (CONV) or gla_chunk_bwd.cu
// then takes dq and dk as one part each.
//
// The intra-chunk terms G[t] = sum_{s<=t} dA[t,s] k_s e^{b_t - b_s}, H[s] =
// sum_{t>=s} dA[t,s] u_t e^{b_t - b_s} and A[t,s] = sum_d u_t k_s e^{b_t -
// b_s} use 16-row sub-chunks. A flagship gate sum over a chunk can reach a
// few hundred, so e^{-bc} would overflow f32 and no product may factor the
// decay across a whole chunk. For sub-chunks I > J the decay is split at a
// row r between them, (x_t e^{b_t - b_r}) (y_s e^{b_r - b_s}), both
// exponents <= 0: r is the row before I for G and A, J's last row for H.
// The 16 x 16 diagonal blocks are summed elementwise in f32 on the CUDA
// cores with e^{b_t - b_s}, t >= s.
//
// What bounds it on the H100: not the products (26 GFLOP at b8 h4 t512
// dk256 dv512, 26 us at the bf16 peak) but memory traffic and latency: the
// states and cotangents (4 * b*h*nc*dk*dv bf16, written once, read once),
// the f32 operands of the intra terms, the chunk-serial state sweeps (nc
// dependent steps a block) and the diagonal blocks on the CUDA cores.
// Against them: the state sweeps load the next chunk while this chunk's
// products run and write the states through shared memory, 16 bytes a
// thread; dq/dk keeps two stages of its value loop in the space its
// epilogue takes later; dq/dk and dv fit two blocks an SM. The route is
// chosen in Python (ops/gla_cuda.py:gla_chunk_conv_bwd_plan).
//
// RWKV6's backward (rwkv6_chunked_bwd.cuh) walks the chunks with the same
// prep, state walk, dq/dk and dv bodies, with RWKV set: r in u's place (no
// scale), the readout decayed at the exclusive gate sum, strict pairs in
// G and H, and the bonus on A's diagonal.
#pragma once

#include <cstdint>

#include "gla_common.cuh"
#include "gla_mma.cuh"
#include "int8_common.cuh"

namespace gla {
namespace chunked {

using bf16 = __nv_bfloat16;

constexpr int kC = 64;           // rows of a chunk
constexpr int kSub = 16;         // rows of a sub-chunk
constexpr int kTile = 64;        // key or value channels of a tile
// bf16 row stride in shared memory: the rows of an ldmatrix on distinct banks
constexpr int kLd = kTile + 8;
constexpr int kLdF = kTile + 1;  // f32 row stride: rows on distinct banks
constexpr int kStateThreads = 128;
constexpr int kPrepRows = 8;     // rows whose inputs a prep thread loads at once
constexpr int kGradThreads = 256;
// rows of the split-decay factors of the sub-chunk pairs: 16 + 32 + 48
constexpr int kPairRows = kSub * (kC / kSub) * (kC / kSub - 1) / 2;
constexpr int kTileBytes = kC * kLd * 2;                     // one staged bf16 tile
constexpr int kFTileBytes = kC * kLdF * 4;                   // one staged f32 tile
constexpr int kPairBytes = kPairRows * kLd * 2;
static_assert(kPairRows == 96, "four sub-chunks a chunk");

using mma::frag_a;
using mma::frag_b;
using mma::ldsm_x4;
using mma::smem_addr;

// acc (16 rows from m0, 16 NP columns from n0, as 2 NP n8 tiles) += X . Y
// over k in [0, K): X and Y as frag_a and frag_b take them.
template <bool KM, bool KN, int NP>
__device__ __forceinline__ void mma_rows(float (&acc)[2 * NP][4], const bf16* x, int ldx,
                                         const bf16* y, int ldy, int m0, int n0, int K) {
  for (int k = 0; k < K; k += 16) {
    uint32_t a[4];
    frag_a<KM>(a, x, ldx, m0, k);
#pragma unroll
    for (int j = 0; j < NP; ++j) {
      uint32_t b[4];
      frag_b<KN>(b, y, ldy, k, n0 + 16 * j);
      q8::mma_bf16(acc[2 * j], a, b[0], b[1]);
      q8::mma_bf16(acc[2 * j + 1], a, b[2], b[3]);
    }
  }
}

// Row and column (within the 16 x 8 tile) of accumulator element e of the
// calling lane: rows g and g + 8, columns 2 t4 and 2 t4 + 1.
__device__ __forceinline__ int acc_row(int e) { return ((threadIdx.x & 31) >> 2) + 8 * (e >> 1); }
__device__ __forceinline__ int acc_col(int e) { return 2 * (threadIdx.x & 3) + (e & 1); }

// 16 bytes of a bf16 row into shared memory, or zeros where !ok (src is
// then not read)
__device__ __forceinline__ void copy16(bf16* dst, const bf16* src, const bf16* any, bool ok) {
  q8::cp_async16(dst, ok ? src : any, ok);
}

__device__ __forceinline__ float exp_le0(float x) { return __expf(fminf(x, 0.f)); }

// ------------------------------------------------------------------ prep
// One thread walks one channel through one chunk of 64 rows (the caller's
// grid: (nc, B*H, DK/64 + ceil(DV/64)), 64 threads). Key-channel threads
// take q and k (with CONV their convs, silu and the rounding points of the
// forward, as ConvBwdChannel::pre; else q and k as they are) and sum the
// gates; value-channel threads take v (with CONV its conv). Outputs on Tp =
// nc * 64 rows (zeros past T): uf = u = scale q, kf = k, bc (f32, (B*H, Tp,
// DK)); kt = k e^{btot - bc}, ul = u e^{bc} (bf16, same shape); kl and ull,
// where not null, their low parts, the f32 value less its bf16 rounding, in
// bf16; vb = v (bf16, (B*H, Tp, DV)); ebt = e^{btot} (f32, (B*H, nc, DK)).
// RWKV (RWKV6's forward: xq = r, scale 1): ul = u e^{bx}, the readout
// decayed at the exclusive sum bx_t = bc_{t-1} (0 on a chunk's first row).
template <typename IO, bool CONV, bool RWKV = false>
__device__ __forceinline__ void prep_rows(const IO* __restrict__ xq, const IO* __restrict__ xk,
                                          const IO* __restrict__ xv, const float* __restrict__ gk,
                                          const IO* __restrict__ wq, const IO* __restrict__ wk,
                                          const IO* __restrict__ wv, float* __restrict__ uf,
                                          float* __restrict__ kf, float* __restrict__ bc,
                                          bf16* __restrict__ kt, bf16* __restrict__ kl,
                                          bf16* __restrict__ ul, bf16* __restrict__ ull,
                                          bf16* __restrict__ vb, float* __restrict__ ebt, int H,
                                          int T, int DK, int DV, float scale) {
  const int c = blockIdx.x, bh = blockIdx.y, h = bh % H, nc = gridDim.x, Tp = nc * kC;
  const int t0 = c * kC, n = min(kC, T - t0);
  const int key_blocks = DK / kTile;
  if ((int)blockIdx.z < key_blocks) {
    const int ch = blockIdx.z * kTile + threadIdx.x;
    const size_t xb = (size_t)bh * T * DK + ch, ob = ((size_t)bh * Tp + t0) * DK + ch;
    float btot = 0.f;
#pragma unroll 8
    for (int r = 0; r < n; ++r) btot += gk[xb + (size_t)(t0 + r) * DK];
    float wqf[kConv], wkf[kConv], hq[kConv], hk[kConv];  // taps; x[t-3 .. t]
    if constexpr (CONV) {
#pragma unroll
      for (int i = 0; i < kConv; ++i) {
        wqf[i] = to_f(wq[(size_t)(h * DK + ch) * kConv + i]);
        wkf[i] = to_f(wk[(size_t)(h * DK + ch) * kConv + i]);
        const int t = t0 - (kConv - 1) + i;
        hq[i] = t >= 0 && i < kConv - 1 ? to_f(xq[xb + (size_t)t * DK]) : 0.f;
        hk[i] = t >= 0 && i < kConv - 1 ? to_f(xk[xb + (size_t)t * DK]) : 0.f;
      }
    }
    float b = 0.f;
    for (int r0 = 0; r0 < kC; r0 += kPrepRows) {
      // the group's loads in flight together
      float xqs[kPrepRows], xks[kPrepRows], gs[kPrepRows];
#pragma unroll
      for (int j = 0; j < kPrepRows; ++j) {
        const bool live = r0 + j < n;
        const size_t x = xb + (size_t)(t0 + r0 + j) * DK;
        xqs[j] = live ? to_f(xq[x]) : 0.f;
        xks[j] = live ? to_f(xk[x]) : 0.f;
        gs[j] = live ? gk[x] : 0.f;
      }
#pragma unroll
      for (int j = 0; j < kPrepRows; ++j) {
        const int r = r0 + j;
        const float bx = b;  // the exclusive sum
        float u = 0.f, k = 0.f;
        if (r < n) {
          b += gs[j];
          if constexpr (CONV) {
            hq[kConv - 1] = xqs[j];
            hk[kConv - 1] = xks[j];
            float zq = 0.f, zk = 0.f;
#pragma unroll
            for (int i = 0; i < kConv; ++i) {
              zq = zq + wqf[i] * hq[i];
              zk = zk + wkf[i] * hk[i];
            }
            u = silu(round_io<IO>(zq)) * scale;
            k = silu(round_io<IO>(zk));
#pragma unroll
            for (int i = 0; i < kConv - 1; ++i) {
              hq[i] = hq[i + 1];
              hk[i] = hk[i + 1];
            }
          } else {
            u = xqs[j] * scale;
            k = xks[j];
          }
        }
        const size_t o = ob + (size_t)r * DK;
        uf[o] = u;
        kf[o] = k;
        bc[o] = b;
        const float kd = k * __expf(btot - b);
        const bf16 hi = __float2bfloat16_rn(kd);
        kt[o] = hi;
        if (kl) kl[o] = __float2bfloat16_rn(kd - __bfloat162float(hi));
        const float ud = u * __expf(RWKV ? bx : b);
        const bf16 uhi = __float2bfloat16_rn(ud);
        ul[o] = uhi;
        if (ull) ull[o] = __float2bfloat16_rn(ud - __bfloat162float(uhi));
      }
    }
    ebt[((size_t)bh * nc + c) * DK + ch] = __expf(btot);
  } else {
    const int ch = (blockIdx.z - key_blocks) * kTile + threadIdx.x;
    if (ch >= DV) return;
    const size_t xb = (size_t)bh * T * DV + ch, ob = ((size_t)bh * Tp + t0) * DV + ch;
    float w[kConv], hv[kConv];
    if constexpr (CONV) {
#pragma unroll
      for (int i = 0; i < kConv; ++i) {
        w[i] = to_f(wv[(size_t)(h * DV + ch) * kConv + i]);
        const int t = t0 - (kConv - 1) + i;
        hv[i] = t >= 0 && i < kConv - 1 ? to_f(xv[xb + (size_t)t * DV]) : 0.f;
      }
    }
    for (int r0 = 0; r0 < kC; r0 += kPrepRows) {
      float xvs[kPrepRows];
#pragma unroll
      for (int j = 0; j < kPrepRows; ++j)
        xvs[j] = r0 + j < n ? to_f(xv[xb + (size_t)(t0 + r0 + j) * DV]) : 0.f;
#pragma unroll
      for (int j = 0; j < kPrepRows; ++j) {
        const int r = r0 + j;
        float v = 0.f;
        if (r < n) {
          if constexpr (CONV) {
            hv[kConv - 1] = xvs[j];
            float z = 0.f;
#pragma unroll
            for (int i = 0; i < kConv; ++i) z = z + w[i] * hv[i];
            v = silu(round_io<IO>(z));
#pragma unroll
            for (int i = 0; i < kConv - 1; ++i) hv[i] = hv[i + 1];
          } else {
            v = xvs[j];
          }
        }
        vb[ob + (size_t)r * DV] = __float2bfloat16_rn(v);
      }
    }
  }
}

// grid (nc, B*H, DK/64 + ceil(DV/64)), 64 threads: prep_rows with (CONV)
// or without the convs, and both low parts.
template <typename IO, bool CONV>
__global__ void __launch_bounds__(kTile)
prep_kernel(const IO* __restrict__ xq, const IO* __restrict__ xk, const IO* __restrict__ xv,
            const float* __restrict__ gk, const IO* __restrict__ wq, const IO* __restrict__ wk,
            const IO* __restrict__ wv, float* __restrict__ uf, float* __restrict__ kf,
            float* __restrict__ bc, bf16* __restrict__ kt, bf16* __restrict__ kl,
            bf16* __restrict__ ul, bf16* __restrict__ ull, bf16* __restrict__ vb,
            float* __restrict__ ebt, int H, int T, int DK, int DV, float scale) {
  prep_rows<IO, CONV>(xq, xk, xv, gk, wq, wk, wv, uf, kf, bc, kt, kl, ul, ull, vb, ebt, H, T, DK,
                      DV, scale);
}

// dsgp part blockIdx.x (B*H, DK) of the warp's 16 key rows from row0: the
// row sums over the block's value tile of dsf . acc, acc the last chunk's
// start state decayed by e^{btot} (0 without dsf).
template <typename ST>
__device__ __forceinline__ void last_chunk_decay(const float (&acc)[8][4], const ST* dsf,
                                                 float* dsgp, int bh, int BH, int row0, int c0,
                                                 int DK, int DV) {
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int row = row0 + acc_row(2 * hh);
    float sum = 0.f;
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 2 * hh; e < 2 * hh + 2; ++e) {
        const int col = c0 + 8 * j + acc_col(e);
        if (dsf && col < DV) sum += to_f(dsf[((size_t)bh * DK + row) * DV + col]) * acc[j][e];
      }
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    sum += __shfl_xor_sync(0xffffffffu, sum, 2);
    if ((threadIdx.x & 3) == 0) dsgp[((size_t)blockIdx.x * BH + bh) * DK + row] = sum;
  }
}

// ---------------------------------------------------------------- states
// Shared memory of a state sweep: two stages of the decayed operand's two
// parts ([t][key]) and of v or do ([t][value]), the state as it leaves in
// two parts ([key][value]) and two stages of e^{btot}. 72.5 KB: three blocks
// an SM.
constexpr int kStateSmem = 8 * kTileBytes + 2 * kTile * 4;

// The chunk walk of one block of a state_kernel (the caller's grid:
// (ceil(DV/64), DK/64, B*H), with B*H more blocks z for the reverse walk
// where there is one; 128 threads): warp w holds key rows 16 w .. 16 w + 15
// of the block's 64 x 64 tile, all 64 value columns, in f32 mma
// accumulators. The decayed operands enter as two bf16 parts (prep_rows'
// kt + kl, ul + ull), two mma a k-step. Forward (z < B*H), from s0: S <-
// e^{btot} S + (kt + kl)^T vb, each chunk's start state leaving to states
// (bf16) and, where states_lo is not null, the rest of it to states_lo;
// after the walk S to sf in its dtype where sf is not null, and where dsgp
// is not null its part blockIdx.x (B*H, DK): per value tile the row sums of
// dsf . e^{btot} S of the last chunk's start state (the decay's part of dsf
// . S_final). Reverse, from dsf: dS <- e^{btot} dS + (ul + ull)^T do, each
// chunk's end-state cotangent to dstates and dstates_lo, at the end ds0
// where not null. states, dstates: (B*H, nc, DK, DV). s0 and dsf may be
// null (zeros).
template <typename ST>
__device__ __forceinline__ void state_walk(
    unsigned char* smem, const bf16* __restrict__ kt, const bf16* __restrict__ kl,
    const bf16* __restrict__ ul, const bf16* __restrict__ ull, const bf16* __restrict__ vb,
    const bf16* __restrict__ dout, const float* __restrict__ ebt, const ST* __restrict__ s0,
    const ST* __restrict__ dsf, bf16* __restrict__ states, bf16* __restrict__ states_lo,
    bf16* __restrict__ dstates, bf16* __restrict__ dstates_lo, float* __restrict__ dsgp,
    ST* __restrict__ ds0, ST* __restrict__ sf, int BH, int T, int nc, int DK, int DV) {
  bf16* sx = reinterpret_cast<bf16*>(smem);  // [2][kC * kLd] decayed k or u, rounded: [t][key]
  bf16* sxl = sx + 2 * kC * kLd;             // [2][kC * kLd] the rest of it
  bf16* sy = sxl + 2 * kC * kLd;             // [2][kC * kLd] v or do: [t][value]
  bf16* so = sy + 2 * kC * kLd;              // [kTile * kLd] the state as it leaves, rounded
  bf16* sol = so + kTile * kLd;              // [kTile * kLd] the rest of it
  float* se = reinterpret_cast<float*>(sol + kTile * kLd);  // [2][kTile] e^{btot} of the rows
  const bool rev = (int)blockIdx.z >= BH;
  const int bh = rev ? blockIdx.z - BH : blockIdx.z;
  const int c0 = blockIdx.x * kTile, d0 = blockIdx.y * kTile, Tp = nc * kC;
  const int warp = threadIdx.x >> 5, m0 = 16 * warp;
  const ST* init = rev ? dsf : s0;
  float acc[8][4];
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int row = d0 + m0 + acc_row(e), col = c0 + 8 * j + acc_col(e);
      acc[j][e] = init && col < DV ? to_f(init[((size_t)bh * DK + row) * DV + col]) : 0.f;
    }
  const bf16* xsrc = rev ? ul : kt;
  const bf16* xlo = rev ? ull : kl;
  bf16* out = rev ? dstates : states;
  bf16* out_lo = rev ? dstates_lo : states_lo;
  const auto chunk_of = [&](int i) { return rev ? nc - 1 - i : i; };
  const auto stage = [&](int buf, int c) {  // one cp.async group
    for (int p = threadIdx.x; p < kC * 8; p += kStateThreads) {
      const int r = p >> 3, q = (p & 7) * 8, t = c * kC + r;
      const size_t key = ((size_t)bh * Tp + t) * DK + d0 + q;
      copy16(sx + (buf * kC + r) * kLd + q, xsrc + key, xsrc, true);
      copy16(sxl + (buf * kC + r) * kLd + q, xlo + key, xlo, true);
      const bool ok = c0 + q < DV && (!rev || t < T);
      const bf16* ysrc = rev ? dout + ((size_t)bh * T + t) * DV + c0 + q
                             : vb + ((size_t)bh * Tp + t) * DV + c0 + q;
      copy16(sy + (buf * kC + r) * kLd + q, ysrc, vb, ok);
    }
    if (threadIdx.x < kTile)
      se[buf * kTile + threadIdx.x] = ebt[((size_t)bh * nc + c) * DK + d0 + threadIdx.x];
    q8::cp_async_commit();
  };
  stage(0, chunk_of(0));
  for (int i = 0; i < nc; ++i) {
    const int c = chunk_of(i), buf = i & 1;
    if (i + 1 < nc) {
      stage(buf ^ 1, chunk_of(i + 1));
    } else {
      q8::cp_async_commit();  // an empty group keeps the wait below the same
    }
    // the state at the chunk's start (forward) or the cotangent at its end
    // (reverse) leaves through shared memory, 16 bytes a thread
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int at = (m0 + acc_row(2 * hh)) * kLd + 8 * j + acc_col(0);
        const __nv_bfloat162 hi = __floats2bfloat162_rn(acc[j][2 * hh], acc[j][2 * hh + 1]);
        *reinterpret_cast<__nv_bfloat162*>(so + at) = hi;
        *reinterpret_cast<__nv_bfloat162*>(sol + at) =
            __floats2bfloat162_rn(acc[j][2 * hh] - __low2float(hi),
                                  acc[j][2 * hh + 1] - __high2float(hi));
      }
    q8::cp_async_wait<1>();
    __syncthreads();  // this chunk's tiles and the state in so are complete
    const size_t o = (((size_t)bh * nc + c) * DK + d0) * DV + c0;
    for (int p = threadIdx.x; p < kTile * 8; p += kStateThreads) {
      const int r = p >> 3, q = (p & 7) * 8;
      if (c0 + q >= DV) continue;
      *reinterpret_cast<uint4*>(out + o + (size_t)r * DV + q) =
          *reinterpret_cast<const uint4*>(so + r * kLd + q);
      if (out_lo)
        *reinterpret_cast<uint4*>(out_lo + o + (size_t)r * DV + q) =
            *reinterpret_cast<const uint4*>(sol + r * kLd + q);
    }
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[j][e] *= se[buf * kTile + m0 + acc_row(e)];
    if (!rev && dsgp && i == nc - 1)
      last_chunk_decay(acc, dsf, dsgp, bh, BH, d0 + m0, c0, DK, DV);
    // acc[key][value] += sum_t x[t][key] y[t][value], x in two parts
    mma_rows<true, true, 4>(acc, sx + buf * kC * kLd, kLd, sy + buf * kC * kLd, kLd, m0, 0, kC);
    mma_rows<true, true, 4>(acc, sxl + buf * kC * kLd, kLd, sy + buf * kC * kLd, kLd, m0, 0, kC);
    __syncthreads();  // the next stage overwrites buf, and the next state so
  }
  ST* last = rev ? ds0 : sf;
  if (last) {
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = d0 + m0 + acc_row(e), col = c0 + 8 * j + acc_col(e);
        if (col < DV) last[((size_t)bh * DK + row) * DV + col] = from_f<ST>(acc[j][e]);
      }
  }
}

// grid (ceil(DV/64), DK/64, 2 B*H), 128 threads, shared memory kStateSmem:
// state_walk forward (states in two parts, dsgp) and in reverse (dstates in
// two parts, ds0). dsf, s0 and ds0 may be null.
template <typename ST>
__global__ void __launch_bounds__(kStateThreads)
state_kernel(const bf16* __restrict__ kt, const bf16* __restrict__ kl,
             const bf16* __restrict__ ul, const bf16* __restrict__ ull,
             const bf16* __restrict__ vb, const bf16* __restrict__ dout,
             const float* __restrict__ ebt, const ST* __restrict__ s0,
             const ST* __restrict__ dsf, bf16* __restrict__ states, bf16* __restrict__ states_lo,
             bf16* __restrict__ dstates, bf16* __restrict__ dstates_lo, float* __restrict__ dsgp,
             ST* __restrict__ ds0, int BH, int T, int nc, int DK, int DV) {
  extern __shared__ __align__(16) unsigned char smem[];
  state_walk<ST>(smem, kt, kl, ul, ull, vb, dout, ebt, s0, dsf, states, states_lo, dstates,
                 dstates_lo, dsgp, ds0, nullptr, BH, T, nc, DK, DV);
}

// ------------------------------------------------------------- dq and dk
// Shared memory of dqk_kernel after the value loop: the f32 u, k and bc of
// the key tile; dA in f32 and in two bf16 parts; the split-decay factors of
// G (k, 96 rows), then in the same bytes those of H (u, 96 rows), each in
// two bf16 parts. During the loop the same bytes hold two stages of its six
// bf16 tiles (do, v, and S and dS in two parts each). 110 KB: two blocks an
// SM.
constexpr int kDqkStage = 6 * kTileBytes;
constexpr int kDqkR1 = 3 * kFTileBytes;
constexpr int kDqkTail = kDqkR1 + kFTileBytes + 2 * kTileBytes + 2 * kPairBytes;
constexpr int kDqkSmem = 2 * kDqkStage > kDqkTail ? 2 * kDqkStage : kDqkTail;

// Row offsets in the factor buffers: G's factor of sub-chunk I (rows 0 ..
// 16 I - 1) starts at kx_row(I); H's of sub-chunk J (rows 16 (J+1) .. 63)
// at ux_row(J).
__device__ __forceinline__ int kx_row(int I) { return 8 * I * (I - 1); }
__device__ __forceinline__ int ux_row(int J) { return 8 * J * (7 - J); }

// G's (FOR_H false) or H's split-decay factors of one key tile, in two bf16
// parts (the rounded value into hi, the rest into lo): kx[s] = k_s
// e^{b_{16I-1} - b_s} for s < 16 I, or ux[t] = u_t e^{b_t - b_{16J+15}} for
// t >= 16 (J + 1) (RWKV: r_t e^{b_{t-1} - b_{16J+15}}, the readout's
// exclusive sum, still <= 0 as t - 1 >= 16J + 15). f32 inputs with row
// stride kLdF.
template <bool FOR_H, bool RWKV = false>
__device__ __forceinline__ void pair_factors(bf16* hi, bf16* lo, const float* fu,
                                             const float* fk, const float* fb) {
  for (int p = threadIdx.x; p < kPairRows * kTile; p += kGradThreads) {
    const int row = p / kTile, d = p % kTile;
    float x;
    if constexpr (FOR_H) {
      const int J = row < 48 ? 0 : row < 80 ? 1 : 2, t = row - ux_row(J) + kSub * (J + 1);
      x = fu[t * kLdF + d] *
          exp_le0(fb[(RWKV ? t - 1 : t) * kLdF + d] - fb[(kSub * J + kSub - 1) * kLdF + d]);
    } else {
      const int I = row < 16 ? 1 : row < 48 ? 2 : 3, s = row - kx_row(I);
      x = fk[s * kLdF + d] * exp_le0(fb[(kSub * I - 1) * kLdF + d] - fb[s * kLdF + d]);
    }
    const bf16 h = __float2bfloat16_rn(x);
    hi[row * kLd + d] = h;
    lo[row * kLd + d] = __float2bfloat16_rn(x - __bfloat162float(h));
  }
}

// The key tile's u, k and bc rows of chunk c into shared f32 (row stride
// kLdF), by a block of kGradThreads threads: 16 bytes a load, and the loads
// of half the tile in flight before any of them is stored, so that a block
// waits on two global-memory latencies a tile.
__device__ __forceinline__ void load_f32_tile(float* fu, float* fk, float* fb,
                                              const float* __restrict__ uf,
                                              const float* __restrict__ kf,
                                              const float* __restrict__ bcum, size_t row0,
                                              int DK, int d0) {
  constexpr int kQuads = kC * kTile / 4 / kGradThreads;  // 16-byte pieces a thread, of each
  constexpr int kHalf = kQuads / 2;
#pragma unroll
  for (int h = 0; h < kQuads; h += kHalf) {
    float4 a[kHalf], b[kHalf], c[kHalf];
#pragma unroll
    for (int i = 0; i < kHalf; ++i) {
      const int p = threadIdx.x + kGradThreads * (h + i);
      const size_t o = (row0 + p / (kTile / 4)) * DK + d0 + 4 * (p % (kTile / 4));
      a[i] = *reinterpret_cast<const float4*>(uf + o);
      b[i] = *reinterpret_cast<const float4*>(kf + o);
      c[i] = *reinterpret_cast<const float4*>(bcum + o);
    }
#pragma unroll
    for (int i = 0; i < kHalf; ++i) {
      const int p = threadIdx.x + kGradThreads * (h + i);
      const int at = (p / (kTile / 4)) * kLdF + 4 * (p % (kTile / 4));
      fu[at] = a[i].x, fu[at + 1] = a[i].y, fu[at + 2] = a[i].z, fu[at + 3] = a[i].w;
      fk[at] = b[i].x, fk[at + 1] = b[i].y, fk[at + 2] = b[i].z, fk[at + 3] = b[i].w;
      fb[at] = c[i].x, fb[at + 1] = c[i].y, fb[at + 2] = c[i].z, fb[at + 3] = c[i].w;
    }
  }
}

// The body of dqk_kernel (the caller's grid: (DK/64, nc, B*H), 256
// threads, shared memory kDqkSmem at smem): warp w holds rows 16 (w % 4) ..
// of the chunk and columns 32 (w / 4) .. of the key tile (dq, dk) or of the
// chunk (dA). dq, dk: (B*H, T, DK) f32. The last chunk's blocks write dsgp
// part ceil(DV/64), (B*H, DK): sum_t k_t e^{btot - bc_t} (v_t dsf^T) of
// their key tile. RWKV (RWKV6's backward, u = r, no scale): the readout
// side decays at the exclusive sum bx_t = b_{t-1}, and the pairs are strict,
// dq = e^{bx} (do S^T) + G with G[t] = sum_{s<t} dA[t,s] k_s e^{bx_t - b_s},
// dk = e^{btot - bc} (v dS^T) + H with H[s] = sum_{t>s} dA[t,s] r_t e^{bx_t
// - b_s}: the state and pair parts only, the bonus's parts left to the
// finishing pass; the key tile 0 blocks write dA's diagonal do_t . v_t to
// vdo (B*H, T) for it.
template <bool RWKV>
__device__ __forceinline__ void dqk_body(
    unsigned char* smem, const float* __restrict__ uf, const float* __restrict__ kf,
    const float* __restrict__ bcum, const bf16* __restrict__ vb, const bf16* __restrict__ dout,
    const bf16* __restrict__ states, const bf16* __restrict__ states_lo,
    const bf16* __restrict__ dstates, const bf16* __restrict__ dstates_lo,
    float* __restrict__ dq, float* __restrict__ dk, float* __restrict__ dsgp,
    float* __restrict__ vdo, int BH, int T, int nc, int DK, int DV, float scale) {
  __shared__ float kd_rows[4][kTile];  // the last chunk's sums of k . dk_inter per row band
  float* fu = reinterpret_cast<float*>(smem);
  float* fk = fu + kC * kLdF;
  float* fb = fk + kC * kLdF;
  float* daf = reinterpret_cast<float*>(smem + kDqkR1);
  bf16* dab = reinterpret_cast<bf16*>(daf + kC * kLdF);  // dA rounded
  bf16* dal = dab + kC * kLd;      // the rest of it
  bf16* fhi = dal + kC * kLd;      // a pair factor, rounded
  bf16* flo = fhi + kPairRows * kLd;  // the rest of it

  const int d0 = blockIdx.x * kTile, c = blockIdx.y, bh = blockIdx.z, Tp = nc * kC;
  const int warp = threadIdx.x >> 5, I = warp & 3, m0 = kSub * I, n0 = 32 * (warp >> 2);
  float M[4][4] = {}, Kd[4][4] = {}, dA[4][4] = {};
  const size_t at = ((size_t)bh * nc + c) * DK * DV;
  const bf16* sts[4] = {states + at, states_lo + at, dstates + at, dstates_lo + at};
  // stage b's tiles: do, v, S (two parts), dS (two parts) of one value
  // tile, 64 x 64 each
  const auto tile = [&](int b, int i) {
    return reinterpret_cast<bf16*>(smem + b * kDqkStage) + i * kC * kLd;
  };
  const auto stage = [&](int b, int c0) {  // one cp.async group
    for (int p = threadIdx.x; p < kC * 8; p += kGradThreads) {
      const int r = p >> 3, q = (p & 7) * 8, t = c * kC + r;
      const bool col = c0 + q < DV;
      copy16(tile(b, 0) + r * kLd + q, dout + ((size_t)bh * T + t) * DV + c0 + q, dout,
             col && t < T);
      copy16(tile(b, 1) + r * kLd + q, vb + ((size_t)bh * Tp + t) * DV + c0 + q, vb, col);
#pragma unroll
      for (int i = 0; i < 4; ++i)
        copy16(tile(b, 2 + i) + r * kLd + q, sts[i] + (size_t)(d0 + r) * DV + c0 + q, sts[i],
               col);
    }
    q8::cp_async_commit();
  };
  stage(0, 0);
  for (int c0 = 0, b = 0; c0 < DV; c0 += kTile, b ^= 1) {
    if (c0 + kTile < DV) {
      stage(b ^ 1, c0 + kTile);
    } else {
      q8::cp_async_commit();  // an empty group keeps the wait below the same
    }
    q8::cp_async_wait<1>();
    __syncthreads();  // this value tile has landed
    const bf16 *s_do = tile(b, 0), *s_v = tile(b, 1);
    mma_rows<false, false, 2>(M, s_do, kLd, tile(b, 2), kLd, m0, n0, kTile);  // do . S^T
    mma_rows<false, false, 2>(M, s_do, kLd, tile(b, 3), kLd, m0, n0, kTile);
    mma_rows<false, false, 2>(Kd, s_v, kLd, tile(b, 4), kLd, m0, n0, kTile);  // v . dS^T
    mma_rows<false, false, 2>(Kd, s_v, kLd, tile(b, 5), kLd, m0, n0, kTile);
    mma_rows<false, false, 2>(dA, s_do, kLd, s_v, kLd, m0, n0, kTile);        // do . v^T
    __syncthreads();  // the next stage overwrites b
  }
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = m0 + acc_row(e), s = n0 + 8 * j + acc_col(e);
      daf[r * kLdF + s] = dA[j][e];
      const bf16 hi = __float2bfloat16_rn(dA[j][e]);
      dab[r * kLd + s] = hi;
      dal[r * kLd + s] = __float2bfloat16_rn(dA[j][e] - __bfloat162float(hi));
    }
  load_f32_tile(fu, fk, fb, uf, kf, bcum, (size_t)bh * Tp + c * kC, DK, d0);
  __syncthreads();
  if constexpr (RWKV) {
    if (blockIdx.x == 0 && threadIdx.x < kC && c * kC + threadIdx.x < T)
      vdo[(size_t)bh * T + c * kC + threadIdx.x] = daf[threadIdx.x * (kLdF + 1)];
  }
  pair_factors<false>(fhi, flo, fu, fk, fb);
  __syncthreads();
  float G[4][4] = {}, Hs[4][4] = {};
  // G rows of sub-chunk I from the sub-chunks before it: dA[I, s] . kx, both
  // in two parts (the product of the two rests left out)
  if (I >= 1) {
    mma_rows<false, true, 2>(G, dab, kLd, fhi + kx_row(I) * kLd, kLd, m0, n0, kSub * I);
    mma_rows<false, true, 2>(G, dab, kLd, flo + kx_row(I) * kLd, kLd, m0, n0, kSub * I);
    mma_rows<false, true, 2>(G, dal, kLd, fhi + kx_row(I) * kLd, kLd, m0, n0, kSub * I);
  }
  __syncthreads();  // G's factors are read; H's take their place
  pair_factors<true, RWKV>(fhi, flo, fu, fk, fb);
  __syncthreads();
  // H rows of sub-chunk I from the sub-chunks after it: dA[t, I]^T . ux
  if (I <= 2) {
    const bf16* da_after = dab + kSub * (I + 1) * kLd;
    const bf16* dl_after = dal + kSub * (I + 1) * kLd;
    const int rows_after = kC - kSub * (I + 1);
    mma_rows<true, true, 2>(Hs, da_after, kLd, fhi + ux_row(I) * kLd, kLd, m0, n0, rows_after);
    mma_rows<true, true, 2>(Hs, da_after, kLd, flo + ux_row(I) * kLd, kLd, m0, n0, rows_after);
    mma_rows<true, true, 2>(Hs, dl_after, kLd, fhi + ux_row(I) * kLd, kLd, m0, n0, rows_after);
  }
  float kd[4][2] = {};  // k . dk_inter summed over the lane's two rows, per column
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = m0 + acc_row(e), d = n0 + 8 * j + acc_col(e);
      const float br = fb[r * kLdF + d];
      // the readout's decay: b_r, or RWKV's exclusive sum b_{r-1} (0 on row 0)
      const float bq = RWKV ? (r > 0 ? fb[(r - 1) * kLdF + d] : 0.f) : br;
      const float dk_inter = exp_le0(fb[(kC - 1) * kLdF + d] - br) * Kd[j][e];
      kd[j][e & 1] += fk[r * kLdF + d] * dk_inter;
      float gs = I >= 1 ? G[j][e] * exp_le0(bq - fb[(m0 - 1) * kLdF + d]) : 0.f;
      float hs = I <= 2 ? Hs[j][e] * exp_le0(fb[(m0 + kSub - 1) * kLdF + d] - br) : 0.f;
      if constexpr (RWKV) {
#pragma unroll 4
        for (int s = m0; s < m0 + kSub; ++s) {  // the diagonal block's strict pairs
          if (s == r) continue;
          // the pair (later row a, earlier row z) at e^{b_{a-1} - b_z}
          const int a = max(r, s), z = min(r, s);
          const float e_rs = exp_le0(fb[(a - 1) * kLdF + d] - fb[z * kLdF + d]);
          if (s < r) {
            gs += daf[r * kLdF + s] * fk[s * kLdF + d] * e_rs;
          } else {
            hs += daf[s * kLdF + r] * fu[s * kLdF + d] * e_rs;
          }
        }
      } else {
#pragma unroll 4
        for (int s = m0; s < m0 + kSub; ++s) {  // the diagonal block: e^{-|b_r - b_s|}
          const float e_rs = __expf(-fabsf(br - fb[s * kLdF + d]));
          if (s <= r) gs += daf[r * kLdF + s] * fk[s * kLdF + d] * e_rs;
          if (s >= r) hs += daf[s * kLdF + r] * fu[s * kLdF + d] * e_rs;
        }
      }
      const int t = c * kC + r;
      if (t < T) {
        const size_t o = ((size_t)bh * T + t) * DK + d0 + d;
        dq[o] = RWKV ? __expf(bq) * M[j][e] + gs : scale * (__expf(br) * M[j][e] + gs);
        dk[o] = dk_inter + hs;
      }
    }
  if (c != nc - 1) return;
  // sum over the chunk's rows (padding rows have k = 0): the lanes of one
  // column, then the four row bands in a fixed order
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      float v = kd[j][e];
      v += __shfl_xor_sync(0xffffffffu, v, 4);
      v += __shfl_xor_sync(0xffffffffu, v, 8);
      v += __shfl_xor_sync(0xffffffffu, v, 16);
      if ((threadIdx.x & 31) < 4) kd_rows[I][n0 + 8 * j + acc_col(e)] = v;
    }
  __syncthreads();
  if (threadIdx.x < kTile) {
    const int v_tiles = (DV + kTile - 1) / kTile;
    dsgp[((size_t)v_tiles * BH + bh) * DK + d0 + threadIdx.x] =
        kd_rows[0][threadIdx.x] + kd_rows[1][threadIdx.x] + kd_rows[2][threadIdx.x] +
        kd_rows[3][threadIdx.x];
  }
}

// grid (DK/64, nc, B*H), 256 threads, shared memory kDqkSmem: dqk_body for
// GLA. (This kernel and dv_kernel are templates so that more than one
// source may include this header.)
template <int = 0>
__global__ void __launch_bounds__(kGradThreads, 2)
dqk_kernel(const float* __restrict__ uf, const float* __restrict__ kf,
           const float* __restrict__ bcum, const bf16* __restrict__ vb,
           const bf16* __restrict__ dout, const bf16* __restrict__ states,
           const bf16* __restrict__ states_lo, const bf16* __restrict__ dstates,
           const bf16* __restrict__ dstates_lo, float* __restrict__ dq, float* __restrict__ dk,
           float* __restrict__ dsgp, int BH, int T, int nc, int DK, int DV, float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  dqk_body<false>(smem, uf, kf, bcum, vb, dout, states, states_lo, dstates, dstates_lo, dq, dk,
                  dsgp, nullptr, BH, T, nc, DK, DV, scale);
}

// -------------------------------------------------------------------- dv
// the bonus of a key tile, after Scores' factors kx (RWKV)
constexpr int kBonusBytes = kTile * 4;

// Shared memory of dv_kernel: A (bf16); then phase 1 (A): the key tile's
// f32 u, k, bc, A's left factor ua and the factors kx; in their place phase
// 2 (dv): a value tile of dS ([key][value]) and of do, and the decayed k of
// every key channel ([s][key], row stride DK + 8). 89 KB at DK 256: two
// blocks an SM. ``two`` (RWKV6's dv_body): A, dS and the decayed k each in
// two bf16 parts, and the bonus in phase 1: 165 KB at DK 256, one block an
// SM.
inline int dv_smem_bytes(int DK, bool two = false) {
  const int parts = two ? 2 : 1;
  const int phase1 = 3 * kFTileBytes + kTileBytes + kPairBytes + (two ? kBonusBytes : 0);
  const int phase2 = parts * DK * kLd * 2 + kTileBytes + parts * kC * (DK + 8) * 2;
  return parts * kTileBytes + (phase1 > phase2 ? phase1 : phase2);
}

// the 544 pairs (t, s), s <= t, within one sub-chunk
constexpr int kDiagPairs = (kC / kSub) * kSub * (kSub + 1) / 2;
constexpr int kPairsPerThread = (kDiagPairs + kGradThreads - 1) / kGradThreads;

// The score matrix A[t, s] = sum_d u_t k_s e^{b_t - b_s} (s <= t) of one
// chunk, by the 256 threads of a block: warp w takes rows 16 (w % 4) .. and
// columns 32 (w / 4) .. of A's products below the diagonal blocks; thread i
// the diagonal pairs (t, s) = (pt, ps) (in sub-chunk p / 136, s <= t) of
// pair index p = i, i + 256, i + 512. RWKV: RWKV6's scores, the readout
// side decayed at the exclusive sum bx_t = b_{t-1}: A[t, s] = sum_d u_t k_s
// e^{b_{t-1} - b_s} for s < t (still <= 0 in every exponent, the split's
// too) and A[t, t] = sum_d u_t bonus_d k_t.
template <bool RWKV = false>
struct Scores {
  int pt[kPairsPerThread], ps[kPairsPerThread];  // pt -1: no pair
  float pa[kPairsPerThread] = {};                // the diagonal pairs' sums
  float A[4][4] = {};                            // the warp's products

  __device__ __forceinline__ Scores() {
#pragma unroll
    for (int i = 0; i < kPairsPerThread; ++i) {
      const int p = threadIdx.x + kGradThreads * i;
      int q = p % (kSub * (kSub + 1) / 2), tl = 0;
      while (q > tl) q -= ++tl;
      pt[i] = p < kDiagPairs ? kSub * (p / (kSub * (kSub + 1) / 2)) + tl : -1;
      ps[i] = pt[i] - tl + q;
    }
  }

  // Adds the key tile d0 .. d0 + 63 of the chunk's rows row0 .. row0 + 63.
  // r1 holds the tile's f32 u, k, bc, A's left factor ua and the factors kx
  // meanwhile (3 kFTileBytes + kTileBytes + kPairBytes; RWKV: kBonusBytes
  // more, the tile's bonus). bonus: RWKV's bonus of the head (DK f32), else
  // unused.
  __device__ __forceinline__ void add_tile(unsigned char* r1, const float* __restrict__ uf,
                                           const float* __restrict__ kf,
                                           const float* __restrict__ bcum, size_t row0, int DK,
                                           int d0, const float* __restrict__ bonus = nullptr) {
    float* fu = reinterpret_cast<float*>(r1);
    float* fk = fu + kC * kLdF;
    float* fb = fk + kC * kLdF;
    bf16* ua = reinterpret_cast<bf16*>(fb + kC * kLdF);
    bf16* kx = ua + kC * kLd;
    float* fub = reinterpret_cast<float*>(kx + kPairRows * kLd);  // RWKV: the tile's bonus
    const int warp = threadIdx.x >> 5, I = warp & 3, m0 = kSub * I, n0 = 32 * (warp >> 2);
    __syncthreads();  // the previous key tile's products are done
    load_f32_tile(fu, fk, fb, uf, kf, bcum, row0, DK, d0);
    if constexpr (RWKV) {
      if (threadIdx.x < kTile) fub[threadIdx.x] = bonus[d0 + threadIdx.x];
    }
    __syncthreads();
    for (int p = threadIdx.x; p < kPairRows * kTile; p += kGradThreads) {
      const int row = p / kTile, d = p % kTile;
      const int J = row < 16 ? 1 : row < 48 ? 2 : 3, s = row - kx_row(J);
      kx[row * kLd + d] = __float2bfloat16_rn(
          fk[s * kLdF + d] * exp_le0(fb[(kSub * J - 1) * kLdF + d] - fb[s * kLdF + d]));
      if (row < kC) {  // A's left factor: u_t e^{b_t - b_r}, r the row before t's sub-chunk
        const int r = kSub * (row / kSub) - 1;  // (RWKV: b_{t-1} for b_t)
        ua[row * kLd + d] = __float2bfloat16_rn(
            r < 0 ? 0.f
                  : fu[row * kLdF + d] *
                        exp_le0(fb[(RWKV ? row - 1 : row) * kLdF + d] - fb[r * kLdF + d]));
      }
    }
#pragma unroll
    for (int i = 0; i < kPairsPerThread; ++i) {
      if (pt[i] < 0) continue;
      // RWKV: the diagonal takes the bonus in the decay's place (its decay
      // row is then its own: every lane of a warp runs the same loop)
      const bool bonus_pair = RWKV && pt[i] == ps[i];
      const float* u = fu + pt[i] * kLdF;
      const float* k = fk + ps[i] * kLdF;
      const float* bt = fb + (RWKV && !bonus_pair ? pt[i] - 1 : pt[i]) * kLdF;
      const float* bs = fb + ps[i] * kLdF;
      float sum = 0.f;
      for (int d = 0; d < kTile; ++d) {
        float e = exp_le0(bt[d] - bs[d]);
        if constexpr (RWKV) e = bonus_pair ? fub[d] : e;
        sum += u[d] * k[d] * e;
      }
      pa[i] += sum;
    }
    __syncthreads();
    // A[t, s] for s in the sub-chunks before t's: ua . kx^T, column pairs
    // below 16 I only
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      if (n0 + 16 * j >= m0) continue;
      float part[2][4] = {};
      mma_rows<false, false, 1>(part, ua, kLd, kx + kx_row(I) * kLd, kLd, m0, n0 + 16 * j,
                                kTile);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        A[2 * j][e] += part[0][e];
        A[2 * j + 1][e] += part[1][e];
      }
    }
  }

  // A into out (64 x 64, row stride ld, bf16 or f32), zeros for s > t. The
  // block's threads must be past their reads of out's bytes; out is
  // complete after the caller's next __syncthreads.
  template <typename E>
  __device__ __forceinline__ void store(E* out, int ld) const {
    const int warp = threadIdx.x >> 5, m0 = kSub * (warp & 3), n0 = 32 * (warp >> 2);
    __syncthreads();
    for (int p = threadIdx.x; p < kC * kC; p += kGradThreads)
      out[(p / kC) * ld + p % kC] = from_f<E>(0.f);
    __syncthreads();
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = m0 + acc_row(e), s = n0 + 8 * j + acc_col(e);
        if (s < m0) out[r * ld + s] = from_f<E>(A[j][e]);
      }
#pragma unroll
    for (int i = 0; i < kPairsPerThread; ++i)
      if (pt[i] >= 0) out[pt[i] * ld + ps[i]] = from_f<E>(pa[i]);
  }

  // A into hi and lo (64 x 64 bf16 each, row stride ld) as two parts, the
  // rounded value and the rest, zeros for s > t; as store takes it.
  __device__ __forceinline__ void store_parts(bf16* hi, bf16* lo, int ld) const {
    const int warp = threadIdx.x >> 5, m0 = kSub * (warp & 3), n0 = 32 * (warp >> 2);
    const auto put = [&](int at, float x) {
      const bf16 h = __float2bfloat16_rn(x);
      hi[at] = h;
      lo[at] = __float2bfloat16_rn(x - __bfloat162float(h));
    };
    __syncthreads();
    for (int p = threadIdx.x; p < kC * kC; p += kGradThreads) put((p / kC) * ld + p % kC, 0.f);
    __syncthreads();
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = m0 + acc_row(e), s = n0 + 8 * j + acc_col(e);
        if (s < m0) put(r * ld + s, A[j][e]);
      }
#pragma unroll
    for (int i = 0; i < kPairsPerThread; ++i)
      if (pt[i] >= 0) put(pt[i] * ld + ps[i], pa[i]);
  }
};

// A of the chunk's rows row0 .. row0 + 63 summed over the DK key channels,
// into s_a in bf16 (row stride kLd); r1 as Scores::add_tile takes it, free
// again when this returns. s_a is complete after the caller's next
// __syncthreads. RWKV: RWKV6's scores with the head's bonus.
template <bool RWKV = false>
__device__ __forceinline__ void chunk_scores(bf16* s_a, unsigned char* r1,
                                             const float* __restrict__ uf,
                                             const float* __restrict__ kf,
                                             const float* __restrict__ bcum, size_t row0,
                                             int DK, const float* __restrict__ bonus = nullptr) {
  Scores<RWKV> sc;
  for (int d0 = 0; d0 < DK; d0 += kTile) sc.add_tile(r1, uf, kf, bcum, row0, DK, d0, bonus);
  sc.store(s_a, kLd);
}

// The body of dv_kernel (the caller's grid: (nc, B*H), 256 threads, shared
// memory dv_smem_bytes(DK, RWKV) at smem): warp w holds rows 16 (w % 4) ..
// of the chunk and columns 32 (w / 4) .. of A or of a value tile. dvo:
// (B*H, T, DV) in f32 or bf16. RWKV: A is RWKV6's scores (Scores<true>)
// with the bonus of head bh % H from bonus (H, DK), and the two products
// take their operands in two bf16 parts, A, dS (dstates + dstates_lo) and
// the decayed k (kt + kl), three mma a k-step for (k e^{btot - bc}) dS and
// two for A^T do: RWKV6's dv enters the layers below through dense
// products, so it is kept within half a bf16 step of f32, as the recurrent
// sweeps keep it (kl and dstates_lo unused otherwise).
template <typename O, bool RWKV>
__device__ __forceinline__ void dv_body(unsigned char* smem, const float* __restrict__ uf,
                                        const float* __restrict__ kf,
                                        const float* __restrict__ bcum,
                                        const bf16* __restrict__ kt,
                                        const bf16* __restrict__ kl,
                                        const bf16* __restrict__ dout,
                                        const bf16* __restrict__ dstates,
                                        const bf16* __restrict__ dstates_lo,
                                        const float* __restrict__ bonus, O* __restrict__ dvo,
                                        int T, int nc, int H, int DK, int DV) {
  const int ldk = DK + 8, parts = RWKV ? 2 : 1;
  bf16* s_a = reinterpret_cast<bf16*>(smem);
  bf16* s_al = s_a + kC * kLd;  // RWKV: A's rest
  unsigned char* r1 = reinterpret_cast<unsigned char*>(s_a + parts * kC * kLd);
  bf16* s_ds = reinterpret_cast<bf16*>(r1);
  bf16* s_dsl = s_ds + DK * kLd;  // RWKV: dS's rest
  bf16* s_do = s_ds + parts * DK * kLd;
  bf16* s_kt = s_do + kC * kLd;
  bf16* s_kl = s_kt + kC * ldk;  // RWKV: the decayed k's rest

  const int c = blockIdx.x, bh = blockIdx.y, Tp = nc * kC;
  const int warp = threadIdx.x >> 5, m0 = kSub * (warp & 3), n0 = 32 * (warp >> 2);
  const size_t row0 = (size_t)bh * Tp + c * kC;
  if constexpr (RWKV) {
    Scores<true> sc;
    for (int d0 = 0; d0 < DK; d0 += kTile)
      sc.add_tile(r1, uf, kf, bcum, row0, DK, d0, bonus + (size_t)(bh % H) * DK);
    sc.store_parts(s_a, s_al, kLd);
  } else {
    chunk_scores(s_a, r1, uf, kf, bcum, row0, DK);
  }
  for (int p = threadIdx.x; p < kC * DK / 8; p += kGradThreads) {
    const int r = p / (DK / 8), q = (p % (DK / 8)) * 8;
    copy16(s_kt + r * ldk + q, kt + (row0 + r) * DK + q, kt, true);
    if constexpr (RWKV) copy16(s_kl + r * ldk + q, kl + (row0 + r) * DK + q, kl, true);
  }
  for (int c0 = 0; c0 < DV; c0 += kTile) {
    __syncthreads();  // A is written; the previous value tile's products are done
    const size_t at = ((size_t)bh * nc + c) * DK * DV + c0;
    for (int p = threadIdx.x; p < DK * 8; p += kGradThreads) {
      const int r = p >> 3, q = (p & 7) * 8;
      copy16(s_ds + r * kLd + q, dstates + at + (size_t)r * DV + q, dstates, c0 + q < DV);
      if constexpr (RWKV)
        copy16(s_dsl + r * kLd + q, dstates_lo + at + (size_t)r * DV + q, dstates_lo,
               c0 + q < DV);
    }
    for (int p = threadIdx.x; p < kC * 8; p += kGradThreads) {
      const int r = p >> 3, q = (p & 7) * 8, t = c * kC + r;
      copy16(s_do + r * kLd + q, dout + ((size_t)bh * T + t) * DV + c0 + q, dout,
             c0 + q < DV && t < T);
    }
    q8::cp_async_commit();
    q8::cp_async_wait<0>();
    __syncthreads();
    float acc[4][4] = {};
    mma_rows<false, true, 2>(acc, s_kt, ldk, s_ds, kLd, m0, n0, DK);  // (k e^{btot-bc}) . dS
    if constexpr (RWKV) {
      mma_rows<false, true, 2>(acc, s_kl, ldk, s_ds, kLd, m0, n0, DK);
      mma_rows<false, true, 2>(acc, s_kt, ldk, s_dsl, kLd, m0, n0, DK);
    }
    mma_rows<true, true, 2>(acc, s_a, kLd, s_do, kLd, m0, n0, kC);  // A^T . do
    if constexpr (RWKV) mma_rows<true, true, 2>(acc, s_al, kLd, s_do, kLd, m0, n0, kC);
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = m0 + acc_row(e), col = c0 + n0 + 8 * j + acc_col(e), t = c * kC + r;
        if (t < T && col < DV) dvo[((size_t)bh * T + t) * DV + col] = from_f<O>(acc[j][e]);
      }
  }
}

// grid (nc, B*H), 256 threads, shared memory dv_smem_bytes(DK): dv_body for
// GLA.
template <typename O>
__global__ void __launch_bounds__(kGradThreads, 2)
dv_kernel(const float* __restrict__ uf, const float* __restrict__ kf,
          const float* __restrict__ bcum, const bf16* __restrict__ kt,
          const bf16* __restrict__ dout, const bf16* __restrict__ dstates,
          O* __restrict__ dvo, int T, int nc, int DK, int DV) {
  extern __shared__ __align__(16) unsigned char smem[];
  dv_body<O, false>(smem, uf, kf, bcum, kt, nullptr, dout, dstates, nullptr, nullptr, dvo, T, nc,
                    1, DK, DV);
}

template <typename K>
int allow_smem(K kernel, int bytes) {
  return static_cast<int>(
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes));
}

// Launches kernels 1-4 of the chunked route, with (CONV) or without the
// convs (wq, wk, wv then null); returns the first error that is not 0.
// Scratch as ops/gla_cuda.py:gla_chunk_conv_bwd and gla_chunk_bwd allocate
// it; dvo is f32 with the convs (the finishing pass's input), else the
// output dv in bf16.
template <typename ST, bool CONV, typename DVO>
int launch_chunked(const bf16* xq, const bf16* xk, const bf16* xv, const float* gk,
                   const bf16* wq, const bf16* wk, const bf16* wv, const ST* s0, const bf16* dout,
                   const ST* dsf, ST* ds0, float* dq, float* dk, float* dsgp, DVO* dvo,
                   float* uf, float* kf, float* bcum, bf16* kt, bf16* kl, bf16* ul, bf16* ull,
                   bf16* states, bf16* states_lo, bf16* dstates, bf16* dstates_lo, bf16* vb,
                   float* ebt, int B, int H, int T, int DK, int DV, float scale,
                   cudaStream_t stream) {
  const int nc = (T + kC - 1) / kC, BH = B * H, v_tiles = (DV + kTile - 1) / kTile;
  prep_kernel<bf16, CONV><<<dim3(nc, BH, DK / kTile + v_tiles), kTile, 0, stream>>>(
      xq, xk, xv, gk, wq, wk, wv, uf, kf, bcum, kt, kl, ul, ull, vb, ebt, H, T, DK, DV, scale);
  int err = static_cast<int>(cudaGetLastError());
  if (err) return err;
  if ((err = allow_smem(state_kernel<ST>, kStateSmem))) return err;
  state_kernel<ST><<<dim3(v_tiles, DK / kTile, 2 * BH), kStateThreads, kStateSmem, stream>>>(
      kt, kl, ul, ull, vb, dout, ebt, s0, dsf, states, states_lo, dstates, dstates_lo, dsgp, ds0,
      BH, T, nc, DK, DV);
  if ((err = static_cast<int>(cudaGetLastError()))) return err;
  if ((err = allow_smem(dqk_kernel<>, kDqkSmem))) return err;
  dqk_kernel<><<<dim3(DK / kTile, nc, BH), kGradThreads, kDqkSmem, stream>>>(
      uf, kf, bcum, vb, dout, states, states_lo, dstates, dstates_lo, dq, dk, dsgp, BH, T, nc, DK,
      DV, scale);
  if ((err = static_cast<int>(cudaGetLastError()))) return err;
  const int dv_smem = dv_smem_bytes(DK);
  if ((err = allow_smem(dv_kernel<DVO>, dv_smem))) return err;
  dv_kernel<DVO><<<dim3(nc, BH), kGradThreads, dv_smem, stream>>>(uf, kf, bcum, kt, dout,
                                                                 dstates, dvo, T, nc, DK, DV);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace chunked
}  // namespace gla
