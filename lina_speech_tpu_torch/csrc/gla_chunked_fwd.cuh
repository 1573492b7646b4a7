// The chunked route of the GLA forward, for bf16 IO, with (CONV) or without
// the q/k/v short convs: the recurrent walk of gla_chunk.cuh (one dependent
// rank-1 update per token on the CUDA cores) replaced by 64-row chunks whose
// products run on the tensor cores (mma.sync m16n8k16, bf16 operands, f32
// sums), as the TPU kernels walk 64-128-row chunks with MXU products
// (lina_speech_tpu/ops/gla_pallas.py:108 _fwd_math; conv body
// _conv_fwd_kernel :804). The plain version of the same decomposition is
// ops/gla_cuda.py:gla_chunk_conv_chunked_plain (gla_chunk_chunked_plain
// without the convs).
//
// Per (batch, head), u = scale q, chunk c of rows t, bc the in-chunk
// inclusive sums of the gates g <= 0 and btot their total (a ragged last
// chunk is padded with zero inputs and zero gates):
//
// 1. prep_kernel: chunked::prep_rows (gla_chunked_bwd.cuh), the backward's
//    prep, which here also writes the low part of the decayed key;
// 2. state_kernel: the backward's forward walk (chunked::state_walk): a
//    block holds a 64 x 64 f32 tile of S in its mma accumulators and walks
//    the chunks from s0, S <- e^{btot} S + (k e^{btot - bc})^T v, storing
//    each chunk's start state in bf16 and, after the last chunk, the final
//    state in the state dtype (round to nearest even);
// 3. scores_kernel, parallel over (chunk, batch*head, key tile): the key
//    tile's part of A[t,s] = sum_d u_t k_s e^{b_t - b_s} (s <= t), formed as
//    the backward's dv_kernel forms A (chunked::Scores: 16-row sub-chunks,
//    the decay split at a row between two of them so that both exponents
//    are <= 0, the diagonal blocks elementwise in f32), in f32;
// 4. out_kernel, parallel over (chunk, batch*head, value-tile group): A as
//    the parts' sum in key-tile order, then o = (u e^{bc}) S_start + A v for
//    each value tile, written in the IO dtype. Where the (chunk,
//    batch*head) blocks fill the card, out_kernel<FUSED> forms A itself, in
//    the same order, and scores_kernel is not launched.
//
// Rounding: every product operand is bf16 (u e^{bc}, the chunk states, A
// and v), as the TPU kernel rounds to its IO dtype, save one: the decayed
// key of the state update goes in as two bf16 parts, its rounded value and
// the rest, two mma a k-step: rounded once, as the TPU rounds it, it moves
// an f32 final state by more than an f32 state is held to
// (tests/test_torch_chunk_fwd.py: test_two_part_key_keeps_an_f32_final_state).
//
// What bounds it on the H100: memory traffic and latency, not the products
// (b8 h4 t512 dk256 dv512: 10 GFLOP, 10 us at the bf16 peak). The chunk
// states (b*h*nc*dk*dv bf16, 67 MB at b8 t512, written once and read once)
// and the f32 operands of A are most of the bytes; the state sweep is nc
// dependent steps a block. Against them: the sweep loads the next chunk
// while this chunk's products run and writes the states through shared
// memory, 16 bytes a thread. A's diagonal blocks are elementwise work on
// the CUDA cores (34,816 exponentials a chunk and key tile), bound by
// instruction issue: where b*h*nc blocks would leave SMs idle (b1), each
// key tile's part is formed in a block of its own, spread over DK/64 times
// the SMs and formed once rather than once for every block of value tiles,
// which then split over more blocks; out_kernel fits two blocks an SM. The
// route is chosen in Python (ops/gla_cuda.py:gla_chunk_fwd_plan); short
// inputs keep the recurrent body, whose one launch costs less than these.
//
// RWKV6's forward (rwkv6_chunked_fwd.cuh) walks the chunks with the same
// prep, state walk, scores and output bodies, with RWKV set: r in u's place
// (no scale), the readout decayed at the exclusive gate sum, and the bonus
// on A's diagonal.
#pragma once

#include "gla_chunked_bwd.cuh"

namespace gla {
namespace chunked_fwd {

using chunked::bf16;
using chunked::kC;
using chunked::kLd;
using chunked::kStateThreads;
using chunked::kTile;
using chunked::kGradThreads;

// grid (nc, B*H, DK/64 + ceil(DV/64)), 64 threads: chunked::prep_rows with
// the low part of the decayed key.
template <bool CONV>
__global__ void __launch_bounds__(kTile)
prep_kernel(const bf16* __restrict__ xq, const bf16* __restrict__ xk,
            const bf16* __restrict__ xv, const float* __restrict__ gk,
            const bf16* __restrict__ wq, const bf16* __restrict__ wk,
            const bf16* __restrict__ wv, float* __restrict__ uf, float* __restrict__ kf,
            float* __restrict__ bc, bf16* __restrict__ kt, bf16* __restrict__ kl,
            bf16* __restrict__ ul, bf16* __restrict__ vb, float* __restrict__ ebt, int H, int T,
            int DK, int DV, float scale) {
  chunked::prep_rows<bf16, CONV>(xq, xk, xv, gk, wq, wk, wv, uf, kf, bc, kt, kl, ul, nullptr, vb,
                                 ebt, H, T, DK, DV, scale);
}

// grid (ceil(DV/64), DK/64, B*H), 128 threads, shared memory
// chunked::kStateSmem: the forward walk of chunked::state_walk, the
// backward's, from s0 (null: zeros), each chunk's start state to states
// (B*H, nc, DK, DV) bf16 and the final state to sf (B*H, DK, DV).
template <typename ST>
__global__ void __launch_bounds__(kStateThreads)
state_kernel(const bf16* __restrict__ kt, const bf16* __restrict__ kl,
             const bf16* __restrict__ vb, const float* __restrict__ ebt,
             const ST* __restrict__ s0, bf16* __restrict__ states, ST* __restrict__ sf, int BH,
             int T, int nc, int DK, int DV) {
  extern __shared__ __align__(16) unsigned char smem[];
  chunked::state_walk<ST>(smem, kt, kl, nullptr, nullptr, vb, nullptr, ebt, s0, nullptr, states,
                          nullptr, nullptr, nullptr, nullptr, nullptr, sf, BH, T, nc, DK, DV);
}

// grid (nc, B*H, DK/64), 256 threads: one key tile's part of the chunk's
// score matrix A (chunked::Scores), written in f32 with zeros above the
// diagonal to ap (B*H, nc, DK/64, 64, 64). Shared memory as Scores::add_tile
// takes it, the part leaving through its first 16 KB (RWKV6's scores_kernel,
// rwkv6_chunked_fwd.cuh, kBonusBytes more).
constexpr int kScoresSmem = 3 * chunked::kFTileBytes + chunked::kTileBytes + chunked::kPairBytes;

// The body of scores_kernel; RWKV: RWKV6's scores, the bonus of head bh % H
// from bonus (H, DK).
template <bool RWKV>
__device__ __forceinline__ void scores_body(unsigned char* smem, const float* __restrict__ uf,
                                            const float* __restrict__ kf,
                                            const float* __restrict__ bcum,
                                            const float* __restrict__ bonus,
                                            float* __restrict__ ap, int nc, int H, int DK) {
  const int c = blockIdx.x, bh = blockIdx.y, Tp = nc * kC;
  chunked::Scores<RWKV> sc;
  sc.add_tile(smem, uf, kf, bcum, (size_t)bh * Tp + c * kC, DK, kTile * blockIdx.z,
              RWKV ? bonus + (size_t)(bh % H) * DK : nullptr);
  float* part = reinterpret_cast<float*>(smem);
  sc.store(part, chunked::kLdF);
  __syncthreads();
  float* out = ap + (((size_t)bh * nc + c) * gridDim.z + blockIdx.z) * kC * kC;
  for (int p = threadIdx.x; p < kC * kC; p += kGradThreads)
    out[p] = part[(p / kC) * chunked::kLdF + p % kC];
}

template <int = 0>
__global__ void __launch_bounds__(kGradThreads, 2)
scores_kernel(const float* __restrict__ uf, const float* __restrict__ kf,
              const float* __restrict__ bcum, float* __restrict__ ap, int nc, int DK) {
  extern __shared__ __align__(16) unsigned char smem[];
  scores_body<false>(smem, uf, kf, bcum, nullptr, ap, nc, 1, DK);
}

// grid (nc, B*H, split), 256 threads: warp w holds rows 16 (w % 4) .. of the
// chunk and columns 32 (w / 4) .. of a value tile; block z takes the value
// tiles z, z + split, ... A, rounded to bf16, is the sum of scores_kernel's
// parts ap over the key tiles in their order, or with FUSED the same sum
// formed in the block (chunked::chunk_scores, its scratch where the value
// tiles go later). o: (B*H, T, DV) bf16. Shared memory: A, a value tile of v
// and of the chunk's start state ([key][value]), and u e^{bc} of every key
// channel ([t][key], row stride DK + 8), the layout of the backward's
// dv_kernel (chunked::dv_smem_bytes: 89 KB at DK 256, two blocks an SM;
// RWKV6's out_kernel, rwkv6_chunked_fwd.cuh, kBonusBytes more). The body of
// out_kernel, RWKV as scores_body takes it.
template <bool FUSED, bool RWKV>
__device__ __forceinline__ void out_body(unsigned char* smem, const float* __restrict__ uf,
                                         const float* __restrict__ kf,
                                         const float* __restrict__ bcum,
                                         const float* __restrict__ bonus,
                                         const float* __restrict__ ap,
                                         const bf16* __restrict__ ul, const bf16* __restrict__ vb,
                                         const bf16* __restrict__ states, bf16* __restrict__ o,
                                         int T, int nc, int H, int DK, int DV) {
  const int ldk = DK + 8;
  bf16* s_a = reinterpret_cast<bf16*>(smem);
  bf16* s_v = s_a + kC * kLd;
  bf16* s_s = s_v + kC * kLd;
  bf16* s_ul = s_s + DK * kLd;

  const int c = blockIdx.x, bh = blockIdx.y, Tp = nc * kC, key_tiles = DK / kTile;
  const int warp = threadIdx.x >> 5, m0 = chunked::kSub * (warp & 3), n0 = 32 * (warp >> 2);
  const size_t row0 = (size_t)bh * Tp + c * kC;
  if constexpr (FUSED)
    chunked::chunk_scores<RWKV>(s_a, reinterpret_cast<unsigned char*>(s_v), uf, kf, bcum, row0,
                                DK, RWKV ? bonus + (size_t)(bh % H) * DK : nullptr);
  for (int p = threadIdx.x; p < kC * DK / 8; p += kGradThreads) {
    const int r = p / (DK / 8), q = (p % (DK / 8)) * 8;
    chunked::copy16(s_ul + r * ldk + q, ul + (row0 + r) * DK + q, ul, true);
  }
  if constexpr (!FUSED) {
    const float* parts = ap + ((size_t)bh * nc + c) * key_tiles * kC * kC;
    for (int p = threadIdx.x; p < kC * kC; p += kGradThreads) {
      float a = 0.f;
      for (int z = 0; z < key_tiles; ++z) a += parts[(size_t)z * kC * kC + p];
      s_a[(p / kC) * kLd + p % kC] = __float2bfloat16_rn(a);
    }
  }
  const bf16* st = states + ((size_t)bh * nc + c) * DK * DV;
  for (int c0 = kTile * blockIdx.z; c0 < DV; c0 += kTile * gridDim.z) {
    __syncthreads();  // A is written; the previous value tile's products are done
    for (int p = threadIdx.x; p < DK * 8; p += kGradThreads) {
      const int r = p >> 3, q = (p & 7) * 8;
      chunked::copy16(s_s + r * kLd + q, st + (size_t)r * DV + c0 + q, states, c0 + q < DV);
    }
    for (int p = threadIdx.x; p < kC * 8; p += kGradThreads) {
      const int r = p >> 3, q = (p & 7) * 8;
      chunked::copy16(s_v + r * kLd + q, vb + (row0 + r) * DV + c0 + q, vb, c0 + q < DV);
    }
    q8::cp_async_commit();
    q8::cp_async_wait<0>();
    __syncthreads();
    float acc[4][4] = {};
    chunked::mma_rows<false, true, 2>(acc, s_ul, ldk, s_s, kLd, m0, n0, DK);  // (u e^{bc}) . S
    chunked::mma_rows<false, true, 2>(acc, s_a, kLd, s_v, kLd, m0, n0, kC);   // A . v
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int r = m0 + chunked::acc_row(2 * hh), t = c * kC + r;
        const int col = c0 + n0 + 8 * j + chunked::acc_col(0);
        if (t < T && col < DV)
          *reinterpret_cast<__nv_bfloat162*>(o + ((size_t)bh * T + t) * DV + col) =
              __floats2bfloat162_rn(acc[j][2 * hh], acc[j][2 * hh + 1]);
      }
  }
}

template <bool FUSED>
__global__ void __launch_bounds__(kGradThreads, 2)
out_kernel(const float* __restrict__ uf, const float* __restrict__ kf,
           const float* __restrict__ bcum, const float* __restrict__ ap,
           const bf16* __restrict__ ul, const bf16* __restrict__ vb,
           const bf16* __restrict__ states, bf16* __restrict__ o, int T, int nc, int DK,
           int DV) {
  extern __shared__ __align__(16) unsigned char smem[];
  out_body<FUSED, false>(smem, uf, kf, bcum, nullptr, ap, ul, vb, states, o, T, nc, 1, DK, DV);
}

// Launches kernels 1-4 (3 where out_kernel forms A itself); returns the
// first error that is not 0. Scratch as
// ops/gla_cuda.py:_chunked_fwd_sizes lays it out. split: out_kernel's
// value-tile groups (ops/gla_cuda.py:fwd_out_split): 1 forms A once in each
// (chunk, batch*head) block, ap unused; more sums A from each key tile's
// part in ap, written by scores_kernel, and spreads the value tiles over
// split blocks.
template <typename ST, bool CONV>
int launch(const bf16* xq, const bf16* xk, const bf16* xv, const float* gk, const bf16* wq,
           const bf16* wk, const bf16* wv, const ST* s0, bf16* o, ST* sf, float* uf, float* kf,
           float* bcum, bf16* kt, bf16* kl, bf16* ul, bf16* states, bf16* vb, float* ebt,
           float* ap, int B, int H, int T, int DK, int DV, float scale, int split,
           cudaStream_t stream) {
  const int nc = (T + kC - 1) / kC, BH = B * H, v_tiles = (DV + kTile - 1) / kTile;
  prep_kernel<CONV><<<dim3(nc, BH, DK / kTile + v_tiles), kTile, 0, stream>>>(
      xq, xk, xv, gk, wq, wk, wv, uf, kf, bcum, kt, kl, ul, vb, ebt, H, T, DK, DV, scale);
  int err = static_cast<int>(cudaGetLastError());
  if (err) return err;
  if ((err = chunked::allow_smem(state_kernel<ST>, chunked::kStateSmem))) return err;
  state_kernel<ST><<<dim3(v_tiles, DK / kTile, BH), kStateThreads, chunked::kStateSmem,
                     stream>>>(kt, kl, vb, ebt, s0, states, sf, BH, T, nc, DK, DV);
  if ((err = static_cast<int>(cudaGetLastError()))) return err;
  const int smem = chunked::dv_smem_bytes(DK);
  if (split == 1) {
    if ((err = chunked::allow_smem(out_kernel<true>, smem))) return err;
    out_kernel<true><<<dim3(nc, BH, 1), kGradThreads, smem, stream>>>(
        uf, kf, bcum, ap, ul, vb, states, o, T, nc, DK, DV);
    return static_cast<int>(cudaGetLastError());
  }
  if ((err = chunked::allow_smem(scores_kernel<>, kScoresSmem))) return err;
  scores_kernel<><<<dim3(nc, BH, DK / kTile), kGradThreads, kScoresSmem, stream>>>(
      uf, kf, bcum, ap, nc, DK);
  if ((err = static_cast<int>(cudaGetLastError()))) return err;
  if ((err = chunked::allow_smem(out_kernel<false>, smem))) return err;
  out_kernel<false><<<dim3(nc, BH, split), kGradThreads, smem, stream>>>(
      uf, kf, bcum, ap, ul, vb, states, o, T, nc, DK, DV);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace chunked_fwd
}  // namespace gla
