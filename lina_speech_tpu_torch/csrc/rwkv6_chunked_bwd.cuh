// The chunked route of the RWKV6 backward, for bf16 IO: the two recurrent
// sweeps of rwkv6_chunk_bwd.cu (one dependent rank-1 update per token on
// the CUDA cores) replaced by the GLA backward's 64-row chunks on the
// tensor cores (gla_chunked_bwd.cuh, mma.sync m16n8k16, bf16 operands, f32
// sums), as the TPU kernel walks chunks with MXU products
// (lina_speech_tpu/ops/rwkv6_pallas.py:137 _bwd_kernel). The plain version
// of the same decomposition is ops/rwkv6_cuda.py:
// rwkv6_chunk_bwd_chunked_plain.
//
// RWKV6's backward is GLA's chunk walk with u = r (no scale) and the
// forward's two changes, made by the shared bodies' RWKV flag:
// 1. the readout decays at the exclusive gate sum bx_t = bc_{t-1} (0 on a
//    chunk's first row): the reverse walk's operand is r e^{bx}
//    (chunked::prep_rows), dr's state part e^{bx} (do S^T), and the pairs
//    are strict, G[t] = sum_{s<t} dA[t,s] k_s e^{bx_t - b_s} and H[s] =
//    sum_{t>s} dA[t,s] r_t e^{bx_t - b_s}, split across 16-row sub-chunks
//    at the row before t's sub-chunk (G) or at s's sub-chunk's last row
//    (H), every exponent <= 0 (chunked::dqk_body<true>);
// 2. dv's score matrix carries the bonus sum_d r_t u_d k_t on its diagonal
//    (chunked::dv_body<true>, chunked::Scores<true>).
// Beside those, dv's two products take their operands in two bf16 parts
// (A, dS, the decayed k), as the recurrent sweeps keep dv f32-accurate:
// with them rounded once, the model's bf16 parameter gradients with every
// backward chunked parted from the recurrent run's by 2.7 times as much as
// an f32-accurate backward's do (scripts/torch_bwd_grad_floor.py --kind
// rwkv6; PERF.md §6).
// dr and dk leave the dq/dk kernel as their state and pair parts alone
// (drS, dkS), beside vdo_t = do_t . v_t (dA's diagonal); the finishing pass
// of rwkv6_chunk_bwd.cu adds the bonus's parts u k vdo and u r vdo, walks
// dw as sum_{s>=t} (-k dkS) + sum_{s>t} r drS + dsf . S_final (the
// inclusive and the exclusive part) and sums du. dw is a difference of
// near-equal sums, so the products that feed drS and dkS take their
// operands in two bf16 parts, as GLA's dq and dk do.
// What bounds it on the H100 is what bounds the GLA backward (memory traffic
// of the chunk states and cotangents, the f32 operands of the intra terms,
// the chunk-serial state walks, the diagonal blocks on the CUDA cores); the
// route is chosen in Python (ops/rwkv6_cuda.py:rwkv6_chunk_bwd_plan).
#pragma once

#include "gla_chunked_bwd.cuh"

namespace rwkv6 {
namespace chunked_bwd {

namespace chunked = gla::chunked;
using chunked::bf16;
using chunked::kC;
using chunked::kGradThreads;
using chunked::kStateThreads;
using chunked::kTile;

// grid (nc, B*H, DK/64 + ceil(DV/64)), 64 threads: chunked::prep_rows on r,
// k, v and the gates w with the exclusive-sum readout factor, both decayed
// operands in two parts. (These kernels are templates so that more than
// one source may include this header.)
template <int = 0>
__global__ void __launch_bounds__(kTile)
prep_kernel(const bf16* __restrict__ r, const bf16* __restrict__ k, const bf16* __restrict__ v,
            const float* __restrict__ w, float* __restrict__ uf, float* __restrict__ kf,
            float* __restrict__ bc, bf16* __restrict__ kt, bf16* __restrict__ kl,
            bf16* __restrict__ ul, bf16* __restrict__ ull, bf16* __restrict__ vb,
            float* __restrict__ ebt, int H, int T, int DK, int DV) {
  chunked::prep_rows<bf16, false, true>(r, k, v, w, nullptr, nullptr, nullptr, uf, kf, bc, kt, kl,
                                        ul, ull, vb, ebt, H, T, DK, DV, 1.f);
}

// grid (ceil(DV/64), DK/64, 2 B*H), 128 threads, shared memory
// chunked::kStateSmem: chunked::state_walk forward from s0 and in reverse
// from dsf (GLA's, the reverse on r e^{bx}), under a name of its own so
// that a profile tells RWKV6's backward from GLA's.
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
  chunked::state_walk<ST>(smem, kt, kl, ul, ull, vb, dout, ebt, s0, dsf, states, states_lo,
                          dstates, dstates_lo, dsgp, ds0, nullptr, BH, T, nc, DK, DV);
}

// grid (DK/64, nc, B*H), 256 threads, shared memory chunked::kDqkSmem:
// chunked::dqk_body<true>, drS and dkS (B*H, T, DK) f32, vdo (B*H, T).
template <int = 0>
__global__ void __launch_bounds__(kGradThreads, 2)
dqk_kernel(const float* __restrict__ uf, const float* __restrict__ kf,
           const float* __restrict__ bcum, const bf16* __restrict__ vb,
           const bf16* __restrict__ dout, const bf16* __restrict__ states,
           const bf16* __restrict__ states_lo, const bf16* __restrict__ dstates,
           const bf16* __restrict__ dstates_lo, float* __restrict__ drs, float* __restrict__ dks,
           float* __restrict__ dsgp, float* __restrict__ vdo, int BH, int T, int nc, int DK,
           int DV) {
  extern __shared__ __align__(16) unsigned char smem[];
  chunked::dqk_body<true>(smem, uf, kf, bcum, vb, dout, states, states_lo, dstates, dstates_lo,
                          drs, dks, dsgp, vdo, BH, T, nc, DK, DV, 1.f);
}

// grid (nc, B*H), 256 threads, shared memory chunked::dv_smem_bytes(DK,
// true): dv = (k e^{btot - bc}) dS + A^T do in bf16, A with the bonus u
// (H, DK), every operand in two bf16 parts (chunked::dv_body<bf16, true>).
template <int = 0>
__global__ void __launch_bounds__(kGradThreads)
dv_kernel(const float* __restrict__ uf, const float* __restrict__ kf,
          const float* __restrict__ bcum, const bf16* __restrict__ kt,
          const bf16* __restrict__ kl, const bf16* __restrict__ dout,
          const bf16* __restrict__ dstates, const bf16* __restrict__ dstates_lo,
          const float* __restrict__ u, bf16* __restrict__ dv, int T, int nc, int H, int DK,
          int DV) {
  extern __shared__ __align__(16) unsigned char smem[];
  chunked::dv_body<bf16, true>(smem, uf, kf, bcum, kt, kl, dout, dstates, dstates_lo, u, dv, T,
                               nc, H, DK, DV);
}

// Launches the four kernels with the scratch of gla::chunked::launch_chunked
// (ops/gla_cuda.py:_chunked_bwd_sizes, r in q's place); returns the first
// error that is not 0. drs, dks: (B*H, T, DK) f32; vdo (B*H, T) f32; dsgp
// (ceil(DV/64) + 1, B*H, DK) f32; dv the output (B*H, T, DV) bf16; u the
// bonus (H, DK) f32. s0, dsf and ds0 may be null.
template <typename ST>
int launch(const bf16* r, const bf16* k, const bf16* v, const float* w, const float* u,
           const ST* s0, const bf16* dout, const ST* dsf, ST* ds0, float* drs, float* dks,
           float* vdo, float* dsgp, bf16* dv, float* uf, float* kf, float* bcum, bf16* kt,
           bf16* kl, bf16* ul, bf16* ull, bf16* states, bf16* states_lo, bf16* dstates,
           bf16* dstates_lo, bf16* vb, float* ebt, int B, int H, int T, int DK, int DV,
           cudaStream_t stream) {
  const int nc = (T + kC - 1) / kC, BH = B * H, v_tiles = (DV + kTile - 1) / kTile;
  prep_kernel<><<<dim3(nc, BH, DK / kTile + v_tiles), kTile, 0, stream>>>(
      r, k, v, w, uf, kf, bcum, kt, kl, ul, ull, vb, ebt, H, T, DK, DV);
  int err = static_cast<int>(cudaGetLastError());
  if (err) return err;
  if ((err = chunked::allow_smem(state_kernel<ST>, chunked::kStateSmem))) return err;
  state_kernel<ST><<<dim3(v_tiles, DK / kTile, 2 * BH), kStateThreads, chunked::kStateSmem,
                     stream>>>(kt, kl, ul, ull, vb, dout, ebt, s0, dsf, states, states_lo,
                               dstates, dstates_lo, dsgp, ds0, BH, T, nc, DK, DV);
  if ((err = static_cast<int>(cudaGetLastError()))) return err;
  if ((err = chunked::allow_smem(dqk_kernel<>, chunked::kDqkSmem))) return err;
  dqk_kernel<><<<dim3(DK / kTile, nc, BH), kGradThreads, chunked::kDqkSmem, stream>>>(
      uf, kf, bcum, vb, dout, states, states_lo, dstates, dstates_lo, drs, dks, dsgp, vdo, BH, T,
      nc, DK, DV);
  if ((err = static_cast<int>(cudaGetLastError()))) return err;
  const int smem = chunked::dv_smem_bytes(DK, true);
  if ((err = chunked::allow_smem(dv_kernel<>, smem))) return err;
  dv_kernel<><<<dim3(nc, BH), kGradThreads, smem, stream>>>(
      uf, kf, bcum, kt, kl, dout, dstates, dstates_lo, u, dv, T, nc, H, DK, DV);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace chunked_bwd
}  // namespace rwkv6
