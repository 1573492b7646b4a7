// The chunked route of the RWKV6 forward, for bf16 IO: the recurrent walk of
// rwkv6_chunk.cu (one dependent rank-1 update per token on the CUDA cores)
// replaced by the GLA forward's 64-row chunks on the tensor cores
// (gla_chunked_fwd.cuh, mma.sync m16n8k16, bf16 operands, f32 sums), as the
// TPU kernel walks chunks with MXU products (lina_speech_tpu/ops/
// rwkv6_pallas.py:52 _fwd_kernel). The plain version of the same
// decomposition is ops/rwkv6_cuda.py:rwkv6_chunk_chunked_plain.
//
// RWKV6's forward is GLA's chunk walk with u = r (no scale) and two changes,
// both made by the shared bodies' RWKV flag:
// 1. the readout decays at the exclusive gate sum bx_t = bc_{t-1} (0 on a
//    chunk's first row; the readout sees the state before the token's
//    update): the query factor of the inter-chunk product is r e^{bx}
//    (chunked::prep_rows), the pairs s < t of a 16-row sub-chunk take
//    e^{bx_t - b_s} and the split of a pair of sub-chunks the left factor
//    r_t e^{bx_t - b_rho}, rho the row before t's sub-chunk: every exponent
//    stays <= 0, as RWKV6's unclamped gates (down to -20 on a reset) need;
// 2. the diagonal s == t is the bonus sum_d r_t u_d k_t in place of the
//    exponential (chunked::Scores<true>, the key tile's bonus staged in
//    shared memory beside the split factors, kBonusBytes).
// The state walk S <- e^{btot} S + (k e^{btot - bc})^T v is GLA's, the
// decayed key in two bf16 parts so that an f32 final state keeps f32
// accuracy; the output o = (r e^{bx}) S_start + A v is GLA's output kernel.
// What bounds it on the H100 is what bounds the GLA forward (memory traffic
// of the chunk states and the f32 operands of A, the nc-step state sweep,
// the diagonal blocks on the CUDA cores); the route is chosen in Python
// (ops/rwkv6_cuda.py:rwkv6_chunk_fwd_plan).
#pragma once

#include "gla_chunked_fwd.cuh"

namespace rwkv6 {
namespace chunked_fwd {

namespace chunked = gla::chunked;
using chunked::bf16;
using chunked::kC;
using chunked::kGradThreads;
using chunked::kStateThreads;
using chunked::kTile;

// grid (nc, B*H, DK/64 + ceil(DV/64)), 64 threads: chunked::prep_rows on r,
// k, v and the gates w, with the exclusive-sum readout factor and the low
// part of the decayed key. (These kernels are templates so that more than
// one source may include this header.)
template <int = 0>
__global__ void __launch_bounds__(kTile)
prep_kernel(const bf16* __restrict__ r, const bf16* __restrict__ k, const bf16* __restrict__ v,
            const float* __restrict__ w, float* __restrict__ uf, float* __restrict__ kf,
            float* __restrict__ bc, bf16* __restrict__ kt, bf16* __restrict__ kl,
            bf16* __restrict__ ul, bf16* __restrict__ vb, float* __restrict__ ebt, int H, int T,
            int DK, int DV) {
  chunked::prep_rows<bf16, false, true>(r, k, v, w, nullptr, nullptr, nullptr, uf, kf, bc, kt, kl,
                                        ul, nullptr, vb, ebt, H, T, DK, DV, 1.f);
}

// grid (ceil(DV/64), DK/64, B*H), 128 threads, shared memory
// chunked::kStateSmem: the forward walk of chunked::state_walk from s0
// (null: zeros), GLA's, each chunk's start state to states (B*H, nc, DK, DV)
// bf16 and the final state to sf (B*H, DK, DV). The same body as
// gla::chunked_fwd::state_kernel, under a name of its own so that a
// profile tells RWKV6's forward from GLA's.
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
// RWKV6 score matrix (gla::chunked_fwd::scores_body), the bonus u (H, DK).
constexpr int kScoresSmem = gla::chunked_fwd::kScoresSmem + chunked::kBonusBytes;

template <int = 0>
__global__ void __launch_bounds__(kGradThreads, 2)
scores_kernel(const float* __restrict__ uf, const float* __restrict__ kf,
              const float* __restrict__ bcum, const float* __restrict__ u,
              float* __restrict__ ap, int nc, int H, int DK) {
  extern __shared__ __align__(16) unsigned char smem[];
  gla::chunked_fwd::scores_body<true>(smem, uf, kf, bcum, u, ap, nc, H, DK);
}

// grid (nc, B*H, split), 256 threads: o = (r e^{bx}) S_start + A v
// (gla::chunked_fwd::out_body), A formed in the block (FUSED) or summed from
// scores_kernel's parts.
inline int out_smem_bytes(int DK) { return chunked::dv_smem_bytes(DK) + chunked::kBonusBytes; }

template <bool FUSED>
__global__ void __launch_bounds__(kGradThreads, 2)
out_kernel(const float* __restrict__ uf, const float* __restrict__ kf,
           const float* __restrict__ bcum, const float* __restrict__ u,
           const float* __restrict__ ap, const bf16* __restrict__ ul,
           const bf16* __restrict__ vb, const bf16* __restrict__ states, bf16* __restrict__ o,
           int T, int nc, int H, int DK, int DV) {
  extern __shared__ __align__(16) unsigned char smem[];
  gla::chunked_fwd::out_body<FUSED, true>(smem, uf, kf, bcum, u, ap, ul, vb, states, o, T, nc,
                                          H, DK, DV);
}

// Launches the four kernels (three where out_kernel forms A itself, split
// 1), in the order and with the scratch of gla::chunked_fwd::launch
// (ops/gla_cuda.py:_chunked_fwd_sizes, r in q's place); returns the first
// error that is not 0. u: the bonus (H, DK) f32.
template <typename ST>
int launch(const bf16* r, const bf16* k, const bf16* v, const float* w, const float* u,
           const ST* s0, bf16* o, ST* sf, float* uf, float* kf, float* bcum, bf16* kt, bf16* kl,
           bf16* ul, bf16* states, bf16* vb, float* ebt, float* ap, int B, int H, int T, int DK,
           int DV, int split, cudaStream_t stream) {
  const int nc = (T + kC - 1) / kC, BH = B * H, v_tiles = (DV + kTile - 1) / kTile;
  prep_kernel<><<<dim3(nc, BH, DK / kTile + v_tiles), kTile, 0, stream>>>(
      r, k, v, w, uf, kf, bcum, kt, kl, ul, vb, ebt, H, T, DK, DV);
  int err = static_cast<int>(cudaGetLastError());
  if (err) return err;
  if ((err = chunked::allow_smem(state_kernel<ST>, chunked::kStateSmem))) return err;
  state_kernel<ST><<<dim3(v_tiles, DK / kTile, BH), kStateThreads, chunked::kStateSmem,
                     stream>>>(kt, kl, vb, ebt, s0, states, sf, BH, T, nc, DK, DV);
  if ((err = static_cast<int>(cudaGetLastError()))) return err;
  const int smem = out_smem_bytes(DK);
  if (split == 1) {
    if ((err = chunked::allow_smem(out_kernel<true>, smem))) return err;
    out_kernel<true><<<dim3(nc, BH, 1), kGradThreads, smem, stream>>>(
        uf, kf, bcum, u, ap, ul, vb, states, o, T, nc, H, DK, DV);
    return static_cast<int>(cudaGetLastError());
  }
  if ((err = chunked::allow_smem(scores_kernel<>, kScoresSmem))) return err;
  scores_kernel<><<<dim3(nc, BH, DK / kTile), kGradThreads, kScoresSmem, stream>>>(
      uf, kf, bcum, u, ap, nc, H, DK);
  if ((err = static_cast<int>(cudaGetLastError()))) return err;
  if ((err = chunked::allow_smem(out_kernel<false>, smem))) return err;
  out_kernel<false><<<dim3(nc, BH, split), kGradThreads, smem, stream>>>(
      uf, kf, bcum, u, ap, ul, vb, states, o, T, nc, H, DK, DV);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace chunked_fwd
}  // namespace rwkv6
