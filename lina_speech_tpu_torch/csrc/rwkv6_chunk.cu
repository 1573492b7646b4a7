// RWKV-6 (Finch) prefill and training forward: the WKV scan of every RWKV6
// layer over a whole chunk of tokens.
//
// Replaces the TPU kernel rwkv6_chunk_pallas (lina_speech_tpu/ops/
// rwkv6_pallas.py:565; _fwd_impl :266 -> pallas_call :308, bodies
// _fwd_kernel :52 and _fwd_kernel_infer :128). Per (batch, head), with f32
// log-decays w <= 0 and an f32 bonus u per key channel:
//
//   o_t = r_t (S_{t-1} + diag(u) k_t^T v_t)
//   S_t = diag(exp w_t) S_{t-1} + k_t^T v_t
//
// The readout comes BEFORE the update and adds the bonus of the current
// token; r is not scaled. o is rounded to the IO dtype, the final state to
// the state dtype (round to nearest even).
//
// Design: the Pallas kernel walks 128-row chunks on a sequential grid axis
// and turns each into MXU matmuls, with the readout decays at the exclusive
// gate cumsum; its training forward also saves the chunk-start states for
// the backward. Here, as in the GLA forward (gla_chunk.cuh), a block owns a
// (DK x 32) f32 state tile in registers (lane = value column, each warp a
// band of DK/8 key rows) and walks the time axis in a loop: every exp
// argument is a gate <= 0, so no chunk factorization is needed for
// stability and a ragged t (down to 1) needs no padding. r, k and v are
// converted to f32 as they arrive and stay f32 inside: the TPU kernel
// rounds the state to bf16 for its inter-chunk product, this one does not.
// Nothing is saved for the backward, which recomputes the states from s0
// (rwkv6_chunk_bwd.cu), so training runs this same kernel.
//
// What bounds it on the H100: the serial time loop (one dependent update
// per token, two block barriers per step), not bytes or FLOPs. Inputs are
// staged in shared memory 16 steps at a time (8 in f32), so the global-load
// latency is paid once per stage. At b8 h4 t512 dk256 dv256 in bf16 it
// moves ~67 MB and does ~6 GFLOP in f32.
//
// Two routes (ops/rwkv6_cuda.py:rwkv6_chunk_fwd_plan): this recurrent body
// for f32 IO and short bf16 inputs, and for longer bf16 inputs the chunked
// route of rwkv6_chunked_fwd.cuh (64-row chunks on the tensor cores, the GLA
// forward's chunk walk with RWKV6's readout decay and bonus).
#include <type_traits>

#include "rwkv6_chunked_fwd.cuh"

namespace rwkv6 {

using gla::kBV;
using gla::kGroups;
using gla::kThreads;
using gla::from_f;
using gla::to_f;

template <typename IO, typename ST, int DK>
__global__ void __launch_bounds__(kThreads)
rwkv6_chunk_kernel(const IO* __restrict__ r, const IO* __restrict__ k,
                   const IO* __restrict__ v, const float* __restrict__ w,
                   const float* __restrict__ u, const ST* __restrict__ s0,
                   IO* __restrict__ o, ST* __restrict__ sf, int H, int T, int DV) {
  constexpr int RPT = DK / kGroups;  // key rows per thread
  const int bh = blockIdx.x;
  const int h = bh % H;
  const int tid = threadIdx.x;
  const int lane = tid % kBV;
  const int grp = tid / kBV;
  const int col = blockIdx.y * kBV + lane;  // value column of this thread
  const int row0 = grp * RPT;

  constexpr int STAGE = sizeof(IO) == 2 ? 16 : 8;
  __shared__ IO str[STAGE * DK], stk[STAGE * DK], stv[STAGE * kBV];
  __shared__ float stw[STAGE * DK];
  __shared__ float sr[DK], sk[DK], suk[DK], sew[DK], sv[kBV];
  __shared__ float part[kGroups][kBV];

  float s[RPT];
  const size_t sbase = (size_t)bh * DK * DV;
#pragma unroll
  for (int i = 0; i < RPT; ++i)
    s[i] = s0 ? to_f(s0[sbase + (size_t)(row0 + i) * DV + col]) : 0.f;

  // thread tid < DK owns key channel tid (and keeps its bonus u); thread
  // tid < kBV owns the block's value column blockIdx.y * kBV + tid
  const bool k_owner = tid < DK;
  const bool v_owner = tid < kBV;
  const float u_ch = k_owner ? u[h * DK + tid] : 0.f;

  const size_t kbase = (size_t)bh * T * DK;
  const size_t vbase = (size_t)bh * T * DV;
  for (int t0 = 0; t0 < T; t0 += STAGE) {
    const int n = min(STAGE, T - t0);  // uniform across the block
    // the last step of the previous stage ended on a barrier after every read
    for (int idx = tid; idx < n * DK; idx += kThreads) {
      const size_t off = kbase + (size_t)t0 * DK + idx;
      str[idx] = r[off];
      stk[idx] = k[off];
      stw[idx] = w[off];
    }
    for (int idx = tid; idx < n * kBV; idx += kThreads) {
      const int j = idx / kBV, c = idx % kBV;
      stv[idx] = v[vbase + (size_t)(t0 + j) * DV + blockIdx.y * kBV + c];
    }
    __syncthreads();

    for (int j = 0; j < n; ++j) {
      if (k_owner) {
        const float kk = to_f(stk[j * DK + tid]);
        sr[tid] = to_f(str[j * DK + tid]);
        sk[tid] = kk;
        suk[tid] = u_ch * kk;
        sew[tid] = expf(stw[j * DK + tid]);
      }
      if (v_owner) sv[tid] = to_f(stv[j * kBV + tid]);
      __syncthreads();

      const float vj = sv[lane];
      float acc = 0.f;
#pragma unroll
      for (int i = 0; i < RPT; ++i) {
        const int row = row0 + i;
        acc += sr[row] * (s[i] + suk[row] * vj);
        s[i] = sew[row] * s[i] + sk[row] * vj;
      }
      part[grp][lane] = acc;
      __syncthreads();

      if (grp == 0) {
        float out = 0.f;
#pragma unroll
        for (int g = 0; g < kGroups; ++g) out += part[g][lane];
        o[vbase + (size_t)(t0 + j) * DV + col] = from_f<IO>(out);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < RPT; ++i)
    sf[sbase + (size_t)(row0 + i) * DV + col] = from_f<ST>(s[i]);
}

template <typename IO, typename ST, int DK>
int launch(const void* r, const void* k, const void* v, const void* w, const void* u,
           const void* s0, void* o, void* sf, int B, int H, int T, int DV,
           cudaStream_t stream) {
  const dim3 grid(B * H, DV / kBV);
  rwkv6_chunk_kernel<IO, ST, DK><<<grid, kThreads, 0, stream>>>(
      static_cast<const IO*>(r), static_cast<const IO*>(k), static_cast<const IO*>(v),
      static_cast<const float*>(w), static_cast<const float*>(u),
      static_cast<const ST*>(s0), static_cast<IO*>(o), static_cast<ST*>(sf), H, T, DV);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace rwkv6

// C entry point (bound with ctypes in ops/rwkv6_cuda.py). Layouts: r, k, w
// (B, H, T, DK); v (B, H, T, DV); u (H, DK) f32; w f32; s0 (B, H, DK, DV)
// or null for a zero state; o (B, H, T, DV); sf (B, H, DK, DV). All
// contiguous; T >= 1. route: gla::kRecurrent or gla::kChunked (bf16 IO
// only); split: the chunked output kernel's value-tile groups; uf .. ap: the
// chunked route's scratch as ops/gla_cuda.py:_chunked_fwd_sizes lays it out
// (null for the recurrent route, ap null where split is 1). Returns
// cudaGetLastError() after the launches, -1 for an unsupported DK, -2 for
// unsupported dtype codes, -3 for DV % 32 != 0, -4 for the chunked route
// with f32 IO, a split outside 1..ceil(DV/64) or above 1 without ap, or an
// unknown route.
extern "C" int rwkv6_chunk_fwd(const void* r, const void* k, const void* v, const void* w,
                               const void* u, const void* s0, void* o, void* sf, void* uf,
                               void* kf, void* bc, void* kt, void* kl, void* ul, void* states,
                               void* vb, void* ebt, void* ap, int B, int H, int T, int DK_,
                               int DV, int io_dtype, int state_dtype, int route, int split,
                               void* stream) {
  if (DV % gla::kBV != 0) return -3;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (route == gla::kChunked) {
    const int v_tiles = (DV + gla::chunked::kTile - 1) / gla::chunked::kTile;
    if (io_dtype != gla::kBF16 || split < 1 || split > v_tiles || (split > 1 && !ap)) return -4;
    if (DK_ != 64 && DK_ != 128 && DK_ != 256) return -1;
    using gla::chunked::bf16;
    const auto run = [&](auto* s0_, auto* sf_) {
      using ST = std::remove_const_t<std::remove_pointer_t<decltype(s0_)>>;
      return rwkv6::chunked_fwd::launch<ST>(
          static_cast<const bf16*>(r), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
          static_cast<const float*>(w), static_cast<const float*>(u), s0_,
          static_cast<bf16*>(o), sf_, static_cast<float*>(uf), static_cast<float*>(kf),
          static_cast<float*>(bc), static_cast<bf16*>(kt), static_cast<bf16*>(kl),
          static_cast<bf16*>(ul), static_cast<bf16*>(states), static_cast<bf16*>(vb),
          static_cast<float*>(ebt), static_cast<float*>(ap), B, H, T, DK_, DV, split, st);
    };
    if (state_dtype == gla::kF32)
      return run(static_cast<const float*>(s0), static_cast<float*>(sf));
    if (state_dtype == gla::kBF16)
      return run(static_cast<const bf16*>(s0), static_cast<bf16*>(sf));
    return -2;
  }
  if (route != gla::kRecurrent) return -4;
  GLA_DISPATCH_TYPES(io_dtype, state_dtype,
                     GLA_DISPATCH_DK(DK_, return rwkv6::launch<IO, ST, DK>(
                         r, k, v, w, u, s0, o, sf, B, H, T, DV, st)))
  return -2;
}
