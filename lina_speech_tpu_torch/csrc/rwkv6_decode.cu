// One RWKV-6 decode token: the classic step of every RWKV6 layer.
//
// Replaces the TPU kernel rwkv6_decode_fused (lina_speech_tpu/ops/
// gla_pallas.py:1728; _rwkv6_decode_impl :1484 -> pallas_call :1498, body
// _rwkv6_decode_kernel :1468). Per (batch, head):
//
//   o = r (S + diag(u) k^T v),   S <- diag(exp w) S + k^T v
//
// with r, k, v in the IO dtype (converted to f32 with no further
// rounding), w and u in f32, the state in f32 or bf16; o is rounded to the
// IO dtype and S to the state dtype. One state read and one state write,
// in place (the Pallas kernel aliases its state buffer the same way).
//
// What bounds it on the H100: bytes. The state is read once and written
// once per token (b8 h4 dk256 dv256 in f32: 8.4 MB each way per layer),
// against ~3 FLOP per state byte. Design as gla_decode.cuh: a block owns a
// (DK x 32) column tile of one (batch, head) state, lane = value column, so
// a warp reads and writes 32 consecutive state elements per key row and
// each element is read and written by the same thread. The JAX layer sends
// batches with fewer than 8 (batch * head) rows to XLA (the Pallas
// kernel's 8-row block, models/rwkv6.py:225-236): TPU tuning that has no
// counterpart here, so this kernel takes every batch size.
#include "gla_common.cuh"

namespace rwkv6 {

using gla::kBV;
using gla::kGroups;
using gla::kThreads;
using gla::from_f;
using gla::to_f;

template <typename IO, typename ST, int DK>
__global__ void __launch_bounds__(kThreads, 2)
rwkv6_decode_kernel(const IO* __restrict__ r, const IO* __restrict__ k,
                    const IO* __restrict__ v, const float* __restrict__ w,
                    const float* __restrict__ u, ST* state, IO* __restrict__ o, int H,
                    int DV) {
  constexpr int RPT = DK / kGroups;
  const int bh = blockIdx.x;
  const int h = bh % H;
  const int tid = threadIdx.x;
  const int lane = tid % kBV;
  const int grp = tid / kBV;
  const int col = blockIdx.y * kBV + lane;
  const int row0 = grp * RPT;

  __shared__ float sr[DK], sk[DK], suk[DK], sew[DK], sv[kBV];
  __shared__ float part[kGroups][kBV];

  if (tid < DK) {
    const size_t off = (size_t)bh * DK + tid;
    const float kk = to_f(k[off]);
    sr[tid] = to_f(r[off]);
    sk[tid] = kk;
    suk[tid] = u[h * DK + tid] * kk;
    sew[tid] = expf(w[off]);
  }
  if (tid < kBV) sv[tid] = to_f(v[(size_t)bh * DV + blockIdx.y * kBV + tid]);
  __syncthreads();

  const float vj = sv[lane];
  ST* srow = state + (size_t)bh * DK * DV + (size_t)row0 * DV + col;
  float s[RPT];
#pragma unroll
  for (int i = 0; i < RPT; ++i) s[i] = to_f(srow[(size_t)i * DV]);
  float acc = 0.f;
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int row = row0 + i;
    acc += sr[row] * (s[i] + suk[row] * vj);
    srow[(size_t)i * DV] = from_f<ST>(sew[row] * s[i] + sk[row] * vj);
  }
  part[grp][lane] = acc;
  __syncthreads();
  if (grp == 0) {
    float out = 0.f;
#pragma unroll
    for (int g = 0; g < kGroups; ++g) out += part[g][lane];
    o[(size_t)bh * DV + col] = from_f<IO>(out);
  }
}

template <typename IO, typename ST, int DK>
int launch_decode(const void* r, const void* k, const void* v, const void* w, const void* u,
                  void* state, void* o, int B, int H, int DV, cudaStream_t stream) {
  const dim3 grid(B * H, DV / kBV);
  rwkv6_decode_kernel<IO, ST, DK><<<grid, kThreads, 0, stream>>>(
      static_cast<const IO*>(r), static_cast<const IO*>(k), static_cast<const IO*>(v),
      static_cast<const float*>(w), static_cast<const float*>(u), static_cast<ST*>(state),
      static_cast<IO*>(o), H, DV);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace rwkv6

// C entry point (bound with ctypes in ops/rwkv6_cuda.py). Layouts: r, k, w
// (B, H, DK); v (B, H, DV); u (H, DK) f32; w f32; state (B, H, DK, DV),
// updated in place; o (B, H, DV). All contiguous. Returns
// cudaGetLastError() after the launch, -1 for an unsupported DK, -2 for
// unsupported dtype codes, -3 for DV % 32 != 0.
extern "C" int rwkv6_decode_step(const void* r, const void* k, const void* v, const void* w,
                                 const void* u, void* state, void* o, int B, int H, int DK_,
                                 int DV, int io_dtype, int state_dtype, void* stream) {
  if (DV % gla::kBV != 0) return -3;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  GLA_DISPATCH_TYPES(io_dtype, state_dtype,
                     GLA_DISPATCH_DK(DK_, return rwkv6::launch_decode<IO, ST, DK>(
                         r, k, v, w, u, state, o, B, H, DV, st)))
  return -2;
}
