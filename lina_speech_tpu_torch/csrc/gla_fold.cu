// Fold a full lazy window of buffered tokens into the GLA recurrent state,
// in place: one state read and one write per window.
//
// Replaces the TPU kernel gla_fold_fused (lina_speech_tpu/ops/
// gla_pallas.py:2232, body _lazy_fold_kernel :1924). Per (batch, head), with
// cc the f32 gate cumsum of the whole window and c_j the cumsum at slot j:
//
//   S <- diag(e^{cc}) S + sum_{j < L} (k_j e^{min(cc - c_j, 0)})^T v_j
//
// The clamp keeps every exp argument <= 0. The Pallas kernel's cast of
// k e^{..} to bf16 (:1928) feeds the MXU and is not part of the function:
// here the rank-L update accumulates in f32 from f32 operands, and only the
// result is rounded to the state dtype. The window buffers are left as they
// are (stale by contract; the lazy step masks them).
//
// What bounds it on the H100: bytes. The state is read and written once
// (b8 flagship: 8.4 MB each way per layer in bf16) against 2 L FLOP per
// state element. Design: a block owns a (DK x 32) column tile of one (batch,
// head) state in registers (lane = value column, each warp a band of DK/8
// key rows), so each state element is read and written by the same thread.
// The decayed keys k_j e^{..} of all DK rows and the block's 32 value
// columns are staged in shared memory 16 window slots at a time, so a window
// of any length folds in passes over the same 19 KB; the rank-L update reads
// its band of decayed keys four rows per shared-memory load (float4). Each
// of the DV / 32 blocks of a (batch, head) stages the same decayed keys: the
// kernel runs at about three times its byte bound, and sharing that stage
// across column tiles is the follow-up.
#include "gla_common.cuh"

namespace {

using namespace gla;

constexpr int kPass = 16;  // window slots staged per pass

template <typename IO, typename ST, int DK>
__global__ void __launch_bounds__(kThreads, 2)
gla_fold_kernel(ST* state, const IO* __restrict__ kbuf, const IO* __restrict__ vbuf,
                const float* __restrict__ cbuf, const float* __restrict__ cc,
                int BH, int DV, int L) {
  constexpr int RPT = DK / kGroups;
  const int bh = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid % kBV;
  const int grp = tid / kBV;
  const int col = blockIdx.y * kBV + lane;
  const int row0 = grp * RPT;

  __shared__ __align__(16) float skd[kPass][DK];
  __shared__ float svv[kPass][kBV];
  __shared__ float scc[DK];

  ST* srow = state + (size_t)bh * DK * DV + (size_t)row0 * DV + col;
  float s[RPT];
#pragma unroll
  for (int r = 0; r < RPT; ++r) s[r] = to_f(srow[(size_t)r * DV]);

  if (tid < DK) scc[tid] = cc[(size_t)bh * DK + tid];
  __syncthreads();
#pragma unroll
  for (int r = 0; r < RPT; ++r) s[r] *= expf(scc[row0 + r]);

  // window buffers are (L, BH, D): element (j, bh, c) at (j * BH + bh) * D + c
  for (int j0 = 0; j0 < L; j0 += kPass) {
    const int n = min(kPass, L - j0);  // uniform across the block
    for (int idx = tid; idx < n * DK; idx += kThreads) {
      const int j = idx / DK, i = idx % DK;
      const size_t off = ((size_t)(j0 + j) * BH + bh) * DK + i;
      skd[j][i] = to_f(kbuf[off]) * expf(fminf(scc[i] - cbuf[off], 0.f));
    }
    for (int idx = tid; idx < n * kBV; idx += kThreads) {
      const int j = idx / kBV, c = idx % kBV;
      svv[j][c] = to_f(vbuf[((size_t)(j0 + j) * BH + bh) * DV + blockIdx.y * kBV + c]);
    }
    __syncthreads();
    for (int j = 0; j < n; ++j) {
      const float vj = svv[j][lane];
      // the warp's band of decayed keys, four rows per shared-memory load
      const float4* kd = reinterpret_cast<const float4*>(&skd[j][row0]);
#pragma unroll
      for (int r = 0; r < RPT; r += 4) {
        const float4 k4 = kd[r / 4];
        s[r] += k4.x * vj;
        s[r + 1] += k4.y * vj;
        s[r + 2] += k4.z * vj;
        s[r + 3] += k4.w * vj;
      }
    }
    __syncthreads();  // every read of this pass ends before the next overwrites
  }

#pragma unroll
  for (int r = 0; r < RPT; ++r) srow[(size_t)r * DV] = from_f<ST>(s[r]);
}

template <typename IO, typename ST, int DK>
int launch(void* state, const void* kbuf, const void* vbuf, const void* cbuf,
           const void* cc, int B, int H, int DV, int L, cudaStream_t stream) {
  const dim3 grid(B * H, DV / kBV);
  gla_fold_kernel<IO, ST, DK><<<grid, kThreads, 0, stream>>>(
      static_cast<ST*>(state), static_cast<const IO*>(kbuf),
      static_cast<const IO*>(vbuf), static_cast<const float*>(cbuf),
      static_cast<const float*>(cc), B * H, DV, L);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// C entry point (bound with ctypes in ops/gla_cuda.py). Layouts: state (B,
// H, DK, DV), updated in place; kbuf (L, B, H, DK) and vbuf (L, B, H, DV) in
// the buffer dtype (code io_dtype); cbuf (L, B, H, DK) and cc (B, H, DK)
// f32. All contiguous. Returns cudaGetLastError() after the launch, -1 for
// an unsupported DK, -2 for unsupported dtype codes, -3 for DV % 32 != 0.
extern "C" int gla_fold_window(void* state, const void* kbuf, const void* vbuf,
                               const void* cbuf, const void* cc, int B, int H, int DK,
                               int DV, int L, int io_dtype, int state_dtype,
                               void* stream) {
  if (DV % gla::kBV != 0) return -3;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  GLA_DISPATCH_TYPES(io_dtype, state_dtype,
                     GLA_DISPATCH_DK(DK, return launch<IO, ST, DK>(
                         state, kbuf, vbuf, cbuf, cc, B, H, DV, L, st)))
  return -2;
}
