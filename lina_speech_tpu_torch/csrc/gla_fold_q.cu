// Fold a full lazy window of buffered tokens into an int8 GLA recurrent
// state, in place, and requantize every row: one state read and one write
// per window, a byte an element each way.
//
// Replaces the TPU kernel gla_fold_fused_q (lina_speech_tpu/ops/
// gla_pallas.py:2097, body _lazy_fold_q_kernel :1988). Per (batch, head),
// with S_q the int8 state, s its f32 row scales, cc the f32 gate cumsum of
// the whole window and c_j the cumsum at slot j:
//
//   S   = diag(e^{cc} s) S_q + sum_{j < L} (k_j e^{min(cc - c_j, 0)})^T v_j
//   s  <- max(max_v |S|, 1e-30) / 127           (per key row)
//   S_q <- clip(round(S / s), -127, 127)        (round half to even)
//
// The clamp keeps every exp argument <= 0. The Pallas kernel's cast of
// k e^{..} to bf16 (:1995) feeds the MXU and is not part of the function:
// here the rank-L update accumulates in f32 from f32 operands. The window
// buffers are left as they are (stale by contract; the lazy step masks them).
//
// What bounds it on the H100: bytes. The int8 state is read and written once
// (b8 flagship: 4.2 MB each way per layer) against 2 L FLOP per element.
// Design: a row's new scale needs the maximum over ALL value columns of that
// row before any element of it can be written, so a block owns whole rows: a
// band of kRows key rows by all DV columns of one (batch, head). A warp owns
// kRows / 8 of those rows; a lane holds DV / 32 consecutive columns of each
// in registers as f32 (16 columns = one 16-byte load and one 16-byte store
// at DV 512), so the row maximum is a lane maximum and a 5-step warp
// shuffle, and the requantized row leaves in the same 16-byte pieces. The
// window's v rows (all DV columns) and the band's decayed keys are staged in
// shared memory 16 slots at a time, v laid out so that the 32 lanes' float4
// reads are conflict free. Each of the DK / kRows blocks of a (batch, head)
// stages the same v rows (16 KB of bf16 from L2 against the 16 KB of state
// the block owns at DV 512).
#include <cstdint>

#include "gla_common.cuh"

namespace {

using namespace gla;

constexpr int kPass = 16;  // window slots staged per pass
constexpr int kRows = 32;  // key rows per block
constexpr int kRowsPerWarp = kRows / kGroups;

// CPL consecutive int8 values as one aligned load / store
template <int CPL> struct Bytes;
template <> struct Bytes<4> { using type = uint32_t; };
template <> struct Bytes<8> { using type = uint2; };
template <> struct Bytes<16> { using type = uint4; };

template <typename IO, int CPL>
__global__ void __launch_bounds__(kThreads)
gla_fold_q_kernel(signed char* state, float* s_scale, const IO* __restrict__ kbuf,
                  const IO* __restrict__ vbuf, const float* __restrict__ cbuf,
                  const float* __restrict__ cc, int BH, int DK, int L) {
  constexpr int DV = CPL * 32;
  constexpr int Q = CPL / 4;  // float4 pieces per lane and row
  using Pack = typename Bytes<CPL>::type;
  const int bh = blockIdx.x;
  const int row_base = blockIdx.y * kRows;
  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int warp = tid / 32;

  // sv[j][piece][lane]: columns lane * CPL + 4 * piece .. + 3 of slot j
  __shared__ __align__(16) float4 sv[kPass][Q][32];
  __shared__ float skd[kPass][kRows];
  __shared__ float scc[kRows];

  if (tid < kRows) scc[tid] = cc[(size_t)bh * DK + row_base + tid];

  // this warp's rows, dequantized: S = e^{cc} s S_q
  float s[kRowsPerWarp][CPL];
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    const int row = row_base + warp * kRowsPerWarp + r;
    const size_t off = ((size_t)bh * DK + row) * DV + lane * CPL;
    union { Pack p; signed char c[CPL]; } in;
    in.p = *reinterpret_cast<const Pack*>(state + off);
    const float f = expf(cc[(size_t)bh * DK + row]) * s_scale[(size_t)bh * DK + row];
#pragma unroll
    for (int c = 0; c < CPL; ++c) s[r][c] = f * static_cast<float>(in.c[c]);
  }
  __syncthreads();

  // window buffers are (L, BH, D): element (j, bh, c) at (j * BH + bh) * D + c
  for (int j0 = 0; j0 < L; j0 += kPass) {
    const int n = min(kPass, L - j0);  // uniform across the block
    for (int idx = tid; idx < n * kRows; idx += kThreads) {
      const int j = idx / kRows, i = idx % kRows;
      const size_t off = ((size_t)(j0 + j) * BH + bh) * DK + row_base + i;
      skd[j][i] = to_f(kbuf[off]) * expf(fminf(scc[i] - cbuf[off], 0.f));
    }
    float* svf = reinterpret_cast<float*>(&sv[0][0][0]);
    for (int idx = tid; idx < n * DV; idx += kThreads) {
      const int j = idx / DV, c = idx % DV;
      const int owner = c / CPL, piece = (c % CPL) / 4, e = c % 4;
      svf[((j * Q + piece) * 32 + owner) * 4 + e] =
          to_f(vbuf[((size_t)(j0 + j) * BH + bh) * DV + c]);
    }
    __syncthreads();
    for (int j = 0; j < n; ++j) {
      float4 v[Q];
#pragma unroll
      for (int q = 0; q < Q; ++q) v[q] = sv[j][q][lane];
#pragma unroll
      for (int r = 0; r < kRowsPerWarp; ++r) {
        const float kd = skd[j][warp * kRowsPerWarp + r];
#pragma unroll
        for (int q = 0; q < Q; ++q) {
          s[r][4 * q] += kd * v[q].x;
          s[r][4 * q + 1] += kd * v[q].y;
          s[r][4 * q + 2] += kd * v[q].z;
          s[r][4 * q + 3] += kd * v[q].w;
        }
      }
    }
    __syncthreads();  // every read of this pass ends before the next overwrites
  }

  // a fresh scale per row, then the row goes back as int8
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    const int row = row_base + warp * kRowsPerWarp + r;
    float mx = 0.f;
#pragma unroll
    for (int c = 0; c < CPL; ++c) mx = fmaxf(mx, fabsf(s[r][c]));
#pragma unroll
    for (int m = 16; m > 0; m >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, m));
    const float sc = fmaxf(mx, 1e-30f) / 127.f;
    union { Pack p; signed char c[CPL]; } out;
#pragma unroll
    for (int c = 0; c < CPL; ++c) {
      const float q = fminf(fmaxf(rintf(s[r][c] / sc), -127.f), 127.f);
      out.c[c] = static_cast<signed char>(q);
    }
    *reinterpret_cast<Pack*>(state + ((size_t)bh * DK + row) * DV + lane * CPL) = out.p;
    if (lane == 0) s_scale[(size_t)bh * DK + row] = sc;
  }
}

template <typename IO, int CPL>
int launch(void* state, void* s_scale, const void* kbuf, const void* vbuf, const void* cbuf,
           const void* cc, int B, int H, int DK, int L, cudaStream_t stream) {
  const dim3 grid(B * H, DK / kRows);
  gla_fold_q_kernel<IO, CPL><<<grid, kThreads, 0, stream>>>(
      static_cast<signed char*>(state), static_cast<float*>(s_scale),
      static_cast<const IO*>(kbuf), static_cast<const IO*>(vbuf),
      static_cast<const float*>(cbuf), static_cast<const float*>(cc), B * H, DK, L);
  return static_cast<int>(cudaGetLastError());
}

template <typename IO>
int launch_dv(void* state, void* s_scale, const void* kbuf, const void* vbuf,
              const void* cbuf, const void* cc, int B, int H, int DK, int DV, int L,
              cudaStream_t stream) {
  switch (DV) {
    case 128: return launch<IO, 4>(state, s_scale, kbuf, vbuf, cbuf, cc, B, H, DK, L, stream);
    case 256: return launch<IO, 8>(state, s_scale, kbuf, vbuf, cbuf, cc, B, H, DK, L, stream);
    case 512: return launch<IO, 16>(state, s_scale, kbuf, vbuf, cbuf, cc, B, H, DK, L, stream);
    default: return -3;
  }
}

}  // namespace

// C entry point (bound with ctypes in ops/gla_cuda.py). Layouts: state (B,
// H, DK, DV) int8 and s_scale (B, H, DK) f32, both updated in place; kbuf
// (L, B, H, DK) and vbuf (L, B, H, DV) in the buffer dtype (code io_dtype);
// cbuf (L, B, H, DK) and cc (B, H, DK) f32. All contiguous. Returns
// cudaGetLastError() after the launch, -1 for a DK that is not a multiple of
// 32, -2 for an unsupported dtype code, -3 for a DV outside {128, 256, 512}.
extern "C" int gla_fold_q_window(void* state, void* s_scale, const void* kbuf,
                                 const void* vbuf, const void* cbuf, const void* cc, int B,
                                 int H, int DK, int DV, int L, int io_dtype, void* stream) {
  if (DK % kRows != 0) return -1;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (io_dtype == gla::kF32)
    return launch_dv<float>(state, s_scale, kbuf, vbuf, cbuf, cc, B, H, DK, DV, L, st);
  if (io_dtype == gla::kBF16)
    return launch_dv<__nv_bfloat16>(state, s_scale, kbuf, vbuf, cbuf, cc, B, H, DK, DV, L, st);
  return -2;
}
