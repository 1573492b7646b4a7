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
// What bounds it on the H100: bytes. In the decode loop m is 1 to 64 rows, so
// each weight byte is used a few times and the kernel is a GEMV: the int8
// weight read once is the traffic (1024 x 2048: 2.1 MB). Design: the weight
// is held (N, Kp), the contraction axis contiguous and every row padded to a
// multiple of 16 bytes, and one warp owns one output channel: a lane loads
// 16 int8 of its channel's row with one 16-byte load, neighbouring lanes
// neighbouring addresses, converts them in registers and uses them for every
// row of an m-tile (up to 8 rows, staged in shared memory as bf16 or int8,
// zero beyond K and beyond m, so neither the ragged K nor a ragged m needs a
// tail loop). A block is 8 warps = 8 channels, 128 to 256 blocks at the
// flagship's widths; a block walks the m-tiles itself (only as many blocks
// along m as it takes to fill the card twice), so its weight rows come from
// device memory once and from the SM's L1 for the further tiles. The rows of
// x are staged with 16-byte loads where K allows it. A K longer than the
// 2,048 columns staged at a time is walked in passes with the sums kept in
// registers. The scale is applied in the epilogue; the sums are reduced
// across the warp with shuffles. w8a8 quantizes the rows of x in a small
// kernel of its own first (one block a row) and contracts with __dp4a.
#include "int8_common.cuh"

namespace {

using namespace q8;

constexpr int kKT = 2048;  // columns of x staged per pass
constexpr int kSMs = 132;  // of an H100: sizes the grid along m, nothing else

// ---- weight only: bf16-rounded activations, f32 accumulation ----
template <typename X, typename O, int MT>
__global__ void __launch_bounds__(kThreads)
int8_linear_wonly_kernel(const X* __restrict__ x, const signed char* __restrict__ q,
                         const float* __restrict__ s, O* __restrict__ out, int M, int K,
                         int Kp, int N) {
  __shared__ __align__(16) uint16_t sx[MT][kKT];  // bf16 bit patterns
  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int n = blockIdx.x * kWarps + tid / 32;
  const signed char* qrow = q + (size_t)(n < N ? n : 0) * Kp;
  const float sn = n < N ? s[n] : 0.f;
  const int n_tiles = (M + MT - 1) / MT;

  // this block's m-tiles: every trip count below is uniform across the block
  for (int tile = blockIdx.y; tile < n_tiles; tile += gridDim.y) {
    const int m0 = tile * MT;
    float acc[MT];
#pragma unroll
    for (int r = 0; r < MT; ++r) acc[r] = 0.f;

    for (int k0 = 0; k0 < Kp; k0 += kKT) {
      const int kt = min(kKT, Kp - k0);  // a multiple of 16
      stage_bf16<X, MT, kKT>(sx, x, M, K, m0, k0, kt, tid);
      __syncthreads();
      if (n < N) {
        for (int c = lane * 16; c < kt; c += 32 * 16) {
          const uint4 w = *reinterpret_cast<const uint4*>(qrow + k0 + c);
          dot16<MT, kKT>(sx, c, w, acc);
        }
      }
      __syncthreads();  // every read of this pass ends before the next overwrites
    }
#pragma unroll
    for (int r = 0; r < MT; ++r) {
      const float total = warp_sum(acc[r]);
      if (lane == 0 && n < N && m0 + r < M)
        out[(size_t)(m0 + r) * N + n] = from_f<O>(total * sn);
    }
  }
}

// ---- w8a8: row quantization of x, then int8 x int8 -> int32 ----
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

template <typename O, int MT>
__global__ void __launch_bounds__(kThreads)
int8_linear_w8a8_kernel(const signed char* __restrict__ xq, const float* __restrict__ sxs,
                        const signed char* __restrict__ q, const float* __restrict__ s,
                        O* __restrict__ out, int M, int Kp, int N) {
  __shared__ __align__(16) signed char sx[MT][kKT];
  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int n = blockIdx.x * kWarps + tid / 32;
  const signed char* qrow = q + (size_t)(n < N ? n : 0) * Kp;
  const float sn = n < N ? s[n] : 0.f;
  const int n_tiles = (M + MT - 1) / MT;

  for (int tile = blockIdx.y; tile < n_tiles; tile += gridDim.y) {
    const int m0 = tile * MT;
    int acc[MT];
#pragma unroll
    for (int r = 0; r < MT; ++r) acc[r] = 0;

    for (int k0 = 0; k0 < Kp; k0 += kKT) {
      const int kt = min(kKT, Kp - k0);  // a multiple of 16
      // 16 bytes a thread: the quantized rows are padded to Kp and zero there
      for (int idx = tid; idx < MT * (kt / 16); idx += kThreads) {
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
        out[(size_t)(m0 + r) * N + n] = from_f<O>(static_cast<float>(total) * sxs[m0 + r] * sn);
    }
  }
}

template <typename X, typename O, int MT>
int launch(const void* x, const void* q, const void* s, void* out, void* xq, void* sx, int M,
           int K, int Kp, int N, int mode, cudaStream_t stream) {
  // blocks along m only until the card is filled twice; a block walks the rest
  const int gx = (N + kWarps - 1) / kWarps;
  const int tiles = (M + MT - 1) / MT;
  const int want = (2 * kSMs + gx - 1) / gx;
  const dim3 grid(gx, tiles < want ? tiles : want);
  if (mode == 0) {
    int8_linear_wonly_kernel<X, O, MT><<<grid, kThreads, 0, stream>>>(
        static_cast<const X*>(x), static_cast<const signed char*>(q),
        static_cast<const float*>(s), static_cast<O*>(out), M, K, Kp, N);
    return static_cast<int>(cudaGetLastError());
  }
  quantize_rows_kernel<X><<<M, kThreads, 0, stream>>>(
      static_cast<const X*>(x), static_cast<signed char*>(xq), static_cast<float*>(sx), K, Kp);
  const int err = static_cast<int>(cudaGetLastError());
  if (err != 0) return err;
  int8_linear_w8a8_kernel<O, MT><<<grid, kThreads, 0, stream>>>(
      static_cast<const signed char*>(xq), static_cast<const float*>(sx),
      static_cast<const signed char*>(q), static_cast<const float*>(s), static_cast<O*>(out),
      M, Kp, N);
  return static_cast<int>(cudaGetLastError());
}

template <typename X, typename O>
int launch_mt(const void* x, const void* q, const void* s, void* out, void* xq, void* sx,
              int M, int K, int Kp, int N, int mode, cudaStream_t stream) {
  if (M == 1) return launch<X, O, 1>(x, q, s, out, xq, sx, M, K, Kp, N, mode, stream);
  if (M == 2) return launch<X, O, 2>(x, q, s, out, xq, sx, M, K, Kp, N, mode, stream);
  if (M <= 4) return launch<X, O, 4>(x, q, s, out, xq, sx, M, K, Kp, N, mode, stream);
  return launch<X, O, 8>(x, q, s, out, xq, sx, M, K, Kp, N, mode, stream);
}

}  // namespace

// C entry point (bound with ctypes in ops/qlinear.py). Layouts: x (M, K) in
// the dtype of code x_dtype (0 f32, 1 bf16); q (N, Kp) int8, Kp a multiple of
// 16 with K <= Kp < K + 16 and zeros beyond K; s (N) f32; out (M, N) in the
// dtype of code out_dtype; mode 0 weight only, 1 w8a8, which also needs the
// scratch xq (M, Kp) int8 and sx (M) f32. All contiguous. Returns
// cudaGetLastError() after the launches, -2 for an unsupported dtype code or
// mode, -3 for a bad Kp, -4 for missing w8a8 scratch.
extern "C" int int8_linear_fwd(const void* x, const void* q, const void* s, void* out, void* xq,
                               void* sx, int M, int K, int Kp, int N, int x_dtype,
                               int out_dtype, int mode, void* stream) {
  if (Kp % 16 != 0 || Kp < K || Kp >= K + 16) return -3;
  if (mode != 0 && mode != 1) return -2;
  if (mode == 1 && (xq == nullptr || sx == nullptr)) return -4;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (x_dtype == 0 && out_dtype == 0)
    return launch_mt<float, float>(x, q, s, out, xq, sx, M, K, Kp, N, mode, st);
  if (x_dtype == 0 && out_dtype == 1)
    return launch_mt<float, __nv_bfloat16>(x, q, s, out, xq, sx, M, K, Kp, N, mode, st);
  if (x_dtype == 1 && out_dtype == 0)
    return launch_mt<__nv_bfloat16, float>(x, q, s, out, xq, sx, M, K, Kp, N, mode, st);
  if (x_dtype == 1 && out_dtype == 1)
    return launch_mt<__nv_bfloat16, __nv_bfloat16>(x, q, s, out, xq, sx, M, K, Kp, N, mode, st);
  return -2;
}
