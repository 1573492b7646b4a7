// Shared helpers of the int8 kernels (int8_linear.cu, fused_ffn_int8.cu):
// conversions, the warp sum, the int8 -> float unpacking of a 16-byte weight
// piece against bf16 activations staged in shared memory, and that staging.
#pragma once

#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace q8 {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
// round to nearest even, as JAX's f32 -> bf16 astype
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

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

// acc[r] += sum of the 16 int8 of the weight piece w times the 16 bf16 of
// sx[r][c .. c + 15], for every row r of the m-tile; f32 accumulation
template <int MT, int LD>
__device__ __forceinline__ void dot16(const uint16_t (*sx)[LD], int c, const uint4& w,
                                      float (&acc)[MT]) {
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
    for (int e = 0; e < 8; ++e) {
      // a bf16 is the high half of an f32
      a += __uint_as_float(xw[e] << 16) * wf[2 * e];
      a += __uint_as_float(xw[e] & 0xffff0000u) * wf[2 * e + 1];
    }
    acc[r] = a;
  }
}

// Rows m0 .. m0 + MT - 1, columns k0 .. k0 + kt - 1 of x (M, K) into shared
// memory as bf16 bit patterns, zero beyond M and K. kt is a multiple of 16.
// Eight columns a thread with 16-byte loads where every row of x starts on a
// 16-byte boundary, else one column a thread.
template <typename X, int MT, int LD>
__device__ __forceinline__ void stage_bf16(uint16_t (*sx)[LD], const X* __restrict__ x, int M,
                                           int K, int m0, int k0, int kt, int tid) {
  const bool wide = K % 8 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  if (wide) {
    const int per_row = kt / 8;
    for (int idx = tid; idx < MT * per_row; idx += kThreads) {
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
  for (int idx = tid; idx < MT * kt; idx += kThreads) {
    const int r = idx / kt, c = idx % kt;
    const int m = m0 + r, k = k0 + c;
    const float v = (m < M && k < K) ? to_f(x[(size_t)m * K + k]) : 0.f;
    sx[r][c] = __bfloat16_as_ushort(__float2bfloat16_rn(v));
  }
}

}  // namespace q8
