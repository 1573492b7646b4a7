// Shared helpers of the GLA kernels: dtype codes, conversions, the
// short-conv tap sum with its rounding points, and the launch shape.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace gla {

// dtype codes passed from Python (ops/gla_cuda.py:_DTYPE_CODE)
constexpr int kF32 = 0;
constexpr int kBF16 = 1;

// route codes passed from Python (ops/gla_cuda.py:_ROUTE_CODE)
constexpr int kRecurrent = 0;
constexpr int kChunked = 1;

// One block owns a (DK x kBV) tile of one (batch, head) state: kThreads
// threads = kGroups warps; lane = value column, warp = a band of DK/kGroups
// key rows held in registers.
constexpr int kThreads = 256;
constexpr int kBV = 32;
constexpr int kGroups = kThreads / kBV;
constexpr int kConv = 4;  // short-conv width

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
// an element of a row-quantized int8 state (its row scale is applied elsewhere)
__device__ __forceinline__ float to_f(signed char x) { return static_cast<float>(x); }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
// round to nearest even, as JAX's f32 -> bf16 astype
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// f32 value rounded through the IO dtype
template <typename T> __device__ __forceinline__ float round_io(float x) {
  return to_f(from_f<T>(x));
}

// How a thread holds a 16-byte word of a state or buffer row: N neighbouring
// columns, unpacked to f32 and packed back (bf16 rounded to nearest even).
template <typename ST> struct Word;
template <> struct Word<float> {
  static constexpr int N = 4;
  static __device__ __forceinline__ void unpack(uint4 w, float (&f)[N]) {
    f[0] = __uint_as_float(w.x);
    f[1] = __uint_as_float(w.y);
    f[2] = __uint_as_float(w.z);
    f[3] = __uint_as_float(w.w);
  }
  static __device__ __forceinline__ uint4 pack(const float (&f)[N]) {
    return make_uint4(__float_as_uint(f[0]), __float_as_uint(f[1]), __float_as_uint(f[2]),
                      __float_as_uint(f[3]));
  }
};
template <> struct Word<__nv_bfloat16> {
  static constexpr int N = 8;
  static __device__ __forceinline__ void unpack(uint4 w, float (&f)[N]) {
    const unsigned u[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      f[2 * j] = __uint_as_float(u[j] << 16);
      f[2 * j + 1] = __uint_as_float(u[j] & 0xffff0000u);
    }
  }
  static __device__ __forceinline__ uint4 pack(const float (&f)[N]) {
    unsigned u[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const __nv_bfloat162 p = __floats2bfloat162_rn(f[2 * j], f[2 * j + 1]);
      u[j] = *reinterpret_cast<const unsigned*>(&p);
    }
    return make_uint4(u[0], u[1], u[2], u[3]);
  }
};

__device__ __forceinline__ float silu(float z) { return z * (1.f / (1.f + expf(-z))); }

// Causal tap sum of one channel, oldest tap first, accumulated in f32:
// hist = x[t-3], x[t-2], x[t-1]; x = x[t]; w = taps (tap 0 oldest).
__device__ __forceinline__ float tap_sum(const float* w, const float* hist, float x) {
  float z = 0.f;
  z = z + w[0] * hist[0];
  z = z + w[1] * hist[1];
  z = z + w[2] * hist[2];
  z = z + w[3] * x;
  return z;
}

}  // namespace gla

// Dispatch a templated launch over (IO, ST) dtypes and DK in {64, 128, 256}.
#define GLA_DISPATCH_DK(DK_VALUE, ...)                        \
  switch (DK_VALUE) {                                         \
    case 64: { constexpr int DK = 64; __VA_ARGS__; break; }   \
    case 128: { constexpr int DK = 128; __VA_ARGS__; break; } \
    case 256: { constexpr int DK = 256; __VA_ARGS__; break; } \
    default: return -1;                                       \
  }

#define GLA_DISPATCH_TYPES(IO_CODE, ST_CODE, ...)                                 \
  if ((IO_CODE) == gla::kF32 && (ST_CODE) == gla::kF32) {                         \
    using IO = float; using ST = float; __VA_ARGS__;                              \
  } else if ((IO_CODE) == gla::kF32 && (ST_CODE) == gla::kBF16) {                 \
    using IO = float; using ST = __nv_bfloat16; __VA_ARGS__;                      \
  } else if ((IO_CODE) == gla::kBF16 && (ST_CODE) == gla::kF32) {                 \
    using IO = __nv_bfloat16; using ST = float; __VA_ARGS__;                      \
  } else if ((IO_CODE) == gla::kBF16 && (ST_CODE) == gla::kBF16) {                \
    using IO = __nv_bfloat16; using ST = __nv_bfloat16; __VA_ARGS__;              \
  } else {                                                                        \
    return -2;                                                                    \
  }
