// Shared helpers of the int8 kernels (int8_linear.cu, fused_ffn_int8.cu):
// conversions, asynchronous 16-byte copies into shared memory, and the two
// tensor-core products they are built on (mma.sync, bf16 and s8).
//
// Both kernels compute a transposed product, out^T (channels x rows) =
// W (channels x K) . x^T, so that the weight is the A operand (16 channels a
// fragment) and the few rows of x are the narrow n8 side. The k order inside
// one fragment is relabelled so that each thread reads its A and B pieces
// with one wide shared-memory load each (the sum over k does not depend on
// the labels, as long as A and B use the same ones):
//   bf16 m16n8k16: fragment columns {2t, 2t+1, 2t+8, 2t+9} of thread t are
//     the stored columns 4t .. 4t+3: one 32-bit load of four int8 weights,
//     one 64-bit load of four bf16 activations;
//   s8 m16n8k32: fragment columns {4t .. 4t+3, 4t+16 .. 4t+19} are the stored
//     columns 8t .. 8t+7: one 64-bit load each for A and B.
#pragma once

#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace q8 {

constexpr int kThreads = 128;  // four warps a block
constexpr int kWarps = kThreads / 32;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
// round to nearest even, as JAX's f32 -> bf16 astype
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

__device__ __forceinline__ uint16_t bf16_bits(float x) {
  return __bfloat16_as_ushort(__float2bfloat16_rn(x));
}

// 16 bytes from device memory into shared memory without passing through
// registers; pred false fills the 16 bytes with zeros and reads nothing
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool pred) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  const int n = pred ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem), "r"(n));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// A split cluster barrier: arrive (release) when this block is done with
// the other blocks' shared memory, wait (acquire) just before it leaves, so
// that no block leaves while another may still read its shared memory, and
// nobody waits in between.
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
}

// two int8 (the low and high byte of v's low half) as a bf16 pair, exact
__device__ __forceinline__ uint32_t i8x2_bf16x2(uint32_t v) {
  const float lo = static_cast<float>(static_cast<signed char>(v & 0xffu));
  const float hi = static_cast<float>(static_cast<signed char>((v >> 8) & 0xffu));
  const __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&p);
}

// d += a . b on the tensor cores: A 16 x 16 bf16 (row), B 16 x 8 bf16 (col),
// f32 accumulation
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d += a . b: A 16 x 32 s8 (row), B 32 x 8 s8 (col), exact int32 sums
__device__ __forceinline__ void mma_s8(int (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                       uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The A fragment of 16 weight rows (int8, row stride ws bytes, this k16 step
// starting at column kk) as bf16: rows g and g + 8, stored columns 4t .. 4t+3
__device__ __forceinline__ void a_frag_bf16(const signed char* w, int ws, int kk, int lane,
                                            uint32_t (&a)[4]) {
  const int g = lane >> 2, t = lane & 3;
  const uint32_t lo = *reinterpret_cast<const uint32_t*>(w + g * ws + kk + 4 * t);
  const uint32_t hi = *reinterpret_cast<const uint32_t*>(w + (g + 8) * ws + kk + 4 * t);
  a[0] = i8x2_bf16x2(lo);
  a[1] = i8x2_bf16x2(hi);
  a[2] = i8x2_bf16x2(lo >> 16);
  a[3] = i8x2_bf16x2(hi >> 16);
}

// The B fragment of 8 rows of x (bf16 bit patterns, row stride xs elements):
// row g, stored columns kk + 4t .. kk + 4t + 3
__device__ __forceinline__ uint2 b_frag_bf16(const uint16_t* x, int xs, int kk, int lane) {
  const int g = lane >> 2, t = lane & 3;
  return *reinterpret_cast<const uint2*>(x + g * xs + kk + 4 * t);
}

}  // namespace q8
