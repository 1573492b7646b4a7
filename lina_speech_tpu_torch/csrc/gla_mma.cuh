// Fragment loads of bf16 mma.sync operands staged in shared memory
// (ldmatrix), shared by the GLA kernels on the tensor cores:
// gla_chunked_bwd.cuh (and the chunked forwards and RWKV6's kernels built on
// it) and gla_fold.cuh.
#pragma once

#include <cstdint>

#include <cuda_bf16.h>

namespace gla {
namespace mma {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

template <bool TRANS>
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const __nv_bfloat16* p) {
  if constexpr (TRANS) {
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
                 : "r"(smem_addr(p)));
  } else {
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
                 : "r"(smem_addr(p)));
  }
}

// The A fragment (rows m0 .. m0+15, k0 .. k0+15) of a product's left
// operand X[m][k], stored with row stride ld as X (KM false) or as its
// transpose X^T[k][m] (KM true).
template <bool KM>
__device__ __forceinline__ void frag_a(uint32_t (&a)[4], const __nv_bfloat16* s, int ld, int m0,
                                       int k0) {
  const int lane = threadIdx.x & 31, i = lane >> 3, r = lane & 7;
  const __nv_bfloat16* p = KM ? s + (k0 + r + 8 * (i >> 1)) * ld + m0 + 8 * (i & 1)
                              : s + (m0 + r + 8 * (i & 1)) * ld + k0 + 8 * (i >> 1);
  ldsm_x4<KM>(a, p);
}

// The B fragments of two n8 tiles (columns n0 .., n0+8 ..; k0 .. k0+15) of
// a right operand Y[k][n]: b[0], b[1] the first, b[2], b[3] the second;
// stored as Y^T[n][k] (KN false) or as Y[k][n] (KN true).
template <bool KN>
__device__ __forceinline__ void frag_b(uint32_t (&b)[4], const __nv_bfloat16* s, int ld, int k0,
                                       int n0) {
  const int lane = threadIdx.x & 31, i = lane >> 3, r = lane & 7;
  const __nv_bfloat16* p = KN ? s + (k0 + r + 8 * (i & 1)) * ld + n0 + 8 * (i >> 1)
                              : s + (n0 + r + 8 * (i >> 1)) * ld + k0 + 8 * (i & 1);
  ldsm_x4<KN>(b, p);
}

}  // namespace mma
}  // namespace gla
