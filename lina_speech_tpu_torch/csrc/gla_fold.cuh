// The rank-L update of the two window folds (gla_fold.cu, gla_fold_q.cu) on
// the tensor cores.
//
// A block folds a band of key rows of one (batch, head): acc (rows x
// columns) += KD . V, KD[i][j] = k_j[i] e^{min(cc[i] - c_j[i], 0)} (the decayed
// keys), V[j][c] = v_j[c], j over the window's slots. Each warp owns a
// 16-row tile of the band and a run of column groups; mma.sync m16n8k16
// takes KD as A (16 rows x 16 slots) and V as B (16 slots x 8 columns), with
// f32 sums. The Pallas kernel's MXU takes KD rounded to bf16; the port's
// function keeps f32 operands, so KD goes in three bf16 parts (hi =
// bf16(KD), mid = bf16(KD - hi), lo = bf16(KD - hi - mid): KD to about 2^-24
// of itself, as f32 holds it), and so does V from f32 buffers (bf16 v is
// exact in one part): three mma a tile and k-step, six for f32 v (the
// products of parts whose orders add up to 2^-16 or more). Two parts (KD to
// 2^-16) move an int8 row's fresh scale by more than 1e-5 of itself.
//
// Column order: the accumulator of an n8 tile gives a lane (g = lane / 4,
// t = lane % 4) columns 2t and 2t + 1. Over NT n8 tiles of a column group
// (8 NT columns), MMA column 8 n + c stands for the group's column
// 2 NT (c / 2) + 2 n + c % 2, so lane t's columns of the group are the 2 NT
// consecutive columns from 2 NT t: whole 16-byte words of the state (8 bf16,
// 2 x 4 f32, or 16 int8) in rows g and g + 8. V is staged in shared memory
// in MMA column order, so a B fragment is one ldmatrix.trans.
#pragma once

#include <cstdint>

#include "gla_common.cuh"
#include "gla_mma.cuh"
#include "int8_common.cuh"

namespace gla {
namespace fold {

using bf16 = __nv_bfloat16;

constexpr int kPad = 8;  // bf16 of row padding: the 8 rows of an ldmatrix on distinct banks

// MMA position of column a of a group of 8 NT columns
template <int NT> __device__ __forceinline__ int mma_pos(int a) {
  const int q = a / (2 * NT), rem = a % (2 * NT);
  return 8 * (rem / 2) + 2 * q + rem % 2;
}

__device__ __forceinline__ uint32_t pack_bf16(float x, float y) {
  const __nv_bfloat162 p = __floats2bfloat162_rn(x, y);
  return *reinterpret_cast<const uint32_t*>(&p);
}

// x as hi + mid + lo in bf16 (each difference exact in f32)
__device__ __forceinline__ void split_bf16(float x, bf16 (&p)[3]) {
  p[0] = __float2bfloat16_rn(x);
  const float r = x - __bfloat162float(p[0]);
  p[1] = __float2bfloat16_rn(r);
  p[2] = __float2bfloat16_rn(r - __bfloat162float(p[1]));
}

// v parts of IO: one for bf16 (exact), three for f32
template <typename IO> constexpr int kVParts = sizeof(IO) == 4 ? 3 : 1;

// The staged window of one pass: the three parts of kd [rows][kld], v's
// parts [K][vld] in MMA column order, K slots (a multiple of 16; slots past
// the window are zero in v and kd).
struct Staged {
  bf16* k[3];
  bf16* v[3];
  int kld, vld;
};

// bytes of a Staged of K slots for R key rows and BC columns
template <typename IO> __host__ __device__ inline int staged_bytes(int K, int R, int BC) {
  return 3 * R * (K + kPad) * 2 + kVParts<IO> * K * (BC + kPad) * 2;
}

template <typename IO>
__device__ __forceinline__ Staged carve(void* p, int K, int R, int BC) {
  Staged s;
  s.kld = K + kPad;
  s.vld = BC + kPad;
  bf16* at = static_cast<bf16*>(p);
  for (int q = 0; q < 3; ++q, at += R * s.kld) s.k[q] = at;
  for (int q = 0; q < 3; ++q) {
    s.v[q] = q < kVParts<IO> ? at : nullptr;
    if (q < kVParts<IO>) at += K * s.vld;
  }
  return s;
}

constexpr int kStageLoads = 4;  // global loads of a staging thread in flight together

// Staging slots [j0, j0 + K) of the window (those at or past L as zeros): the
// decayed keys of the band's rows [k0, k0 + nk) (band rows from band0 of
// head bh), and v of the block's columns [c0, c0 + BC) (columns past DV as
// zeros), in groups of 8 NT columns. Every thread of the block takes part,
// in rounds of kStageLoads loads a thread: load(r) brings round r into
// registers, store(r) writes it to shared memory, so a caller can ask for
// the state between the two; it waits (barrier) before any read.
template <typename IO, int NT> struct Stage {
  static constexpr int IV = Word<IO>::N;  // values of a v word
  Staged s;
  const IO* __restrict__ kbuf;
  const IO* __restrict__ vbuf;
  const float* __restrict__ cbuf;
  const float* __restrict__ ccrow;
  int BH, DK, DV, bh, band0, k0, nk, c0, BC, j0, K, L;
  float kx[kStageLoads][2], cx[kStageLoads][2], ci[kStageLoads];
  uint4 vx[kStageLoads];

  __device__ __forceinline__ int rounds() const {
    const int per = kStageLoads * blockDim.x;
    return max((nk * K / 2 + per - 1) / per, (K * (BC / IV) + per - 1) / per);
  }
  __device__ __forceinline__ int key(int r, int u) const {  // (row, slot pair) index
    return (r * kStageLoads + u) * blockDim.x + threadIdx.x;
  }
  __device__ __forceinline__ void load(int r) {
    const int kp = K / 2, words = BC / IV;
#pragma unroll
    for (int u = 0; u < kStageLoads; ++u) {
      const int idx = key(r, u);
      if (idx < nk * kp) {
        const int i = k0 + idx / kp, j = j0 + 2 * (idx % kp);
        ci[u] = ccrow[i];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const bool in = j + e < L;
          const size_t off = ((size_t)(in ? j + e : 0) * BH + bh) * DK + band0 + i;
          kx[u][e] = in ? to_f(kbuf[off]) : 0.f;
          cx[u][e] = in ? cbuf[off] : 0.f;
        }
      }
      const int j = j0 + idx / words, c = c0 + (idx % words) * IV;
      vx[u] = idx < K * words && j < L && c < DV
                  ? *reinterpret_cast<const uint4*>(vbuf + ((size_t)j * BH + bh) * DV + c)
                  : make_uint4(0, 0, 0, 0);
    }
  }
  __device__ __forceinline__ void store(int r) const {
    const int kp = K / 2, words = BC / IV;
#pragma unroll
    for (int u = 0; u < kStageLoads; ++u) {
      const int idx = key(r, u);
      if (idx < nk * kp) {
        const int i = idx / kp, j = 2 * (idx % kp);
        bf16 p0[3], p1[3];
        split_bf16(kx[u][0] * expf(fminf(ci[u] - cx[u][0], 0.f)), p0);
        split_bf16(kx[u][1] * expf(fminf(ci[u] - cx[u][1], 0.f)), p1);
#pragma unroll
        for (int q = 0; q < 3; ++q)
          *reinterpret_cast<__nv_bfloat162*>(s.k[q] + i * s.kld + j) =
              __halves2bfloat162(p0[q], p1[q]);
      }
      if (idx < K * words) {  // the word's column pairs to their MMA positions
        const int j = idx / words, a = (idx % words) * IV;  // block column of the word
        float f[IV];
        Word<IO>::unpack(vx[u], f);
#pragma unroll
        for (int e = 0; e < IV; e += 2) {
          const int col = a + e, g = col / (8 * NT);
          const int p = j * s.vld + g * 8 * NT + mma_pos<NT>(col % (8 * NT));
          if constexpr (IV == 4) {  // f32 v: three parts
            bf16 p0[3], p1[3];
            split_bf16(f[e], p0);
            split_bf16(f[e + 1], p1);
#pragma unroll
            for (int q = 0; q < 3; ++q)
              *reinterpret_cast<__nv_bfloat162*>(s.v[q] + p) = __halves2bfloat162(p0[q], p1[q]);
          } else {
            *reinterpret_cast<uint32_t*>(s.v[0] + p) = pack_bf16(f[e], f[e + 1]);
          }
        }
      }
    }
  }
};

// acc[g][n] (the warp's 16 rows from m0, n8 tile n of column group g, NG
// groups from MMA column n0) += KD . V over the staged K slots: parts a of
// KD times parts b of V with a + b < 3
template <int NT, int NG, int VP>
__device__ __forceinline__ void update(float (&acc)[NG][NT][4], const Staged& s, int m0, int n0,
                                       int K) {
  for (int k0 = 0; k0 < K; k0 += 16) {
    uint32_t a[3][4];
#pragma unroll
    for (int q = 0; q < 3; ++q) mma::frag_a<false>(a[q], s.k[q], s.kld, m0, k0);
#pragma unroll
    for (int g = 0; g < NG; ++g)
#pragma unroll
      for (int n = 0; n < NT; n += 2)
#pragma unroll
        for (int vb = 0; vb < VP; ++vb) {
          uint32_t b[4];
          mma::frag_b<true>(b, s.v[vb], s.vld, k0, n0 + g * 8 * NT + 8 * n);
#pragma unroll
          for (int q = 0; q + vb < 3; ++q) {
            q8::mma_bf16(acc[g][n], a[q], b[0], b[1]);
            q8::mma_bf16(acc[g][n + 1], a[q], b[2], b[3]);
          }
        }
  }
}

// cp.async.wait_group 0 and one with a count known only after unrolling; the
// memory clobber keeps a thread's reads of its own copies after the wait
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_upto(int n) {
  switch (n) {
    case 0: asm volatile("cp.async.wait_group 0;\n" ::: "memory"); break;
    case 1: asm volatile("cp.async.wait_group 1;\n" ::: "memory"); break;
    case 2: asm volatile("cp.async.wait_group 2;\n" ::: "memory"); break;
    default: asm volatile("cp.async.wait_group 3;\n" ::: "memory"); break;
  }
}

}  // namespace fold
}  // namespace gla
