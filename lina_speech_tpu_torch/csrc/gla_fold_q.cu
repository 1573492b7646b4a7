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
// here the rank-L update runs on the tensor cores with f32 sums from
// f32-accurate operands (three bf16 parts, gla_fold.cuh), and round(S / s)
// takes the IEEE quotient S / s (equal bits, from s's reciprocal, quotient()).
// The window buffers are left as they are (stale by contract; the lazy step
// masks them).
//
// What bounds it on the H100: bytes. The int8 state is read and written once
// (b8 flagship: 4.2 MB each way per layer) against 2 L FLOP per element and
// a dequantization and requantization per element, whose instruction stream
// (about 2 us at b8 across the card) has to overlap the state's. Design: as
// gla_fold.cu, a block owns a band of R key rows (the route code,
// ops/gla_cuda.py:gla_fold_q_plan) as 1, 2 or 4 sub-bands of 16-row warp
// tiles, a lane 16 consecutive columns (one 16-byte word) of rows g and
// g + 8, copied through a ring of shared memory; a row's new scale needs the
// maximum over all its columns before any element can be written, so a
// block holds whole rows: DV / 64 warps across, each row's maximum a lane
// maximum, two quad shuffles and a pass through shared memory across the
// warps. The conversions avoid the GPU's quarter-rate units: int8 to f32 and
// the rounding to int8 by float bit patterns, the quotient from one
// reciprocal a row.
#include <algorithm>
#include <cstdint>

#include "gla_fold.cuh"

namespace {

using namespace gla;

constexpr int kMaxWarps = 8;        // warps of a block (at most)
constexpr int kRing = 2;            // sub-bands of the state in flight (a power of two)
static_assert((kRing & (kRing - 1)) == 0, "ring slots are taken by a mask");
constexpr int kWholeBytes = 65536;  // most staged-window bytes for a window staged once
constexpr int kPassBytes = 49152;   // ... for a pass of a longer window

// The geometry of a launch with band height R: DV / 64 warps across (all of
// a row), RB down a sub-band, S sub-bands; K window slots staged at once (a
// multiple of 16), the whole window or a pass of it.
struct BandShape {
  int RB, S, K, smem;
  bool whole;
};

template <typename IO>
bool band_shape(int DK, int DV, int L, int R, BandShape& g) {
  if (R <= 0 || R % 16 != 0 || DK % R != 0) return false;
  const int WA = DV / 64;
  g.RB = std::min(kMaxWarps / WA, R / 16);
  while (R / 16 % g.RB) --g.RB;  // whole sub-bands
  g.S = R / (16 * g.RB);
  if (g.S != 1 && g.S != 2 && g.S != 4) return false;
  const int RS = R / g.S;
  const int K = (L + 15) / 16 * 16;
  g.whole = fold::staged_bytes<IO>(K, R, DV) <= kWholeBytes;
  g.K = K;
  if (!g.whole) {
    g.K = 16;
    while (g.K + 16 < K && fold::staged_bytes<IO>(g.K + 16, RS, DV) <= kPassBytes) g.K += 16;
  }
  // the ring, the staged window, two sub-bands' row maxima
  g.smem = std::min(kRing, g.S) * RS * DV + fold::staged_bytes<IO>(g.K, g.whole ? R : RS, DV) +
           2 * RS * WA * (int)sizeof(float);
  return true;
}

// Byte k of x (an int8) as f32, exactly, without a conversion instruction:
// 2^23 + (b + 128) is a float whose bits hold b + 128 in the low byte.
__device__ __forceinline__ float int8_to_f(unsigned x, int k) {
  const unsigned b = __byte_perm(x ^ 0x80808080u, 0x4B000000u, 0x7540 + k);
  return __uint_as_float(b) - 8388736.f;
}

// a / b correctly rounded (the IEEE quotient, equal bits), given y = 1 / b
// correctly rounded: q = a y is within 1.5 ulp of a / b; q + (a - b q) y,
// the residual exact in an fma, within half an ulp and a little; a second
// step from there rounds to a / b (Markstein's theorem, which wants q within
// an ulp). That needs no underflow: |a| >= 2^-103 and a / b a normal float.
// Where |a| is smaller (b >= 2^-90 here) or a / b subnormal, |a / b| <
// 2^-13 and both round to 0, so round(a / b) is the same; the caller takes
// a true division where b < 2^-90. scripts/torch_fold_quotient_check.py
// holds this function to the IEEE quotient on the card.
__device__ __forceinline__ float quotient(float a, float b, float y) {
  float q = a * y;
  q = fmaf(fmaf(-q, b, a), y, q);
  return fmaf(fmaf(-q, b, a), y, q);
}

// round(x) for |x| <= 127.5, half to even, as int8 in the low byte: adding
// 1.5 * 2^23 rounds x to an integer and leaves it in the low bits. No clip:
// |S / sc| <= max |S| / RN(max |S| / 127) <= 127 (1 + 2^-24), so
// clip(round(S / sc), -127, 127) = round(S / sc).
__device__ __forceinline__ unsigned f_to_int8(float x) {
  return __float_as_uint(x + 12582912.f);
}

// the low bytes of four words as one
__device__ __forceinline__ unsigned pack4(unsigned a, unsigned b, unsigned c, unsigned d) {
  return __byte_perm(__byte_perm(a, b, 0x0040), __byte_perm(c, d, 0x0040), 0x5410);
}

// WA: warps across a row (DV / 64), each 64 columns of it
template <typename IO, int WA, int S>
__global__ void __launch_bounds__(kMaxWarps * 32, 2)
gla_fold_q_band_kernel(signed char* state, float* s_scale, const IO* __restrict__ kbuf,
                       const IO* __restrict__ vbuf, const float* __restrict__ cbuf,
                       const float* __restrict__ cc, int BH, int DK, int L, int R, int K,
                       int whole, int D) {
  constexpr int NT = 8;         // n8 tiles of a 64-column group
  constexpr int DV = 64 * WA;
  constexpr int SW = DV / 16;   // 16-byte words of a row
  // the ring's depth, bounded for the compiler: with D known in [1, S] it
  // drops the ring's dead paths (left unbounded, the folds ran slower)
  D = min(max(D, 1), S);
  const int RS = R / S;         // rows of a sub-band; D of them in flight
  extern __shared__ uint4 smem[];
  uint4* ring = smem;           // [D][RS][SW] sub-bands of the int8 state
  const fold::Staged win = fold::carve<IO>(ring + D * RS * SW, K, whole ? R : RS, DV);
  float* smax = reinterpret_cast<float*>(
      reinterpret_cast<char*>(ring + D * RS * SW) +
      fold::staged_bytes<IO>(K, whole ? R : RS, DV));  // [2][RS][WA]

  const int bands = DK / R;
  const int bh = blockIdx.x / bands;
  const int band0 = (blockIdx.x % bands) * R;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int g8 = lane / 4, t = lane % 4;
  const int wa = warp % WA;                // the warp's 64 columns
  const int m0 = 16 * (warp / WA);         // its 16 rows in a sub-band
  const float* ccrow = cc + (size_t)bh * DK + band0;
  float* scrow = s_scale + (size_t)bh * DK + band0;
  signed char* head = state + ((size_t)bh * DK + band0) * DV;
  const int word = 4 * wa + t;             // the thread's 16 columns of a row

  // the thread's words: rows m0 + g8 + 8 h of a sub-band, columns 16 word ..
  auto slot = [&](int s, int h) {
    return ((s & (D - 1)) * RS + m0 + g8 + 8 * h) * SW + word;
  };
  auto issue = [&](int s) {
#pragma unroll
    for (int h = 0; h < 2; ++h)
      q8::cp_async16(ring + slot(s, h), head + (size_t)(s * RS + m0 + g8 + 8 * h) * DV + 16 * word,
                     true);
  };
  // the window's first stage round (keys, v: small, mostly from L2) is asked
  // for first, so it does not queue behind the state; then the first D
  // sub-bands' words, one copy group each; the row scales and gate sums
  fold::Stage<IO, NT> stage{win, kbuf, vbuf, cbuf, ccrow, BH, DK, DV, bh, band0, 0, R,
                            0, DV, 0, K, L};
  if (whole) stage.load(0);
  for (int s = 0; s < D; ++s) {
    issue(s);
    q8::cp_async_commit();
  }
  float f[S][2];  // e^{cc} s of the thread's rows
#pragma unroll
  for (int s = 0; s < S; ++s)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int i = s * RS + m0 + g8 + 8 * h;
      f[s][h] = scrow[i] * expf(ccrow[i]);
    }
  if (whole) {  // the rest of the window's stage, behind the state's copies
    stage.store(0);
    for (int r = 1; r < stage.rounds(); ++r) {
      stage.load(r);
      stage.store(r);
    }
  }

  // window buffers are (L, BH, D): element (j, bh, c) at (j * BH + bh) * D + c
#pragma unroll
  for (int s = 0; s < S; ++s) {
    float acc[1][NT][4] = {};  // the update, from zero; column 2 n + e of the
                               // thread's 16 is acc[0][n][e + 2 h]
    for (int j0 = 0; j0 < L; j0 += K) {
      if (whole) {
        fold::cp_async_wait_upto(min(D, S - s) - 1);  // sub-bands 0 .. s are in
        if (s == 0) __syncthreads();                   // ... and the staged window
      } else {
        __syncthreads();  // every read of the last pass ends before this overwrites
        fold::Stage<IO, NT> pass{win, kbuf, vbuf, cbuf, ccrow, BH, DK, DV, bh, band0, s * RS, RS,
                                 0, DV, j0, K, L};
        for (int r = 0; r < pass.rounds(); ++r) {
          pass.load(r);
          pass.store(r);
        }
        fold::cp_async_wait_all();
        __syncthreads();
      }
      fold::update<NT, 1, fold::kVParts<IO>>(acc, win, (whole ? s * RS : 0) + m0, 64 * wa, K);
    }
    // the dequantized state (e^{cc} s) S_q + the update, rounded as the
    // plain version rounds it (no contraction)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const uint4 in = ring[slot(s, h)];
      const unsigned x[4] = {in.x, in.y, in.z, in.w};
#pragma unroll
      for (int o = 0; o < 16; ++o) {
        float& a = acc[0][o / 2][o % 2 + 2 * h];
        a = __fadd_rn(__fmul_rn(f[s][h], int8_to_f(x[o / 4], o % 4)), a);
      }
    }
    if (s + D < S) {  // the slot is free again: the next sub-band's words
      issue(s + D);
      q8::cp_async_commit();
    }
    // a fresh scale per row: the lane's maximum, its quad's (64 columns),
    // then the row's across the WA warps
    float mx[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mx[h] = 0.f;
#pragma unroll
      for (int o = 0; o < 16; ++o) mx[h] = fmaxf(mx[h], fabsf(acc[0][o / 2][o % 2 + 2 * h]));
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
    }
    if constexpr (WA > 1) {
      float* part = smax + (s % 2) * RS * WA;
      if (t == 0) {
#pragma unroll
        for (int h = 0; h < 2; ++h) part[(m0 + g8 + 8 * h) * WA + wa] = mx[h];
      }
      __syncthreads();
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int a = 0; a < WA; ++a) mx[h] = fmaxf(mx[h], part[(m0 + g8 + 8 * h) * WA + a]);
    }
    // the row goes back as int8: clip(round(S / sc)), round half to even
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float sc = fmaxf(mx[h], 1e-30f) / 127.f;
      const float y = __frcp_rn(sc);
      unsigned q[16];
      if (sc >= 0x1p-90f) {
#pragma unroll
        for (int o = 0; o < 16; ++o)
          q[o] = f_to_int8(quotient(acc[0][o / 2][o % 2 + 2 * h], sc, y));
      } else {  // a row of near-zero values (max |S| < 2^-83)
#pragma unroll
        for (int o = 0; o < 16; ++o) q[o] = f_to_int8(acc[0][o / 2][o % 2 + 2 * h] / sc);
      }
      const uint4 out = make_uint4(pack4(q[0], q[1], q[2], q[3]), pack4(q[4], q[5], q[6], q[7]),
                                   pack4(q[8], q[9], q[10], q[11]),
                                   pack4(q[12], q[13], q[14], q[15]));
      const int i = s * RS + m0 + g8 + 8 * h;
      *reinterpret_cast<uint4*>(head + (size_t)i * DV + 16 * word) = out;
      if (wa == 0 && t == 0) scrow[i] = sc;
    }
  }
}

// One launch with band height R: -8 for a height the layout cannot cut
// (whole 16-row warp tiles in 1, 2 or 4 sub-bands, dividing DK).
template <typename IO, int WA>
int launch_band(void* state, void* s_scale, const void* kbuf, const void* vbuf,
                const void* cbuf, const void* cc, int B, int H, int DK, int L, int R,
                cudaStream_t stream) {
  BandShape g;
  if (!band_shape<IO>(DK, 64 * WA, L, R, g)) return -8;
#define Q_LAUNCH(SV)                                                                           \
  do {                                                                                         \
    auto kernel = gla_fold_q_band_kernel<IO, WA, SV>;                                          \
    if (g.smem > 48 * 1024)                                                                    \
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, g.smem);       \
    kernel<<<B * H * (DK / R), 32 * WA * g.RB, g.smem, stream>>>(                              \
        static_cast<signed char*>(state), static_cast<float*>(s_scale),                        \
        static_cast<const IO*>(kbuf), static_cast<const IO*>(vbuf),                            \
        static_cast<const float*>(cbuf), static_cast<const float*>(cc), B * H, DK, L, R, g.K,  \
        g.whole, std::min(kRing, g.S));                                                        \
  } while (0)
  if (g.S == 1) Q_LAUNCH(1);
  else if (g.S == 2) Q_LAUNCH(2);
  else Q_LAUNCH(4);
#undef Q_LAUNCH
  return static_cast<int>(cudaGetLastError());
}

template <typename IO>
int launch_dv(void* state, void* s_scale, const void* kbuf, const void* vbuf,
              const void* cbuf, const void* cc, int B, int H, int DK, int DV, int L, int R,
              cudaStream_t stream) {
  switch (DV) {
    case 128: return launch_band<IO, 2>(state, s_scale, kbuf, vbuf, cbuf, cc, B, H, DK, L, R, stream);
    case 256: return launch_band<IO, 4>(state, s_scale, kbuf, vbuf, cbuf, cc, B, H, DK, L, R, stream);
    case 512: return launch_band<IO, 8>(state, s_scale, kbuf, vbuf, cbuf, cc, B, H, DK, L, R, stream);
    default: return -3;
  }
}

}  // namespace

// C entry point (bound with ctypes in ops/gla_cuda.py). Layouts: state (B,
// H, DK, DV) int8 and s_scale (B, H, DK) f32, both updated in place; kbuf
// (L, B, H, DK) and vbuf (L, B, H, DV) in the buffer dtype (code io_dtype);
// cbuf (L, B, H, DK) and cc (B, H, DK) f32. All contiguous. rows: the band
// height. Returns cudaGetLastError() after the launch, -1 for a DK that is
// not a multiple of 16, -2 for an unsupported dtype code, -3 for a DV
// outside {128, 256, 512}, -6 for a state or vbuf off a 16-byte boundary
// (both are read in 16-byte words), -8 for a band height the layout cannot
// cut.
extern "C" int gla_fold_q_window(void* state, void* s_scale, const void* kbuf,
                                 const void* vbuf, const void* cbuf, const void* cc, int B,
                                 int H, int DK, int DV, int L, int io_dtype, int rows,
                                 void* stream) {
  if (DK % 16 != 0) return -1;
  if (reinterpret_cast<uintptr_t>(state) % 16 != 0 || reinterpret_cast<uintptr_t>(vbuf) % 16 != 0)
    return -6;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (io_dtype == gla::kF32)
    return launch_dv<float>(state, s_scale, kbuf, vbuf, cbuf, cc, B, H, DK, DV, L, rows, st);
  if (io_dtype == gla::kBF16)
    return launch_dv<__nv_bfloat16>(state, s_scale, kbuf, vbuf, cbuf, cc, B, H, DK, DV, L,
                                    rows, st);
  return -2;
}
