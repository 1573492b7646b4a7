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
// here the rank-L update is formed on the tensor cores with f32 sums from
// f32-accurate operands (three bf16 parts, gla_fold.cuh), then e^{cc} S is
// added to it in f32 as the plain version adds it; only the result is
// rounded to the state dtype. The window buffers are left as they are
// (stale by contract; the lazy step masks them).
//
// What bounds it on the H100: bytes. The state is read and written once
// (b8 flagship: 8.4 MB each way per layer in bf16) against 2 L FLOP per
// state element. Design: a block owns a band of R key rows (the route code,
// ops/gla_cuda.py:gla_fold_plan) across the value columns of one (batch,
// head), as 1, 2 or 4 sub-bands of whole 16-row warp tiles; a warp takes 64
// columns (32 where the head has an odd number of 32-column groups), a lane
// the 8 consecutive columns of each group in rows g and g + 8 (gla_fold.cuh),
// so the state moves in 16-byte words: each thread copies its own words into
// a ring of shared memory (cp.async, kRing sub-bands in flight) and reads
// them back after its own wait, so no barrier guards the ring. The block
// first asks for its share of the window (the band's decayed keys: R x L
// exponentials that no other block forms; v in MMA column order), so that
// those small loads do not queue behind the state's, then for the state;
// one barrier, then each sub-band is updated (mma.sync), its decayed state
// added and stored as its words arrive, the next sub-band's copy issued as
// its slot frees. A window longer than fits the stage is staged in passes
// of 16-slot steps. A head wider than kMaxWarps warps splits its columns
// across blocks (grid.y), which then form the band's decayed keys once each.
#include <algorithm>
#include <cstdint>

#include "gla_fold.cuh"

namespace {

using namespace gla;

constexpr int kMaxWarps = 16;       // warps of a block (at most)
constexpr int kRing = 2;            // sub-bands of the state in flight (a power of two)
static_assert((kRing & (kRing - 1)) == 0, "ring slots are taken by a mask");
constexpr int kWholeBytes = 65536;  // most staged-window bytes for a window staged once
constexpr int kPassBytes = 49152;   // ... for a pass of a longer window

// The geometry of a launch with band height R: NG column groups of 32 a
// warp, WA warps across, RB down a sub-band, S sub-bands; K window slots
// staged at once (a multiple of 16), the whole window or a pass of it.
struct BandShape {
  int NG, WA, RB, S, K, smem;
  bool whole;
  dim3 grid;
};

template <typename IO, typename ST>
bool band_shape(int B, int H, int DK, int DV, int L, int R, BandShape& g) {
  if (R <= 0 || R % 16 != 0 || DK % R != 0) return false;
  const int groups = DV / 32;
  g.NG = groups % 2 == 0 ? 2 : 1;
  const int NWA = groups / g.NG;  // warps across the head
  g.WA = std::min(NWA, kMaxWarps);
  g.RB = std::min(kMaxWarps / g.WA, R / 16);
  while (R / 16 % g.RB) --g.RB;  // whole sub-bands
  g.S = R / (16 * g.RB);
  if (g.S != 1 && g.S != 2 && g.S != 4) return false;
  const int BC = g.WA * g.NG * 32;  // the block's columns
  const int K = (L + 15) / 16 * 16;
  g.whole = fold::staged_bytes<IO>(K, R, BC) <= kWholeBytes;
  g.K = K;
  if (!g.whole) {
    g.K = 16;
    while (g.K + 16 < K && fold::staged_bytes<IO>(g.K + 16, R / g.S, BC) <= kPassBytes) g.K += 16;
  }
  g.smem = std::min(kRing, g.S) * (R / g.S) * BC * (int)sizeof(ST) +
           fold::staged_bytes<IO>(g.K, g.whole ? R : R / g.S, BC);
  g.grid = dim3(B * H * (DK / R), (NWA + g.WA - 1) / g.WA);
  return true;
}

template <typename IO, typename ST, int NG, int S>
__global__ void __launch_bounds__(kMaxWarps * 32, 1)
gla_fold_band_kernel(ST* state, const IO* __restrict__ kbuf, const IO* __restrict__ vbuf,
                     const float* __restrict__ cbuf, const float* __restrict__ cc,
                     int BH, int DK, int DV, int L, int R, int WA, int K, int whole,
                     int D) {
  constexpr int NT = 4;                       // n8 tiles of a 32-column group
  constexpr int SN = Word<ST>::N;             // values of a state word
  constexpr int NW = 8 / SN;                  // state words of a thread's 8 columns
  // the ring's depth, bounded for the compiler: with D known in [1, S] it
  // drops the ring's dead paths (left unbounded, the folds ran slower)
  D = min(max(D, 1), S);
  const int RS = R / S;                       // rows of a sub-band; D of them in flight
  const int BC = WA * NG * 32;                // the block's columns
  const int SW = BC / SN;                     // state words of a ring row
  extern __shared__ uint4 smem[];
  uint4* ring = smem;                         // [D][RS][SW] sub-bands of the state
  const fold::Staged win =
      fold::carve<IO>(ring + D * RS * SW, K, whole ? R : RS, BC);

  const int bands = DK / R;
  const int bh = blockIdx.x / bands;
  const int band0 = (blockIdx.x % bands) * R;
  const int c0 = blockIdx.y * BC;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int g8 = lane / 4, t = lane % 4;
  const int wa = warp % WA;                   // the warp's place across
  const int m0 = 16 * (warp / WA);            // its 16 rows in a sub-band
  const float* ccrow = cc + (size_t)bh * DK + band0;
  ST* head = state + ((size_t)bh * DK + band0) * DV;

  // the thread's words: rows m0 + g8 + 8 h of a sub-band, columns
  // 32 (wa NG + gi) + 8 t .. + 7 of the block
  auto col = [&](int gi) { return 32 * (wa * NG + gi) + 8 * t; };
  auto slot = [&](int s, int h, int gi, int u) {
    return ((s & (D - 1)) * RS + m0 + g8 + 8 * h) * SW + col(gi) / SN + u;
  };
  auto issue = [&](int s) {
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int gi = 0; gi < NG; ++gi)
        if (c0 + col(gi) < DV) {
#pragma unroll
          for (int u = 0; u < NW; ++u)
            q8::cp_async16(ring + slot(s, h, gi, u),
                           head + (size_t)(s * RS + m0 + g8 + 8 * h) * DV + c0 + col(gi) + u * SN,
                           true);
        }
  };
  // the window's first stage round (keys, v: small, mostly from L2) is asked
  // for first, so it does not queue behind the state; then the first D
  // sub-bands' words, one copy group each
  fold::Stage<IO, NT> stage{win, kbuf, vbuf, cbuf, ccrow, BH, DK, DV, bh, band0, 0, R,
                            c0, BC, 0, K, L};
  if (whole) stage.load(0);
  for (int s = 0; s < D; ++s) {
    issue(s);
    q8::cp_async_commit();
  }
  float ecc[S][2];
#pragma unroll
  for (int s = 0; s < S; ++s)
#pragma unroll
    for (int h = 0; h < 2; ++h) ecc[s][h] = expf(ccrow[s * RS + m0 + g8 + 8 * h]);
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
    float acc[NG][NT][4] = {};  // the update, from zero
    for (int j0 = 0; j0 < L; j0 += K) {
      if (whole) {
        fold::cp_async_wait_upto(min(D, S - s) - 1);  // sub-bands 0 .. s are in
        if (s == 0) __syncthreads();                   // ... and the staged window
      } else {
        __syncthreads();  // every read of the last pass ends before this overwrites
        fold::Stage<IO, NT> pass{win, kbuf, vbuf, cbuf, ccrow, BH, DK, DV, bh, band0, s * RS, RS,
                                 c0, BC, j0, K, L};
        for (int r = 0; r < pass.rounds(); ++r) {
          pass.load(r);
          pass.store(r);
        }
        fold::cp_async_wait_all();
        __syncthreads();
      }
      fold::update<NT, NG, fold::kVParts<IO>>(acc, win, (whole ? s * RS : 0) + m0, 32 * wa * NG,
                                            K);
    }
    // e^{cc} S + the update, rounded as the plain version rounds it (no
    // contraction); column 2 n + e of a group is acc[.][n][e + 2 h]
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int gi = 0; gi < NG; ++gi) {
        uint4 w[NW];
#pragma unroll
        for (int u = 0; u < NW; ++u) w[u] = ring[slot(s, h, gi, u)];
        float f[8];
#pragma unroll
        for (int u = 0; u < NW; ++u) {
          float x[SN];
          Word<ST>::unpack(w[u], x);
#pragma unroll
          for (int e = 0; e < SN; ++e) f[u * SN + e] = x[e];
        }
#pragma unroll
        for (int o = 0; o < 8; ++o) {
          float& a = acc[gi][o / 2][o % 2 + 2 * h];
          a = __fadd_rn(__fmul_rn(ecc[s][h], f[o]), a);
        }
      }
    if (s + D < S) {  // the slot is free again: the next sub-band's words
      issue(s + D);
      q8::cp_async_commit();
    }
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int gi = 0; gi < NG; ++gi) {
        if (c0 + col(gi) >= DV) continue;
        float f[8];
#pragma unroll
        for (int o = 0; o < 8; ++o) f[o] = acc[gi][o / 2][o % 2 + 2 * h];
        ST* dst = head + (size_t)(s * RS + m0 + g8 + 8 * h) * DV + c0 + col(gi);
#pragma unroll
        for (int u = 0; u < NW; ++u) {
          float x[SN];
#pragma unroll
          for (int e = 0; e < SN; ++e) x[e] = f[u * SN + e];
          reinterpret_cast<uint4*>(dst)[u] = Word<ST>::pack(x);
        }
      }
  }
}

// One launch with band height R: -8 for a height the layout cannot cut
// (whole 16-row warp tiles in 1, 2 or 4 sub-bands, dividing DK).
template <typename IO, typename ST>
int launch_band(void* state, const void* kbuf, const void* vbuf, const void* cbuf,
                const void* cc, int B, int H, int DK, int DV, int L, int R,
                cudaStream_t stream) {
  BandShape g;
  if (!band_shape<IO, ST>(B, H, DK, DV, L, R, g)) return -8;
#define BAND_LAUNCH(NGV, SV)                                                                   \
  do {                                                                                         \
    auto kernel = gla_fold_band_kernel<IO, ST, NGV, SV>;                                       \
    if (g.smem > 48 * 1024)                                                                    \
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, g.smem);       \
    kernel<<<g.grid, 32 * g.WA * g.RB, g.smem, stream>>>(                                      \
        static_cast<ST*>(state), static_cast<const IO*>(kbuf), static_cast<const IO*>(vbuf),   \
        static_cast<const float*>(cbuf), static_cast<const float*>(cc), B * H, DK, DV, L, R,   \
        g.WA, g.K, g.whole, std::min(kRing, g.S));                                             \
  } while (0)
  if (g.NG == 2) {
    if (g.S == 1) BAND_LAUNCH(2, 1);
    else if (g.S == 2) BAND_LAUNCH(2, 2);
    else BAND_LAUNCH(2, 4);
  } else {
    if (g.S == 1) BAND_LAUNCH(1, 1);
    else if (g.S == 2) BAND_LAUNCH(1, 2);
    else BAND_LAUNCH(1, 4);
  }
#undef BAND_LAUNCH
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// C entry point (bound with ctypes in ops/gla_cuda.py). Layouts: state (B,
// H, DK, DV), updated in place; kbuf (L, B, H, DK) and vbuf (L, B, H, DV) in
// the buffer dtype (code io_dtype); cbuf (L, B, H, DK) and cc (B, H, DK)
// f32. All contiguous. rows: the band height. Returns cudaGetLastError()
// after the launch, -1 for an unsupported DK, -2 for unsupported dtype
// codes, -3 for DV % 32 != 0, -6 for a state or vbuf off a 16-byte boundary
// (both are read in 16-byte words), -8 for a band height the layout cannot
// cut.
extern "C" int gla_fold_window(void* state, const void* kbuf, const void* vbuf,
                               const void* cbuf, const void* cc, int B, int H, int DK,
                               int DV, int L, int io_dtype, int state_dtype, int rows,
                               void* stream) {
  if (DV % 32 != 0 || DV < 32) return -3;
  if (reinterpret_cast<uintptr_t>(state) % 16 != 0 || reinterpret_cast<uintptr_t>(vbuf) % 16 != 0)
    return -6;
  if (DK != 64 && DK != 128 && DK != 256) return -1;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  GLA_DISPATCH_TYPES(io_dtype, state_dtype,
                     return launch_band<IO, ST>(state, kbuf, vbuf, cbuf, cc, B, H, DK, DV, L,
                                                rows, st))
  return -2;
}
