// A SwiGLU FFN over int8 weights whose hidden activation never reaches device
// memory: y = (silu(g) * h) @ dequant(W_out) + b_out with g, h = split(x @
// dequant(W_in)^T + b_in), gate first.
//
// Replaces the TPU kernel fused_ffn_int8 (lina_speech_tpu/ops/qlinear.py:241,
// body _ffn_kernel :156), with its rounding points (:167-181, :235-238):
//
//   g = (sum_k bf16(x_k) Wg[j, k]) * sg[j] + bg[j]      f32, bias joined in f32
//   h = (sum_k bf16(x_k) Wh[j, k]) * sh[j] + bh[j]      f32
//   gb = bf16(g);  u[j] = bf16(bf16(gb / (1 + e^{-gb})) * bf16(h))   (silu in f32)
//   y[n] = (sum_j u[j] W_out[j, n]) * s_out[n] + b_out[n]            f32 sum
//
// (The unfused route rounds g to bf16 before it adds the bias, so the two
// routes differ in the last bit; a SwiGLU takes this one whenever both of its
// weights are int8 and the mode is weight only.)
//
// What bounds it on the H100: bytes, the 2.80 MB of W_in and 1.40 MB of W_out
// read once (d 1024, hidden 1365). On the TPU the grid walks the hidden
// chunks in order and adds into one output block; here blocks run in
// parallel, so a block owns a chunk of 16 hidden units for an m-tile of up to
// 8 rows: it stages the rows of x in shared memory as bf16, computes its 32
// columns of x W_in^T as int8_linear.cu does (a warp owns four weight rows,
// the gate and value rows of two units, and loads a piece of all four before
// it uses any: 16-byte loads along the contiguous axis, W_in held (2H, d)),
// forms u for its 16 units in shared memory, and contracts them with its 16
// rows of W_out, held hidden-major (H, d) so that those rows are contiguous (a
// thread owns 4 neighbouring output columns, one 4-byte load a row, all 16
// loads in flight before the first is used). The per-chunk partial
// outputs (ceil(H / 16), m, d) f32 go to scratch, and a second small kernel
// adds them in a fixed order and applies scale and bias: the result is the
// same from run to run, which f32 atomics would not give. The scratch costs
// 0.35 MB of traffic a row each way, little at decode's m and the first thing
// to fuse away at larger m. The last chunk is ragged (1365 = 85 * 16 + 5):
// its missing units contribute u = 0.
#include "int8_common.cuh"

namespace {

using namespace q8;

constexpr int kChunk = 16;                     // hidden units per block
constexpr int kUnitsPerWarp = kChunk / kWarps;  // 2
constexpr int kDMax = 2048;                    // widest model the x stage holds

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// acc[i][r] = sum_k sx[r][k] * rows[i][k] for the R weight rows of a warp and
// every row r of the m-tile, over this lane's 16-byte pieces of the weight
// rows; the caller reduces across the warp. The R loads of a piece are issued
// together: a weight row is two pieces a lane at d 1024, and the latency of a
// load from device memory, not its bytes, is what a block waits for.
template <int MT, int R>
__device__ __forceinline__ void row_dots(const uint16_t (*sx)[kDMax],
                                         const signed char* const (&rows)[R], int D, int lane,
                                         float (&acc)[R][MT]) {
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int r = 0; r < MT; ++r) acc[i][r] = 0.f;
#pragma unroll 2
  for (int c = lane * 16; c < D; c += 32 * 16) {
    uint4 w[R];
#pragma unroll
    for (int i = 0; i < R; ++i) w[i] = *reinterpret_cast<const uint4*>(rows[i] + c);
#pragma unroll
    for (int i = 0; i < R; ++i) dot16<MT, kDMax>(sx, c, w[i], acc[i]);
  }
}

template <typename X, int MT>
__global__ void __launch_bounds__(kThreads)
ffn_chunk_kernel(const X* __restrict__ x, const signed char* __restrict__ q_in,
                 const float* __restrict__ s_in, const float* __restrict__ b_in,
                 const signed char* __restrict__ q_out, float* __restrict__ parts, int M,
                 int D, int Hd) {
  __shared__ __align__(16) uint16_t sx[MT][kDMax];  // bf16 bit patterns
  __shared__ float su[MT][kChunk];
  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int warp = tid / 32;
  const int j0 = blockIdx.x * kChunk;
  const int m0 = blockIdx.y * MT;

  stage_bf16<X, MT, kDMax>(sx, x, M, D, m0, 0, D, tid);
  __syncthreads();

  // this warp's hidden units: u = bf16(bf16(silu(bf16(g))) * bf16(h)). The
  // gate and value rows of kTogether units go through row_dots together (all
  // of the warp's at a small m-tile, one unit at the 8-row tile, whose sums
  // fill the registers); a unit past the ragged end reads row 0 and gives 0
  constexpr int kTogether = MT <= 4 ? kUnitsPerWarp : 1;
#pragma unroll
  for (int u0 = 0; u0 < kUnitsPerWarp; u0 += kTogether) {
    const signed char* rows[2 * kTogether];
#pragma unroll
    for (int uu = 0; uu < kTogether; ++uu) {
      const int j = j0 + warp * kUnitsPerWarp + u0 + uu;
      rows[2 * uu] = q_in + (size_t)(j < Hd ? j : 0) * D;
      rows[2 * uu + 1] = q_in + (size_t)(j < Hd ? Hd + j : 0) * D;
    }
    float gh[2 * kTogether][MT];
    row_dots<MT, 2 * kTogether>(sx, rows, D, lane, gh);
#pragma unroll
    for (int uu = 0; uu < kTogether; ++uu) {
      const int jj = warp * kUnitsPerWarp + u0 + uu;
      const int j = j0 + jj;
      const bool live = j < Hd;  // uniform across the warp
      const float sg = live ? s_in[j] : 0.f, sh = live ? s_in[Hd + j] : 0.f;
      const float bg = (live && b_in != nullptr) ? b_in[j] : 0.f;
      const float bh = (live && b_in != nullptr) ? b_in[Hd + j] : 0.f;
#pragma unroll
      for (int r = 0; r < MT; ++r) {
        // scale, then bias, each rounded on its own (no fused multiply-add)
        const float gf = __fadd_rn(__fmul_rn(warp_sum(gh[2 * uu][r]), sg), bg);
        const float hf = __fadd_rn(__fmul_rn(warp_sum(gh[2 * uu + 1][r]), sh), bh);
        const float gb = round_bf16(gf);
        const float act = round_bf16(gb * (1.f / (1.f + expf(-gb))));
        const float u = live ? round_bf16(act * round_bf16(hf)) : 0.f;
        if (lane == r) su[r][jj] = u;
      }
    }
  }
  __syncthreads();

  // this chunk's part of the output: a thread owns 4 neighbouring columns. The
  // chunk's 16 pieces of W_out are loaded before any is used; a unit past the
  // ragged end (u = 0) reads the last row again
  for (int n0 = tid * 4; n0 < D; n0 += kThreads * 4) {
    uint32_t wo[kChunk];
#pragma unroll
    for (int jj = 0; jj < kChunk; ++jj)
      wo[jj] = *reinterpret_cast<const uint32_t*>(q_out + (size_t)min(j0 + jj, Hd - 1) * D + n0);
    float acc[MT][4];
#pragma unroll
    for (int r = 0; r < MT; ++r) acc[r][0] = acc[r][1] = acc[r][2] = acc[r][3] = 0.f;
#pragma unroll
    for (int jj = 0; jj < kChunk; ++jj) {
      float wf[4];
      unpack4(wo[jj], wf);
#pragma unroll
      for (int r = 0; r < MT; ++r) {
        const float u = su[r][jj];
        acc[r][0] += u * wf[0];
        acc[r][1] += u * wf[1];
        acc[r][2] += u * wf[2];
        acc[r][3] += u * wf[3];
      }
    }
#pragma unroll
    for (int r = 0; r < MT; ++r) {
      if (m0 + r < M) {
        float4* dst = reinterpret_cast<float4*>(
            parts + ((size_t)blockIdx.x * M + m0 + r) * D + n0);
        *dst = make_float4(acc[r][0], acc[r][1], acc[r][2], acc[r][3]);
      }
    }
  }
}

// y[m, n] = (sum over chunks, in order) * s_out[n] + b_out[n]
template <typename O>
__global__ void __launch_bounds__(kThreads)
ffn_sum_kernel(const float* __restrict__ parts, const float* __restrict__ s_out,
               const float* __restrict__ b_out, O* __restrict__ out, int n_chunks, int MD,
               int D) {
  const int idx = blockIdx.x * kThreads + threadIdx.x;
  if (idx >= MD) return;
  float total = 0.f;
#pragma unroll 8
  for (int c = 0; c < n_chunks; ++c) total += parts[(size_t)c * MD + idx];
  const int n = idx % D;
  float y = __fmul_rn(total, s_out[n]);
  if (b_out != nullptr) y = __fadd_rn(y, b_out[n]);
  out[idx] = from_f<O>(y);
}

template <typename X, typename O, int MT>
int launch(const void* x, const void* q_in, const void* s_in, const void* b_in,
           const void* q_out, const void* s_out, const void* b_out, void* parts, void* out,
           int M, int D, int Hd, cudaStream_t stream) {
  const int n_chunks = (Hd + kChunk - 1) / kChunk;
  const dim3 grid(n_chunks, (M + MT - 1) / MT);
  ffn_chunk_kernel<X, MT><<<grid, kThreads, 0, stream>>>(
      static_cast<const X*>(x), static_cast<const signed char*>(q_in),
      static_cast<const float*>(s_in), static_cast<const float*>(b_in),
      static_cast<const signed char*>(q_out), static_cast<float*>(parts), M, D, Hd);
  const int err = static_cast<int>(cudaGetLastError());
  if (err != 0) return err;
  const int md = M * D;
  ffn_sum_kernel<O><<<(md + kThreads - 1) / kThreads, kThreads, 0, stream>>>(
      static_cast<const float*>(parts), static_cast<const float*>(s_out),
      static_cast<const float*>(b_out), static_cast<O*>(out), n_chunks, md, D);
  return static_cast<int>(cudaGetLastError());
}

template <typename X, typename O>
int launch_mt(const void* x, const void* q_in, const void* s_in, const void* b_in,
              const void* q_out, const void* s_out, const void* b_out, void* parts, void* out,
              int M, int D, int Hd, cudaStream_t stream) {
#define FFN_LAUNCH(MT) \
  return launch<X, O, MT>(x, q_in, s_in, b_in, q_out, s_out, b_out, parts, out, M, D, Hd, stream)
  if (M == 1) FFN_LAUNCH(1);
  if (M == 2) FFN_LAUNCH(2);
  if (M <= 4) FFN_LAUNCH(4);
  FFN_LAUNCH(8);
#undef FFN_LAUNCH
}

}  // namespace

// C entry point (bound with ctypes in ops/qlinear.py). Layouts: x (M, D) in
// the dtype of code x_dtype (0 f32, 1 bf16), D a multiple of 16 and at most
// 2048; q_in (2 Hd, D) int8, rows 0..Hd-1 the gate; s_in (2 Hd) f32; b_in
// (2 Hd) f32 or null; q_out (Hd, D) int8, hidden-major; s_out (D) f32; b_out
// (D) f32 or null; parts: scratch (ceil(Hd / 16), M, D) f32; out (M, D) in the
// dtype of code out_dtype. All contiguous. Returns cudaGetLastError() after
// the launches, -2 for an unsupported dtype code, -3 for an unsupported D.
extern "C" int fused_ffn_int8_fwd(const void* x, const void* q_in, const void* s_in,
                                  const void* b_in, const void* q_out, const void* s_out,
                                  const void* b_out, void* parts, void* out, int M, int D,
                                  int Hd, int x_dtype, int out_dtype, void* stream) {
  if (D % 16 != 0 || D > kDMax || D < 16) return -3;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (x_dtype == 0 && out_dtype == 0)
    return launch_mt<float, float>(x, q_in, s_in, b_in, q_out, s_out, b_out, parts, out, M, D,
                                   Hd, st);
  if (x_dtype == 0 && out_dtype == 1)
    return launch_mt<float, __nv_bfloat16>(x, q_in, s_in, b_in, q_out, s_out, b_out, parts,
                                           out, M, D, Hd, st);
  if (x_dtype == 1 && out_dtype == 0)
    return launch_mt<__nv_bfloat16, float>(x, q_in, s_in, b_in, q_out, s_out, b_out, parts,
                                           out, M, D, Hd, st);
  if (x_dtype == 1 && out_dtype == 1)
    return launch_mt<__nv_bfloat16, __nv_bfloat16>(x, q_in, s_in, b_in, q_out, s_out, b_out,
                                                   parts, out, M, D, Hd, st);
  return -2;
}
