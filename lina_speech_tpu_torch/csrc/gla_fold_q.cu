// The int8 fold's C entry and its int8 body; the int4 body is built by
// gla_fold_q4.cu. What the kernel computes, what bounds it on the H100 and
// its design: gla_fold_q.cuh.
#include "gla_fold_q.cuh"

// C entry point (bound with ctypes in ops/gla_cuda.py). Layouts: state (B,
// H, DK, DV) int8 (state_dtype 2), or (B, H, DK, DV / 2) int4 two a byte
// (state_dtype 3), and s_scale (B, H, DK) f32, both updated in place; kbuf
// (L, B, H, DK) and vbuf (L, B, H, DV) in the buffer dtype (code io_dtype);
// cbuf (L, B, H, DK) and cc (B, H, DK) f32. All contiguous. rows: the band
// height. Returns cudaGetLastError() after the launch, -1 for a DK that is
// not a multiple of 16, -2 for an unsupported dtype code, -3 for a DV
// outside {128, 256, 512}, -6 for a state or vbuf off a 16-byte boundary
// (both are read in 16-byte words, an int4 state in 8-byte ones), -8 for a
// band height the layout cannot cut.
extern "C" int gla_fold_q_window(void* state, void* s_scale, const void* kbuf,
                                 const void* vbuf, const void* cbuf, const void* cc, int B,
                                 int H, int DK, int DV, int L, int io_dtype, int state_dtype,
                                 int rows, void* stream) {
  if (DK % 16 != 0) return -1;
  if (state_dtype != 2 && state_dtype != kI4) return -2;
  if (reinterpret_cast<uintptr_t>(state) % 16 != 0 || reinterpret_cast<uintptr_t>(vbuf) % 16 != 0)
    return -6;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (state_dtype == kI4)
    return gla::fold_q4_window(state, s_scale, kbuf, vbuf, cbuf, cc, B, H, DK, DV, L, io_dtype,
                               rows, st);
  if (io_dtype == gla::kF32)
    return launch_dv<float, false>(state, s_scale, kbuf, vbuf, cbuf, cc, B, H, DK, DV, L, rows,
                                   st);
  if (io_dtype == gla::kBF16)
    return launch_dv<__nv_bfloat16, false>(state, s_scale, kbuf, vbuf, cbuf, cc, B, H, DK, DV, L,
                                           rows, st);
  return -2;
}
