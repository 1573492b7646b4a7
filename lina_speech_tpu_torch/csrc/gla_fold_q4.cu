// The int4 body of the int8 fold (gla_fold_q.cuh, Q4 = true), in a
// translation unit of its own so that nvcc compiles it beside the int8 body;
// gla_fold_q.cu's C entry calls it for state code 3.
#include "gla_fold_q.cuh"

namespace gla {
int fold_q4_window(void* state, void* s_scale, const void* kbuf, const void* vbuf,
                   const void* cbuf, const void* cc, int B, int H, int DK, int DV, int L,
                   int io_dtype, int rows, cudaStream_t stream) {
  if (io_dtype == kF32)
    return launch_dv<float, true>(state, s_scale, kbuf, vbuf, cbuf, cc, B, H, DK, DV, L, rows,
                                  stream);
  if (io_dtype == kBF16)
    return launch_dv<__nv_bfloat16, true>(state, s_scale, kbuf, vbuf, cbuf, cc, B, H, DK, DV, L,
                                          rows, stream);
  return -2;
}
}  // namespace gla
