"""Check on the GPU that the int8 fold's quotient is the IEEE quotient.

``csrc/gla_fold_q.cu`` takes round(S / sc) from sc's correctly rounded
reciprocal y and two correction steps (``quotient()``) instead of a division
per element. This script builds a small CUDA source that includes that file
(so it checks the function the kernel runs), draws (a, b) pairs as the fold
meets them -- b = max / 127 over row maxima from 1e-30 up to 1e38, |a| <= max,
a from the row's range down to tiny values -- and counts, for each pair
with b >= 2^-90 (the kernel divides truly below), where quotient(a, b, y)
differs from a / b in any bit while |a| >= 2^-103 and a / b is a normal
float, and where the int8 it rounds to differs from round(a / b) at all
(both should be 0). Prints one JSON line. Run on the machine with the
card:

    python scripts/torch_fold_quotient_check.py [--log2-pairs 33] [--seeds 3]
"""
import argparse
import ctypes
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

SOURCE = r'''
#include "gla_fold_q.cu"

__device__ unsigned long long g_bad[2];

__device__ __forceinline__ unsigned mix(unsigned x) {
  x ^= x >> 16; x *= 0x7feb352du; x ^= x >> 15; x *= 0x846ca68bu; x ^= x >> 16;
  return x;
}

__global__ void check_kernel(unsigned long long n, unsigned seed) {
  for (unsigned long long i = blockIdx.x * (unsigned long long)blockDim.x + threadIdx.x; i < n;
       i += (unsigned long long)gridDim.x * blockDim.x) {
    const unsigned h1 = mix((unsigned)i * 2654435761u + seed), h2 = mix(h1 + 0x9e3779b9u);
    const float mx = fmaxf(__uint_as_float(0x00800000u + h1 % 0x7e000000u), 1e-30f);
    const float b = mx / 127.f;
    if (b < 0x1p-90f) continue;
    float a;
    if (h2 & 1) {  // a share of the row's maximum
      a = mx * ((float)((int)(h2 % 254001u) - 127000) / 127000.f);
    } else {  // any magnitude up to it, down to tiny
      a = __uint_as_float((h2 & 0x807fffffu) | ((h2 >> 1) % (__float_as_uint(mx) >> 23) << 23));
    }
    if (fabsf(a) > mx) a = copysignf(mx, a);
    const float q = quotient(a, b, __frcp_rn(b)), d = a / b;
    if (fabsf(a) >= 0x1p-103f && fabsf(d) >= 0x1p-126f &&
        __float_as_uint(q) != __float_as_uint(d))
      atomicAdd(&g_bad[0], 1ull);
    if ((f_to_int8(q) & 0xffu) != (f_to_int8(d) & 0xffu)) atomicAdd(&g_bad[1], 1ull);
  }
}

extern "C" int quotient_check(unsigned long long n, unsigned seed, unsigned long long* out) {
  unsigned long long z[2] = {0, 0};
  cudaMemcpyToSymbol(g_bad, z, sizeof(z));
  check_kernel<<<1320, 256>>>(n, seed);
  cudaError_t e = cudaDeviceSynchronize();
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaMemcpyFromSymbol(out, g_bad, sizeof(z)));
}
'''


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--log2-pairs", type=int, default=33)
    parser.add_argument("--seeds", type=int, default=3)
    args = parser.parse_args()
    from lina_speech_tpu_torch.ops import _build

    out_dir = _build.build_dir()
    out_dir.mkdir(parents=True, exist_ok=True)
    src, lib_path = out_dir / "fold_quotient_check.cu", out_dir / "libfold_quotient_check.so"
    src.write_text(SOURCE)
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC), "-shared",
                    "-o", str(lib_path), str(src)], check=True, capture_output=True)
    lib = ctypes.CDLL(str(lib_path))
    lib.quotient_check.argtypes = [ctypes.c_ulonglong, ctypes.c_uint, ctypes.c_void_p]
    n = 1 << args.log2_pairs
    res = {"pairs_per_seed": n, "seeds": args.seeds, "quotient_bits_differ": 0,
           "int8_differs": 0}
    t0 = time.perf_counter()
    for seed in range(args.seeds):
        out = (ctypes.c_ulonglong * 2)()
        err = lib.quotient_check(n, 1000 + seed, ctypes.addressof(out))
        if err:
            raise SystemExit(f"quotient check failed with CUDA error {err}")
        res["quotient_bits_differ"] += out[0]
        res["int8_differs"] += out[1]
    res["seconds"] = round(time.perf_counter() - t0, 2)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip().splitlines()
    res["card"] = card[0] if card else None
    print(json.dumps(res))


if __name__ == "__main__":
    main()
