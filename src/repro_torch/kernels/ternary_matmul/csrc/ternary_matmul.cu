// Packed-ternary x int8 projection with the fused dequant (+ residual)
// epilogue: the decode GEMV and the tiled prefill matmul.
//
// Replaces: repro/kernels/ternary_matmul/kernel.py::ternary_gemv_kernel
// (kernel.py:109, pallas_call :136; M <= 16 decode rows, dispatched at
// ternary_matmul/ops.py:30) and ::ternary_matmul_kernel (kernel.py:147,
// pallas_call :166; prefill rows).
//
// Computes out[m, k] = T((float(acc) * x_scale[m]) * w_scale), then
// T(out + residual[m, k]) when a residual is given, with
// acc = sum_n x[m, n] * trit(n, k) in int32 (exact).
//
// Bound on the H100. The GEMV is bound by bytes: the 2-bit weight stream
// (N/4 * K bytes) is nearly all its traffic, and it reads each packed byte
// from device memory exactly once while x (M <= 16 rows) waits in shared
// memory. The tiled matmul at prefill (M = 512) does 2*M*N*K integer
// operations on N/4*K weight bytes and is bound by operations; this first
// version uses __dp4a on CUDA cores (four int8 products per instruction)
// rather than int8 tensor cores, which is later work (mma.sync / wgmma).
//
// Design: see ternary_tiles.cuh. The GEMV spreads K over blocks of 8
// columns and the contraction over 128 row lanes per block, summed by warp
// shuffles and shared memory; the matmul walks 64x64 output tiles.

#include "ternary_tiles.cuh"

namespace {

template <typename T>
int launch(const void* x, const void* xs, const void* wp, const void* ws, const void* res,
           void* out, int m, int n, int k, bool small_m, cudaStream_t stream) {
  rtk::DequantEpi<T> epi{static_cast<const float*>(xs), static_cast<const float*>(ws),
                         static_cast<const T*>(res), static_cast<T*>(out), k, 0};
  return (int)rtk::launch_ternary<1>(static_cast<const int8_t*>(x), m, n / 4, k,
                                    static_cast<const uint8_t*>(wp), nullptr, epi, small_m,
                                    stream);
}

int dispatch(const void* x, const void* xs, const void* wp, const void* ws, const void* res,
             void* out, int m, int n, int k, int dtype, bool small_m, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == rtk::kBF16)
    return launch<__nv_bfloat16>(x, xs, wp, ws, res, out, m, n, k, small_m, s);
  if (dtype == rtk::kF32) return launch<float>(x, xs, wp, ws, res, out, m, n, k, small_m, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" int tm_ternary_gemv(const void* x, const void* xs, const void* wp, const void* ws,
                               const void* res, void* out, int m, int n, int k, int dtype,
                               void* stream) {
  if (m > 16) return (int)cudaErrorInvalidValue;
  return dispatch(x, xs, wp, ws, res, out, m, n, k, dtype, true, stream);
}

extern "C" int tm_ternary_matmul(const void* x, const void* xs, const void* wp,
                                 const void* ws, const void* res, void* out, int m, int n,
                                 int k, int dtype, void* stream) {
  return dispatch(x, xs, wp, ws, res, out, m, n, k, dtype, false, stream);
}
