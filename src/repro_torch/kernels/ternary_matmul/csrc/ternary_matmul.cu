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
// (N/4 * K bytes) is nearly all its traffic (0.59 MB, 0.18 us at [384,
// 1536]), so its time is the chain of dependent memory round trips. The
// tiled matmul at prefill does 2*M*N*K integer operations on N/4*K weight
// bytes and is bound by operations: at [512, 4096] x [1024, 1536] +
// residual, 6.44 G int8 operations are 3.26 us at 1979 TOP/s, its 6.5 MB
// of operands 1.95 us at 3.35 TB/s.
//
// Design. The GEMV (ternary_tiles.cuh) keeps that chain to one round trip:
// blocks of 64 columns split the contraction in thread-block clusters (so
// [384, 1536] runs 144 blocks), request every weight byte by 16-byte
// cp.async before they wait, with x and the epilogue's operands alongside,
// and sum the split exactly in int32 through distributed shared memory.
// The matmul (ternary_mma.cuh) runs on the int8 tensor cores,
// mma.sync.m16n8k32: output tiles of 64 x 64 to 128 x 128, stages of 32
// packed rows by cp.async, the 2-bit weights unpacked to signed int8 in
// registers, in a contraction order that makes the planar packing cost a
// byte transpose and no more.

#include "ternary_mma.cuh"
#include "ternary_tiles.cuh"

namespace {

template <typename T>
int launch(const void* x, const void* xs, const void* wp, const void* ws, const void* res,
           void* out, int m, int n, int k, bool small_m, cudaStream_t stream) {
  rtk::DequantEpi<T> epi{static_cast<const float*>(xs), static_cast<const float*>(ws),
                         static_cast<const T*>(res), static_cast<T*>(out), k, 0};
  const int8_t* xi = static_cast<const int8_t*>(x);
  const uint8_t* w = static_cast<const uint8_t*>(wp);
  return (int)(small_m ? rtk::launch_gemv<1>(xi, m, n / 4, k, w, nullptr, epi, stream)
                       : rtk::launch_ternary_mma<1>(xi, m, n / 4, k, w, nullptr, epi, stream));
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
