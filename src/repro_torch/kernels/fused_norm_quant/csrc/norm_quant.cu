// Fused RMSNorm + per-row absmax int8 quantization, the block prologue.
//
// Replaces: repro/kernels/fused_norm_quant/kernel.py::norm_quant_kernel
// (the Pallas TPU kernel at kernel.py:74, pallas_call at :88).
//
// Computes, per row of x [M, N] (bf16 or f32) with gamma [N] f32:
//   y = T(x * rsqrt(mean(x^2) + eps) * gamma)       (f32 arithmetic)
//   scale = T(max(absmax(y), T(1e-8)) / 127)          (in T, ternary.py:77)
//   code = clip(rint(T(y / scale)), -127, 127)         (ternary.py:84)
//
// Bound on the H100: bytes. It reads the row once (N·sizeof(T)) and writes
// N int8 codes and one f32 scale; the arithmetic is a few flops per
// element, far below the card's ~300 flop/byte ridge.
//
// Design: one block of 256 threads per row, strided over N so that neighbour
// threads read neighbour elements. The row is read three times (sum of
// squares, absmax, codes); the second and third reads hit L1/L2, so device
// memory sees it once. Recomputing y in each pass is deterministic, so
// the codes are those of the absmax pass's y exactly.

#include "common.cuh"

namespace {

constexpr int kThreads = 256;

template <typename T>
__global__ void norm_quant_kernel(const T* __restrict__ x, const float* __restrict__ gamma,
                                  int8_t* __restrict__ q, float* __restrict__ qs, int n,
                                  float eps) {
  __shared__ float red[32];
  const size_t row = blockIdx.x;
  const T* xr = x + row * n;
  float ss = 0.0f;
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const float v = rtk::Num<T>::to_f(xr[i]);
    ss = __fadd_rn(ss, __fmul_rn(v, v));
  }
  ss = rtk::block_reduce<false>(ss, red);
  const float rms = __frcp_rn(__fsqrt_rn(__fadd_rn(__fdiv_rn(ss, (float)n), eps)));
  auto y = [&](int i) {
    return rtk::round_to<T>(
        __fmul_rn(__fmul_rn(rtk::Num<T>::to_f(xr[i]), rms), gamma[i]));
  };
  rtk::quantize_row<T>(y, n, q + row * n, qs + row, red);
}

template <typename T>
int launch(const void* x, const void* gamma, void* q, void* qs, int m, int n, float eps,
           cudaStream_t stream) {
  if (m == 0) return 0;
  norm_quant_kernel<T><<<m, kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(gamma), static_cast<int8_t*>(q),
      static_cast<float*>(qs), n, eps);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int tm_norm_quant(const void* x, const void* gamma, void* q, void* qs, int m,
                             int n, float eps, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == rtk::kBF16) return launch<__nv_bfloat16>(x, gamma, q, qs, m, n, eps, s);
  if (dtype == rtk::kF32) return launch<float>(x, gamma, q, qs, m, n, eps, s);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* tm_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
