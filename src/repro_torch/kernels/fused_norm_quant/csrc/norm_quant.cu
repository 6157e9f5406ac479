// Fused RMSNorm + per-row absmax int8 quantization, the block prologue,
// and its table-lookup variant.
//
// Replaces: repro/kernels/fused_norm_quant/kernel.py::norm_quant_kernel
// (the Pallas TPU kernel at kernel.py:74, pallas_call at :88) and
// ::norm_quant_tables_kernel (kernel.py:105, pallas_call at :130).
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
//
// The tables variant (template flag kTables) is the same kernel, so its
// codes and scale are those of the plain prologue bit for bit; after the
// codes are written, the block reads them back and writes the row's
// ceil(N/3)*27 f32 TL table entries (rtk::tl_entry; the ragged last group
// padded with zero codes, after the norm, fused_norm_quant/kernel.py:48-50).
// Each thread builds one group's 27 entries in shared memory, 256 groups at
// a time, and the block then copies them out with neighbouring threads on
// neighbouring floats. The tables bound it on this card: 36 bytes written
// per activation (55,296 B per row at N = 1536) against the 2 or 4 read,
// so the write stream is the cost.

#include "common.cuh"

namespace {

constexpr int kThreads = 256;

template <typename T, bool kTables>
__global__ void norm_quant_kernel(const T* __restrict__ x, const float* __restrict__ gamma,
                                  int8_t* __restrict__ q, float* __restrict__ qs,
                                  float* __restrict__ tables, int n, float eps) {
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
  if constexpr (kTables) {
    extern __shared__ float stage[];  // [kThreads groups][27]
    __syncthreads();  // the row's codes, written by every thread, are visible
    const int8_t* qr = q + row * n;
    const int groups = (n + rtk::kTlGroup - 1) / rtk::kTlGroup;
    float* tr = tables + row * (size_t)groups * rtk::kTlCombos;
    for (int g0 = 0; g0 < groups; g0 += kThreads) {
      const int t = g0 + threadIdx.x;
      if (t < groups) {
        int a[rtk::kTlGroup];
        rtk::tl_group(qr, n, t, a);
#pragma unroll
        for (int c = 0; c < rtk::kTlCombos; ++c)
          stage[threadIdx.x * rtk::kTlCombos + c] = (float)rtk::tl_entry(a[0], a[1], a[2], c);
      }
      __syncthreads();
      const int len = min(kThreads, groups - g0) * rtk::kTlCombos;
      float* dst = tr + (size_t)g0 * rtk::kTlCombos;
      for (int e = threadIdx.x; e < len; e += kThreads) dst[e] = stage[e];
      __syncthreads();  // stage is rewritten by the next chunk
    }
  }
}

constexpr size_t kTablesSmem = (size_t)kThreads * rtk::kTlCombos * sizeof(float);

template <typename T, bool kTables>
int launch(const void* x, const void* gamma, void* q, void* qs, void* tables, int m, int n,
           float eps, cudaStream_t stream) {
  if (m == 0) return 0;
  norm_quant_kernel<T, kTables><<<m, kThreads, kTables ? kTablesSmem : 0, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(gamma), static_cast<int8_t*>(q),
      static_cast<float*>(qs), static_cast<float*>(tables), n, eps);
  return (int)cudaGetLastError();
}

template <bool kTables>
int dispatch(const void* x, const void* gamma, void* q, void* qs, void* tables, int m, int n,
             float eps, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == rtk::kBF16)
    return launch<__nv_bfloat16, kTables>(x, gamma, q, qs, tables, m, n, eps, s);
  if (dtype == rtk::kF32) return launch<float, kTables>(x, gamma, q, qs, tables, m, n, eps, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" int tm_norm_quant(const void* x, const void* gamma, void* q, void* qs, int m,
                             int n, float eps, int dtype, void* stream) {
  return dispatch<false>(x, gamma, q, qs, nullptr, m, n, eps, dtype, stream);
}

extern "C" int tm_norm_quant_tables(const void* x, const void* gamma, void* q, void* qs,
                                    void* tables, int m, int n, float eps, int dtype,
                                    void* stream) {
  return dispatch<true>(x, gamma, q, qs, tables, m, n, eps, dtype, stream);
}

extern "C" const char* tm_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
