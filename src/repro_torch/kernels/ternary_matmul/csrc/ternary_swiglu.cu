// Fused packed SwiGLU: gate and up projections of one int8 input, then
// silu(g) * u and a per-row absmax int8 requantization.
//
// Replaces: repro/kernels/ternary_matmul/kernel.py::ternary_swiglu_kernel
// (kernel.py:177, pallas_call :203).
//
// Computes, for x [M, N] int8 with row scales xs and gate/up planar pack2
// weights [N/4, K] with scalar scales:
//   g = T((acc_g * xs) * wgs),  u = T((acc_u * xs) * wus)
//   h = T(T(g * T(sigmoid(g))) * u)            (silu in the act dtype T)
//   (h_i8, h_scale) = quantize_act(h)          (ternary.py:77-86)
//
// Bound on the H100: as ternary_matmul.cu — bytes of the two weight
// streams at decode (M <= 16), integer operations at prefill.
//
// Design: TWO PASSES. The row's absmax needs all K (4096) hidden values,
// and one block per row would leave most of the 132 SMs idle at decode
// (M = 4 rows). Pass 1 runs the shared GEMV/matmul main loops with NW = 2
// (both weights against one x tile, so x is staged once) and writes h in
// T to a scratch [M, K] buffer; pass 2 is one block per row that takes the
// absmax and writes the codes. The scratch round trip is M*K*sizeof(T)
// bytes (32 KB at decode), small beside the 2 * N/4 * K weight bytes.

#include "ternary_tiles.cuh"

namespace {

template <typename T>
struct SwigluEpi {
  const float* xs;
  const float* wgs;
  const float* wus;
  T* h;  // [M, K] scratch
  int k;
  __device__ __forceinline__ void operator()(int m, int col, const int* acc) const {
    const float xsm = xs[m];
    const float g = rtk::round_to<T>(__fmul_rn(__fmul_rn((float)acc[0], xsm), *wgs));
    const float u = rtk::round_to<T>(__fmul_rn(__fmul_rn((float)acc[1], xsm), *wus));
    const float sig = rtk::round_to<T>(__fdiv_rn(1.0f, __fadd_rn(1.0f, expf(-g))));
    const float a = rtk::round_to<T>(__fmul_rn(g, sig));
    h[(size_t)m * k + col] = rtk::Num<T>::from_f(__fmul_rn(a, u));
  }
};

constexpr int kRequantThreads = 256;

template <typename T>
__global__ void requant_kernel(const T* __restrict__ h, int8_t* __restrict__ q,
                               float* __restrict__ qs, int k) {
  __shared__ float red[32];
  const size_t row = blockIdx.x;
  const T* hr = h + row * k;
  auto y = [&](int i) { return rtk::Num<T>::to_f(hr[i]); };
  rtk::quantize_row<T>(y, k, q + row * k, qs + row, red);
}

template <typename T>
int launch(const void* x, const void* xs, const void* wg, const void* wgs, const void* wu,
           const void* wus, void* h, void* q, void* qs, int m, int n, int k,
           cudaStream_t stream) {
  if (m == 0) return 0;
  SwigluEpi<T> epi{static_cast<const float*>(xs), static_cast<const float*>(wgs),
                   static_cast<const float*>(wus), static_cast<T*>(h), k};
  cudaError_t err = rtk::launch_ternary<2>(
      static_cast<const int8_t*>(x), m, n / 4, k, static_cast<const uint8_t*>(wg),
      static_cast<const uint8_t*>(wu), epi, m <= 16, stream);
  if (err != cudaSuccess) return (int)err;
  requant_kernel<T><<<m, kRequantThreads, 0, stream>>>(
      static_cast<const T*>(h), static_cast<int8_t*>(q), static_cast<float*>(qs), k);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int tm_ternary_swiglu(const void* x, const void* xs, const void* wg,
                                 const void* wgs, const void* wu, const void* wus, void* h,
                                 void* q, void* qs, int m, int n, int k, int dtype,
                                 void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == rtk::kBF16)
    return launch<__nv_bfloat16>(x, xs, wg, wgs, wu, wus, h, q, qs, m, n, k, s);
  if (dtype == rtk::kF32) return launch<float>(x, xs, wg, wgs, wu, wus, h, q, qs, m, n, k, s);
  return (int)cudaErrorInvalidValue;
}
