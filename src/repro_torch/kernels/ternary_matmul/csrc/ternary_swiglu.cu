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
// (M = 4 rows). Pass 1 runs the shared GEMV/__dp4a matmul main loops with NW = 2
// (both weights against one x tile, so x is staged once) and writes h in
// T to a scratch [M, K] buffer; pass 2 is one block per row that takes the
// absmax and writes the codes. The scratch round trip is M*K*sizeof(T)
// bytes (32 KB at decode), small beside the 2 * N/4 * K weight bytes.

#include "ternary_tiles.cuh"

namespace {

template <typename T>
int launch(const void* x, const void* xs, const void* wg, const void* wgs, const void* wu,
           const void* wus, void* h, void* q, void* qs, int m, int n, int k,
           cudaStream_t stream) {
  if (m == 0) return 0;
  rtk::SwigluEpi<T> epi{static_cast<const float*>(xs), static_cast<const float*>(wgs),
                        static_cast<const float*>(wus), static_cast<T*>(h), k};
  const int8_t* xi = static_cast<const int8_t*>(x);
  const uint8_t *g = static_cast<const uint8_t*>(wg), *u = static_cast<const uint8_t*>(wu);
  cudaError_t err = m <= 16 ? rtk::launch_gemv<2>(xi, m, n / 4, k, g, u, epi, stream)
                            : rtk::launch_matmul<2>(xi, m, n / 4, k, g, u, epi, stream);
  if (err != cudaSuccess) return (int)err;
  return (int)rtk::launch_requant<T>(static_cast<const T*>(h), static_cast<int8_t*>(q),
                                     static_cast<float*>(qs), m, k, stream);
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
