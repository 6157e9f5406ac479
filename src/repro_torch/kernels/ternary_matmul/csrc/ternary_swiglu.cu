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
// Bound on the H100: bytes at decode rows (M <= 16: the two 2-bit weight
// streams, 3.1 MB at [384, 4096], 0.94 us), integer operations at prefill
// rows (4 M N K: 6.5 us at 512 rows, 52 us at 4096).
//
// Design: TWO PASSES. The row's absmax needs all K (4096) values of h,
// which no one block computes. Pass 1 runs gate and up against one staged
// x and writes h in T to a scratch [M, K]: at decode rows the GEMV
// (ternary_tiles.cuh, NW = 2: cluster-split blocks, 16-byte cp.async of
// every weight byte before any wait, mma.sync on one m16 tile), at prefill
// rows the tensor-core matmul (ternary_mma.cuh, NW = 2: 64 x 128 tiles,
// two accumulator sets in 128 registers). Pass 2 (requant_kernel) is one
// block per row, the row read once into registers. Its round trip through
// the scratch, 2 M K sizeof(T) bytes (67 MB at 4096 rows, about 20 us),
// is small beside pass 1. A single launch at decode rows, whose last block
// requantized all M x K values, ran slower (ternary_tiles.cuh).

#include "ternary_mma.cuh"
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
                            : rtk::launch_ternary_mma<2>(xi, m, n / 4, k, g, u, epi, stream);
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
