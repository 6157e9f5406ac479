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
// element, far below the card's ~300 flop/byte ridge. At decode rows (4 to
// 16) the bytes take nanoseconds and the call is a chain of dependent
// latencies (load, reduce, scale, codes), so the design keeps that chain
// short:
//   - one block of 256 threads per row; thread t owns elements t, t + 256,
//     ... (kPer of them, a template parameter: 6 at d_model 1536, 10 at
//     2560), and starts every load of x and gamma before the first use;
//   - y is computed once and kept in registers for the absmax and the codes;
//   - each block reduction takes one __syncthreads: the warps' partials go
//     to their own area of shared memory (one area per reduction, so no
//     barrier guards its reuse) and every thread folds the eight partials
//     itself in the tree warp 0 used to, ((r0+r4)+(r2+r6))+((r1+r5)+(r3+r7));
//   - the codes go through shared memory and leave as 16-byte stores.
// The sum of squares keeps the order of the loop form below (thread t adds
// its elements in order, then the warp butterfly, then that tree), so the
// codes and scales are bit-equal to it and to the earlier kernel. Rows
// wider than 16 * 256 elements take the loop form: the same kernel walking
// the row three times (sum of squares, absmax, codes), as no register tile
// holds them.
//
// The tables variant (template flag kTables) is the same kernel, so its
// codes and scale are those of the plain prologue bit for bit; after the
// codes are written, the block reads them back (from shared memory, or
// from q in the loop form) and writes the row's ceil(N/3)*27 f32 TL table
// entries (rtk::tl_entry; the ragged last group padded with zero codes,
// after the norm, fused_norm_quant/kernel.py:48-50). Each thread builds one
// group's 27 entries in shared memory, 256 groups at a time, and the block
// then copies them out with neighbouring threads on neighbouring floats.
// The tables bound it on this card: 36 bytes written per activation (55,296
// B per row at N = 1536) against the 2 or 4 read, so the write stream is
// the cost.

#include "common.cuh"

namespace {

constexpr int kThreads = 256, kWarps = kThreads / 32;
constexpr int kMaxPer = 16;  // the register form: rows of up to 16 * 256 elements
static_assert(kWarps == 8, "the fold below is warp 0's tree over eight warps");

// The block's sum (kMax false) or max of v, with one barrier: `part` holds
// 8 floats that no other reduction uses. Every thread folds the partials in
// the order block_reduce's warp 0 adds them (its butterfly over lanes 0-7,
// zeros elsewhere), so a sum is bit-equal to block_reduce's.
template <bool kMax>
__device__ __forceinline__ float fold8(float v, float* part) {
  v = kMax ? rtk::warp_max(v) : rtk::warp_sum(v);
  if ((threadIdx.x & 31) == 0) part[threadIdx.x >> 5] = v;
  __syncthreads();
  float r[kWarps];
#pragma unroll
  for (int w = 0; w < kWarps; ++w) r[w] = part[w];
  if constexpr (kMax)
    return fmaxf(fmaxf(fmaxf(r[0], r[4]), fmaxf(r[2], r[6])),
                 fmaxf(fmaxf(r[1], r[5]), fmaxf(r[3], r[7])));
  return __fadd_rn(__fadd_rn(__fadd_rn(r[0], r[4]), __fadd_rn(r[2], r[6])),
                   __fadd_rn(__fadd_rn(r[1], r[5]), __fadd_rn(r[3], r[7])));
}

__device__ __forceinline__ float inv_rms(float ss, int n, float eps) {
  return __frcp_rn(__fsqrt_rn(__fadd_rn(__fdiv_rn(ss, (float)n), eps)));
}

// The TL tables of a row from its codes qr [n] (global or shared memory).
__device__ __forceinline__ void write_tables(const int8_t* qr, int n, float* tr, float* stage) {
  const int groups = (n + rtk::kTlGroup - 1) / rtk::kTlGroup;
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

// kPer > 0: the register form (n <= kPer * 256); kPer == 0: the loop form.
template <typename T, bool kTables, int kPer>
__global__ void __launch_bounds__(kThreads)
    norm_quant_kernel(const T* __restrict__ x, const float* __restrict__ gamma,
                      int8_t* __restrict__ q, float* __restrict__ qs,
                      float* __restrict__ tables, int n, float eps) {
  extern __shared__ float stage[];  // kTables: [kThreads groups][27]
  const size_t row = blockIdx.x;
  const T* xr = x + row * n;
  int8_t* qr = q + row * n;
  const int groups = (n + rtk::kTlGroup - 1) / rtk::kTlGroup;
  float* tr = kTables ? tables + row * (size_t)groups * rtk::kTlCombos : nullptr;
  if constexpr (kPer == 0) {
    __shared__ float red[32];
    float ss = 0.0f;
    for (int i = threadIdx.x; i < n; i += kThreads) {
      const float v = rtk::Num<T>::to_f(xr[i]);
      ss = __fadd_rn(ss, __fmul_rn(v, v));
    }
    ss = rtk::block_reduce<false>(ss, red);
    const float rms = inv_rms(ss, n, eps);
    auto y = [&](int i) {
      return rtk::round_to<T>(
          __fmul_rn(__fmul_rn(rtk::Num<T>::to_f(xr[i]), rms), gamma[i]));
    };
    rtk::quantize_row<T>(y, n, qr, qs + row, red);
    if constexpr (kTables) {
      __syncthreads();  // the row's codes, written by every thread, are visible
      write_tables(qr, n, tr, stage);
    }
  } else {
    __shared__ float part[2][kWarps];
    __shared__ __align__(16) int8_t codes[kPer * kThreads];
    const int tid = threadIdx.x;
    float v[kPer], g[kPer];
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      const int i = tid + j * kThreads;
      v[j] = i < n ? rtk::Num<T>::to_f(xr[i]) : 0.0f;
      g[j] = i < n ? gamma[i] : 0.0f;
    }
    float ss = 0.0f;
#pragma unroll
    for (int j = 0; j < kPer; ++j)
      if (tid + j * kThreads < n) ss = __fadd_rn(ss, __fmul_rn(v[j], v[j]));
    const float rms = inv_rms(fold8<false>(ss, part[0]), n, eps);
    float amax = 0.0f;
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      v[j] = rtk::round_to<T>(__fmul_rn(__fmul_rn(v[j], rms), g[j]));  // y; 0 past n
      amax = fmaxf(amax, fabsf(v[j]));
    }
    const float scale = rtk::act_scale<T>(fold8<true>(amax, part[1]));
    const bool vec = n % 16 == 0 && (uintptr_t)qr % 16 == 0;
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      const int i = tid + j * kThreads;
      if (i >= n) continue;
      const int8_t c = rtk::act_code<T>(v[j], scale);
      if (vec || kTables) codes[i] = c;
      if (!vec) qr[i] = c;
    }
    if (tid == 0) qs[row] = scale;
    if (vec || kTables) __syncthreads();
    if (vec)
      for (int e = tid; e < n / 16; e += kThreads)
        reinterpret_cast<uint4*>(qr)[e] = reinterpret_cast<const uint4*>(codes)[e];
    if constexpr (kTables) write_tables(codes, n, tr, stage);
  }
}

constexpr size_t kTablesSmem = (size_t)kThreads * rtk::kTlCombos * sizeof(float);

template <typename T, bool kTables, int kPer>
cudaError_t launch_per(const void* x, const void* gamma, void* q, void* qs, void* tables, int m,
                       int n, float eps, cudaStream_t stream) {
  norm_quant_kernel<T, kTables, kPer><<<m, kThreads, kTables ? kTablesSmem : 0, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(gamma), static_cast<int8_t*>(q),
      static_cast<float*>(qs), static_cast<float*>(tables), n, eps);
  return cudaGetLastError();
}

// The register tile that holds the row: the smallest instance of at least
// ceil(n / 256) elements a thread, or the loop form past kMaxPer.
template <typename T, bool kTables>
int launch(const void* x, const void* gamma, void* q, void* qs, void* tables, int m, int n,
           float eps, cudaStream_t stream) {
  if (m == 0) return 0;
  const int per = (n + kThreads - 1) / kThreads;
#define NQ_LAUNCH(P) \
  if (per <= P) return (int)launch_per<T, kTables, P>(x, gamma, q, qs, tables, m, n, eps, stream)
  NQ_LAUNCH(1);
  NQ_LAUNCH(2);
  NQ_LAUNCH(4);
  NQ_LAUNCH(6);
  NQ_LAUNCH(8);
  NQ_LAUNCH(10);
  NQ_LAUNCH(12);
  NQ_LAUNCH(kMaxPer);
#undef NQ_LAUNCH
  return (int)launch_per<T, kTables, 0>(x, gamma, q, qs, tables, m, n, eps, stream);
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
