// Chunked RWKV-6 WKV from a zero state: the prefill's time-mix recurrence.
//
// Replaces: repro/kernels/wkv/kernel.py::wkv_kernel (kernel.py:75,
// pallas_call at :89) around the body _kernel (:27-71).
//
// Computes, for one head (b, hh) with r, k, v, w = log-decay [S, N] and the
// bonus u [N] (head hh of u [H, N]), chunk by chunk of kC = 64 rows, in f32:
//   lc = inclusive cumsum of w over the chunk's rows, e = lc - w;
//   A[t, s] = sum_i r[t, i] k[s, i] exp(e[t, i] - lc[s, i])   for s < t;
//   d[t]    = sum_i r[t, i] k[t, i] u[i];
//   y[t, m] = (sum_{s<t} A[t, s] v[s, m] + d[t] v[t, m])
//             + sum_i r[t, i] exp(e[t, i]) S[i, m];
//   S[i, m] <- exp(lc_last[i]) S[i, m] + sum_s k[s, i] exp(lc_last[i] - lc[s, i]) v[s, m],
// the same terms, in the same grouping, as the TPU kernel and the plain
// version (repro/models/rwkv.py:105-123). The state S [N, N] starts at
// zero; y [B, H, S, N] and the final state [B, H, N, N] are f32.
//
// Decay terms: exp(e[t] - lc[s]) is formed only for s < t, where it is a
// ratio <= 1. For s >= t the exponent reaches +640 at the model's decay
// clip (-10 a row), so exp gives inf and inf * 0 is NaN; the TPU kernel
// computes those terms and masks them after (kernel.py:47-51), this kernel
// never forms them. expf, not __expf: the build's --fmad=false keeps the
// arithmetic IEEE f32 without contraction.
//
// Any S: the last chunk's rows past S enter with k = v = 0 and w = 0, so
// they add nothing and the state passes through them unchanged (the JAX
// wrapper instead picks a chunk that divides S; the two round differently,
// not in what they compute). No padded copies: the kernel reads r, k, v
// and w through their batch, head and row strides (time_mix hands it
// [B, S, H, N] views as [B, H, S, N]), with the last axis contiguous.
//
// Bound on the H100 at [1 * 40, 4096, 64] (bf16 r/k/v, f32 w, y and
// state): 147 MB moved, 44 us at 3.35 TB/s; about 4.4 GFLOP of f32 on the
// causal half of the chunks plus 0.33 G exp, about 70 us at 67 TFLOP/s:
// bound by operations, and among them by the intra-chunk exps (2016 pairs
// x 64 channels a chunk).
//
// Design (simple first): one block of 512 threads per (b, head), looping
// over its own chunks in order, the TPU kernel's sequential chunk axis.
// The [N, N] state (16 KB at N = 64) stays in shared memory across chunks,
// with the chunk's r, k, v, lc, e and A (117 KB at N = 64, one block an
// SM). Per chunk: the rows are loaded and widened to f32; 64 threads scan
// the columns; every thread takes lower-triangle pairs (t, s) for A and
// the exps; then r * exp(e) and k * exp(lc_last - lc) replace r and k in
// place; then each thread owns a value column m and a set of rows for y,
// and of key rows for the state update. With B = 1 this runs 40 blocks on
// 132 SMs, and A's exps run at one SM a head: splitting the intra-chunk
// part over (head, chunk) blocks ahead of a sequential state pass is the
// next step for speed.

#include <math.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 512;
constexpr int kC = 64;            // rows a chunk
constexpr int kAP = kC + 1;       // padded row stride of A
constexpr int kPairs = kC * (kC - 1) / 2;

template <int N>
constexpr size_t smem_bytes() {
  return sizeof(float) * (5 * kC * (N + 1) + kC * kAP + N * (N + 1) + kC + 2 * N);
}

template <typename T, int N>
__global__ void __launch_bounds__(kThreads)
    wkv_kernel(const T* __restrict__ r, const T* __restrict__ k, const T* __restrict__ v,
               const float* __restrict__ logw, const float* __restrict__ u,
               float* __restrict__ y, float* __restrict__ s_out, int h, int s,
               long long sb, long long sh, long long ss) {
  constexpr int P = N + 1;         // padded row stride: column walks hit distinct banks
  constexpr int kRG = kThreads / N;  // row groups of the column-owning phases
  extern __shared__ float smem[];
  float* r_s = smem;               // [kC][P] r, then r * exp(e)
  float* k_s = r_s + kC * P;       // [kC][P] k, then k * exp(lc_last - lc)
  float* v_s = k_s + kC * P;       // [kC][P]
  float* lc_s = v_s + kC * P;      // [kC][P] w, then its inclusive cumsum
  float* e_s = lc_s + kC * P;      // [kC][P] lc - w
  float* a_s = e_s + kC * P;       // [kC][kAP] A, rows t > s
  float* st_s = a_s + kC * kAP;    // [N][P] the state
  float* d_s = st_s + N * P;       // [kC] the bonus diagonal
  float* u_s = d_s + kC;           // [N]
  float* dec_s = u_s + N;          // [N] exp(lc_last)

  const int bh = blockIdx.x, tid = threadIdx.x;
  const int b = bh / h, hh = bh - b * h;
  const long long base = (long long)b * sb + (long long)hh * sh;
  const int m = tid % N, rg = tid / N;  // the value column this thread owns

  for (int i = tid; i < N * P; i += kThreads) st_s[i] = 0.0f;
  for (int i = tid; i < N; i += kThreads) u_s[i] = u[(size_t)hh * N + i];

  for (int c0 = 0; c0 < s; c0 += kC) {
    const int rows = min(kC, s - c0);
    __syncthreads();  // the previous chunk is consumed
    for (int idx = tid; idx < kC * N; idx += kThreads) {
      const int t = idx / N, i = idx - t * N;
      float rv = 0.0f, kv = 0.0f, vv = 0.0f, wv = 0.0f;
      if (t < rows) {
        const long long g = base + (long long)(c0 + t) * ss + i;
        rv = rtk::Num<T>::to_f(r[g]);
        kv = rtk::Num<T>::to_f(k[g]);
        vv = rtk::Num<T>::to_f(v[g]);
        wv = logw[g];
      }
      r_s[t * P + i] = rv;
      k_s[t * P + i] = kv;
      v_s[t * P + i] = vv;
      lc_s[t * P + i] = wv;
    }
    __syncthreads();
    if (tid < N) {  // the cumulative log-decay, one column a thread, in row order
      float acc = 0.0f;
      for (int t = 0; t < kC; ++t) {
        const float w = lc_s[t * P + tid];
        acc = __fadd_rn(acc, w);
        lc_s[t * P + tid] = acc;
        e_s[t * P + tid] = __fsub_rn(acc, w);
      }
    }
    __syncthreads();
    // A over the lower triangle, s < t only: each exponent is <= 0
    for (int p = tid; p < kPairs; p += kThreads) {
      int t = (int)((1.0f + sqrtf(1.0f + 8.0f * (float)p)) * 0.5f);
      while (t * (t - 1) / 2 > p) --t;
      while (t * (t + 1) / 2 <= p) ++t;
      const int sr = p - t * (t - 1) / 2;
      const float* rt = r_s + t * P;
      const float* et = e_s + t * P;
      const float* ks = k_s + sr * P;
      const float* ls = lc_s + sr * P;
      float acc = 0.0f;
#pragma unroll 8
      for (int i = 0; i < N; ++i)
        acc = __fadd_rn(acc, __fmul_rn(__fmul_rn(rt[i], ks[i]),
                                       expf(__fsub_rn(et[i], ls[i]))));
      a_s[t * kAP + sr] = acc;
    }
    for (int t = tid; t < kC; t += kThreads) {
      float acc = 0.0f;
      for (int i = 0; i < N; ++i)
        acc = __fadd_rn(acc, __fmul_rn(__fmul_rn(r_s[t * P + i], k_s[t * P + i]), u_s[i]));
      d_s[t] = acc;
    }
    __syncthreads();
    // r * exp(e) and k * exp(lc_last - lc) in place; exp(lc_last)
    for (int idx = tid; idx < kC * N; idx += kThreads) {
      const int t = idx / N, i = idx - t * N;
      const float last = lc_s[(kC - 1) * P + i];
      r_s[t * P + i] = __fmul_rn(r_s[t * P + i], expf(e_s[t * P + i]));
      k_s[t * P + i] = __fmul_rn(k_s[t * P + i], expf(__fsub_rn(last, lc_s[t * P + i])));
    }
    for (int i = tid; i < N; i += kThreads) dec_s[i] = expf(lc_s[(kC - 1) * P + i]);
    __syncthreads();
    // y, value column m, rows rg, rg + kRG, ...: intra-chunk, then the state
    for (int t = rg; t < rows; t += kRG) {
      const float* at = a_s + t * kAP;
      float intra = 0.0f;
      for (int j = 0; j < t; ++j) intra = __fadd_rn(intra, __fmul_rn(at[j], v_s[j * P + m]));
      intra = __fadd_rn(intra, __fmul_rn(d_s[t], v_s[t * P + m]));
      const float* qt = r_s + t * P;
      float cross = 0.0f;
#pragma unroll 8
      for (int i = 0; i < N; ++i) cross = __fadd_rn(cross, __fmul_rn(qt[i], st_s[i * P + m]));
      y[((size_t)bh * s + c0 + t) * N + m] = __fadd_rn(intra, cross);
    }
    __syncthreads();  // y has read the state
    // the state update, value column m, key rows rg, rg + kRG, ...
    for (int i = rg; i < N; i += kRG) {
      float acc = 0.0f;
#pragma unroll 8
      for (int j = 0; j < kC; ++j) acc = __fadd_rn(acc, __fmul_rn(k_s[j * P + i], v_s[j * P + m]));
      st_s[i * P + m] = __fadd_rn(__fmul_rn(dec_s[i], st_s[i * P + m]), acc);
    }
  }
  __syncthreads();  // S = 0 (no chunk) was zeroed by other threads
  for (int i = rg; i < N; i += kRG) s_out[(size_t)bh * N * N + i * N + m] = st_s[i * P + m];
}

template <typename T, int N>
int launch_n(const void* r, const void* k, const void* v, const float* logw, const float* u,
             float* y, float* s_out, int bh, int h, int s, long long sb, long long sh,
             long long ss, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<N>();
  const cudaError_t err = rtk::allow_smem(wkv_kernel<T, N>, smem);
  if (err != cudaSuccess) return (int)err;
  wkv_kernel<T, N><<<bh, kThreads, smem, stream>>>(
      static_cast<const T*>(r), static_cast<const T*>(k), static_cast<const T*>(v), logw, u, y,
      s_out, h, s, sb, sh, ss);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const void* r, const void* k, const void* v, const float* logw, const float* u,
           float* y, float* s_out, int bh, int h, int s, int n, long long sb, long long sh,
           long long ss, cudaStream_t stream) {
  if (bh == 0) return 0;
  switch (n) {
    case 16:
      return launch_n<T, 16>(r, k, v, logw, u, y, s_out, bh, h, s, sb, sh, ss, stream);
    case 32:
      return launch_n<T, 32>(r, k, v, logw, u, y, s_out, bh, h, s, sb, sh, ss, stream);
    case 64:
      return launch_n<T, 64>(r, k, v, logw, u, y, s_out, bh, h, s, sb, sh, ss, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// r, k, v [B, H, S, N] of the activation dtype and logw [B, H, S, N] f32,
// all four with the element strides sb, sh, ss and a contiguous last axis;
// u [H, N] f32; y [B, H, S, N] and s_out [B, H, N, N] f32, contiguous.
extern "C" int tm_wkv(const void* r, const void* k, const void* v, const void* logw,
                      const void* u, void* y, void* s_out, int bh, int h, int s, int n,
                      long long sb, long long sh, long long ss, int dtype, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* w = static_cast<const float*>(logw);
  const float* uu = static_cast<const float*>(u);
  float* yy = static_cast<float*>(y);
  float* so = static_cast<float*>(s_out);
  if (dtype == rtk::kBF16)
    return launch<__nv_bfloat16>(r, k, v, w, uu, yy, so, bh, h, s, n, sb, sh, ss, st);
  if (dtype == rtk::kF32) return launch<float>(r, k, v, w, uu, yy, so, bh, h, s, n, sb, sh, ss, st);
  return (int)cudaErrorInvalidValue;
}
