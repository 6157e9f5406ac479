// Causal attention over a whole prompt: the one-shot prefill's attention.
//
// Replaces: repro/kernels/flash_attention/kernel.py::flash_attention_kernel
// (kernel.py:101, pallas_call at :138) around the body _kernel (:35-98).
//
// Computes, for q [B, H, S, D] and k/v [B, HK, S, D] (H % HK == 0; head hh
// of slot b reads kv head b*HK + hh / G, G = H / HK, the TPU kernel's index
// map at kernel.py:131-134): s = (q . k) * scale in f32, the -1e30 mask
// above the diagonal, online softmax with m and l in f32, probabilities
// cast to T before P.V, out = T(acc / max(l, 1e-30)). causal_skip = 1
// visits only the kv tiles up to the block's causal frontier, the paper's
// causal-skip schedule (Table II); 0 visits
// every tile and masks each element, the dense ablation: the same output,
// about twice the work. Any S: a ragged last tile is masked, nothing is
// padded.
//
// Bound on the H100: at S = 4096, D = 96, 16 heads, the live causal pairs
// are 16 * 4096 * 4097 / 2 = 134 M, 4 * D flops each: 51.6 GFLOP, 52 us on
// the bf16 tensor cores; q, k, v and out are 50 MB, 15 us. Long prompts are
// bound by operations, short ones (S = 128) by bytes and launch. This
// kernel runs the products on the CUDA cores in f32 (67 TFLOP/s), so its
// floor is some 15 times the tensor-core bound; wgmma is later work.
//
// Design (simple first; the same tiling as prefill_append.cu): one block of
// 128 threads per (b * H + head, tile of 32 query rows); four threads share
// a query row, each holding D/4 of its q and of its f32 accumulator in
// registers, their partial dots summed by two xor shuffles. kv rows stream
// through shared memory 32 at a time as f32, each tile read as 16-byte
// vectors. The query tiles are issued last first: the tiles near the end of
// the sequence walk the most kv tiles, so they start first and the short
// ones fill the tail. D is a template argument (16, 32, 64, 96 or 128).

#include <math.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kQuad = 4;                 // threads per query row
constexpr int kRows = kThreads / kQuad;  // query rows per block
constexpr int kTk = 32;                  // kv rows per shared-memory tile
constexpr float kNegInf = -1e30f;

// Rows [0, n) of a tile of kTk consecutive rows of src into shared memory
// as f32, zeros past n; 16-byte vectors, all loads issued before use.
template <typename T, int D>
__device__ __forceinline__ void load_tile(const T* __restrict__ src, int n, float* dst) {
  constexpr int kVec = 16 / sizeof(T);  // elements per vector
  constexpr int kPerRow = D / kVec;     // D * sizeof(T) % 16 == 0
  constexpr int kTotal = kTk * kPerRow;
  constexpr int kIters = (kTotal + kThreads - 1) / kThreads;
  const uint4* v4 = reinterpret_cast<const uint4*>(src);
  uint4 buf[kIters];
#pragma unroll
  for (int it = 0; it < kIters; ++it) {
    const int v = threadIdx.x + it * kThreads;
    buf[it] = v < kTotal && v / kPerRow < n ? v4[v] : make_uint4(0u, 0u, 0u, 0u);
  }
#pragma unroll
  for (int it = 0; it < kIters; ++it) {
    const int v = threadIdx.x + it * kThreads;
    if (v >= kTotal) break;
    const T* e = reinterpret_cast<const T*>(&buf[it]);
    float4* d = reinterpret_cast<float4*>(dst + v * kVec);
#pragma unroll
    for (int t = 0; t < kVec / 4; ++t)
      d[t] = make_float4(rtk::Num<T>::to_f(e[4 * t]), rtk::Num<T>::to_f(e[4 * t + 1]),
                         rtk::Num<T>::to_f(e[4 * t + 2]), rtk::Num<T>::to_f(e[4 * t + 3]));
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                           const T* __restrict__ v, T* __restrict__ out, int h, int hk, int s,
                           float scale, int causal_skip) {
  constexpr int kDp = D / kQuad;  // dims per thread
  __shared__ __align__(16) float k_s[kTk * D];
  __shared__ __align__(16) float v_s[kTk * D];

  const int bh = blockIdx.x, tid = threadIdx.x;
  const int b = bh / h;
  const int kvh = b * hk + (bh - b * h) / (h / hk);
  const int part = tid & (kQuad - 1);
  const int r0 = (gridDim.y - 1 - blockIdx.y) * kRows;  // last query tile first
  const int row = r0 + tid / kQuad;
  const bool row_ok = row < s;
  const int qpos = row_ok ? row : s - 1;  // idle threads shadow the last row
  const T* kb = k + (size_t)kvh * s * D;
  const T* vb = v + (size_t)kvh * s * D;

  float qr[kDp], acc[kDp];
  {
    const T* qp = q + ((size_t)bh * s + qpos) * D + part * kDp;
#pragma unroll
    for (int e = 0; e < kDp; ++e) {
      qr[e] = rtk::Num<T>::to_f(qp[e]);
      acc[e] = 0.0f;
    }
  }
  float m_run = kNegInf, l_run = 0.0f;

  // Online-softmax update of this thread's row over the tile in shared
  // memory: its rows j < n sit at key positions kpos0 + j.
  auto update = [&](int kpos0, int n) {
    float sc[kTk];
    float tmax = kNegInf;
#pragma unroll
    for (int j = 0; j < kTk; ++j) {
      const float4* kr = reinterpret_cast<const float4*>(k_s + j * D + part * kDp);
      float dot = 0.0f;
#pragma unroll
      for (int e = 0; e < kDp / 4; ++e) {
        const float4 kv = kr[e];
        dot = fmaf(qr[4 * e], kv.x, dot);
        dot = fmaf(qr[4 * e + 1], kv.y, dot);
        dot = fmaf(qr[4 * e + 2], kv.z, dot);
        dot = fmaf(qr[4 * e + 3], kv.w, dot);
      }
      dot += __shfl_xor_sync(0xffffffffu, dot, 1);
      dot += __shfl_xor_sync(0xffffffffu, dot, 2);
      const int kpos = kpos0 + j;
      sc[j] = j < n && kpos <= qpos ? dot * scale : kNegInf;
      tmax = fmaxf(tmax, sc[j]);
    }
    const float m_new = fmaxf(m_run, tmax);
    if (m_new == kNegInf) return;  // nothing live for this row yet
    const float alpha = expf(m_run - m_new);
    float psum = 0.0f;
#pragma unroll
    for (int j = 0; j < kTk; ++j) {
      const float p = sc[j] == kNegInf ? 0.0f : expf(sc[j] - m_new);
      psum += p;
      sc[j] = rtk::round_to<T>(p);  // P in V's dtype before P.V
    }
    l_run = l_run * alpha + psum;
    m_run = m_new;
#pragma unroll
    for (int e = 0; e < kDp; ++e) acc[e] *= alpha;
#pragma unroll
    for (int j = 0; j < kTk; ++j) {
      const float4* vr = reinterpret_cast<const float4*>(v_s + j * D + part * kDp);
#pragma unroll
      for (int e = 0; e < kDp / 4; ++e) {
        const float4 vv = vr[e];
        acc[4 * e] = fmaf(sc[j], vv.x, acc[4 * e]);
        acc[4 * e + 1] = fmaf(sc[j], vv.y, acc[4 * e + 1]);
        acc[4 * e + 2] = fmaf(sc[j], vv.z, acc[4 * e + 2]);
        acc[4 * e + 3] = fmaf(sc[j], vv.w, acc[4 * e + 3]);
      }
    }
  };

  // kv rows up to the block's last query row, or every row for the dense
  // schedule
  const int hi = causal_skip ? min(r0 + kRows, s) : s;
  for (int t0 = 0; t0 < hi; t0 += kTk) {
    const int n = min(kTk, s - t0);
    __syncthreads();  // the previous tile is consumed
    load_tile<T, D>(kb + (size_t)t0 * D, n, k_s);
    load_tile<T, D>(vb + (size_t)t0 * D, n, v_s);
    __syncthreads();
    update(t0, n);
  }

  if (row_ok) {
    T* op = out + ((size_t)bh * s + row) * D + part * kDp;
    const float l = fmaxf(l_run, 1e-30f);
#pragma unroll
    for (int e = 0; e < kDp; ++e) op[e] = rtk::Num<T>::from_f(acc[e] / l);
  }
}

template <typename T, int D>
int launch_d(const void* q, const void* k, const void* v, void* out, int b, int h, int hk,
             int s, float scale, int causal_skip, cudaStream_t stream) {
  const dim3 grid(b * h, (s + kRows - 1) / kRows);
  flash_attention_kernel<T, D><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(out), h, hk, s, scale, causal_skip);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const void* q, const void* k, const void* v, void* out, int b, int h, int hk, int s,
           int d, float scale, int causal_skip, cudaStream_t stream) {
  if (b == 0 || s == 0) return 0;
#define TM_FA_CASE(D) \
  case D:             \
    return launch_d<T, D>(q, k, v, out, b, h, hk, s, scale, causal_skip, stream);
  switch (d) {
    TM_FA_CASE(16)
    TM_FA_CASE(32)
    TM_FA_CASE(64)
    TM_FA_CASE(96)
    TM_FA_CASE(128)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef TM_FA_CASE
}

}  // namespace

// q, out [B, H, S, D], k, v [B, HK, S, D], all of the activation dtype.
extern "C" int tm_flash_attention(const void* q, const void* k, const void* v, void* out, int b,
                                  int h, int hk, int s, int d, float scale, int causal_skip,
                                  int dtype, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == rtk::kBF16)
    return launch<__nv_bfloat16>(q, k, v, out, b, h, hk, s, d, scale, causal_skip, st);
  if (dtype == rtk::kF32)
    return launch<float>(q, k, v, out, b, h, hk, s, d, scale, causal_skip, st);
  return (int)cudaErrorInvalidValue;
}
