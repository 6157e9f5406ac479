// Single-token attention of each decoding slot against its KV cache.
//
// Replaces: repro/kernels/decode_attention/kernel.py::decode_attention_kernel
// (kernel.py:305 -> _call :113, pallas_call :170) and, with an int8 cache,
// ::decode_attention_kernel_quant (kernel.py:324, body _kernel :75-106);
// over a page pool, ::decode_attention_paged_kernel (kernel.py:261) and
// ::decode_attention_paged_kernel_quant (kernel.py:281), both built by
// _call_paged (pallas_call :250).
//
// Computes, for every (slot b, kv head) row bh of q [B*HK, G, D] against
// k/v [B*HK, M, D] (bf16 or f32) and the slot's frontier p = pos[b]:
//   s = (q . k) * scale in f32, softcap * tanh(s / softcap) when softcap > 0,
//   masked to -1e30 past p and, with a window, at p - kpos >= window;
//   online softmax over kv blocks: m, l in f32, probabilities cast to the
//   cache dtype before P.V (kernel.py:103), out = T(acc / max(l, 1e-30))
//   (kernel.py:110).
// Blocks past the frontier or wholly below the window foot are skipped and
// never read, as the TPU kernel's clamped index map skips them.
// The int8 variant reads k/v [B*HK, M, D] int8 with f32 row scales
// [B*HK, M] and dequantizes each row in registers as T(code * scale) in f32
// (ternary.py:102) before it is dotted or weighted; the dense path's
// arithmetic is unchanged.
// The paged variant (kPaged) reads k/v from page pools [P*HK, ps, D] (int8:
// scales [P*HK, ps]) through the page table pt [B, NB]: logical row r of
// slot b, kv head h is pool row (pt[b, r / ps] * HK + h) * ps + r % ps
// (rtk::kv_row). Nothing else differs, so on any table its output is bit
// for bit the contiguous kernel's on the gathered dense view. Rows outside
// [first, last] are not looked up: no table entry or page past the frontier
// or below the window foot is read.
//
// Bound on the H100: bytes. Each live cache row is read once (2*D elements
// of K and V) for 4*G*D flops, far below the ridge. At tellme's decode
// shape (B = 4, 16 heads, G = 1, D = 96, a few hundred positions) the whole
// call moves well under a megabyte, so launch latency sets its time.
//
// Design: one block of 128 threads per (slot, kv head), walking the live
// rows 128 at a time; G > 1 query heads share each K/V row read. Each
// thread scores one row (16-byte loads of its K row for bf16, D = 96 being
// no power of two), block reductions update (m, l), and then threads own
// (g, d) outputs for the P.V update, reading rows of V together and
// unrolled so that several rows' loads are in flight. A 128-row step spans
// two 64-row pages, so the paged variant looks up each thread's row, and
// keeps the row indices of the step in shared memory for the P.V loop.
// Split-KV across blocks is later work.

#include <math.h>

#include <type_traits>

#include "common.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kBkv = kThreads;  // kv rows per block step: one per thread
constexpr float kNegInf = -1e30f;

// q . k for one cache row, summed in order e = 0..d-1 (f32, no FMA).
template <typename T>
__device__ __forceinline__ float dot_row(const float* q, const T* k, int d) {
  float acc = 0.0f;
#pragma unroll 8
  for (int e = 0; e < d; ++e) acc = __fadd_rn(acc, __fmul_rn(q[e], rtk::Num<T>::to_f(k[e])));
  return acc;
}

// bf16 rows of a multiple of 8 elements: 16-byte loads, same order.
template <>
__device__ __forceinline__ float dot_row<__nv_bfloat16>(const float* q, const __nv_bfloat16* k,
                                                       int d) {
  float acc = 0.0f;
  if (d % 8 == 0 && (reinterpret_cast<uintptr_t>(k) & 15) == 0) {
    const uint4* kv = reinterpret_cast<const uint4*>(k);
#pragma unroll 4
    for (int c = 0; c < d / 8; ++c) {
      const uint4 u = kv[c];
      const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        const float2 f = __bfloat1622float2(h[t]);
        acc = __fadd_rn(acc, __fmul_rn(q[8 * c + 2 * t], f.x));
        acc = __fadd_rn(acc, __fmul_rn(q[8 * c + 2 * t + 1], f.y));
      }
    }
    return acc;
  }
  for (int e = 0; e < d; ++e) acc = __fadd_rn(acc, __fmul_rn(q[e], __bfloat162float(k[e])));
  return acc;
}

// q . T(code * scale) for one int8 cache row, in the order of dot_row.
template <typename T>
__device__ __forceinline__ float dot_row_i8(const float* q, const int8_t* k, float ks, int d) {
  float acc = 0.0f;
  if (d % 16 == 0 && (reinterpret_cast<uintptr_t>(k) & 15) == 0) {
    const uint4* kv = reinterpret_cast<const uint4*>(k);
#pragma unroll 2
    for (int c = 0; c < d / 16; ++c) {
      const uint4 u = kv[c];
      const int8_t* b = reinterpret_cast<const int8_t*>(&u);
#pragma unroll
      for (int t = 0; t < 16; ++t)
        acc = __fadd_rn(acc, __fmul_rn(q[16 * c + t], rtk::kv_dequant<T>(b[t], ks)));
    }
    return acc;
  }
  for (int e = 0; e < d; ++e) acc = __fadd_rn(acc, __fmul_rn(q[e], rtk::kv_dequant<T>(k[e], ks)));
  return acc;
}

// Block-wide max with -1e30 as identity (scores may all be masked).
__device__ __forceinline__ float block_max(float v, float* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  v = rtk::warp_max(v);
  __syncthreads();
  if (lane == 0) red[warp] = v;
  __syncthreads();
  float r = kNegInf;
  for (int w = 0; w < kThreads / 32; ++w) r = fmaxf(r, red[w]);
  return r;
}

// CT is the cache's element type: T (dense) or int8_t (with row scales
// ks, vs; unused and null for a dense cache). With kPaged, k, v, ks, vs are
// page pools read through pt [B, NB] (null and unused otherwise).
template <typename T, typename CT, bool kPaged>
__global__ void __launch_bounds__(kThreads)
    decode_attention_kernel(const T* __restrict__ q, const CT* __restrict__ k,
                            const CT* __restrict__ v, const float* __restrict__ ks,
                            const float* __restrict__ vs, const int* __restrict__ pos,
                            const int* __restrict__ pt, T* __restrict__ out, int hk, int g,
                            int m, int d, int nb, int ps, int window, float softcap,
                            float scale) {
  constexpr bool kQuant = std::is_same<CT, int8_t>::value;
  extern __shared__ float smem[];
  float* qf = smem;             // [g*d] queries in f32
  float* acc = qf + g * d;      // [g*d] unnormalized outputs
  float* s = acc + g * d;       // [g*kBkv] scores, then probabilities
  float* mrow = s + g * kBkv;   // [g] running max
  float* lrow = mrow + g;       // [g] running sum
  float* alpha = lrow + g;      // [g] rescale of this step
  float* red = alpha + g;       // [32] reduction scratch
  int* rows = reinterpret_cast<int*>(red + 32);  // [kBkv] pool rows (kPaged)

  const int bh = blockIdx.x, tid = threadIdx.x;
  const int p = pos[bh / hk];
  const T* qb = q + (size_t)bh * g * d;

  for (int i = tid; i < g * d; i += kThreads) {
    qf[i] = rtk::Num<T>::to_f(qb[i]);
    acc[i] = 0.0f;
  }
  for (int i = tid; i < g; i += kThreads) {
    mrow[i] = kNegInf;
    lrow[i] = 0.0f;
  }
  __syncthreads();

  const int last = min(p, m - 1);                              // last live row
  const int first = window > 0 ? max(p - window + 1, 0) : 0;  // first live row
  for (int j = first / kBkv; j <= last / kBkv; ++j) {
    // scores: thread tid owns row j*kBkv + tid; rows outside [first, last]
    // are masked with -1e30 and never read (nor looked up)
    const int kp = j * kBkv + tid;
    const bool live = kp >= first && kp <= last;
    const size_t row = live ? rtk::kv_row<kPaged>(pt, bh, hk, m, nb, ps, kp) : 0;
    if constexpr (kPaged) rows[tid] = (int)row;
    for (int gi = 0; gi < g; ++gi) {
      float sc = kNegInf;
      if (live) {
        float dot;
        if constexpr (kQuant)
          dot = dot_row_i8<T>(qf + gi * d, k + row * d, ks[row], d);
        else
          dot = dot_row<T>(qf + gi * d, k + row * d, d);
        sc = __fmul_rn(dot, scale);
        if (softcap > 0.0f) sc = __fmul_rn(softcap, tanhf(__fdiv_rn(sc, softcap)));
      }
      s[gi * kBkv + tid] = sc;
    }
    // online-softmax state, one query head at a time (every thread reads
    // mrow[gi] before the sum's barriers; thread 0 writes it after them)
    for (int gi = 0; gi < g; ++gi) {
      const float sc = s[gi * kBkv + tid];
      const float m_new = fmaxf(mrow[gi], block_max(sc, red));
      const float e = expf(sc - m_new);
      s[gi * kBkv + tid] = e;
      const float sum = rtk::block_reduce<false>(e, red);
      if (tid == 0) {
        const float a = expf(mrow[gi] - m_new);
        alpha[gi] = a;
        lrow[gi] = __fadd_rn(__fmul_rn(lrow[gi], a), sum);
        mrow[gi] = m_new;
      }
    }
    __syncthreads();
    // acc = acc * alpha + T(p) . V over this block's live rows; threads own
    // (g, d) outputs, so a row of V is read by neighbouring threads
    const int r0 = max(first - j * kBkv, 0), r1 = min(last - j * kBkv, kBkv - 1);
    for (int i = tid; i < g * d; i += kThreads) {
      const int gi = i / d, e = i - gi * d;
      const float* pr = s + gi * kBkv;
      float o = 0.0f;
      if constexpr (kPaged) {
#pragma unroll 8
        for (int r = r0; r <= r1; ++r) {
          const size_t vr = (size_t)rows[r];
          float vv;
          if constexpr (kQuant)
            vv = rtk::kv_dequant<T>(v[vr * d + e], vs[vr]);
          else
            vv = rtk::Num<T>::to_f(v[vr * d + e]);
          o = __fadd_rn(o, __fmul_rn(rtk::round_to<T>(pr[r]), vv));
        }
      } else {
        const size_t row0 = (size_t)bh * m + (size_t)j * kBkv;
        const CT* vcol = v + row0 * d + e;
        if constexpr (kQuant) {
          const float* vsr = vs + row0;
#pragma unroll 8
          for (int r = r0; r <= r1; ++r)
            o = __fadd_rn(o, __fmul_rn(rtk::round_to<T>(pr[r]),
                                       rtk::kv_dequant<T>(vcol[(size_t)r * d], vsr[r])));
        } else {
#pragma unroll 8
          for (int r = r0; r <= r1; ++r)
            o = __fadd_rn(o, __fmul_rn(rtk::round_to<T>(pr[r]),
                                       rtk::Num<T>::to_f(vcol[(size_t)r * d])));
        }
      }
      acc[i] = __fadd_rn(__fmul_rn(acc[i], alpha[gi]), o);
    }
    __syncthreads();  // s and rows are rewritten by the next step
  }

  T* ob = out + (size_t)bh * g * d;
  for (int i = tid; i < g * d; i += kThreads) {
    const int gi = i / d;
    ob[i] = rtk::Num<T>::from_f(__fdiv_rn(acc[i], fmaxf(lrow[gi], 1e-30f)));
  }
}

template <typename T, typename CT, bool kPaged>
int launch(const void* q, const void* k, const void* v, const void* ks, const void* vs,
           const void* pos, const void* pt, void* out, int bhk, int hk, int g, int m, int d,
           int nb, int ps, int window, float softcap, float scale, cudaStream_t stream) {
  if (bhk == 0) return 0;
  const size_t smem = (size_t)(2 * g * d + g * kBkv + 3 * g + 32) * sizeof(float) +
                      (kPaged ? kBkv * sizeof(int) : 0);
  cudaError_t err = rtk::allow_smem(decode_attention_kernel<T, CT, kPaged>, smem);
  if (err != cudaSuccess) return (int)err;
  decode_attention_kernel<T, CT, kPaged><<<bhk, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const CT*>(k), static_cast<const CT*>(v),
      static_cast<const float*>(ks), static_cast<const float*>(vs),
      static_cast<const int*>(pos), static_cast<const int*>(pt), static_cast<T*>(out), hk, g,
      m, d, nb, ps, window, softcap, scale);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int tm_decode_attention(const void* q, const void* k, const void* v,
                                   const void* pos, void* out, int bhk, int hk, int g, int m,
                                   int d, int window, float softcap, float scale, int dtype,
                                   void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == rtk::kBF16)
    return launch<__nv_bfloat16, __nv_bfloat16, false>(q, k, v, nullptr, nullptr, pos,
                                                       nullptr, out, bhk, hk, g, m, d, 0, 0,
                                                       window, softcap, scale, s);
  if (dtype == rtk::kF32)
    return launch<float, float, false>(q, k, v, nullptr, nullptr, pos, nullptr, out, bhk, hk,
                                       g, m, d, 0, 0, window, softcap, scale, s);
  return (int)cudaErrorInvalidValue;
}

// The int8-cache variant: k, v int8 [B*HK, M, D], ks, vs f32 [B*HK, M].
extern "C" int tm_decode_attention_quant(const void* q, const void* k, const void* v,
                                         const void* ks, const void* vs, const void* pos,
                                         void* out, int bhk, int hk, int g, int m, int d,
                                         int window, float softcap, float scale, int dtype,
                                         void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == rtk::kBF16)
    return launch<__nv_bfloat16, int8_t, false>(q, k, v, ks, vs, pos, nullptr, out, bhk, hk,
                                                g, m, d, 0, 0, window, softcap, scale, s);
  if (dtype == rtk::kF32)
    return launch<float, int8_t, false>(q, k, v, ks, vs, pos, nullptr, out, bhk, hk, g, m, d,
                                        0, 0, window, softcap, scale, s);
  return (int)cudaErrorInvalidValue;
}

// The paged variants: k, v pools [P*HK, ps, D] of T (quant = 0) or int8 with
// f32 scale pools ks, vs [P*HK, ps] (quant = 1), read through pt [B, NB]
// int32; the logical cache holds nb * ps rows.
extern "C" int tm_decode_attention_paged(const void* q, const void* k, const void* v,
                                         const void* ks, const void* vs, const void* pt,
                                         const void* pos, void* out, int bhk, int hk, int g,
                                         int nb, int ps, int d, int window, float softcap,
                                         float scale, int quant, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int m = nb * ps;
  using bf16 = __nv_bfloat16;
  if (dtype == rtk::kBF16 && quant)
    return launch<bf16, int8_t, true>(q, k, v, ks, vs, pos, pt, out, bhk, hk, g, m, d, nb, ps,
                                      window, softcap, scale, s);
  if (dtype == rtk::kBF16)
    return launch<bf16, bf16, true>(q, k, v, nullptr, nullptr, pos, pt, out, bhk, hk, g, m, d,
                                    nb, ps, window, softcap, scale, s);
  if (dtype == rtk::kF32 && quant)
    return launch<float, int8_t, true>(q, k, v, ks, vs, pos, pt, out, bhk, hk, g, m, d, nb, ps,
                                       window, softcap, scale, s);
  if (dtype == rtk::kF32)
    return launch<float, float, true>(q, k, v, nullptr, nullptr, pos, pt, out, bhk, hk, g, m,
                                      d, nb, ps, window, softcap, scale, s);
  return (int)cudaErrorInvalidValue;
}
