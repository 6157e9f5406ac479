// Chunked prefill attention against each slot's cache prefix, with the
// chunk's K/V appended into the cache in place.
//
// Replaces: repro/kernels/prefill_append/kernel.py::prefill_append_kernel
// (kernel.py:532) and ::prefill_append_kernel_quant (kernel.py:556), both
// built by _call (pallas_call at :246) around the body _kernel (:53-157);
// over a page pool, ::prefill_append_paged_kernel (kernel.py:477) and
// ::prefill_append_paged_kernel_quant (kernel.py:503), both built by
// _call_paged (:369, pallas_call :464).
//
// Computes, for every (slot b, kv head) row bh = b*HK + h of the grouped
// chunk queries q [B*HK, G*C, D] (row = g*C + i sits at position off[b] + i):
//   attention over the cache prefix (rows < off[b]) and causally over the
//   chunk's own rows k_new/v_new [B*HK, C, D]: s = (q . k) * scale in f32,
//   softcap * tanh(s / softcap) when softcap > 0, the -1e30 mask (causal,
//   and pos - kpos >= window with a window), online softmax with m and l in
//   f32, probabilities cast to T before P.V, out = T(acc / max(l, 1e-30)).
//   The chunk's rows land in the cache at [off[b], off[b] + C): dense, as
//   they are; int8 (kQuant), as quantize_kv's codes and f32 row scales
//   (ternary.py:89, bit-equal to the plain version: absmax, scale and
//   quotient in T, rint half to even). The int8 variant reads prefix rows
//   dequantized as T(code * scale) and attends to the chunk's own
//   dequantized rows (kernel.py:130-138), as every later reader will.
//   Slots with off >= prefix_limit > 0 (the engine's trash-diverted slots)
//   only write: their prefix is never read (kernel.py:98-101). Their output
//   is garbage by contract; here it is zero, and no attention is computed
//   for them at all (the TPU kernel still runs their chunk phase).
// The paged variant (kPaged) keeps the cache as page pools [P*HK, ps, D]
// (int8: scales [P*HK, ps]) read and written through the page table pt
// [B, NB]: logical row r of slot b, kv head h is pool row
// (pt[b, r / ps] * HK + h) * ps + r % ps (rtk::kv_row). Everything else is
// the contiguous kernel, so on any table its output is bit for bit the
// contiguous kernel's on the gathered dense view, and the pools after the
// append are that kernel's cache scattered back through the table. A 32-row
// kv tile starts at a multiple of 32 and so lies inside one page (the
// wrapper asks ps % 32 == 0), and the chunk's C rows fill whole pages
// (C % ps == 0, off % C == 0), written one page at a time. Write-only slots
// write through trash-region entries, which map the garbage page: several
// slots may write it at once, which is benign because the page is never
// read unmasked (repro/serving/paging.py:30-35).
//
// Bound on the H100: at the engine's tick shapes (C = 256, D = 96, a few
// hundred prefix rows) a slot's chunk q/k/v/out and its live prefix are a
// few MB read or written once, against 4*G*D flops per (query, key) pair
// (~1 GFLOP per live slot); the bytes and the bf16 tensor-core flops give
// bounds of the same order, about 1-2 us per live slot.
//
// Design (simple first; tensor-core MMA is later work): one block of 128
// threads per (bh, tile of 32 grouped query rows). Four threads share a
// query row, each holding D/4 of its q and of its f32 accumulator in
// registers; their partial dots are summed by two xor shuffles, which leave
// the same sum in all four. kv rows stream through shared memory 32 at a
// time as T-rounded f32 (dequantized on load for int8), each tile read as
// 16-byte vectors. D = 96 is no power of two, so D is a template argument
// (16, 32, 64, 96 or 128) and the per-thread slices are read as float4. The
// blocks of query tile 0 write the chunk into the cache at the end: no block
// of this launch reads those rows (prefix reads stop below off, chunk reads
// come from k_new), so the in-place append cannot race. Paged, the same
// holds across slots: a page the chunk writes has refcount 1 (the engine's
// ensure_writable forks shared pages first), so no other slot's table maps
// it, and the chunk attends to its own rows from k_new/v_new, never from
// the pool.

#include <math.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kQuad = 4;                 // threads per query row
constexpr int kRows = kThreads / kQuad;  // grouped query rows per block
constexpr int kTk = 32;                  // kv rows per shared-memory tile
constexpr int kWarps = kThreads / 32;
constexpr float kNegInf = -1e30f;

// quantize_kv of one row x[0..d) (T values) by one warp: returns the row
// scale; code(e) gives element e's int8 code.
template <typename T>
__device__ __forceinline__ float row_scale(const T* x, int d) {
  float amax = 0.0f;
  for (int e = threadIdx.x & 31; e < d; e += 32)
    amax = fmaxf(amax, fabsf(rtk::Num<T>::to_f(x[e])));
  return rtk::act_scale<T>(rtk::warp_max(amax));
}

// Rows [0, n) of a tile of kTk consecutive rows (src, and their int8 scales
// sc) into shared memory as f32 values (dequantized for int8), zeros past n.
// The tile is contiguous, so each thread reads it as 16-byte vectors, all of
// its loads issued before the first is used.
template <typename T, typename CT, int D, bool kQuant>
__device__ __forceinline__ void load_tile(const CT* __restrict__ src, const float* sc, int n,
                                          float* dst) {
  constexpr int kVec = 16 / sizeof(CT);     // elements per vector
  constexpr int kPerRow = D / kVec;         // D % 16 == 0: whole vectors per row
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
    const CT* e = reinterpret_cast<const CT*>(&buf[it]);
    float4* d = reinterpret_cast<float4*>(dst + v * kVec);
    float s = 0.0f;
    if constexpr (kQuant) s = v / kPerRow < n ? sc[v / kPerRow] : 0.0f;
#pragma unroll
    for (int t = 0; t < kVec / 4; ++t) {
      float f[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        if constexpr (kQuant)
          f[u] = rtk::kv_dequant<T>(e[4 * t + u], s);
        else
          f[u] = rtk::Num<T>::to_f(e[4 * t + u]);
      }
      d[t] = make_float4(f[0], f[1], f[2], f[3]);
    }
  }
}

// With kPaged, kc, vc, ks, vs are page pools read and written through pt
// [B, NB] (null and unused otherwise); m = nb * ps.
template <typename T, typename CT, int D, bool kQuant, bool kPaged>
__global__ void __launch_bounds__(kThreads)
    prefill_append_kernel(const T* __restrict__ q, const T* __restrict__ kn,
                          const T* __restrict__ vn, CT* __restrict__ kc, CT* __restrict__ vc,
                          float* __restrict__ ks, float* __restrict__ vs,
                          const int* __restrict__ off, const int* __restrict__ pt,
                          T* __restrict__ out, int hk, int g, int c, int m, int nb, int ps,
                          int window, float softcap, float scale, int prefix_limit) {
  constexpr int kDp = D / kQuad;  // dims per thread
  __shared__ __align__(16) float k_s[kTk * D];
  __shared__ __align__(16) float v_s[kTk * D];

  const int bh = blockIdx.x, tid = threadIdx.x;
  const int part = tid & (kQuad - 1);
  const int gc = g * c;
  const int row = blockIdx.y * kRows + tid / kQuad;
  const bool row_ok = row < gc;
  const int qrow = row_ok ? row : gc - 1;  // idle threads shadow the last row
  const int o = off[bh / hk];
  const bool in_range = o >= 0 && o + c <= m;
  const int qpos = o + qrow % c;
  const T* knb = kn + (size_t)bh * c * D;
  const T* vnb = vn + (size_t)bh * c * D;

  float qr[kDp], acc[kDp];
  {
    const T* qp = q + ((size_t)bh * gc + qrow) * D + part * kDp;
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
    float s[kTk];
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
      float sc = dot * scale;
      if (softcap > 0.0f) sc = softcap * tanhf(sc / softcap);
      const int kpos = kpos0 + j;
      bool live = j < n && kpos <= qpos;
      if (window > 0) live = live && qpos - kpos < window;
      s[j] = live ? sc : kNegInf;
      tmax = fmaxf(tmax, s[j]);
    }
    const float m_new = fmaxf(m_run, tmax);
    if (m_new == kNegInf) return;  // nothing live for this row yet
    const float alpha = expf(m_run - m_new);
    float psum = 0.0f;
#pragma unroll
    for (int j = 0; j < kTk; ++j) {
      const float p = s[j] == kNegInf ? 0.0f : expf(s[j] - m_new);
      psum += p;
      s[j] = rtk::round_to<T>(p);  // P in V's dtype before P.V
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
        acc[4 * e] = fmaf(s[j], vv.x, acc[4 * e]);
        acc[4 * e + 1] = fmaf(s[j], vv.y, acc[4 * e + 1]);
        acc[4 * e + 2] = fmaf(s[j], vv.z, acc[4 * e + 2]);
        acc[4 * e + 3] = fmaf(s[j], vv.w, acc[4 * e + 3]);
      }
    }
  };

  // --- prefix phase: cache rows [lo, hi); write-only slots attend nowhere --
  const bool write_only = prefix_limit > 0 && o >= prefix_limit;
  const int hi = write_only ? 0 : min(max(o, 0), m);
  const int lo = window > 0 ? max(o - window + 1, 0) : 0;  // row 0's window foot
  for (int t0 = (lo / kTk) * kTk; t0 < hi; t0 += kTk) {
    const int n = min(kTk, hi - t0);
    __syncthreads();  // the previous tile is consumed
    // the tile's kTk rows are consecutive in one page (or in the slot's rows)
    const size_t row0 = rtk::kv_row<kPaged>(pt, bh, hk, m, nb, ps, t0);
    load_tile<T, CT, D, kQuant>(kc + row0 * D, kQuant ? ks + row0 : nullptr, n, k_s);
    load_tile<T, CT, D, kQuant>(vc + row0 * D, kQuant ? vs + row0 : nullptr, n, v_s);
    __syncthreads();
    update(t0, n);
  }

  // --- chunk phase: the chunk's own rows, causal -------------------------
  const int r_first = blockIdx.y * kRows;
  const int r_last = min(r_first + kRows, gc) - 1;
  const int kmax = r_first / c == r_last / c ? r_last % c : c - 1;  // last row attended here
  for (int t0 = 0; !write_only && t0 <= kmax; t0 += kTk) {
    const int n = min(kTk, c - t0);
    __syncthreads();
    if constexpr (kQuant) {
      // each warp quantizes whole rows and keeps them dequantized
      const int w = tid >> 5;
      for (int j = w; j < kTk; j += kWarps) {
        if (j < n) {
          const T* kx = knb + (size_t)(t0 + j) * D;
          const T* vx = vnb + (size_t)(t0 + j) * D;
          const float ksc = row_scale<T>(kx, D), vsc = row_scale<T>(vx, D);
          for (int e = tid & 31; e < D; e += 32) {
            k_s[j * D + e] = rtk::kv_dequant<T>(
                rtk::act_code<T>(rtk::Num<T>::to_f(kx[e]), ksc), ksc);
            v_s[j * D + e] = rtk::kv_dequant<T>(
                rtk::act_code<T>(rtk::Num<T>::to_f(vx[e]), vsc), vsc);
          }
        } else {
          for (int e = tid & 31; e < D; e += 32) k_s[j * D + e] = v_s[j * D + e] = 0.0f;
        }
      }
    } else {
      load_tile<T, T, D, false>(knb + (size_t)t0 * D, nullptr, n, k_s);
      load_tile<T, T, D, false>(vnb + (size_t)t0 * D, nullptr, n, v_s);
    }
    __syncthreads();
    update(o + t0, n);
  }

  if (row_ok) {  // zero for write-only slots: acc = 0 and l = 0
    T* op = out + ((size_t)bh * gc + row) * D + part * kDp;
    const float l = fmaxf(l_run, 1e-30f);
#pragma unroll
    for (int e = 0; e < kDp; ++e) op[e] = rtk::Num<T>::from_f(acc[e] / l);
  }

  // --- the append: tile-0 blocks write rows [o, o + c) of this bh --------
  if (blockIdx.y != 0 || !in_range) return;
  if constexpr (kQuant) {
    const int w = tid >> 5, lane = tid & 31;
    for (int j = w; j < c; j += kWarps) {
      const size_t row = rtk::kv_row<kPaged>(pt, bh, hk, m, nb, ps, o + j);
      const T* kx = knb + (size_t)j * D;
      const T* vx = vnb + (size_t)j * D;
      const float ksc = row_scale<T>(kx, D), vsc = row_scale<T>(vx, D);
      for (int e = lane; e < D; e += 32) {
        kc[row * D + e] = rtk::act_code<T>(rtk::Num<T>::to_f(kx[e]), ksc);
        vc[row * D + e] = rtk::act_code<T>(rtk::Num<T>::to_f(vx[e]), vsc);
      }
      if (lane == 0) {
        ks[row] = ksc;
        vs[row] = vsc;
      }
    }
  } else {
    // whole pages (paged) or the slot's c rows at once (contiguous)
    const int span = kPaged ? ps : c;
    for (int t0 = 0; t0 < c; t0 += span) {
      CT* kdst = kc + rtk::kv_row<kPaged>(pt, bh, hk, m, nb, ps, o + t0) * D;
      CT* vdst = vc + rtk::kv_row<kPaged>(pt, bh, hk, m, nb, ps, o + t0) * D;
      const T* ksrc = knb + (size_t)t0 * D;
      const T* vsrc = vnb + (size_t)t0 * D;
      for (int i = tid; i < span * D; i += kThreads) {
        kdst[i] = ksrc[i];
        vdst[i] = vsrc[i];
      }
    }
  }
}

template <typename T, typename CT, bool kQuant, bool kPaged, int D>
int launch_d(const void* q, const void* kn, const void* vn, void* kc, void* vc, void* ks,
             void* vs, const void* off, const void* pt, void* out, int bhk, int hk, int g,
             int c, int m, int nb, int ps, int window, float softcap, float scale,
             int prefix_limit, cudaStream_t stream) {
  const dim3 grid(bhk, (g * c + kRows - 1) / kRows);
  prefill_append_kernel<T, CT, D, kQuant, kPaged><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(kn), static_cast<const T*>(vn),
      static_cast<CT*>(kc), static_cast<CT*>(vc), static_cast<float*>(ks),
      static_cast<float*>(vs), static_cast<const int*>(off), static_cast<const int*>(pt),
      static_cast<T*>(out), hk, g, c, m, nb, ps, window, softcap, scale, prefix_limit);
  return (int)cudaGetLastError();
}

template <typename T, typename CT, bool kQuant, bool kPaged>
int launch(const void* q, const void* kn, const void* vn, void* kc, void* vc, void* ks,
           void* vs, const void* off, const void* pt, void* out, int bhk, int hk, int g, int c,
           int m, int nb, int ps, int d, int window, float softcap, float scale,
           int prefix_limit, cudaStream_t stream) {
  if (bhk == 0 || c == 0) return 0;
#define TM_PA_CASE(D)                                                                       \
  case D:                                                                                  \
    return launch_d<T, CT, kQuant, kPaged, D>(q, kn, vn, kc, vc, ks, vs, off, pt, out, bhk, \
                                              hk, g, c, m, nb, ps, window, softcap, scale,  \
                                              prefix_limit, stream);
  switch (d) {
    TM_PA_CASE(16)
    TM_PA_CASE(32)
    TM_PA_CASE(64)
    TM_PA_CASE(96)
    TM_PA_CASE(128)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef TM_PA_CASE
}

template <bool kPaged>
int dispatch(const void* q, const void* kn, const void* vn, void* kc, void* vc, void* ks,
             void* vs, const void* off, const void* pt, void* out, int bhk, int hk, int g,
             int c, int m, int nb, int ps, int d, int window, float softcap, float scale,
             int prefix_limit, int quant, int dtype, cudaStream_t s) {
  using bf16 = __nv_bfloat16;
  if (dtype == rtk::kBF16 && quant)
    return launch<bf16, int8_t, true, kPaged>(q, kn, vn, kc, vc, ks, vs, off, pt, out, bhk, hk,
                                              g, c, m, nb, ps, d, window, softcap, scale,
                                              prefix_limit, s);
  if (dtype == rtk::kBF16)
    return launch<bf16, bf16, false, kPaged>(q, kn, vn, kc, vc, ks, vs, off, pt, out, bhk, hk,
                                             g, c, m, nb, ps, d, window, softcap, scale,
                                             prefix_limit, s);
  if (dtype == rtk::kF32 && quant)
    return launch<float, int8_t, true, kPaged>(q, kn, vn, kc, vc, ks, vs, off, pt, out, bhk,
                                               hk, g, c, m, nb, ps, d, window, softcap, scale,
                                               prefix_limit, s);
  if (dtype == rtk::kF32)
    return launch<float, float, false, kPaged>(q, kn, vn, kc, vc, ks, vs, off, pt, out, bhk,
                                               hk, g, c, m, nb, ps, d, window, softcap, scale,
                                               prefix_limit, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// quant = 0: dense cache of T (ks, vs unused); quant = 1: int8 cache with
// f32 row scales ks, vs [B*HK, M].
extern "C" int tm_prefill_append(const void* q, const void* kn, const void* vn, void* kc,
                                 void* vc, void* ks, void* vs, const void* off, void* out,
                                 int bhk, int hk, int g, int c, int m, int d, int window,
                                 float softcap, float scale, int prefix_limit, int quant,
                                 int dtype, void* stream) {
  return dispatch<false>(q, kn, vn, kc, vc, ks, vs, off, nullptr, out, bhk, hk, g, c, m, 0, 0,
                         d, window, softcap, scale, prefix_limit, quant, dtype,
                         static_cast<cudaStream_t>(stream));
}

// The paged variants: kc, vc pools [P*HK, ps, D] (ks, vs [P*HK, ps] for
// quant = 1) read and written through pt [B, NB] int32; the logical cache
// holds nb * ps rows.
extern "C" int tm_prefill_append_paged(const void* q, const void* kn, const void* vn, void* kc,
                                       void* vc, void* ks, void* vs, const void* pt,
                                       const void* off, void* out, int bhk, int hk, int g,
                                       int c, int nb, int ps, int d, int window, float softcap,
                                       float scale, int prefix_limit, int quant, int dtype,
                                       void* stream) {
  return dispatch<true>(q, kn, vn, kc, vc, ks, vs, off, pt, out, bhk, hk, g, c, nb * ps, nb,
                        ps, d, window, softcap, scale, prefix_limit, quant, dtype,
                        static_cast<cudaStream_t>(stream));
}
