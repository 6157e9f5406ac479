// The kernels of the chunked prefill's attention, shared by the four
// translation units that instantiate them, one for each layout and cache
// dtype: prefill_append.cu (contiguous, dense cache; it also holds the
// extern "C" entry tm_prefill_append), prefill_append_int8.cu (contiguous,
// int8 cache), prefill_append_paged.cu (page pools, dense; the entry
// tm_prefill_append_paged) and prefill_append_paged_int8.cu (page pools,
// int8). Each instantiates dispatch<kPaged, kQuant> for its own pair only,
// so the four quarters of the template instantiations compile in parallel.
//
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
// (pt[b, r / ps] * HK + h) * ps + r % ps (rtk::kv_row). A 32-row half of a
// kv tile lies in one page (the wrapper asks ps % 32 == 0), so the
// tensor-core kernel looks up each half once a tile; the CUDA-core kernel
// looks up each 32-row tile. Everything else is the contiguous kernel, so on
// any table its output is bit for bit the contiguous kernel's on the
// gathered dense view, and the pools after the append are that kernel's
// cache scattered back through the table. Write-only slots write through
// trash-region entries, which map the garbage page: several slots may
// write it at once, which is benign because the page is never read
// unmasked (repro/serving/paging.py:30-35).
//
// Bound on the H100: at the engine's fused tick (8 slots, C = 256, D = 96,
// 16 heads, live slots at offsets 0 and 512, six write-only) the call
// reads q, k_new, v_new and the live prefix once and writes out and the
// chunk's cache rows once, about 36 MB: 10.8 us at 3.35 TB/s; its 3.15 M
// live (query, key) pairs are 1.2 GFLOP, 1.2 us on the bf16 tensor cores.
// So it is bound by bytes, and at one slot (C = 128 at 768, 32 blocks) by
// the latency of each block's walk over 14 kv tiles.
//
// bf16 runs on the tensor cores (prefill_append_tc_kernel), with flash
// attention's warp-level walk (csrc/attn_mma.cuh): one block of 4 warps per
// (bh, tile of 64 grouped query rows), Q in registers as m16n8k16
// fragments, K and V bf16 in shared memory (rows padded by 16 bytes,
// ldmatrix and ldmatrix.trans), P rounded to bf16 as the A operand of P.V.
// The walk visits the prefix tiles [window foot, off) from the cache, then
// the chunk's own tiles from k_new/v_new up to the block's last row. Rows
// outside those ranges are staged as zeros and never read, so NaN in an
// unread page cannot reach P.V. A 64-row tile may hold rows of two query
// heads of a group (G > 1, C % 64 != 0): every lane masks by the positions
// of its own two rows, and only tiles that reach past a warp's diagonal,
// its window foot or a ragged end are masked elementwise. Dense tiles
// stream through a two-stage cp.async ring. The int8 cache's codes and row
// scales stream by cp.async into a raw buffer while the previous tile is
// computed, and are written as T(code * scale) bf16 rows into the one
// K/V stage; the chunk's own rows are quantized and dequantized the same
// way (each warp four K rows and their V rows at a time, their absmax
// shuffles interleaved).
//
// f32 runs on the CUDA cores (prefill_append_kernel), in f32 throughout:
// the tensor cores would take f32 as TF32, which misses the 1e-5 bar. One
// block of 128 threads per (bh, tile of 32 grouped query rows); four
// threads share a query row, each holding D/4 of its q and accumulator,
// their partial dots summed by two xor shuffles; kv rows stream through
// shared memory 32 at a time as T-rounded f32 (dequantized on load for
// int8), each tile read as 16-byte vectors.
//
// The append is spread over the blocks of each bh: block y writes its
// share of the chunk's rows, 16-byte vectors for a dense cache, and for
// int8 each lane's four codes as one word and the row scale, a warp
// quantizing four rows (and their V rows) at a time. No block of the
// launch reads those rows (prefix reads stop below off, chunk reads come
// from k_new/v_new), so the in-place append cannot race. Paged, the same
// holds across slots: a page the chunk writes
// has refcount 1 (the engine's ensure_writable forks shared pages first),
// so no other slot's table maps it. Blocks of write-only slots append,
// zero their output rows and exit. D is a template argument (16, 32, 64,
// 96 or 128).

#pragma once

#include <math.h>

#include <type_traits>

#include "attn_mma.cuh"
#include "common.cuh"

namespace {

using bf16 = __nv_bfloat16;
namespace attn = rtk::attn;

constexpr int kThreads = 128;
constexpr int kQuad = 4;                 // threads per query row
constexpr int kRows = kThreads / kQuad;  // grouped query rows per block
constexpr int kTk = 32;                  // kv rows per shared-memory tile
constexpr int kWarps = kThreads / 32;
constexpr float kNegInf = -1e30f;

// Four consecutive T values as f32.
__device__ __forceinline__ void load4(const float* p, float (&v)[4]) {
  const float4 u = *reinterpret_cast<const float4*>(p);
  v[0] = u.x, v[1] = u.y, v[2] = u.z, v[3] = u.w;
}
__device__ __forceinline__ void load4(const bf16* p, float (&v)[4]) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
  v[0] = a.x, v[1] = a.y, v[2] = b.x, v[3] = b.y;
}

// quantize_kv's scales of kN rows x[i] [D] (x[i] null: a row of zeros)
// held by one warp, four elements a lane (lanes past D hold zeros), their
// absmax reductions interleaved so that one row's shuffles hide another's.
template <typename T, int D, int kN>
__device__ __forceinline__ void rows4_scales(const T* (&x)[kN], float (&v)[kN][4],
                                             float (&s)[kN]) {
  const int lane = threadIdx.x & 31;
  float amax[kN];
#pragma unroll
  for (int i = 0; i < kN; ++i) {
    v[i][0] = v[i][1] = v[i][2] = v[i][3] = 0.0f;
    if (x[i] != nullptr && 4 * lane < D) load4(x[i] + 4 * lane, v[i]);
    amax[i] = fmaxf(fmaxf(fabsf(v[i][0]), fabsf(v[i][1])), fmaxf(fabsf(v[i][2]), fabsf(v[i][3])));
  }
#pragma unroll
  for (int o = 16; o; o >>= 1)
#pragma unroll
    for (int i = 0; i < kN; ++i) amax[i] = fmaxf(amax[i], __shfl_xor_sync(0xffffffffu, amax[i], o));
#pragma unroll
  for (int i = 0; i < kN; ++i) s[i] = rtk::act_scale<T>(amax[i]);
}

// A lane's four int8 codes of a row with scale s, as one word.
template <typename T>
__device__ __forceinline__ uint32_t codes4(const float (&v)[4], float s) {
  uint32_t w = 0;
#pragma unroll
  for (int u = 0; u < 4; ++u) w |= (uint32_t)(uint8_t)rtk::act_code<T>(v[u], s) << (8 * u);
  return w;
}

// The chunk's rows [j0, j1) of bh (knb, vnb [C, D]) into the cache at
// rows o + j, by the whole block. int8: quantize_kv, each warp four rows
// (and their V rows) at a time.
template <typename T, typename CT, int D, bool kQuant, bool kPaged>
__device__ __forceinline__ void append_rows(const T* __restrict__ knb, const T* __restrict__ vnb,
                                            CT* __restrict__ kc, CT* __restrict__ vc,
                                            float* __restrict__ ks, float* __restrict__ vs,
                                            const int* __restrict__ pt, int bh, int hk, int m,
                                            int nb, int ps, int o, int j0, int j1) {
  if constexpr (kQuant) {
    constexpr int kB = 4;
    const int nw = blockDim.x >> 5, lane = threadIdx.x & 31;
    for (int j = j0 + (int)(threadIdx.x >> 5); j < j1; j += nw * kB) {
      const T* x[2 * kB];
#pragma unroll
      for (int i = 0; i < kB; ++i) {
        const int jj = j + i * nw;
        x[i] = jj < j1 ? knb + (size_t)jj * D : nullptr;
        x[kB + i] = jj < j1 ? vnb + (size_t)jj * D : nullptr;
      }
      float v[2 * kB][4], sc[2 * kB];
      rows4_scales<T, D, 2 * kB>(x, v, sc);
#pragma unroll
      for (int i = 0; i < kB; ++i) {
        const int jj = j + i * nw;
        if (jj >= j1) break;
        const size_t row = rtk::kv_row<kPaged>(pt, bh, hk, m, nb, ps, o + jj);
        if (4 * lane < D) {
          *reinterpret_cast<uint32_t*>(kc + row * D + 4 * lane) = codes4<T>(v[i], sc[i]);
          *reinterpret_cast<uint32_t*>(vc + row * D + 4 * lane) = codes4<T>(v[kB + i], sc[kB + i]);
        }
        if (lane == 0) {
          ks[row] = sc[i];
          vs[row] = sc[kB + i];
        }
      }
    }
  } else {
    constexpr int kVec = 16 / sizeof(T), kPer = D / kVec;  // 16-byte vectors per row
    for (int i = threadIdx.x; i < (j1 - j0) * kPer; i += blockDim.x) {
      const int jj = i / kPer, j = j0 + jj, col = (i - jj * kPer) * kVec;
      const size_t row = rtk::kv_row<kPaged>(pt, bh, hk, m, nb, ps, o + j);
      const uint4 kx = *reinterpret_cast<const uint4*>(knb + (size_t)j * D + col);
      const uint4 vx = *reinterpret_cast<const uint4*>(vnb + (size_t)j * D + col);
      *reinterpret_cast<uint4*>(kc + row * D + col) = kx;
      *reinterpret_cast<uint4*>(vc + row * D + col) = vx;
    }
  }
}

// Block y's share of the c chunk rows, of ny blocks.
__device__ __forceinline__ void append_share(int c, int y, int ny, int& j0, int& j1) {
  const int per = (c + ny - 1) / ny;
  j0 = min(y * per, c);
  j1 = min(y * per + per, c);
}

// ---------------------------------------------------------------------------
// f32: CUDA cores
// ---------------------------------------------------------------------------

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
        const int e = 4 * (tid & 31);
        const T* x[2] = {j < n ? knb + (size_t)(t0 + j) * D : nullptr,
                         j < n ? vnb + (size_t)(t0 + j) * D : nullptr};
        float y[2][4], sc[2];
        rows4_scales<T, D, 2>(x, y, sc);
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int u = 0; u < 4; ++u)
            y[i][u] = rtk::kv_dequant<T>(rtk::act_code<T>(y[i][u], sc[i]), sc[i]);
        if (e < D) {
          float* dst[2] = {k_s + j * D + e, v_s + j * D + e};
#pragma unroll
          for (int i = 0; i < 2; ++i)
            *reinterpret_cast<float4*>(dst[i]) = make_float4(y[i][0], y[i][1], y[i][2], y[i][3]);
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

  // --- this block's share of the append --------------------------------
  if (!in_range) return;
  int j0, j1;
  append_share(c, blockIdx.y, gridDim.y, j0, j1);
  append_rows<T, CT, D, kQuant, kPaged>(knb, vnb, kc, vc, ks, vs, pt, bh, hk, m, nb, ps, o, j0,
                                        j1);
}

// ---------------------------------------------------------------------------
// bf16: tensor cores
// ---------------------------------------------------------------------------

// Shared memory of one block. Dense: K and V, two stages each, padded
// rows. int8: one K/V stage and a raw buffer that holds either a prefix
// tile's codes [2][64][D] and scales [2][64], or a chunk tile's bf16 rows
// [2][64][D].
template <int D, bool kQuant>
constexpr size_t tc_smem_bytes() {
  return kQuant ? 2 * attn::Shape<D>::kTile * sizeof(bf16) + 2 * attn::kKeys * D * sizeof(bf16)
                : 4 * attn::Shape<D>::kTile * sizeof(bf16);
}

// Two f32 products rounded once to a bf16 pair: T(code * scale) as
// kv_dequant gives it, packed.
__device__ __forceinline__ uint32_t dequant2(int c0, int c1, float s) {
  return attn::pack_bf16(__fmul_rn((float)c0, s), __fmul_rn((float)c1, s));
}

// 16 int8 codes with their row scale -> 16 bf16 T(code * scale).
__device__ __forceinline__ void dequant16(const int8_t* codes, float s, bf16* dst) {
  const uint4 u = *reinterpret_cast<const uint4*>(codes);
  const int8_t* c8 = reinterpret_cast<const int8_t*>(&u);
  uint32_t w[8];
#pragma unroll
  for (int t = 0; t < 8; ++t) w[t] = dequant2(c8[2 * t], c8[2 * t + 1], s);
  reinterpret_cast<uint4*>(dst)[0] = make_uint4(w[0], w[1], w[2], w[3]);
  reinterpret_cast<uint4*>(dst)[1] = make_uint4(w[4], w[5], w[6], w[7]);
}

// Chunk rows r0 + j * kWarps (j < kB) of the raw K and V tiles (bf16
// [64][D]) quantized as quantize_kv does and written dequantized,
// T(code * scale), into the stage's padded rows: one warp, four elements a
// lane.
template <int D, int kB>
__device__ __forceinline__ void requant_rows(const bf16* rk, const bf16* rv, bf16* kd, bf16* vd,
                                             int r0) {
  const int lane = threadIdx.x & 31;
  const bf16* x[2 * kB];
#pragma unroll
  for (int i = 0; i < kB; ++i) {
    x[i] = rk + (r0 + i * attn::kWarps) * D;
    x[kB + i] = rv + (r0 + i * attn::kWarps) * D;
  }
  float v[2 * kB][4], sc[2 * kB];
  rows4_scales<bf16, D, 2 * kB>(x, v, sc);
  if (4 * lane >= D) return;
#pragma unroll
  for (int i = 0; i < 2 * kB; ++i) {
    int c[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) c[u] = rtk::act_code<bf16>(v[i][u], sc[i]);
    bf16* dst = (i < kB ? kd : vd) + (r0 + (i % kB) * attn::kWarps) * attn::Shape<D>::kStride;
    *reinterpret_cast<uint2*>(dst + 4 * lane) =
        make_uint2(dequant2(c[0], c[1], sc[i]), dequant2(c[2], c[3], sc[i]));
  }
}

// CT is the cache's element type: bf16, or int8_t with row scales ks, vs
// (kQuant). With kPaged, kc, vc, ks, vs are page pools read and written
// through pt [B, NB] (null and unused otherwise); m = nb * ps.
template <typename CT, int D, bool kQuant, bool kPaged>
__global__ void __launch_bounds__(attn::kThreads)
    prefill_append_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ kn,
                             const bf16* __restrict__ vn, CT* __restrict__ kc,
                             CT* __restrict__ vc, float* __restrict__ ks,
                             float* __restrict__ vs, const int* __restrict__ off,
                             const int* __restrict__ pt, bf16* __restrict__ out, int hk, int g,
                             int c, int m, int nb, int ps, int window, float softcap,
                             float scale, int prefix_limit) {
  constexpr int kTile = attn::Shape<D>::kTile, kStride = attn::Shape<D>::kStride;
  constexpr int kKeys = attn::kKeys;
  constexpr int kStages = kQuant ? 1 : 2;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* kbuf = reinterpret_cast<bf16*>(smem);  // [kStages][kKeys][kStride]
  bf16* vbuf = kbuf + kStages * kTile;         // [kStages][kKeys][kStride]
  unsigned char* raw = reinterpret_cast<unsigned char*>(vbuf + kStages * kTile);  // int8 only

  const int bh = blockIdx.x, gc = g * c, tid = threadIdx.x;
  const int o = off[bh / hk];
  const int y = gridDim.y - 1 - blockIdx.y;  // last query tile first
  const int r0 = y * attn::kRows;
  const bf16* knb = kn + (size_t)bh * c * D;
  const bf16* vnb = vn + (size_t)bh * c * D;
  bf16* ob = out + (size_t)bh * gc * D;

  if (o >= 0 && o + c <= m) {  // this block's share of the append
    int j0, j1;
    append_share(c, y, gridDim.y, j0, j1);
    append_rows<bf16, CT, D, kQuant, kPaged>(knb, vnb, kc, vc, ks, vs, pt, bh, hk, m, nb, ps,
                                             o, j0, j1);
  }
  if (prefix_limit > 0 && o >= prefix_limit) {  // write-only: zero output rows
    const int n = (min(attn::kRows, gc - r0) * D) / 8;
    uint4* op = reinterpret_cast<uint4*>(ob + (size_t)r0 * D);
    for (int i = tid; i < n; i += attn::kThreads) op[i] = make_uint4(0u, 0u, 0u, 0u);
    return;
  }

  // Positions of the lane's two rows (rows past G*C shadow the last), and
  // the warp's least and greatest.
  const int warp = tid >> 5, lane = tid & 31;
  const int wrow = 16 * warp;
  int qpos[2];
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) qpos[rr] = o + min(r0 + wrow + (lane >> 2) + 8 * rr, gc - 1) % c;
  const int pmin = __reduce_min_sync(0xffffffffu, min(qpos[0], qpos[1]));
  const int pmax = __reduce_max_sync(0xffffffffu, max(qpos[0], qpos[1]));

  // The block's chunk rows [i_lo, i_hi] (every row when the tile holds two
  // query heads); the walk: prefix keys [p_lo, p_hi) in n_pre tiles from
  // pre0, then chunk keys from chk0 up to i_hi.
  const int r_last = min(r0 + attn::kRows, gc) - 1;
  const bool one_head = r0 / c == r_last / c;
  const int i_lo = one_head ? r0 % c : 0, i_hi = one_head ? r_last % c : c - 1;
  const int p_hi = min(max(o, 0), m);
  const int p_lo = window > 0 ? max(o + i_lo - window + 1, 0) : 0;
  const int pre0 = p_lo / kKeys * kKeys;
  const int n_pre = p_lo < p_hi ? (p_hi - pre0 + kKeys - 1) / kKeys : 0;
  const int chk0 = (window > 0 ? max(i_lo - window + 1, 0) : 0) / kKeys * kKeys;
  const int ntiles = n_pre + (i_hi - chk0) / kKeys + 1;
  auto tile_t0 = [&](int it) {
    return it < n_pre ? pre0 + it * kKeys : chk0 + (it - n_pre) * kKeys;
  };
  // Cache row of prefix key t0 + r, live in [p_lo, p_hi): a 32-row half
  // of a tile lies in one page (ps % 32 == 0), so its rows follow its
  // first one, resolved once a tile. Chunk row t0 + r, live below c.
  auto prefix_row = [=](int t0) {
    size_t half[2];
#pragma unroll
    for (int i = 0; i < 2; ++i)
      half[i] = t0 + 32 * i < p_hi ? rtk::kv_row<kPaged>(pt, bh, hk, m, nb, ps, t0 + 32 * i) : 0;
    return [=](int r, bool& ok) -> size_t {
      const int kp = t0 + r;
      ok = kp >= p_lo && kp < p_hi;
      return ok ? (r < 32 ? half[0] : half[1]) + (r & 31) : 0;
    };
  };
  auto chunk_row = [=](int t0) {
    return [=](int r, bool& ok) -> size_t {
      ok = t0 + r < c;
      return ok ? t0 + r : 0;
    };
  };

  // int8: tile it's codes and scales (prefix) or bf16 rows (chunk) into
  // the raw buffer
  int8_t* rk8 = reinterpret_cast<int8_t*>(raw);
  int8_t* rv8 = rk8 + kKeys * D;
  float* rks = reinterpret_cast<float*>(rv8 + kKeys * D);
  float* rvs = rks + kKeys;
  bf16* rkb = reinterpret_cast<bf16*>(raw);
  bf16* rvb = rkb + kKeys * D;
  auto stage = [&](int it, int st) {
    const int t0 = tile_t0(it);
    if constexpr (kQuant) {
      if (it < n_pre) {
        constexpr int kChunks = D / 16;
        const auto row_of = prefix_row(t0);
        for (int i = tid; i < kKeys * kChunks; i += attn::kThreads) {
          const int r = i / kChunks, col = (i - r * kChunks) * 16;
          bool ok;
          const size_t row = row_of(r, ok);
          rtk::cp_async16(rk8 + r * D + col, kc + row * D + col, ok);
          rtk::cp_async16(rv8 + r * D + col, vc + row * D + col, ok);
        }
        for (int r = tid; r < kKeys; r += attn::kThreads) {
          bool ok;
          const size_t row = row_of(r, ok);
          rtk::cp_async4(rks + r, ks + row, ok);
          rtk::cp_async4(rvs + r, vs + row, ok);
        }
      } else {
        constexpr int kChunks = D / 8;
        for (int i = tid; i < kKeys * kChunks; i += attn::kThreads) {
          const int r = i / kChunks, col = (i - r * kChunks) * 8;
          const bool ok = t0 + r < c;
          const size_t row = ok ? t0 + r : 0;
          rtk::cp_async16(rkb + r * D + col, knb + row * D + col, ok);
          rtk::cp_async16(rvb + r * D + col, vnb + row * D + col, ok);
        }
      }
    } else if (it < n_pre) {
      attn::stage_kv_rows<D>(kbuf + st * kTile, vbuf + st * kTile, kc, vc, prefix_row(t0));
    } else {
      attn::stage_kv_rows<D>(kbuf + st * kTile, vbuf + st * kTile, knb, vnb, chunk_row(t0));
    }
  };
  // int8: the raw buffer's tile it as bf16 rows of the K/V stage
  auto convert = [&](int it) {
    if (it < n_pre) {
      constexpr int kChunks = D / 16;
      for (int i = tid; i < kKeys * kChunks; i += attn::kThreads) {
        const int r = i / kChunks, col = (i - r * kChunks) * 16;
        dequant16(rk8 + r * D + col, rks[r], kbuf + r * kStride + col);
        dequant16(rv8 + r * D + col, rvs[r], vbuf + r * kStride + col);
      }
    } else {
      for (int r0 = warp; r0 < kKeys; r0 += 4 * attn::kWarps)
        requant_rows<D, 4>(rkb, rvb, kbuf, vbuf, r0);
    }
  };

  // Q goes through a K buffer (dense: stage 1's), into registers as A
  // fragments, with the first tile behind it.
  bf16* qtile = kbuf + (kStages - 1) * kTile;
  attn::stage_rows<D>(qtile, q + (size_t)bh * gc * D, [=](int r, bool& ok) -> size_t {
    ok = r0 + r < gc;
    return ok ? r0 + r : 0;
  });
  stage(0, 0);
  rtk::cp_async_commit();
  rtk::cp_async_wait<0>();
  __syncthreads();
  uint32_t qf[D / 16][4];
  attn::load_q<D>(qf, qtile, wrow);
  __syncthreads();  // the Q buffer is free

  float acc[D / 8][4];
#pragma unroll
  for (int dt = 0; dt < D / 8; ++dt) acc[dt][0] = acc[dt][1] = acc[dt][2] = acc[dt][3] = 0.0f;
  float m_run[2] = {attn::kNegInf, attn::kNegInf}, l_run[2] = {0.0f, 0.0f};

  for (int it = 0; it < ntiles; ++it) {
    int st = 0;
    if constexpr (kQuant) {
      rtk::cp_async_wait<0>();
      __syncthreads();  // tile it is in the raw buffer; the stage is consumed
      convert(it);
      __syncthreads();  // the stage holds tile it; the raw buffer is free
      if (it + 1 < ntiles) stage(it + 1, 0);
      rtk::cp_async_commit();
    } else {
      if (it + 1 < ntiles) stage(it + 1, (it + 1) & 1);
      rtk::cp_async_commit();
      rtk::cp_async_wait<1>();  // this tile has landed; the next may be in flight
      __syncthreads();
      st = it & 1;
    }
    const int t0 = tile_t0(it);
    float sc[attn::kKTiles][4];
    attn::qk<D>(sc, qf, kbuf + st * kTile);
    if (it < n_pre) {  // prefix keys: every one precedes the chunk
      const bool masked = t0 + kKeys > p_hi || (window > 0 && t0 < pmax - window + 1);
      attn::scale_mask(sc, scale, softcap, masked, [&](int col, int rr) {
        const int kp = t0 + col;
        return kp < p_hi && (window <= 0 || qpos[rr] - kp < window);
      });
    } else {  // the chunk's keys t0 + col at positions o + t0 + col
      const bool masked = t0 + kKeys - 1 > pmin - o || t0 + kKeys > c ||
                          (window > 0 && o + t0 < pmax - window + 1);
      attn::scale_mask(sc, scale, softcap, masked, [&](int col, int rr) {
        const int kp = o + t0 + col;
        return t0 + col < c && kp <= qpos[rr] && (window <= 0 || qpos[rr] - kp < window);
      });
    }
    attn::online_softmax<D>(sc, m_run, l_run, acc);
    attn::pv<D>(acc, sc, vbuf + st * kTile);
    if constexpr (!kQuant) __syncthreads();  // the stage is consumed before it is refilled
  }

#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    const int row = r0 + wrow + (lane >> 2) + 8 * rr;
    if (row < gc) attn::store_row<D>(ob + (size_t)row * D, acc, rr, l_run[rr]);
  }
}

template <typename T, typename CT, bool kQuant, bool kPaged, int D>
int launch_d(const void* q, const void* kn, const void* vn, void* kc, void* vc, void* ks,
             void* vs, const void* off, const void* pt, void* out, int bhk, int hk, int g,
             int c, int m, int nb, int ps, int window, float softcap, float scale,
             int prefix_limit, cudaStream_t stream) {
  if constexpr (std::is_same<T, bf16>::value) {
    constexpr size_t smem = tc_smem_bytes<D, kQuant>();
    const cudaError_t err =
        rtk::allow_smem(prefill_append_tc_kernel<CT, D, kQuant, kPaged>, smem);
    if (err != cudaSuccess) return (int)err;
    const dim3 grid(bhk, (g * c + attn::kRows - 1) / attn::kRows);
    prefill_append_tc_kernel<CT, D, kQuant, kPaged><<<grid, attn::kThreads, smem, stream>>>(
        static_cast<const bf16*>(q), static_cast<const bf16*>(kn), static_cast<const bf16*>(vn),
        static_cast<CT*>(kc), static_cast<CT*>(vc), static_cast<float*>(ks),
        static_cast<float*>(vs), static_cast<const int*>(off), static_cast<const int*>(pt),
        static_cast<bf16*>(out), hk, g, c, m, nb, ps, window, softcap, scale, prefix_limit);
  } else {
    const dim3 grid(bhk, (g * c + kRows - 1) / kRows);
    prefill_append_kernel<T, CT, D, kQuant, kPaged><<<grid, kThreads, 0, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(kn), static_cast<const T*>(vn),
        static_cast<CT*>(kc), static_cast<CT*>(vc), static_cast<float*>(ks),
        static_cast<float*>(vs), static_cast<const int*>(off), static_cast<const int*>(pt),
        static_cast<T*>(out), hk, g, c, m, nb, ps, window, softcap, scale, prefix_limit);
  }
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

template <bool kPaged, bool kQuant>
int dispatch(const void* q, const void* kn, const void* vn, void* kc, void* vc, void* ks,
             void* vs, const void* off, const void* pt, void* out, int bhk, int hk, int g,
             int c, int m, int nb, int ps, int d, int window, float softcap, float scale,
             int prefix_limit, int dtype, cudaStream_t s) {
  if (dtype == rtk::kBF16)
    return launch<bf16, std::conditional_t<kQuant, int8_t, bf16>, kQuant, kPaged>(
        q, kn, vn, kc, vc, ks, vs, off, pt, out, bhk, hk, g, c, m, nb, ps, d, window, softcap,
        scale, prefix_limit, s);
  if (dtype == rtk::kF32)
    return launch<float, std::conditional_t<kQuant, int8_t, float>, kQuant, kPaged>(
        q, kn, vn, kc, vc, ks, vs, off, pt, out, bhk, hk, g, c, m, nb, ps, d, window, softcap,
        scale, prefix_limit, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// The quarter of each translation unit, defined there: dispatch<kPaged,
// kQuant> of its layout and cache dtype. pt is null and nb, ps are 0 for
// the contiguous layout.
#define RTK_PA_QUARTER(name)                                                                 \
  extern "C" int name(const void* q, const void* kn, const void* vn, void* kc, void* vc,    \
                      void* ks, void* vs, const void* off, const void* pt, void* out, int bhk, \
                      int hk, int g, int c, int m, int nb, int ps, int d, int window,         \
                      float softcap, float scale, int prefix_limit, int dtype, cudaStream_t s)
RTK_PA_QUARTER(rtk_prefill_append_dense);
RTK_PA_QUARTER(rtk_prefill_append_int8);
RTK_PA_QUARTER(rtk_prefill_append_paged_dense);
RTK_PA_QUARTER(rtk_prefill_append_paged_int8);
#define RTK_PA_DISPATCH(kPaged, kQuant)                                                      \
  return dispatch<kPaged, kQuant>(q, kn, vn, kc, vc, ks, vs, off, pt, out, bhk, hk, g, c, m, \
                                  nb, ps, d, window, softcap, scale, prefix_limit, dtype, s)
