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
// Rows past the frontier or below the window foot are never read, as the
// TPU kernel's clamped index map skips their blocks.
// The int8 variant reads k/v [B*HK, M, D] int8 with f32 row scales
// [B*HK, M] and dequantizes each row in registers as T(code * scale) in f32
// (ternary.py:102) before it is dotted or weighted.
// The paged variant (kPaged) reads k/v from page pools [P*HK, ps, D] (int8:
// scales [P*HK, ps]) through the page table pt [B, NB]: logical row r of
// slot b, kv head h is pool row (pt[b, r / ps] * HK + h) * ps + r % ps
// (rtk::kv_row), looked up per row. Nothing else differs, so on any table
// its output is bit for bit the contiguous kernel's on the gathered dense
// view; no table entry or page past the frontier or below the window foot
// is read.
//
// Bound on the H100: bytes. Each live cache row is read once (2*D elements
// of K and V, int8: plus two scales) for 4*G*D flops, far below the ridge.
// At the engine's decode shape (8 slots, 16 kv heads, D = 96, G = 1, 6078
// live rows a head) that is 37 MB, 11 us at 3.35 TB/s; at generate's (4
// slots, 164 rows) 1 us, where launch latency sets the time.
//
// Design: split-KV. The grid is (B*HK, splits, G / kG): block (bh, j, z)
// takes logical rows [j * split, (j + 1) * split) of bh, clipped to the live
// range [first, last], for query heads z*kG .. z*kG + kG - 1 (kG = 4, 2 or
// 1, the largest that divides G). The split is a fixed 128 rows
// (ops.SPLIT_ROWS), never read from pos, so the launch makes no
// device-to-host transfer and stays capturable in a CUDA graph, and a
// slot's rows are cut at the same places whatever the cache length; blocks
// with no live row write an empty partial. Inside a block, each warp walks
// its own rows: a row is read by a group of L lanes (L the power of two at
// or above D's pieces: 16 bytes a lane for bf16 and f32, 8 int8 codes for
// int8), neighbouring lanes on neighbouring bytes, 32 / L rows a pass.
// Two phases, each with eight passes' loads in flight. First the scores:
// K through registers, a row's dot summed over its lanes by xor shuffles,
// into shared memory, with the block's max (paged: each row's pool row
// kept there too, so the table is read once). Then p = expf(s - max)
// against that max, as the plain version takes it against the row's (a
// running max over a few rows rounds T(p) elsewhere, which flipped a
// one-ulp near-tie of generate's greedy decode), l += p and
// acc += T(p) . V in registers. The groups' and warps' sums are added in
// a fixed order. With one split that is the output. Otherwise each block
// writes its (max, l, acc) to scratch, and the last block of (bh, z) to
// arrive (an atomic ticket, which that block resets to zero) merges the
// splits in split order, never in arrival order, so the result is
// deterministic and the paged kernel stays bit-equal to the contiguous
// one. Tickets persist across calls; concurrent calls on two streams of
// one device would share them, so the port issues these calls on one
// stream.

#include <math.h>

#include <type_traits>

#include "common.cuh"

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kPasses = 8;    // row passes per warp whose loads are in flight together
constexpr int kMaxD = 128;
constexpr float kNegInf = -1e30f;

// A lane's piece of a cache row: 16 bytes of T, or 8 int8 codes.
template <typename CT>
struct Piece {
  static constexpr int kE = sizeof(CT) == 1 ? 8 : 16 / (int)sizeof(CT);  // elements
  using Vec = std::conditional_t<sizeof(CT) == 1, uint2, uint4>;
};

template <typename CT>
__device__ __forceinline__ typename Piece<CT>::Vec zero_piece() {
  if constexpr (sizeof(CT) == 1)
    return make_uint2(0u, 0u);
  else
    return make_uint4(0u, 0u, 0u, 0u);
}

// The piece's elements as f32 (int8: T(code * scale)).
template <typename T, typename CT>
__device__ __forceinline__ void unpack(const typename Piece<CT>::Vec& u, float s,
                                       float (&f)[Piece<CT>::kE]) {
  if constexpr (std::is_same<CT, int8_t>::value) {
    const int8_t* c = reinterpret_cast<const int8_t*>(&u);
#pragma unroll
    for (int e = 0; e < 8; ++e) f[e] = rtk::kv_dequant<T>(c[e], s);
  } else if constexpr (std::is_same<CT, float>::value) {
    f[0] = __uint_as_float(u.x), f[1] = __uint_as_float(u.y);
    f[2] = __uint_as_float(u.z), f[3] = __uint_as_float(u.w);
  } else {
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      const float2 v = __bfloat1622float2(h[t]);
      f[2 * t] = v.x, f[2 * t + 1] = v.y;
    }
  }
}

// CT is the cache's element type: T (dense) or int8_t (with row scales ks,
// vs; null for a dense cache). With kPaged, k, v, ks, vs are page pools read
// through pt [B, NB] (null otherwise). part holds the splits' partials
// (acc [B*HK, G, splits, D], then (m, l) [B*HK, G, splits, 2]) and tickets
// one int a (bh, z); both unused with one split. Dynamic shared memory:
// the block's scores (kG * split floats) and, paged, its rows' pool rows
// (split ints).
template <typename T, typename CT, bool kPaged, int kG>
__global__ void __launch_bounds__(kThreads)
    decode_attention_kernel(const T* __restrict__ q, const CT* __restrict__ k,
                            const CT* __restrict__ v, const float* __restrict__ ks,
                            const float* __restrict__ vs, const int* __restrict__ pos,
                            const int* __restrict__ pt, T* __restrict__ out,
                            float* __restrict__ part, int* __restrict__ tickets, int hk, int g,
                            int m, int d, int nb, int ps, int window, float softcap, float scale,
                            int split) {
  constexpr bool kQuant = std::is_same<CT, int8_t>::value;
  constexpr int kE = Piece<CT>::kE;
  using Vec = typename Piece<CT>::Vec;
  extern __shared__ float sm_s[];  // [kG][split], then (paged) [split] pool rows
  __shared__ float sm_red[kWarps][kG];
  __shared__ __align__(16) float sm_acc[kWarps][kG][kMaxD];
  __shared__ bool sm_last;

  const int bh = blockIdx.x, sp = blockIdx.y, nsplit = gridDim.y, z = blockIdx.z;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int npieces = d / kE;
  int lanes = 1;  // lanes per row
  while (lanes < npieces) lanes <<= 1;
  const int rows = 32 / lanes;  // rows per warp pass
  const int grp = lane / lanes, pc = lane - grp * lanes;
  const bool act = pc < npieces;
  const int p = pos[bh / hk];
  const int last = min(p, m - 1);                              // last live row
  const int first = window > 0 ? max(p - window + 1, 0) : 0;  // first live row
  const int lo = max(sp * split, first), hi = min(sp * split + split, last + 1);
  // Warp w takes passes w, w + 4, ...: rows w0 + u * kWarps * rows + grp.
  const int stride = kWarps * rows;

  float qv[kG][kE], mx[kG];
  const T* qb = q + ((size_t)bh * g + z * kG) * d + pc * kE;
#pragma unroll
  for (int gi = 0; gi < kG; ++gi) {
#pragma unroll
    for (int e = 0; e < kE; ++e) qv[gi][e] = act ? rtk::Num<T>::to_f(qb[gi * d + e]) : 0.0f;
    mx[gi] = kNegInf;
  }

  // Phase 1: the scores of rows [lo, hi) into shared memory, a row's dot
  // summed over its group's lanes, and the block's max of each query head;
  // K through registers, kPasses rows a lane in flight. Each row's cache
  // row is kept for phase 2, so a paged row is looked up once.
  const int s0 = sp * split;
  int* sm_row = reinterpret_cast<int*>(sm_s + kG * split);  // [split]
  for (int w0 = lo + warp * rows; w0 < hi; w0 += kPasses * stride) {
    Vec kp[kPasses];
    float ksc[kPasses];
#pragma unroll
    for (int u = 0; u < kPasses; ++u) {
      const int r = w0 + u * stride + grp;
      kp[u] = zero_piece<CT>();
      ksc[u] = 0.0f;
      if (r < hi && act) {
        const size_t row = rtk::kv_row<kPaged>(pt, bh, hk, m, nb, ps, r);
        kp[u] = *reinterpret_cast<const Vec*>(k + row * d + pc * kE);
        if constexpr (kQuant) ksc[u] = ks[row];
        if (kPaged && pc == 0) sm_row[r - s0] = (int)row;
      }
    }
#pragma unroll
    for (int u = 0; u < kPasses; ++u) {
      const int r = w0 + u * stride + grp;
      float kf[kE];
      unpack<T, CT>(kp[u], ksc[u], kf);
#pragma unroll
      for (int gi = 0; gi < kG; ++gi) {
        float dot = 0.0f;
#pragma unroll
        for (int e = 0; e < kE; ++e) dot += qv[gi][e] * kf[e];
        for (int o = lanes >> 1; o; o >>= 1) dot += __shfl_xor_sync(0xffffffffu, dot, o);
        float x = dot * scale;
        if (softcap > 0.0f) x = softcap * tanhf(x / softcap);
        if (r < hi) {
          mx[gi] = fmaxf(mx[gi], x);
          if (pc == 0) sm_s[gi * split + (r - s0)] = x;
        }
      }
    }
  }
#pragma unroll
  for (int gi = 0; gi < kG; ++gi) {
    mx[gi] = rtk::warp_max(mx[gi]);
    if (lane == 0) sm_red[warp][gi] = mx[gi];
  }
  __syncthreads();
#pragma unroll
  for (int gi = 0; gi < kG; ++gi) {
    mx[gi] = kNegInf;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) mx[gi] = fmaxf(mx[gi], sm_red[w][gi]);
  }
  __syncthreads();  // sm_red is reused for the sums

  // Phase 2: p = expf(s - max) against the block's max, as the plain
  // version takes it against the row's; l += p; acc += T(p) . V.
  float acc[kG][kE], l_run[kG];
#pragma unroll
  for (int gi = 0; gi < kG; ++gi) {
#pragma unroll
    for (int e = 0; e < kE; ++e) acc[gi][e] = 0.0f;
    l_run[gi] = 0.0f;
  }
  for (int w0 = lo + warp * rows; w0 < hi; w0 += kPasses * stride) {
    Vec vp[kPasses];
    float vsc[kPasses];
#pragma unroll
    for (int u = 0; u < kPasses; ++u) {
      const int r = w0 + u * stride + grp;
      vp[u] = zero_piece<CT>();
      vsc[u] = 0.0f;
      if (r < hi && act) {
        const size_t row =
            kPaged ? (size_t)sm_row[r - s0] : rtk::kv_row<false>(pt, bh, hk, m, nb, ps, r);
        vp[u] = *reinterpret_cast<const Vec*>(v + row * d + pc * kE);
        if constexpr (kQuant) vsc[u] = vs[row];
      }
    }
#pragma unroll
    for (int u = 0; u < kPasses; ++u) {
      const int r = w0 + u * stride + grp;
      if (r >= hi) continue;
      float vf[kE];
      unpack<T, CT>(vp[u], vsc[u], vf);
#pragma unroll
      for (int gi = 0; gi < kG; ++gi) {
        const float pu = expf(sm_s[gi * split + (r - s0)] - mx[gi]);
        l_run[gi] += pu;
        const float pr = rtk::round_to<T>(pu);  // P in V's dtype before P.V
#pragma unroll
        for (int e = 0; e < kE; ++e) acc[gi][e] += pr * vf[e];
      }
    }
  }

  // Sum the warp's groups (lanes x and x ^ o hold the same sums after each
  // step: a + b == b + a), then the warps in order 0..3.
  for (int o = lanes; o < 32; o <<= 1) {
#pragma unroll
    for (int gi = 0; gi < kG; ++gi) {
      l_run[gi] += __shfl_xor_sync(0xffffffffu, l_run[gi], o);
#pragma unroll
      for (int e = 0; e < kE; ++e) acc[gi][e] += __shfl_xor_sync(0xffffffffu, acc[gi][e], o);
    }
  }
  if (grp == 0 && act) {
#pragma unroll
    for (int gi = 0; gi < kG; ++gi) {
#pragma unroll
      for (int e = 0; e < kE; ++e) sm_acc[warp][gi][pc * kE + e] = acc[gi][e];
      if (lane == 0) sm_red[warp][gi] = l_run[gi];
    }
  }
  __syncthreads();

  // out[bh, z*kG + gi, e] = T(acc / max(l, 1e-30))
  auto finish = [&](int gi, int e, float ll, float aa) {
    out[((size_t)bh * g + z * kG + gi) * d + e] = rtk::Num<T>::from_f(aa / fmaxf(ll, 1e-30f));
  };
  const size_t head0 = (size_t)bh * g + z * kG;  // first query head of (bh, z)
  float* part_acc = part;
  float* part_ml = part + (size_t)gridDim.x * g * nsplit * d;
  for (int i = threadIdx.x; i < kG * d; i += kThreads) {
    const int gi = i / d, e = i - gi * d;
    float ll = 0.0f, aa = 0.0f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      ll += sm_red[w][gi];
      aa += sm_acc[w][gi][e];
    }
    if (nsplit == 1) {
      finish(gi, e, ll, aa);
    } else {
      const size_t h = (head0 + gi) * nsplit + sp;
      part_acc[h * d + e] = aa;
      if (e == 0) {
        part_ml[2 * h] = mx[gi];
        part_ml[2 * h + 1] = ll;
      }
    }
  }
  if (nsplit == 1) return;

  // The last block of (bh, z) to arrive merges the splits in split order.
  __threadfence();
  __syncthreads();
  int* ticket = tickets + (size_t)bh * gridDim.z + z;
  if (threadIdx.x == 0) sm_last = atomicAdd(ticket, 1) == nsplit - 1;
  __syncthreads();
  if (!sm_last) return;
  if (threadIdx.x == 0) *ticket = 0;  // ready for the next call
  __threadfence();
  for (int i = threadIdx.x; i < kG * d; i += kThreads) {
    const int gi = i / d, e = i - gi * d;
    const size_t h0 = (head0 + gi) * nsplit;
    float mm = kNegInf;
    for (int j = 0; j < nsplit; ++j) mm = fmaxf(mm, __ldcg(part_ml + 2 * (h0 + j)));
    float ll = 0.0f, aa = 0.0f;
    for (int j = 0; j < nsplit; ++j) {
      const float a = expf(__ldcg(part_ml + 2 * (h0 + j)) - mm);
      ll += __ldcg(part_ml + 2 * (h0 + j) + 1) * a;
      aa += __ldcg(part_acc + (h0 + j) * d + e) * a;
    }
    finish(gi, e, ll, aa);
  }
}

template <typename T, typename CT, bool kPaged, int kG>
int launch_g(const void* q, const void* k, const void* v, const void* ks, const void* vs,
             const void* pos, const void* pt, void* out, void* part, void* tickets, int bhk,
             int hk, int g, int m, int d, int nb, int ps, int window, float softcap, float scale,
             int split, cudaStream_t stream) {
  const dim3 grid(bhk, (m + split - 1) / split, g / kG);
  const size_t smem = (size_t)kG * split * sizeof(float) + (kPaged ? split * sizeof(int) : 0);
  const cudaError_t err = rtk::allow_smem(decode_attention_kernel<T, CT, kPaged, kG>, smem);
  if (err != cudaSuccess) return (int)err;
  decode_attention_kernel<T, CT, kPaged, kG><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const CT*>(k), static_cast<const CT*>(v),
      static_cast<const float*>(ks), static_cast<const float*>(vs),
      static_cast<const int*>(pos), static_cast<const int*>(pt), static_cast<T*>(out),
      static_cast<float*>(part), static_cast<int*>(tickets), hk, g, m, d, nb, ps, window,
      softcap, scale, split);
  return (int)cudaGetLastError();
}

template <typename T, typename CT, bool kPaged>
int launch(const void* q, const void* k, const void* v, const void* ks, const void* vs,
           const void* pos, const void* pt, void* out, void* part, void* tickets, int bhk,
           int hk, int g, int m, int d, int nb, int ps, int window, float softcap, float scale,
           int split, cudaStream_t stream) {
  if (bhk == 0 || m == 0) return 0;
  if (d % 16 || d > kMaxD || split <= 0) return (int)cudaErrorInvalidValue;
#define TM_DA_G(KG)                                                                           \
  return launch_g<T, CT, kPaged, KG>(q, k, v, ks, vs, pos, pt, out, part, tickets, bhk, hk, g, \
                                     m, d, nb, ps, window, softcap, scale, split, stream);
  if (g % 4 == 0) TM_DA_G(4)
  if (g % 2 == 0) TM_DA_G(2)
  TM_DA_G(1)
#undef TM_DA_G
}

}  // namespace

// part: f32 scratch of B*HK*G*splits*(D + 2) floats and tickets: B*H int32
// zeros (reset by the kernel after use), splits = ceil(M / split); both
// unused (may be null) when split >= M.
extern "C" int tm_decode_attention(const void* q, const void* k, const void* v,
                                   const void* pos, void* out, void* part, void* tickets,
                                   int bhk, int hk, int g, int m, int d, int window,
                                   float softcap, float scale, int split, int dtype,
                                   void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == rtk::kBF16)
    return launch<__nv_bfloat16, __nv_bfloat16, false>(q, k, v, nullptr, nullptr, pos,
                                                       nullptr, out, part, tickets, bhk, hk, g,
                                                       m, d, 0, 0, window, softcap, scale,
                                                       split, s);
  if (dtype == rtk::kF32)
    return launch<float, float, false>(q, k, v, nullptr, nullptr, pos, nullptr, out, part,
                                       tickets, bhk, hk, g, m, d, 0, 0, window, softcap, scale,
                                       split, s);
  return (int)cudaErrorInvalidValue;
}

// The int8-cache variant: k, v int8 [B*HK, M, D], ks, vs f32 [B*HK, M].
extern "C" int tm_decode_attention_quant(const void* q, const void* k, const void* v,
                                         const void* ks, const void* vs, const void* pos,
                                         void* out, void* part, void* tickets, int bhk, int hk,
                                         int g, int m, int d, int window, float softcap,
                                         float scale, int split, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == rtk::kBF16)
    return launch<__nv_bfloat16, int8_t, false>(q, k, v, ks, vs, pos, nullptr, out, part,
                                                tickets, bhk, hk, g, m, d, 0, 0, window, softcap,
                                                scale, split, s);
  if (dtype == rtk::kF32)
    return launch<float, int8_t, false>(q, k, v, ks, vs, pos, nullptr, out, part, tickets, bhk,
                                        hk, g, m, d, 0, 0, window, softcap, scale, split, s);
  return (int)cudaErrorInvalidValue;
}

// The paged variants: k, v pools [P*HK, ps, D] of T (quant = 0) or int8 with
// f32 scale pools ks, vs [P*HK, ps] (quant = 1), read through pt [B, NB]
// int32; the logical cache holds nb * ps rows.
extern "C" int tm_decode_attention_paged(const void* q, const void* k, const void* v,
                                         const void* ks, const void* vs, const void* pt,
                                         const void* pos, void* out, void* part, void* tickets,
                                         int bhk, int hk, int g, int nb, int ps, int d,
                                         int window, float softcap, float scale, int split,
                                         int quant, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int m = nb * ps;
  using bf16 = __nv_bfloat16;
  if (dtype == rtk::kBF16 && quant)
    return launch<bf16, int8_t, true>(q, k, v, ks, vs, pos, pt, out, part, tickets, bhk, hk, g,
                                      m, d, nb, ps, window, softcap, scale, split, s);
  if (dtype == rtk::kBF16)
    return launch<bf16, bf16, true>(q, k, v, nullptr, nullptr, pos, pt, out, part, tickets, bhk,
                                    hk, g, m, d, nb, ps, window, softcap, scale, split, s);
  if (dtype == rtk::kF32 && quant)
    return launch<float, int8_t, true>(q, k, v, ks, vs, pos, pt, out, part, tickets, bhk, hk, g,
                                       m, d, nb, ps, window, softcap, scale, split, s);
  if (dtype == rtk::kF32)
    return launch<float, float, true>(q, k, v, nullptr, nullptr, pos, pt, out, part, tickets,
                                      bhk, hk, g, m, d, nb, ps, window, softcap, scale, split, s);
  return (int)cudaErrorInvalidValue;
}
