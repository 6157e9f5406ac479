// Table-lookup (TL) ternary matmul, the paper's Algorithm 1 (G = 3): the
// decode GEMV, the tiled matmul for any number of rows (int8 rows or the
// prologue's precomputed tables in, optional residual), and the fused
// SwiGLU.
//
// Replaces: repro/kernels/tl_gemv/kernel.py::tl_gemv_kernel (kernel.py:91,
// pallas_call :110), ::tl_matmul_kernel (kernel.py:141, pallas_call :198)
// and ::tl_swiglu_kernel (kernel.py:216, pallas_call :255).
//
// Computes, for group indices w_idx [T, K] uint8 (T = ceil(N/3), values in
// [0, 27), built offline from the planar pack2 weights by
// core/tl_matmul.py::tl_indices) and tables tab[m, t, c] of the int8 row
// (built here from x, or read from the prologue's f32 [M, T*27]):
//   acc[m, k] = sum_t tab[m, t, w_idx[t, k]]        (int32, exact)
// then the packed kernels' own epilogues (ternary_tiles.cuh): DequantEpi
// for a projection, SwigluEpi and requant_kernel for the SwiGLU. Table
// entries are exact integers (|entry| <= 381), so the f32 tables convert
// to int without loss and acc equals the packed kernels' __dp4a sum; with
// the same epilogue code the TL output is bit-equal to ternary_gemv /
// ternary_matmul / ternary_swiglu by construction.
//
// Bound on the H100. At decode (M <= 16) the index stream, T*K bytes (a
// quarter of JAX's int32 indices, 1.33x the pack2 bytes), is nearly all
// the traffic: bytes. At prefill the M*T*K lookup-adds bound it, counted
// at the f32 peak; in practice each lookup is one shared-memory load and
// one integer add, so the shared-memory load rate (one warp-wide load per
// SM per clock) sets the pace, far below that peak.
//
// Design. The TPU kernels hold all of x and all tables in VMEM; a Hopper
// block cannot (the tables of 4 rows at N = 1536 are 221 KB), so a block
// owns a tile of output columns and BM rows and walks the group axis in
// chunks of TC groups: per chunk it stages the rows' tables in shared
// memory (built from the int8 rows, or converted from the prologue's f32,
// read with 16-byte loads issued seven at a time) and the chunk's indices
// [TC][BK] bytes, then every lane looks up its columns. A table word holds
// the entry of two rows, each biased to a non-negative 16-bit lane, so one
// shared-memory load and one 32-bit add serve two rows (the lookup loop is
// bound by those loads); the lanes are unpacked and unbiased into int32 sums
// after each chunk, before a lane could carry. The pair words of a chunk,
// [BM/2][TC][27], take 27,648 B. A warp's 32 lanes read one (row pair,
// group)'s 27 consecutive words, which lie in distinct banks, so the
// lookups are free of bank conflicts. Decode (M <= 16): 32 columns a block,
// so that K = 1536 spreads over 48 blocks, one column a lane, the 8 warps
// on interleaved groups, summed through shared memory at the end. Prefill:
// 32 rows and 128 columns a block, four columns a lane, each warp 4 rows,
// so that the tables staged per chunk serve 128 columns. Columns past K
// look up index 13, the zero group.

#include "../../ternary_matmul/csrc/ternary_tiles.cuh"

namespace {

using rtk::kTlCombos;
constexpr int kThreads = 256, kWarps = kThreads / 32;
// A table word holds one entry of two rows, each biased by kBias to [0, 762]
// in a 16-bit lane: a 32-bit add of two words then adds the lanes without a
// carry from one into the other while a lane's sum stays below 2^16, that
// is for up to 86 groups; the sums are unpacked and unbiased after each chunk.
constexpr int kBias = 127 * rtk::kTlGroup;  // the largest |entry|
constexpr int kMaxLaneGroups = 65535 / (2 * kBias);
constexpr int kTableWords = 256 * kTlCombos;  // row pairs * TC = 256 in every config

template <int BM, int CW, int WR>
struct TlConfig {
  static constexpr int kWR = WR;                 // warps along rows
  static constexpr int kWT = kWarps / WR;        // warps along groups
  static constexpr int kRPW = BM / WR;           // rows per warp
  static constexpr int kPPW = kRPW / 2;          // row pairs per warp
  static constexpr int kCW = CW;                 // columns per lane
  static constexpr int kBK = 32 * CW;            // columns per block
  static constexpr int kTC = 2 * kTableWords / (BM * kTlCombos);  // groups per chunk
  static constexpr int kBM = BM;
  static_assert(kRPW % 2 == 0, "a warp owns whole row pairs");
  static_assert((kTC + kWT - 1) / kWT <= kMaxLaneGroups, "a 16-bit lane could carry");
  static_assert(kTC % 4 == 0, "a chunk of tables must be whole float4s");
};

// The table area, then the chunk's indices; the cross-warp sums reuse the
// table area, which is sized for them.
template <int NW, class Cfg>
__host__ __device__ constexpr int tl_table_bytes() {
  constexpr int tab = kTableWords * 4;
  constexpr int red = Cfg::kWT == 1 ? 0 : Cfg::kWT * NW * Cfg::kBM * Cfg::kBK * 4;
  return tab > red ? tab : red;
}

template <int NW, class Cfg>
constexpr size_t tl_smem() {
  return (size_t)tl_table_bytes<NW, Cfg>() + (size_t)NW * Cfg::kTC * Cfg::kBK;
}

__device__ __forceinline__ unsigned pair_word(int e0, int e1) {
  return (unsigned)(e0 + kBias) | ((unsigned)(e1 + kBias) << 16);
}

// Stage a chunk of the prologue's tables, rows 2p and 2p+1 of [BM][TC*27]
// f32, as pair words [BM/2][TC*27], with 16-byte loads, a batch of kBatch
// positions (two loads each) in flight per thread before their stores (a
// row's chunk starts on a 16-byte boundary: groups * 27 % 4 == 0 and TC %
// 4 == 0, so a float4 never straddles the chunk's end).
template <class Cfg>
__device__ __forceinline__ void stage_tables_vec(const float* __restrict__ tables,
                                                 size_t trow, int m, int m0, int t0, int tc,
                                                 unsigned* tab) {
  constexpr int kRowQuads = Cfg::kTC * kTlCombos / 4;
  constexpr int kQuads = Cfg::kBM / 2 * kRowQuads;
  constexpr int kBatch = 7;
  const int len = tc * kTlCombos / 4;
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int q0 = 0; q0 < kQuads; q0 += kBatch * kThreads) {
    float4 v0[kBatch], v1[kBatch];
#pragma unroll
    for (int i = 0; i < kBatch; ++i) {
      const int e = q0 + i * kThreads + threadIdx.x;
      const int p = e / kRowQuads, j = e - p * kRowQuads;
      const int row = m0 + 2 * p;
      const float* src = tables + row * trow + (size_t)t0 * kTlCombos + 4 * j;
      const bool in = e < kQuads && j < len;
      v0[i] = in && row < m ? *reinterpret_cast<const float4*>(src) : zero;
      v1[i] = in && row + 1 < m ? *reinterpret_cast<const float4*>(src + trow) : zero;
    }
#pragma unroll
    for (int i = 0; i < kBatch; ++i) {
      const int e = q0 + i * kThreads + threadIdx.x;
      if (e < kQuads)
        *reinterpret_cast<uint4*>(tab + 4 * e) = make_uint4(
            pair_word(__float2int_rn(v0[i].x), __float2int_rn(v1[i].x)),
            pair_word(__float2int_rn(v0[i].y), __float2int_rn(v1[i].y)),
            pair_word(__float2int_rn(v0[i].z), __float2int_rn(v1[i].z)),
            pair_word(__float2int_rn(v0[i].w), __float2int_rn(v1[i].w)));
    }
  }
}

template <int NW, class Cfg, class Epi>
__global__ void __launch_bounds__(kThreads)
    tl_kernel(const int8_t* __restrict__ x, const float* __restrict__ tables, int m, int n,
              int groups, int k, const uint8_t* __restrict__ w0,
              const uint8_t* __restrict__ w1, int vec, int tvec, Epi epi) {
  constexpr int BM = Cfg::kBM, TC = Cfg::kTC, BK = Cfg::kBK, CW = Cfg::kCW;
  constexpr int WR = Cfg::kWR, WT = Cfg::kWT, RPW = Cfg::kRPW, PPW = Cfg::kPPW;
  constexpr int kPairWords = TC * kTlCombos;  // words per row pair
  extern __shared__ int smem[];
  unsigned* tab = reinterpret_cast<unsigned*>(smem);  // [BM/2][TC][27] pair words
  uint8_t* idx_s = reinterpret_cast<uint8_t*>(smem) + tl_table_bytes<NW, Cfg>();  // [NW][TC][BK]
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wr = warp % WR, wt = warp / WR;
  const int m0 = blockIdx.y * BM, k0 = blockIdx.x * BK;
  const uint8_t* w[2] = {w0, w1};
  const size_t trow = (size_t)groups * kTlCombos;  // table floats per row

  int acc[NW][RPW][CW];
#pragma unroll
  for (int a = 0; a < NW; ++a)
#pragma unroll
    for (int r = 0; r < RPW; ++r)
#pragma unroll
      for (int c = 0; c < CW; ++c) acc[a][r][c] = 0;

  for (int t0 = 0; t0 < groups; t0 += TC) {
    const int tc = min(TC, groups - t0);
    __syncthreads();  // the previous chunk's lookups are done
    if (tables != nullptr && tvec) {
      stage_tables_vec<Cfg>(tables, trow, m, m0, t0, tc, tab);
    } else if (tables != nullptr) {
      const int len = tc * kTlCombos;
      for (int e = threadIdx.x; e < BM / 2 * kPairWords; e += kThreads) {
        const int p = e / kPairWords, j = e - p * kPairWords;
        const int row = m0 + 2 * p;
        const float* src = tables + row * trow + (size_t)t0 * kTlCombos + j;
        const bool in = j < len;
        tab[e] = pair_word(in && row < m ? __float2int_rn(src[0]) : 0,
                           in && row + 1 < m ? __float2int_rn(src[trow]) : 0);
      }
    } else {
      for (int e = threadIdx.x; e < BM / 2 * TC; e += kThreads) {
        const int p = e / TC, tt = e - p * TC;
        const int row = m0 + 2 * p;
        int a0[rtk::kTlGroup] = {0, 0, 0}, a1[rtk::kTlGroup] = {0, 0, 0};
        if (tt < tc) {
          if (row < m) rtk::tl_group(x + (size_t)row * n, n, t0 + tt, a0);
          if (row + 1 < m) rtk::tl_group(x + (size_t)(row + 1) * n, n, t0 + tt, a1);
        }
        unsigned* dst = tab + e * kTlCombos;  // stride 27 (odd): no bank conflicts
#pragma unroll
        for (int c = 0; c < kTlCombos; ++c)
          dst[c] = pair_word(rtk::tl_entry(a0[0], a0[1], a0[2], c),
                             rtk::tl_entry(a1[0], a1[1], a1[2], c));
      }
    }
#pragma unroll
    for (int a = 0; a < NW; ++a) {
      uint8_t* ia = idx_s + a * TC * BK;
      if (vec) {  // k % 4 == 0 and w 4-byte aligned: a word is all in or all past K
        for (int e = threadIdx.x; e < TC * BK / 4; e += kThreads) {
          const int tt = e / (BK / 4), col = (e - tt * (BK / 4)) * 4;
          unsigned v = 0x0D0D0D0Du;  // four zero groups
          if (tt < tc && k0 + col < k)
            v = *reinterpret_cast<const unsigned*>(w[a] + (size_t)(t0 + tt) * k + k0 + col);
          *reinterpret_cast<unsigned*>(ia + tt * BK + col) = v;
        }
      } else {
        for (int e = threadIdx.x; e < TC * BK; e += kThreads) {
          const int tt = e / BK, col = e - tt * BK;
          ia[e] = (tt < tc && k0 + col < k) ? w[a][(size_t)(t0 + tt) * k + k0 + col]
                                            : (uint8_t)rtk::kTlZeroGroup;
        }
      }
    }
    __syncthreads();

    // two rows per load: biased 16-bit lanes summed in one 32-bit add
    unsigned pacc[NW][PPW][CW];
#pragma unroll
    for (int a = 0; a < NW; ++a)
#pragma unroll
      for (int p = 0; p < PPW; ++p)
#pragma unroll
        for (int c = 0; c < CW; ++c) pacc[a][p][c] = 0u;
#pragma unroll 4
    for (int tt = wt; tt < tc; tt += WT) {
      const unsigned* tr = tab + ((wr * PPW) * TC + tt) * kTlCombos;
#pragma unroll
      for (int a = 0; a < NW; ++a) {
        int id[CW];
        const uint8_t* ir = idx_s + (a * TC + tt) * BK + lane * CW;
        if constexpr (CW == 4) {
          const unsigned v = *reinterpret_cast<const unsigned*>(ir);
#pragma unroll
          for (int c = 0; c < 4; ++c) id[c] = (v >> (8 * c)) & 0xFF;
        } else {
#pragma unroll
          for (int c = 0; c < CW; ++c) id[c] = ir[c];
        }
#pragma unroll
        for (int p = 0; p < PPW; ++p)
#pragma unroll
          for (int c = 0; c < CW; ++c) pacc[a][p][c] += tr[p * kPairWords + id[c]];
      }
    }
    const int bias = kBias * (tc > wt ? (tc - wt + WT - 1) / WT : 0);  // groups this warp took
#pragma unroll
    for (int a = 0; a < NW; ++a)
#pragma unroll
      for (int p = 0; p < PPW; ++p)
#pragma unroll
        for (int c = 0; c < CW; ++c) {
          acc[a][2 * p][c] += (int)(pacc[a][p][c] & 0xFFFFu) - bias;
          acc[a][2 * p + 1][c] += (int)(pacc[a][p][c] >> 16) - bias;
        }
  }

  if constexpr (WT == 1) {
#pragma unroll
    for (int r = 0; r < RPW; ++r)
#pragma unroll
      for (int c = 0; c < CW; ++c) {
        const int row = m0 + wr * RPW + r, col = k0 + lane * CW + c;
        if (row < m && col < k) {
          int sum[NW];
#pragma unroll
          for (int a = 0; a < NW; ++a) sum[a] = acc[a][r][c];
          epi(row, col, sum);
        }
      }
  } else {
    // WR == 1: every warp holds all BM rows for its share of the groups
    __syncthreads();  // the tables are no longer read; their space holds the sums
    int* red = smem;  // [WT][NW][BM][BK]
#pragma unroll
    for (int a = 0; a < NW; ++a)
#pragma unroll
      for (int r = 0; r < RPW; ++r)
#pragma unroll
        for (int c = 0; c < CW; ++c)
          red[((wt * NW + a) * BM + r) * BK + lane * CW + c] = acc[a][r][c];
    __syncthreads();
    for (int e = threadIdx.x; e < BM * BK; e += kThreads) {
      const int r = e / BK, col = e - r * BK;
      const int row = m0 + r, kk = k0 + col;
      if (row >= m || kk >= k) continue;
      int sum[NW];
#pragma unroll
      for (int a = 0; a < NW; ++a) {
        int s = 0;
#pragma unroll
        for (int wi = 0; wi < WT; ++wi) s += red[((wi * NW + a) * BM + r) * BK + col];
        sum[a] = s;
      }
      epi(row, kk, sum);
    }
  }
}

template <int NW, class Cfg, class Epi>
cudaError_t launch_cfg(const int8_t* x, const float* tables, int m, int n, int groups, int k,
                       const uint8_t* w0, const uint8_t* w1, Epi epi, cudaStream_t stream) {
  const size_t smem = tl_smem<NW, Cfg>();
  auto kernel = tl_kernel<NW, Cfg, Epi>;
  cudaError_t err = rtk::allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const int vec = (k % 4 == 0) && ((uintptr_t)w0 % 4 == 0) &&
                  (NW == 1 || (uintptr_t)w1 % 4 == 0);
  const int tvec = tables != nullptr && (groups * kTlCombos) % 4 == 0 &&
                   (uintptr_t)tables % 16 == 0;
  const dim3 grid((k + Cfg::kBK - 1) / Cfg::kBK, (m + Cfg::kBM - 1) / Cfg::kBM);
  kernel<<<grid, kThreads, smem, stream>>>(x, tables, m, n, groups, k, w0, w1, vec, tvec,
                                           epi);
  return cudaGetLastError();
}

// Decode configurations for m <= 16 (BM = 4, 8 or 16), the tiled one above.
template <int NW, class Epi>
cudaError_t launch_tl(const int8_t* x, const float* tables, int m, int n, int groups, int k,
                      const uint8_t* w0, const uint8_t* w1, Epi epi, cudaStream_t stream) {
  if (m == 0 || k == 0) return cudaSuccess;
  if (m <= 4) return launch_cfg<NW, TlConfig<4, 1, 1>>(x, tables, m, n, groups, k, w0, w1, epi, stream);
  if (m <= 8) return launch_cfg<NW, TlConfig<8, 1, 1>>(x, tables, m, n, groups, k, w0, w1, epi, stream);
  if (m <= 16)
    return launch_cfg<NW, TlConfig<16, 1, 1>>(x, tables, m, n, groups, k, w0, w1, epi, stream);
  return launch_cfg<NW, TlConfig<32, 4, 8>>(x, tables, m, n, groups, k, w0, w1, epi, stream);
}

template <typename T>
int matmul(const void* x, const void* tables, const void* xs, const void* w_idx,
           const void* ws, int ws_stride, const void* res, void* out, int m, int n,
           int groups, int k, cudaStream_t stream) {
  rtk::DequantEpi<T> epi{static_cast<const float*>(xs), static_cast<const float*>(ws),
                         static_cast<const T*>(res), static_cast<T*>(out), k, ws_stride};
  return (int)launch_tl<1>(static_cast<const int8_t*>(x), static_cast<const float*>(tables), m,
                           n, groups, k, static_cast<const uint8_t*>(w_idx), nullptr, epi,
                           stream);
}

template <typename T>
int swiglu(const void* x, const void* tables, const void* xs, const void* wg, const void* wgs,
           const void* wu, const void* wus, void* h, void* q, void* qs, int m, int n,
           int groups, int k, cudaStream_t stream) {
  if (m == 0) return 0;
  rtk::SwigluEpi<T> epi{static_cast<const float*>(xs), static_cast<const float*>(wgs),
                        static_cast<const float*>(wus), static_cast<T*>(h), k};
  cudaError_t err = launch_tl<2>(static_cast<const int8_t*>(x),
                                 static_cast<const float*>(tables), m, n, groups, k,
                                 static_cast<const uint8_t*>(wg),
                                 static_cast<const uint8_t*>(wu), epi, stream);
  if (err != cudaSuccess) return (int)err;
  return (int)rtk::launch_requant<T>(static_cast<const T*>(h), static_cast<int8_t*>(q),
                                     static_cast<float*>(qs), m, k, stream);
}

}  // namespace

// x [m, n] int8 (tables built here), f32 out [m, k]; w_scale a scalar
// (ws_stride 0) or [k] (1). Decode rows only (m <= 16).
extern "C" int tm_tl_gemv(const void* x, const void* xs, const void* w_idx, const void* ws,
                          int ws_stride, void* out, int m, int n, int groups, int k,
                          void* stream) {
  if (m > 16) return (int)cudaErrorInvalidValue;
  return matmul<float>(x, nullptr, xs, w_idx, ws, ws_stride, nullptr, out, m, n, groups, k,
                       static_cast<cudaStream_t>(stream));
}

// x [m, n] int8, or tables [m, groups*27] f32 (x then unused; either may be
// null, not both), out [m, k] in dtype, residual [m, k] in dtype or null.
extern "C" int tm_tl_matmul(const void* x, const void* tables, const void* xs,
                            const void* w_idx, const void* ws, int ws_stride, const void* res,
                            void* out, int m, int n, int groups, int k, int dtype,
                            void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == rtk::kBF16)
    return matmul<__nv_bfloat16>(x, tables, xs, w_idx, ws, ws_stride, res, out, m, n, groups,
                                 k, s);
  if (dtype == rtk::kF32)
    return matmul<float>(x, tables, xs, w_idx, ws, ws_stride, res, out, m, n, groups, k, s);
  return (int)cudaErrorInvalidValue;
}

// Gate and up from one table set; h [m, k] is the pass-1 scratch in dtype.
extern "C" int tm_tl_swiglu(const void* x, const void* tables, const void* xs, const void* wg,
                            const void* wgs, const void* wu, const void* wus, void* h,
                            void* q, void* qs, int m, int n, int groups, int k, int dtype,
                            void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == rtk::kBF16)
    return swiglu<__nv_bfloat16>(x, tables, xs, wg, wgs, wu, wus, h, q, qs, m, n, groups, k,
                                 s);
  if (dtype == rtk::kF32)
    return swiglu<float>(x, tables, xs, wg, wgs, wu, wus, h, q, qs, m, n, groups, k, s);
  return (int)cudaErrorInvalidValue;
}
