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
// to int without loss and acc equals the packed kernels' sum; with the same
// epilogue code the TL output is bit-equal to ternary_gemv / ternary_matmul
// / ternary_swiglu by construction.
//
// Bound on the H100. At decode (M <= 16) the index stream, T*K bytes (a
// quarter of JAX's int32 indices, 1.33x the pack2 bytes), is nearly all
// the traffic: bytes. At prefill the M*T*K lookup-adds bound it, counted
// at the f32 peak; in practice each lookup is one shared-memory load and
// one integer add, so the shared-memory load rate (one warp-wide 32-bit
// load per SM per clock, ~27 us at [512, 1536] x [512, 1536]) sets the
// pace, far below that peak.
//
// Design. The TPU kernels hold all of x and all tables in VMEM; a Hopper
// block cannot (the tables of 4 rows at N = 1536 are 221 KB). A block owns
// BM rows and BK output columns, and a share of the group axis: the blocks
// of one output tile form a thread-block cluster of up to 8 (the portable
// size) that splits the groups, so that enough blocks run (q/k/v at
// decode: 24 column tiles x 8) and each stages only its share of the
// tables and indices. A block walks its share in chunks of TC groups
// through two buffers: while the warps look up chunk c, the chunk c + 1
// indices are in flight by cp.async (16 bytes where K and the pointer
// allow) and its tables by loads held in registers (16-byte loads of the
// prologue's f32, or the int8 rows' three codes a group), stored once the
// lookups are done; one barrier a chunk. From int8 a thread builds a (row
// pair, group)'s 27 words from 13: the word is linear in the three codes
// (below) and entry 26 - c is -entry c. A table word holds the entry of two
// rows, each biased to a non-negative 16-bit lane, so one shared-memory
// load and one 32-bit add serve two rows (the lookup loop is bound by those
// loads); the lanes are unpacked and unbiased into int32 sums after each
// chunk, before a lane could carry. A warp's 32 lanes read one (row pair,
// group)'s 27 consecutive words, which lie in distinct banks, so the
// lookups are free of bank conflicts. Each block of a cluster owns a slice
// of the tile's rows: every block stores its int32 sums of a row into the
// owner's shared memory (distributed shared memory, 16-byte stores at
// prefill; integer sums are exact in any order), and after one cluster
// barrier each owner adds them and runs its rows' epilogue. The tile
// shapes (TlDecode, TlPrefill below) were chosen by timing on the H100:
// 512 columns a prefill block, so that the prologue's f32 tables are read
// from L2 K/512 times (one weight: a warp's 16 lookups a group share one
// index word).

#include <cooperative_groups.h>

#include <algorithm>
#include <type_traits>

#include "../../ternary_matmul/csrc/ternary_tiles.cuh"

namespace {

using rtk::kTlCombos;
constexpr int kThreads = 256, kWarps = kThreads / 32;
constexpr int kMaxSplit = 8;  // blocks of a cluster (the portable size)
// A table word holds one entry of two rows, each biased by kBias to [0, 762]
// in a 16-bit lane: a 32-bit add of two words then adds the lanes without a
// carry from one into the other while a lane's sum stays below 2^16, that
// is for up to 86 groups; the sums are unpacked and unbiased after each chunk.
constexpr int kBias = 127 * rtk::kTlGroup;  // the largest |entry|
constexpr int kMaxLaneGroups = 65535 / (2 * kBias);
constexpr unsigned kBiasWord = (unsigned)kBias | ((unsigned)kBias << 16);

// BM rows, CW columns a lane, WR warps along rows, WC along columns (the
// rest along groups), TC groups a chunk, MB blocks an SM asked of ptxas.
template <int BM, int CW, int WR, int WC, int TC, int MB>
struct TlConfig {
  static constexpr int kBM = BM, kCW = CW, kWR = WR, kWC = WC, kTC = TC, kMinBlocks = MB;
  static constexpr int kWT = kWarps / (WR * WC);                 // warps along groups
  static constexpr int kRPW = BM / WR, kPPW = kRPW / 2;          // rows, row pairs a warp
  static constexpr int kBK = 32 * CW * WC;                       // columns a block
  static constexpr int kPairWords = TC * kTlCombos;              // words of a row pair a chunk
  static constexpr int kTabWords = BM / 2 * kPairWords;          // one table buffer
  static constexpr int kRowQuads = kPairWords / 4;
  static constexpr int kQuads = kTabWords / 4;                   // f32: float4 pairs a chunk
  static constexpr int kBatch = (kQuads + kThreads - 1) / kThreads;
  static constexpr int kItems = BM / 2 * TC;                     // int8: (pair, group) items
  static constexpr int kItemsPer = (kItems + kThreads - 1) / kThreads;
  static constexpr int kOutPer = kWT == 1 ? kRPW * CW : (BM * kBK + kThreads - 1) / kThreads;
  static_assert(WR * WC * kWT == kWarps, "the warps tile rows x columns x groups");
  static_assert(kWT == 1 || WR == 1, "warps on groups hold every row");
  static_assert(kRPW % 2 == 0, "a warp owns whole row pairs");
  static_assert((TC + kWT - 1) / kWT <= kMaxLaneGroups, "a 16-bit lane could carry");
  static_assert(TC % 4 == 0, "a chunk of tables must be whole float4s");
};

template <int NW, class Cfg>
struct TlSmem {
  static constexpr size_t kTables = 2 * (size_t)Cfg::kTabWords * 4;       // [2][BM/2][TC][27]
  // the warps' partial sums [WT][NW][BM][BK] reuse the table area after the walk
  static constexpr size_t kPartials =
      Cfg::kWT == 1 ? 0 : (size_t)Cfg::kWT * NW * Cfg::kBM * Cfg::kBK * 4;
  static constexpr size_t kArea = kTables > kPartials ? kTables : kPartials;
  static constexpr size_t kIdx = 2 * (size_t)NW * Cfg::kTC * Cfg::kBK;    // [2][NW][TC][BK]
  // split > 1: the rows this block owns, as every block of the cluster
  // sends them, [split][rows_per][NW][BK] int32 (split * rows_per < BM +
  // split rows: kMax bounds every split)
  static size_t bytes(int split) {
    const int rows_per = (Cfg::kBM + split - 1) / split;
    return kArea + kIdx + (split > 1 ? (size_t)split * rows_per * NW * Cfg::kBK * 4 : 0);
  }
  static constexpr size_t kMax =
      kArea + kIdx + (size_t)(Cfg::kBM + kMaxSplit - 1) * NW * Cfg::kBK * 4;
};

__device__ __forceinline__ unsigned pair_word(int e0, int e1) {
  return (unsigned)(e0 + kBias) | ((unsigned)(e1 + kBias) << 16);
}

template <int NW, bool kTab, class Cfg, class Epi>
__global__ void __launch_bounds__(kThreads, Cfg::kMinBlocks)
    tl_kernel(const int8_t* __restrict__ x, const float* __restrict__ tables, int m, int n,
              int groups, int k, const uint8_t* __restrict__ w0,
              const uint8_t* __restrict__ w1, int share, int ivec, int tvec, Epi epi) {
  namespace cg = cooperative_groups;
  constexpr int BM = Cfg::kBM, TC = Cfg::kTC, BK = Cfg::kBK, CW = Cfg::kCW;
  constexpr int WR = Cfg::kWR, WC = Cfg::kWC, WT = Cfg::kWT, RPW = Cfg::kRPW;
  constexpr int PPW = Cfg::kPPW, kPairWords = Cfg::kPairWords, kTabWords = Cfg::kTabWords;
  constexpr int kOut = Cfg::kOutPer;
  extern __shared__ __align__(16) int smem[];
  unsigned* tab = reinterpret_cast<unsigned*>(smem);                     // [2][kTabWords]
  uint8_t* idx_s = reinterpret_cast<uint8_t*>(smem) + TlSmem<NW, Cfg>::kArea;  // [2][NW][TC][BK]
  int* recv = reinterpret_cast<int*>(idx_s + TlSmem<NW, Cfg>::kIdx);  // split > 1
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wr = warp % WR, wc = (warp / WR) % WC, wt = warp / (WR * WC);
  const int rank = blockIdx.x, split = gridDim.x;
  const int k0 = blockIdx.y * BK, m0 = blockIdx.z * BM;
  const int gbeg = rank * share, gend = min(groups, gbeg + share);
  const int nchunks = gend > gbeg ? (gend - gbeg + TC - 1) / TC : 0;
  const size_t trow = (size_t)groups * kTlCombos;  // table floats a row
  const uint8_t* w[2] = {w0, w1};

  // split > 1: block r owns tile rows [r rows_per, (r + 1) rows_per): it
  // receives every block's sums of them and runs their epilogue
  const int rows_per = (BM + split - 1) / split;
  const int own0 = rank * rows_per, own1 = min(BM, own0 + rows_per);
  if (split > 1) rtk::cluster_arrive_relaxed();  // waited on before the first remote store
  if (WT > 1)  // decode: the epilogue's operands into L1 meanwhile
    for (int o = own0 * BK + tid; o < own1 * BK; o += kThreads)
      if (m0 + o / BK < m && k0 + o % BK < k) epi.prefetch(m0 + o / BK, k0 + o % BK);

  int acc[NW][RPW][CW];
#pragma unroll
  for (int a = 0; a < NW; ++a)
#pragma unroll
    for (int r = 0; r < RPW; ++r)
#pragma unroll
      for (int c = 0; c < CW; ++c) acc[a][r][c] = 0;

  // --- staging of chunk c: indices by cp.async, tables into registers ---
  float4 v0[Cfg::kBatch], v1[Cfg::kBatch];       // f32 tables, rows 2p and 2p + 1
  int xa[Cfg::kItemsPer][2 * rtk::kTlGroup];     // int8: the two rows' codes of a group
  auto chunk_start = [&](int c) { return gbeg + c * TC; };
  auto chunk_len = [&](int c) { return min(TC, gend - chunk_start(c)); };

  auto fetch = [&](int c) {
    const int t0 = chunk_start(c), tc = chunk_len(c);
    uint8_t* ib = idx_s + (c & 1) * NW * TC * BK;
#pragma unroll
    for (int a = 0; a < NW; ++a) {
      uint8_t* ia = ib + a * TC * BK;
      const uint8_t* wa = w[a];
      if (ivec == 16) {  // k % 16 == 0, 16-byte aligned: a chunk is all in or all past K
        for (int e = tid; e < TC * BK / 16; e += kThreads) {
          const int tt = e / (BK / 16), col = (e - tt * (BK / 16)) * 16;
          const bool ok = tt < tc && k0 + col < k;
          rtk::cp_async16(ia + tt * BK + col, ok ? wa + (size_t)(t0 + tt) * k + k0 + col : wa,
                          ok);
        }
      } else if (ivec == 4) {
        for (int e = tid; e < TC * BK / 4; e += kThreads) {
          const int tt = e / (BK / 4), col = (e - tt * (BK / 4)) * 4;
          const bool ok = tt < tc && k0 + col < k;
          rtk::cp_async4(ia + tt * BK + col, ok ? wa + (size_t)(t0 + tt) * k + k0 + col : wa,
                         ok);
        }
      } else {  // past the chunk or K: index 0, a valid entry whose sums are not kept
        for (int e = tid; e < TC * BK; e += kThreads) {
          const int tt = e / BK, col = e - tt * BK;
          ia[e] = (tt < tc && k0 + col < k) ? wa[(size_t)(t0 + tt) * k + k0 + col] : 0;
        }
      }
    }
    rtk::cp_async_commit();
    if (kTab && tvec) {  // a row's chunk starts on a 16-byte boundary
      const int len = tc * kTlCombos / 4;
      const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
      for (int i = 0; i < Cfg::kBatch; ++i) {
        const int e = i * kThreads + tid;
        const int p = e / Cfg::kRowQuads, j = e - p * Cfg::kRowQuads;
        const int row = m0 + 2 * p;
        const float* src = tables + row * trow + (size_t)t0 * kTlCombos + 4 * j;
        const bool in = e < Cfg::kQuads && j < len;
        v0[i] = in && row < m ? __ldg(reinterpret_cast<const float4*>(src)) : zero;
        v1[i] = in && row + 1 < m ? __ldg(reinterpret_cast<const float4*>(src + trow)) : zero;
      }
    } else if (!kTab) {
#pragma unroll
      for (int i = 0; i < Cfg::kItemsPer; ++i) {
        const int e = i * kThreads + tid;
        const int p = e / TC, tt = e - p * TC;
        const int row = m0 + 2 * p;
#pragma unroll
        for (int j = 0; j < 2 * rtk::kTlGroup; ++j) xa[i][j] = 0;
        if (e < Cfg::kItems && tt < tc) {
          if (row < m) rtk::tl_group(x + (size_t)row * n, n, t0 + tt, xa[i]);
          if (row + 1 < m) rtk::tl_group(x + (size_t)(row + 1) * n, n, t0 + tt, xa[i] + 3);
        }
      }
    }
  };

  auto store = [&](int c) {
    unsigned* tb = tab + (c & 1) * kTabWords;
    if (kTab && tvec) {
#pragma unroll
      for (int i = 0; i < Cfg::kBatch; ++i) {
        const int e = i * kThreads + tid;
        if (e < Cfg::kQuads)
          *reinterpret_cast<uint4*>(tb + 4 * e) = make_uint4(
              pair_word(__float2int_rn(v0[i].x), __float2int_rn(v1[i].x)),
              pair_word(__float2int_rn(v0[i].y), __float2int_rn(v1[i].y)),
              pair_word(__float2int_rn(v0[i].z), __float2int_rn(v1[i].z)),
              pair_word(__float2int_rn(v0[i].w), __float2int_rn(v1[i].w)));
      }
    } else if (kTab) {  // unaligned tables: float by float
      const int t0 = chunk_start(c), len = chunk_len(c) * kTlCombos;
      for (int e = tid; e < kTabWords; e += kThreads) {
        const int p = e / kPairWords, j = e - p * kPairWords;
        const int row = m0 + 2 * p;
        const float* src = tables + row * trow + (size_t)t0 * kTlCombos + j;
        const bool in = j < len;
        tb[e] = pair_word(in && row < m ? __float2int_rn(src[0]) : 0,
                          in && row + 1 < m ? __float2int_rn(src[trow]) : 0);
      }
    } else {
      // word(c) = kBiasWord + sum_i (digit_i(c) - 1) * A_i, A_i = a_i(row 0) +
      // 2^16 a_i(row 1), exact mod 2^32 since both lanes end in [0, 762];
      // word(26 - c) = 2 kBiasWord - word(c), word(13) = kBiasWord
#pragma unroll
      for (int i = 0; i < Cfg::kItemsPer; ++i) {
        const int e = i * kThreads + tid;
        if (e >= Cfg::kItems) continue;
        unsigned A[rtk::kTlGroup], wd[kTlCombos];
#pragma unroll
        for (int j = 0; j < rtk::kTlGroup; ++j)
          A[j] = (unsigned)xa[i][j] + ((unsigned)xa[i][j + 3] << 16);
#pragma unroll
        for (int cc = 0; cc < rtk::kTlZeroGroup; ++cc) {
          unsigned v = kBiasWord;
          const int d[3] = {cc % 3, (cc / 3) % 3, cc / 9};
#pragma unroll
          for (int j = 0; j < rtk::kTlGroup; ++j) {
            if (d[j] == 0) v -= A[j];
            if (d[j] == 2) v += A[j];
          }
          wd[cc] = v;
          wd[kTlCombos - 1 - cc] = 2u * kBiasWord - v;
        }
        wd[rtk::kTlZeroGroup] = kBiasWord;
        unsigned* dst = tb + e * kTlCombos;  // stride 27 (odd): no bank conflicts
#pragma unroll
        for (int cc = 0; cc < kTlCombos; ++cc) dst[cc] = wd[cc];
      }
    }
  };

  if (nchunks > 0) {
    fetch(0);
    store(0);
  }
  for (int c = 0; c < nchunks; ++c) {
    rtk::cp_async_wait<0>();
    __syncthreads();  // chunk c is staged; chunk c - 1's buffers are free
    if (c + 1 < nchunks) fetch(c + 1);
    const unsigned* tb = tab + (c & 1) * kTabWords;
    const uint8_t* ib = idx_s + (c & 1) * NW * TC * BK;
    const int tc = chunk_len(c);
    // two rows per load: biased 16-bit lanes summed in one 32-bit add
    unsigned pacc[NW][PPW][CW];
#pragma unroll
    for (int a = 0; a < NW; ++a)
#pragma unroll
      for (int p = 0; p < PPW; ++p)
#pragma unroll
        for (int cc = 0; cc < CW; ++cc) pacc[a][p][cc] = 0u;
#pragma unroll 4
    for (int tt = wt; tt < tc; tt += WT) {
      const unsigned* tr = tb + ((wr * PPW) * TC + tt) * kTlCombos;
#pragma unroll
      for (int a = 0; a < NW; ++a) {
        int id[CW];
        const uint8_t* ir = ib + (a * TC + tt) * BK + (wc * 32 + lane) * CW;
        if constexpr (CW == 8) {
          const uint2 v = *reinterpret_cast<const uint2*>(ir);
#pragma unroll
          for (int cc = 0; cc < 4; ++cc) {
            id[cc] = (v.x >> (8 * cc)) & 0xFF;
            id[cc + 4] = (v.y >> (8 * cc)) & 0xFF;
          }
        } else if constexpr (CW == 4) {
          const unsigned v = *reinterpret_cast<const unsigned*>(ir);
#pragma unroll
          for (int cc = 0; cc < 4; ++cc) id[cc] = (v >> (8 * cc)) & 0xFF;
        } else {
#pragma unroll
          for (int cc = 0; cc < CW; ++cc) id[cc] = ir[cc];
        }
#pragma unroll
        for (int p = 0; p < PPW; ++p)
#pragma unroll
          for (int cc = 0; cc < CW; ++cc) pacc[a][p][cc] += tr[p * kPairWords + id[cc]];
      }
    }
    const int bias = kBias * (tc > wt ? (tc - wt + WT - 1) / WT : 0);  // groups this warp took
#pragma unroll
    for (int a = 0; a < NW; ++a)
#pragma unroll
      for (int p = 0; p < PPW; ++p)
#pragma unroll
        for (int cc = 0; cc < CW; ++cc) {
          acc[a][2 * p][cc] += (int)(pacc[a][p][cc] & 0xFFFFu) - bias;
          acc[a][2 * p + 1][cc] += (int)(pacc[a][p][cc] >> 16) - bias;
        }
    if (c + 1 < nchunks) store(c + 1);
  }

  // --- this block's sums: out[a][i] at tile row orow(i), column ocol(i) ---
  int out[NW][kOut];
  auto orow = [&](int i) { return WT == 1 ? wr * RPW + i / CW : (i * kThreads + tid) / BK; };
  auto ocol = [&](int i) {
    return WT == 1 ? (wc * 32 + lane) * CW + i % CW : (i * kThreads + tid) % BK;
  };
  if constexpr (WT == 1) {
#pragma unroll
    for (int a = 0; a < NW; ++a)
#pragma unroll
      for (int i = 0; i < kOut; ++i) out[a][i] = acc[a][i / CW][i % CW];
  } else {  // WR == 1: every warp holds all BM rows for its share of the groups
    __syncthreads();  // the tables are no longer read; their space holds the partials
    int* part = smem;  // [WT][NW][BM][BK]
#pragma unroll
    for (int a = 0; a < NW; ++a)
#pragma unroll
      for (int r = 0; r < RPW; ++r)
#pragma unroll
        for (int cc = 0; cc < CW; ++cc)
          part[((wt * NW + a) * BM + r) * BK + (wc * 32 + lane) * CW + cc] = acc[a][r][cc];
    __syncthreads();
#pragma unroll
    for (int i = 0; i < kOut; ++i) {
      const int e = i * kThreads + tid;
#pragma unroll
      for (int a = 0; a < NW; ++a) {
        int s = 0;
        if (e < BM * BK)
#pragma unroll
          for (int wi = 0; wi < WT; ++wi) s += part[((wi * NW + a) * BM) * BK + e];
        out[a][i] = s;
      }
    }
  }

  if (split > 1) {
    // every block's sums of row r go to slot `rank` of r's owner
    rtk::cluster_wait();  // every block of the cluster has started
    cg::cluster_group cluster = cg::this_cluster();
    auto slot = [&](int row, int a) {
      const int owner = row / rows_per;
      return cluster.map_shared_rank(recv, owner) +
             ((rank * rows_per + row - owner * rows_per) * NW + a) * BK;
    };
    if constexpr (WT == 1 && CW % 4 == 0) {  // a lane's CW columns: 16-byte stores
#pragma unroll
      for (int a = 0; a < NW; ++a)
#pragma unroll
        for (int r = 0; r < RPW; ++r) {
          int* dst = slot(wr * RPW + r, a) + (wc * 32 + lane) * CW;
#pragma unroll
          for (int c4 = 0; c4 < CW; c4 += 4)
            *reinterpret_cast<int4*>(dst + c4) =
                make_int4(out[a][r * CW + c4], out[a][r * CW + c4 + 1],
                          out[a][r * CW + c4 + 2], out[a][r * CW + c4 + 3]);
        }
    } else {
#pragma unroll
      for (int i = 0; i < kOut; ++i)
        if (WT == 1 || i * kThreads + tid < BM * BK)
#pragma unroll
          for (int a = 0; a < NW; ++a) slot(orow(i), a)[ocol(i)] = out[a][i];
    }
    rtk::cluster_arrive();  // release: the stores before the owners' wait
    rtk::cluster_wait();
    for (int e = own0 * BK + tid; e < own1 * BK; e += kThreads) {
      const int row = e / BK, col = e - row * BK;
      if (m0 + row >= m || k0 + col >= k) continue;
      int sum[NW];
#pragma unroll
      for (int a = 0; a < NW; ++a) {
        int v = 0;
        for (int b = 0; b < split; ++b) v += recv[((b * rows_per + row - own0) * NW + a) * BK + col];
        sum[a] = v;
      }
      epi(m0 + row, k0 + col, sum);
    }
    return;
  }
#pragma unroll
  for (int i = 0; i < kOut; ++i)
    if ((WT == 1 || i * kThreads + tid < BM * BK) && m0 + orow(i) < m && k0 + ocol(i) < k) {
      int sum[NW];
#pragma unroll
      for (int a = 0; a < NW; ++a) sum[a] = out[a][i];
      epi(m0 + orow(i), k0 + ocol(i), sum);
    }
}

// The cluster size s <= 8 that splits the group axis, for `occ` blocks an
// SM. Decode rows are a chain of latencies: the largest split whose blocks
// all run at once. Prefill rows are bound by each SM's shared-memory
// loads: none when the tiles alone fill every SM's blocks, else the split
// (a power of two, so that each block owns whole warps' rows) that least
// loads the busiest SM, ceil(tiles s / SMs) blocks of 1/s of a tile's
// work, ties to the smaller.
inline int tl_split(int tiles, int groups, bool decode, int sms, int occ) {
  const int max_s = std::min(kMaxSplit, std::max(1, (groups + 3) / 4));
  if (decode) {
    int s = max_s;
    while (s > 1 && (long)tiles * s > (long)occ * sms) --s;
    return s;
  }
  int best = 1;
  long best_num = (tiles + sms - 1) / sms, best_den = 1;
  if ((long)tiles >= (long)occ * sms) return 1;  // every SM full: no split to pay for
  for (int s = 2; s <= max_s; s *= 2) {
    const long num = ((long)tiles * s + sms - 1) / sms;
    if (num * best_den < best_num * s) best = s, best_num = num, best_den = s;
  }
  return best;
}

template <int NW, bool kTab, class Cfg, class Epi>
cudaError_t launch_cfg(const int8_t* x, const float* tables, int m, int n, int groups, int k,
                       const uint8_t* w0, const uint8_t* w1, Epi epi, cudaStream_t stream) {
  auto kernel = tl_kernel<NW, kTab, Cfg, Epi>;
  // the card's SMs and this kernel's blocks an SM, asked once (the first
  // call comes before any graph capture: the wrappers' warm-ups)
  struct Fit {
    cudaError_t err;
    int sms, occ;
  };
  static const Fit fit = [kernel] {
    Fit f{cudaSuccess, 0, 0};
    int dev = 0;
    f.err = cudaGetDevice(&dev);
    if (f.err == cudaSuccess)
      f.err = cudaDeviceGetAttribute(&f.sms, cudaDevAttrMultiProcessorCount, dev);
    const size_t smem_max = TlSmem<NW, Cfg>::kMax;
    if (f.err == cudaSuccess) f.err = rtk::allow_smem(kernel, smem_max);
    if (f.err == cudaSuccess)
      f.err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&f.occ, kernel, kThreads, smem_max);
    return f;
  }();
  if (fit.err != cudaSuccess) {
    cudaGetLastError();  // leave no error behind for the next launcher to read
    return fit.err;
  }
  const int ctiles = (k + Cfg::kBK - 1) / Cfg::kBK, rtiles = (m + Cfg::kBM - 1) / Cfg::kBM;
  const int s =
      tl_split(ctiles * rtiles, groups, Cfg::kWT > 1, fit.sms, std::max(fit.occ, 1));
  const int share = ((groups + s - 1) / s + 3) / 4 * 4;  // whole float4s of tables
  const int split = (groups + share - 1) / share;
  const size_t smem = TlSmem<NW, Cfg>::bytes(split);
  const bool al16 = (uintptr_t)w0 % 16 == 0 && (NW == 1 || (uintptr_t)w1 % 16 == 0);
  const bool al4 = (uintptr_t)w0 % 4 == 0 && (NW == 1 || (uintptr_t)w1 % 4 == 0);
  const int ivec = k % 16 == 0 && al16 ? 16 : (k % 4 == 0 && al4 ? 4 : 0);
  const int tvec = kTab && groups % 4 == 0 && (uintptr_t)tables % 16 == 0;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(split, ctiles, rtiles);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = split;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = split > 1 ? 1 : 0;
  cudaLaunchKernelEx(&cfg, kernel, x, tables, m, n, groups, k, w0, w1, share, ivec, tvec, epi);
  return cudaGetLastError();  // the launch's error, read (and so cleared) here
}

// Decode configurations (M <= 16): one or two columns a lane, warps along
// the columns (two or four) and the rest on interleaved groups, a chunk of
// 512 / BM groups (27.6 KB of pair words; half that with two weights below
// 16 rows), within 128 registers (none asked at 16 rows with two weights).
// Tables read from f32 at 4 and 8 rows take 128 or 256 columns a block,
// so that fewer blocks read the same tables from L2; built from int8 (no
// such reads) and at 16 rows, 64 columns, so that more blocks share the
// walk.
template <int NW, int BM, bool kTab, bool kWide = kTab && BM < 16>
using TlDecode = TlConfig<BM, kWide ? 2 : 1, 1, kWide && NW == 2 ? 4 : 2,
                          (NW == 2 && BM < 16 ? 256 : 512) / BM, NW == 2 && BM == 16 ? 1 : 2>;
// Prefill: each warp 8 rows (four pairs), 512 columns a block. One weight:
// 16 rows, 4 columns a lane, 2 x 4 warps, 16 groups a chunk; two weights:
// 8 rows, 2 columns a lane, 1 x 8 warps, 32 groups a chunk (both within
// 128 registers, two blocks an SM).
template <int NW>
using TlPrefill = std::conditional_t<NW == 1, TlConfig<16, 4, 2, 4, 16, 2>,
                                     TlConfig<8, 2, 1, 8, 32, 2>>;

template <int NW, bool kTab, class Epi>
cudaError_t launch_src(const int8_t* x, const float* tables, int m, int n, int groups, int k,
                       const uint8_t* w0, const uint8_t* w1, Epi epi, cudaStream_t stream) {
  if (m <= 4)
    return launch_cfg<NW, kTab, TlDecode<NW, 4, kTab>>(x, tables, m, n, groups, k, w0, w1, epi, stream);
  if (m <= 8)
    return launch_cfg<NW, kTab, TlDecode<NW, 8, kTab>>(x, tables, m, n, groups, k, w0, w1, epi, stream);
  if (m <= 16)
    return launch_cfg<NW, kTab, TlDecode<NW, 16, kTab>>(x, tables, m, n, groups, k, w0, w1, epi, stream);
  return launch_cfg<NW, kTab, TlPrefill<NW>>(x, tables, m, n, groups, k, w0, w1, epi, stream);
}

template <int NW, class Epi>
cudaError_t launch_tl(const int8_t* x, const float* tables, int m, int n, int groups, int k,
                      const uint8_t* w0, const uint8_t* w1, Epi epi, cudaStream_t stream) {
  if (m == 0 || k == 0) return cudaSuccess;
  if (tables != nullptr)
    return launch_src<NW, true>(x, tables, m, n, groups, k, w0, w1, epi, stream);
  return launch_src<NW, false>(x, tables, m, n, groups, k, w0, w1, epi, stream);
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
