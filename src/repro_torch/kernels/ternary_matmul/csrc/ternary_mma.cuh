// Tensor-core main loop of the packed ternary matmul at prefill rows
// (M > 16): int8 activations x [M, N] against NW planar pack2 weight
// matrices wp [N/4, K] on mma.sync.m16n8k32 (s8 x s8 -> s32), ending in an
// epilogue functor of ternary_tiles.cuh. NW = 1 is the projection; NW = 2
// the SwiGLU's gate and up, which share every staged x tile, each with its
// own accumulator set, and hand the epilogue both sums of one output.
//
// What bounds it: operations. At [512, 1536] x 2 [384, 4096] the SwiGLU
// does 12.9 G int8 operations (6.5 us at 1979 TOP/s) on 3.9 MB of
// operands (1.2 us at 3.35 TB/s); the projection at the same rows 2.4 G.
// So the loop runs on the int8 tensor cores, keeps the 2-bit weights at 2
// bits in shared memory, and spends a byte transpose and four ALU
// operations a k32 step on turning them into mma operands.
//
// The contraction in mma order. An int32 sum is exact in any order, so a
// k32 step may take its 32 contraction values in whatever order makes both
// operands cheap, as long as A and B agree:
//   - one k32 step is one bit-plane p of 32 packed rows i0 + 0..31, i.e.
//     activations x[m, p*N/4 + i0 + 0..31], which lie contiguous in x;
//   - lane tig of a quad takes packed rows 8 tig + 0..3 (operand register
//     0) and 8 tig + 4..7 (register 2 of A, 1 of B), so its A registers are
//     one 8-byte load of a staged x row;
//   - its B register is then four packed bytes of one column, one plane:
//     the thread loads its packed rows of four adjacent columns (one
//     16-byte load per four rows), transposes them with __byte_perm, and
//     each plane p is a shift, mask, add and xor away from four signed
//     trits. mma column g of n-tile j is output column 4 g + j, so those
//     four columns feed the warp's four n-tiles.
// A stage of 32 packed rows thus feeds four k32 steps, and shared memory
// holds the weights at 2 bits each.
//
// Stages arrive by cp.async, three in flight: x as four plane sub-tiles
// [4][BM][32] (16-byte copies), the packed tile column-word major
// [BN/4][36 words] (4-byte copies; the pad of 4 words makes the 16-byte
// reads of eight lanes fall on distinct banks). Rows past M, packed rows
// past N/4 and columns past K are zero-filled by the copy (an x of zero
// cancels whatever trit it meets); where N/4 % 16, K % 4 or the alignment
// of x or wp rule the copies out, the same stages are filled by plain
// loads with the same masks, and the main loop does not change.
#pragma once

#include "common.cuh"

namespace rtk {

constexpr int kMmaTI = 32;      // packed rows per stage: 128 contraction values
constexpr int kMmaStages = 3;   // stages in flight
constexpr int kMmaWStride = 36;  // words per column word in the staged weight tile

// Block tile BM x BN, warp tile WM x 32 (WM / 16 m-tiles by four n-tiles)
// for each of NW weights.
template <int BM, int BN, int WM, int NW>
struct MmaTile {
  static constexpr int kWarpsN = BN / 32;
  static constexpr int kThreads = 32 * (BM / WM) * kWarpsN;
  static constexpr int kMTiles = WM / 16;
  static constexpr int kXBytes = 4 * BM * kMmaTI;             // [4][BM][32] int8
  static constexpr int kWBytes = (BN / 4) * kMmaWStride * 4;  // [BN/4][36] words a weight
  static constexpr int kStageBytes = kXBytes + NW * kWBytes;
  static constexpr size_t kSmem = (size_t)kMmaStages * kStageBytes;
};

// Stage packed rows [i0, i0 + 32) of the block's tile into `st`: the x
// sub-tiles once, then each weight's packed tile.
template <class Tile, int BM, int BN, int NW>
__device__ __forceinline__ void mma_stage(const int8_t* __restrict__ x, int m, int n4, int k,
                                          const uint8_t* __restrict__ w0,
                                          const uint8_t* __restrict__ w1, int m0, int k0, int i0,
                                          int vec, uint8_t* st) {
  int8_t* xs = reinterpret_cast<int8_t*>(st);
  const size_t n = 4 * (size_t)n4;
  constexpr int kCols = BN / 4;  // column words
  if (vec) {
    for (int c = threadIdx.x; c < 4 * BM * 2; c += Tile::kThreads) {
      const int p = c / (2 * BM), r = (c >> 1) - p * BM, half = c & 1;
      const int i = i0 + 16 * half;
      const bool ok = m0 + r < m && i < n4;
      cp_async16(xs + (p * BM + r) * kMmaTI + 16 * half,
                 ok ? x + (m0 + r) * n + p * n4 + i : x, ok);
    }
#pragma unroll
    for (int a = 0; a < NW; ++a) {
      const uint8_t* w = a ? w1 : w0;
      uint32_t* ws = reinterpret_cast<uint32_t*>(st + Tile::kXBytes + a * Tile::kWBytes);
      for (int c = threadIdx.x; c < kMmaTI * kCols; c += Tile::kThreads) {
        const int rr = c / kCols, cw = c - rr * kCols;
        const int i = i0 + rr, col = k0 + 4 * cw;
        const bool ok = i < n4 && col < k;
        cp_async4(ws + cw * kMmaWStride + rr, ok ? w + (size_t)i * k + col : w, ok);
      }
    }
  } else {
    for (int c = threadIdx.x; c < 4 * BM * kMmaTI; c += Tile::kThreads) {
      const int p = c / (BM * kMmaTI), r = c / kMmaTI - p * BM, i = i0 + c % kMmaTI;
      xs[c] = m0 + r < m && i < n4 ? x[(m0 + r) * n + p * n4 + i] : 0;
    }
#pragma unroll
    for (int a = 0; a < NW; ++a) {
      const uint8_t* w = a ? w1 : w0;
      uint32_t* ws = reinterpret_cast<uint32_t*>(st + Tile::kXBytes + a * Tile::kWBytes);
      for (int c = threadIdx.x; c < kMmaTI * kCols; c += Tile::kThreads) {
        const int rr = c / kCols, cw = c - rr * kCols;
        const int i = i0 + rr;
        uint32_t word = 0;
#pragma unroll
        for (int t = 0; t < 4; ++t) {
          const int col = k0 + 4 * cw + t;
          if (i < n4 && col < k) word |= (uint32_t)w[(size_t)i * k + col] << (8 * t);
        }
        ws[cw * kMmaWStride + rr] = word;
      }
    }
  }
}

// Plane p of four packed bytes (one per lane) -> four signed int8 trits:
// (v | 0x80) - 1 borrows inside its own lane, ^ 0x80 makes it v - 1.
__device__ __forceinline__ uint32_t plane_trits(uint32_t b, int p) {
  return ((((b >> (2 * p)) & 0x03030303u) | 0x80808080u) - 0x01010101u) ^ 0x80808080u;
}

template <int NW, int BM, int BN, int WM, class Epi, int MinB = 1>
__global__ void __launch_bounds__(MmaTile<BM, BN, WM, NW>::kThreads, MinB)
    mma_matmul_kernel(const int8_t* __restrict__ x, int m, int n4, int k,
                      const uint8_t* __restrict__ w0, const uint8_t* __restrict__ w1, int vec,
                      Epi epi) {
  using Tile = MmaTile<BM, BN, WM, NW>;
  constexpr int kMT = Tile::kMTiles;
  extern __shared__ __align__(16) uint8_t mma_smem[];
  const int m0 = blockIdx.y * BM, k0 = blockIdx.x * BN;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, tig = lane & 3;  // the fragments' row group and its lane
  const int wm = (warp / Tile::kWarpsN) * WM;  // the warp's first row in the block
  const int wn = (warp % Tile::kWarpsN) * 32;  // the warp's first column in the block

  int acc[NW][kMT][4][4];
#pragma unroll
  for (int w = 0; w < NW; ++w)
#pragma unroll
    for (int a = 0; a < kMT; ++a)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        acc[w][a][j][0] = acc[w][a][j][1] = acc[w][a][j][2] = acc[w][a][j][3] = 0;

  const int nst = (n4 + kMmaTI - 1) / kMmaTI;
#pragma unroll
  for (int s = 0; s < kMmaStages - 1; ++s) {
    if (s < nst)
      mma_stage<Tile, BM, BN, NW>(x, m, n4, k, w0, w1, m0, k0, s * kMmaTI, vec,
                                  mma_smem + s * Tile::kStageBytes);
    cp_async_commit();
  }
  for (int s = 0; s < nst; ++s) {
    cp_async_wait<kMmaStages - 2>();  // stage s has landed
    __syncthreads();                  // and stage s - 1 is consumed
    {
      const int nx = s + kMmaStages - 1;
      if (nx < nst)
        mma_stage<Tile, BM, BN, NW>(x, m, n4, k, w0, w1, m0, k0, nx * kMmaTI, vec,
                                    mma_smem + (nx % kMmaStages) * Tile::kStageBytes);
      cp_async_commit();
    }
    const uint8_t* st = mma_smem + (s % kMmaStages) * Tile::kStageBytes;
    const int8_t* xs = reinterpret_cast<const int8_t*>(st);
    // Packed rows 8 tig .. + 3 (lo) and + 4 .. + 7 (hi) of columns
    // wn + 4 g .. + 3, transposed: lo_c[w][j] holds column 4 g + j's four
    // bytes of weight w.
    uint32_t lo_c[NW][4], hi_c[NW][4];
#pragma unroll
    for (int w = 0; w < NW; ++w) {
      const uint32_t* wcol = reinterpret_cast<const uint32_t*>(st + Tile::kXBytes +
                                                               w * Tile::kWBytes) +
                             (wn / 4 + g) * kMmaWStride;
      const uint4 lo = *reinterpret_cast<const uint4*>(wcol + 8 * tig);
      const uint4 hi = *reinterpret_cast<const uint4*>(wcol + 8 * tig + 4);
      transpose_bytes4(lo.x, lo.y, lo.z, lo.w, lo_c[w]);
      transpose_bytes4(hi.x, hi.y, hi.z, hi.w, hi_c[w]);
    }
#pragma unroll
    for (int p = 0; p < 4; ++p) {  // one k32 step per plane
      uint32_t a[kMT][4];
#pragma unroll
      for (int t = 0; t < kMT; ++t) {
        const int8_t* xr = xs + (p * BM + wm + 16 * t + g) * kMmaTI + 8 * tig;
        const uint2 r0 = *reinterpret_cast<const uint2*>(xr);
        const uint2 r8 = *reinterpret_cast<const uint2*>(xr + 8 * kMmaTI);
        a[t][0] = r0.x;
        a[t][1] = r8.x;
        a[t][2] = r0.y;
        a[t][3] = r8.y;
      }
#pragma unroll
      for (int w = 0; w < NW; ++w)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const uint32_t b0 = plane_trits(lo_c[w][j], p), b1 = plane_trits(hi_c[w][j], p);
#pragma unroll
          for (int t = 0; t < kMT; ++t) mma_s8(acc[w][t][j], a[t], b0, b1);
        }
    }
  }

  // acc[w][t][j]: elements 0, 1 at row wm + 16 t + g, columns wn + 8 tig + j
  // and + 4; elements 2, 3 eight rows down.
#pragma unroll
  for (int t = 0; t < kMT; ++t)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int row = m0 + wm + 16 * t + g + 8 * (e >> 1);
      if (row >= m) continue;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = k0 + wn + 8 * tig + 4 * (e & 1) + j;
        if (col >= k) continue;
        int sum[NW];
#pragma unroll
        for (int w = 0; w < NW; ++w) sum[w] = acc[w][t][j][e];
        epi(row, col, sum);
      }
    }
}

template <int NW, int BM, int BN, int WM, class Epi, int MinB = 1>
inline cudaError_t launch_mma_tile(const int8_t* x, int m, int n4, int k, const uint8_t* w0,
                                   const uint8_t* w1, int vec, Epi epi, cudaStream_t stream) {
  using Tile = MmaTile<BM, BN, WM, NW>;
  auto kernel = mma_matmul_kernel<NW, BM, BN, WM, Epi, MinB>;
  const cudaError_t err = allow_smem(kernel, Tile::kSmem);
  if (err != cudaSuccess) return err;
  const dim3 grid((k + BN - 1) / BN, (m + BM - 1) / BM);
  kernel<<<grid, Tile::kThreads, Tile::kSmem, stream>>>(x, m, n4, k, w0, w1, vec, epi);
  return cudaGetLastError();
}

// The tiled launch for any M. One weight (a projection): a larger tile
// reuses each staged byte more, but a block runs on one SM: 128 x 128
// (held to 128 registers, two blocks an SM) where that gives at least two
// blocks per SM, else 64 x 64 (on the H100
// at the main path's shapes: the large tile at 4000 rows, the small one at
// a 512-row prefill, whose 192 blocks would be 48 of the large, and at the
// chunk step's 2048, where the two times are within 5 %). Two weights (the
// SwiGLU's gate and up, sharing each staged x tile): 64 x 128 of eight
// warp tiles 32 x 32, held to 128 registers a thread so that two blocks
// share an SM; on the H100 it beat 128 x 64 (one or two blocks an SM),
// 64 x 64 and 64 x 128 at one block at 512, 2048 and 4096 rows.
template <int NW, class Epi>
inline cudaError_t launch_ternary_mma(const int8_t* x, int m, int n4, int k, const uint8_t* w0,
                                      const uint8_t* w1, Epi epi, cudaStream_t stream) {
  if (m == 0 || k == 0) return cudaSuccess;
  const int vec = n4 % 16 == 0 && k % 4 == 0 && (uintptr_t)x % 16 == 0 &&
                  (uintptr_t)w0 % 4 == 0 && (NW == 1 || (uintptr_t)w1 % 4 == 0);
  if constexpr (NW == 2) {
    return launch_mma_tile<2, 64, 128, 32, Epi, 2>(x, m, n4, k, w0, w1, vec, epi, stream);
  } else {
    int dev = 0, sms = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return err;
    if ((long)((m + 127) / 128) * ((k + 127) / 128) >= 2L * sms)
      return launch_mma_tile<1, 128, 128, 64, Epi, 2>(x, m, n4, k, w0, w1, vec, epi, stream);
    return launch_mma_tile<1, 64, 64, 32>(x, m, n4, k, w0, w1, vec, epi, stream);
  }
}

}  // namespace rtk
