// Integer main loops shared by the packed ternary GEMV/matmul and SwiGLU
// kernels: int8 activations x [M, N] against NW planar pack2 weight
// matrices wp [N/4, K] (NW = 1 for a projection, 2 for gate+up).
//
// Planar pack2 (repro/core/packing.py:43): byte (i, k) holds the trits of
// weight rows i, i+N/4, i+2N/4, i+3N/4 in bit-planes 0..3. `rtk::trits4`
// spreads a byte into four signed int8 lanes in plane order and
// `rtk::x_word` packs the four activations those planes meet in the same
// order, so one __dp4a does the byte's four multiply-adds. Accumulation is
// int32, hence exact and independent of order; the epilogue functor turns
// the accumulators of output (m, k) into the result.
#pragma once

#include "common.cuh"

namespace rtk {

constexpr int kGemvThreads = 256;                             // 8 warps
constexpr int kGemvColThreads = 2;                            // 4 columns each
constexpr int kGemvCols = 4 * kGemvColThreads;                // columns per block
constexpr int kGemvRowLanes = kGemvThreads / kGemvColThreads;  // rows in flight

// Stage x [m, 4*n4] into shared memory as plane words, [m][n4]; with xvec
// (n4 % 4 == 0, x 4-byte aligned) by 4-byte loads, four words at a time.
__device__ __forceinline__ void stage_x_words(const int8_t* x, int m, int n4, int xvec,
                                              int* xw) {
  const int n = 4 * n4;
  if (xvec) {
    const int q4 = n4 / 4;
    for (int idx = threadIdx.x; idx < m * q4; idx += blockDim.x) {
      const int r = idx / q4, i = (idx - r * q4) * 4;
      x_words4(x + (size_t)r * n, i, n4, xw + r * n4 + i);
    }
  } else {
    for (int idx = threadIdx.x; idx < m * n4; idx += blockDim.x) {
      const int r = idx / n4, i = idx - r * n4;
      xw[idx] = x_word(x + (size_t)r * n, i, n4);
    }
  }
}

// Small-M path (M <= MB <= 16, decode rows). Each weight byte is read from
// device memory once; all M rows of x sit in shared memory as packed words.
// A block owns 8 columns, so that even K = 1536 spreads over 192 blocks;
// thread t owns columns k0 + 4*(t&1) .. +3 and weight rows i = t>>1
// (mod 128), unrolled so that several rows' loads are in flight.
template <int NW, int MB, class Epi>
__global__ void __launch_bounds__(kGemvThreads)
    gemv_kernel(const int8_t* __restrict__ x, int m, int n4, int k,
                const uint8_t* __restrict__ w0, const uint8_t* __restrict__ w1, int vec,
                int xvec, Epi epi) {
  extern __shared__ int smem[];
  int* xw = smem;                  // [m][n4] activation words
  int* red = smem + m * n4;        // [8 warps][NW][MB][kGemvCols]
  stage_x_words(x, m, n4, xvec, xw);
  __syncthreads();

  const int cq = threadIdx.x % kGemvColThreads, lane_row = threadIdx.x / kGemvColThreads;
  const int kb = blockIdx.x * kGemvCols;
  const int k0 = kb + cq * 4;
  const uint8_t* w[2] = {w0, w1};
  int acc[NW][MB][4];
#pragma unroll
  for (int a = 0; a < NW; ++a)
#pragma unroll
    for (int r = 0; r < MB; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[a][r][c] = 0;

#pragma unroll 4
  for (int i = lane_row; i < n4; i += kGemvRowLanes) {
#pragma unroll
    for (int a = 0; a < NW; ++a) {
      const uint8_t* row = w[a] + (size_t)i * k;
      int t[4];
      if (vec && k0 + 3 < k) {
        const uchar4 b = *reinterpret_cast<const uchar4*>(row + k0);
        t[0] = trits4(b.x); t[1] = trits4(b.y); t[2] = trits4(b.z); t[3] = trits4(b.w);
      } else {
#pragma unroll
        for (int c = 0; c < 4; ++c) t[c] = k0 + c < k ? trits4(row[k0 + c]) : 0;
      }
#pragma unroll
      for (int r = 0; r < MB; ++r) {
        if (r < m) {
          const int xv = xw[r * n4 + i];
#pragma unroll
          for (int c = 0; c < 4; ++c) acc[a][r][c] = __dp4a(xv, t[c], acc[a][r][c]);
        }
      }
    }
  }

  // Sum over the row lanes: inside a warp by shuffles across the lanes that
  // share a column group, then the 8 warps through shared memory.
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int a = 0; a < NW; ++a)
#pragma unroll
    for (int r = 0; r < MB; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        int v = acc[a][r][c];
#pragma unroll
        for (int off = kGemvColThreads; off < 32; off <<= 1)
          v += __shfl_xor_sync(0xffffffffu, v, off);
        if (lane < kGemvColThreads)
          red[((warp * NW + a) * MB + r) * kGemvCols + cq * 4 + c] = v;
      }
  __syncthreads();
  for (int idx = threadIdx.x; idx < MB * kGemvCols; idx += blockDim.x) {
    const int r = idx / kGemvCols, col = idx - r * kGemvCols;
    if (r >= m || kb + col >= k) continue;
    int sum[NW];
#pragma unroll
    for (int a = 0; a < NW; ++a) {
      int s = 0;
      for (int wi = 0; wi < kGemvThreads / 32; ++wi)
        s += red[((wi * NW + a) * MB + r) * kGemvCols + col];
      sum[a] = s;
    }
    epi(r, kb + col, sum);
  }
}

template <int NW, int MB>
constexpr size_t gemv_smem(int m, int n4) {
  return (size_t)m * n4 * 4 + (size_t)(kGemvThreads / 32) * NW * MB * kGemvCols * 4;
}

constexpr int kMmBM = 64, kMmBK = 64, kMmTI = 32, kMmThreads = 256;

// Tiled path for prefill rows: a block owns a 64x64 output tile and walks
// the packed rows 32 at a time through shared memory; each thread holds a
// 4x4 micro-tile (rows ty + 16a, columns tx + 16c).
template <int NW, class Epi>
__global__ void __launch_bounds__(kMmThreads)
    matmul_kernel(const int8_t* __restrict__ x, int m, int n4, int k,
                  const uint8_t* __restrict__ w0, const uint8_t* __restrict__ w1, int xvec,
                  Epi epi) {
  __shared__ int xs[kMmTI][kMmBM + 1];
  __shared__ int ws[NW][kMmTI][kMmBK];
  const int n = 4 * n4;
  const int m0 = blockIdx.y * kMmBM, k0 = blockIdx.x * kMmBK;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const uint8_t* w[2] = {w0, w1};
  int acc[NW][4][4];
#pragma unroll
  for (int a = 0; a < NW; ++a)
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[a][r][c] = 0;

  for (int i0 = 0; i0 < n4; i0 += kMmTI) {
    if (xvec) {  // n4 % 4 == 0: a group of four rows is all in range or all out
      for (int idx = threadIdx.x; idx < kMmBM * kMmTI / 4; idx += blockDim.x) {
        const int mm = idx / (kMmTI / 4), ii = (idx - mm * (kMmTI / 4)) * 4;
        const int r = m0 + mm, i = i0 + ii;
        int w4[4] = {0, 0, 0, 0};
        if (r < m && i < n4) x_words4(x + (size_t)r * n, i, n4, w4);
#pragma unroll
        for (int t = 0; t < 4; ++t) xs[ii + t][mm] = w4[t];
      }
    } else {
      for (int idx = threadIdx.x; idx < kMmBM * kMmTI; idx += blockDim.x) {
        const int mm = idx / kMmTI, ii = idx - mm * kMmTI;
        const int r = m0 + mm, i = i0 + ii;
        xs[ii][mm] = (r < m && i < n4) ? x_word(x + (size_t)r * n, i, n4) : 0;
      }
    }
#pragma unroll
    for (int a = 0; a < NW; ++a)
      for (int idx = threadIdx.x; idx < kMmTI * kMmBK; idx += blockDim.x) {
        const int ii = idx / kMmBK, kk = idx - ii * kMmBK;
        const int i = i0 + ii, col = k0 + kk;
        ws[a][ii][kk] = (i < n4 && col < k) ? trits4(w[a][(size_t)i * k + col]) : 0;
      }
    __syncthreads();
#pragma unroll 4
    for (int ii = 0; ii < kMmTI; ++ii) {
      int xv[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) xv[r] = xs[ii][ty + 16 * r];
#pragma unroll
      for (int a = 0; a < NW; ++a) {
        int wv[4];
#pragma unroll
        for (int c = 0; c < 4; ++c) wv[c] = ws[a][ii][tx + 16 * c];
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int c = 0; c < 4; ++c) acc[a][r][c] = __dp4a(xv[r], wv[c], acc[a][r][c]);
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int row = m0 + ty + 16 * r, col = k0 + tx + 16 * c;
      if (row < m && col < k) {
        int sum[NW];
#pragma unroll
        for (int a = 0; a < NW; ++a) sum[a] = acc[a][r][c];
        epi(row, col, sum);
      }
    }
}

// Launch the small-M kernel for m <= 16 (MB = 4, 8 or 16) or the tiled one.
template <int NW, class Epi>
inline cudaError_t launch_ternary(const int8_t* x, int m, int n4, int k, const uint8_t* w0,
                                  const uint8_t* w1, Epi epi, bool small_m,
                                  cudaStream_t stream) {
  if (m == 0 || k == 0) return cudaSuccess;
  const int xvec = (n4 % 4 == 0) && ((uintptr_t)x % 4 == 0);
  if (small_m) {
    const bool vec = (k % 4 == 0) && ((uintptr_t)w0 % 4 == 0) &&
                     (NW == 1 || (uintptr_t)w1 % 4 == 0);
    const dim3 grid((k + kGemvCols - 1) / kGemvCols);
#define TM_GEMV_CASE(MB)                                                            \
  if (m <= MB) {                                                                    \
    const size_t smem = gemv_smem<NW, MB>(m, n4);                                   \
    cudaError_t err = allow_smem(gemv_kernel<NW, MB, Epi>, smem);                   \
    if (err != cudaSuccess) return err;                                             \
    gemv_kernel<NW, MB, Epi><<<grid, kGemvThreads, smem, stream>>>(x, m, n4, k, w0, \
                                                                   w1, vec, xvec, epi);   \
    return cudaGetLastError();                                                      \
  }
    TM_GEMV_CASE(4)
    TM_GEMV_CASE(8)
    TM_GEMV_CASE(16)
#undef TM_GEMV_CASE
    return cudaErrorInvalidValue;
  }
  const dim3 grid((k + kMmBK - 1) / kMmBK, (m + kMmBM - 1) / kMmBM);
  matmul_kernel<NW, Epi><<<grid, kMmThreads, 0, stream>>>(x, m, n4, k, w0, w1, xvec, epi);
  return cudaGetLastError();
}

}  // namespace rtk
