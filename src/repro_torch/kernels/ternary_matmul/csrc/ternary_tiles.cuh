// The packed ternary GEMV at decode rows (M <= 16), shared by the projection
// (NW = 1 weight) and the SwiGLU (NW = 2, gate and up): int8 activations
// x [M, N] against NW planar pack2 weight matrices wp [N/4, K]. The tiled
// matmul of prefill rows runs on the tensor cores (ternary_mma.cuh). The
// epilogue functors and the SwiGLU's row requant live here too: the
// table-lookup kernels (tl_gemv/csrc/tl_gemv.cu) end in the same code, so
// both engines round their int32 sums identically.
//
// What bounds the GEMV: bytes. The 2-bit weights (N/4 * K bytes, 0.59 MB
// at [384, 1536]) are nearly all its traffic, 0.18 us at 3.35 TB/s, so the
// call is as fast as its chain of dependent steps is short. The design
// keeps one memory round trip on it:
//   - a block owns 64 output columns and a contiguous share of the packed
//     rows (128, or 64 where that fills the SMs: [384, 1536] runs 24 x 6 =
//     144 blocks); the blocks of a column tile form a thread-block cluster
//     (at most 8, the portable size) that splits the contraction;
//   - every weight byte of the block is requested by 16-byte cp.async
//     (four lanes cover a packed row's 64 bytes) before the block waits on
//     anything, x's M rows x 4 planes of the block's packed rows alongside
//     (16-byte cp.async), and the epilogue's scales and residual are
//     prefetched into L1 by the block that will read them;
//   - the contraction runs on the int8 tensor cores, ternary_mma.cuh's
//     order on one m16 tile (rows past M are zero operands), so that M =
//     16 costs what M = 4 does;
//   - int32 sums: the four planes' warps in shared memory, then each
//     block of the cluster stores its sums into the leader's shared memory
//     (distributed shared memory) and leaves; the leader, after one cluster
//     barrier, runs the epilogue. Int32 sums are exact in any order, so the
//     result does not depend on the split.
// The SwiGLU at decode rows then runs requant_kernel, one block a row. A
// single launch whose last block (by a ticket) requantized all M x K
// values was tried and ran slower on the H100: that block's codes are
// compute-bound on one SM.
#pragma once

#include <cooperative_groups.h>

#include "ternary_mma.cuh"

namespace rtk {

constexpr int kGemvThreads = 256;  // 8 warps: 2 column halves x 4 bit-planes
constexpr int kGemvCols = 64;      // output columns of a block
constexpr int kGemvMaxSplit = 8;   // blocks of a cluster (the portable size)
constexpr int kGemvMaxRows = 512;  // packed rows staged at once

__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void prefetch_l1(const void* p) {
  asm volatile("prefetch.global.L1 [%0];\n" ::"l"(p));
}

// Projection epilogue: out[m, k] = T((float(acc) * xs[m]) * ws), then
// T(out + residual[m, k]) when a residual is given (the reference's
// `(acc * x_scale * w_scale).astype(T)` and `out + r`). `ws` is one scalar
// (ws_stride 0) or a per-output-channel row (ws_stride 1).
template <typename T>
struct DequantEpi {
  const float* xs;  // [M] per-row activation scales
  const float* ws;  // device scalar or [K] weight scale
  const T* res;     // [M, K] or nullptr
  T* out;           // [M, K]
  int k;
  int ws_stride;
  __device__ __forceinline__ void prefetch(int m, int col) const {
    prefetch_l1(xs + m);
    prefetch_l1(ws + col * ws_stride);
    if (res != nullptr) prefetch_l1(res + (size_t)m * k + col);
  }
  __device__ __forceinline__ void operator()(int m, int col, const int* acc) const {
    const float v = __fmul_rn(__fmul_rn((float)acc[0], xs[m]), ws[col * ws_stride]);
    T o = Num<T>::from_f(v);
    const size_t at = (size_t)m * k + col;
    if (res != nullptr) o = Num<T>::from_f(__fadd_rn(Num<T>::to_f(o), Num<T>::to_f(res[at])));
    out[at] = o;
  }
};

// SwiGLU epilogue: gate and up accumulators ->
//   g = T((acc_g * xs) * wgs),  u = T((acc_u * xs) * wus)
//   h = T(T(g * T(sigmoid(g))) * u)            (silu in the act dtype T)
// written to the scratch row h [M, K]; requant_kernel follows.
template <typename T>
struct SwigluEpi {
  const float* xs;
  const float* wgs;
  const float* wus;
  T* h;  // [M, K] scratch
  int k;
  __device__ __forceinline__ void prefetch(int m, int) const {
    prefetch_l1(xs + m);
    prefetch_l1(wgs);
    prefetch_l1(wus);
  }
  __device__ __forceinline__ void operator()(int m, int col, const int* acc) const {
    const float xsm = xs[m];
    const float g = round_to<T>(__fmul_rn(__fmul_rn((float)acc[0], xsm), *wgs));
    const float u = round_to<T>(__fmul_rn(__fmul_rn((float)acc[1], xsm), *wus));
    const float sig = round_to<T>(__fdiv_rn(1.0f, __fadd_rn(1.0f, expf(-g))));
    const float a = round_to<T>(__fmul_rn(g, sig));
    h[(size_t)m * k + col] = Num<T>::from_f(__fmul_rn(a, u));
  }
};

// 16 bytes of h: 16 / sizeof(T) values, as floats.
__device__ __forceinline__ int h_floats(uint4 v, float* f, float) {
  f[0] = __uint_as_float(v.x); f[1] = __uint_as_float(v.y);
  f[2] = __uint_as_float(v.z); f[3] = __uint_as_float(v.w);
  return 4;
}
__device__ __forceinline__ int h_floats(uint4 v, float* f, __nv_bfloat16) {
  const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f[2 * i] = __uint_as_float(w[i] << 16);
    f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
  return 8;
}

// The decode GEMV: grid (split, ceil(K / 64)), clusters of `split` blocks
// along x. Block (rank, tile) reduces packed rows [rank * rows, + rows) of
// columns [64 tile, + 64), staging at most `stage_rows` of them at a time
// (one stage at the models' shapes). Shared memory of a stage: the packed
// weights row-major [NW][sr][64] and x's m rows [m][4 planes][sr]. `vec`:
// K % 16 == 0 and 16-byte aligned weights; `xvec`: N/4 % 16 == 0 and
// 16-byte aligned x. Otherwise the same stages are filled by masked byte
// loads.
//
// Warp w takes bit-plane p = w / 2 of column half w % 2 over every 32-row
// chunk of the stage: a lane gathers packed rows 8 tig .. + 7 of columns
// 4 g .. + 3 by eight 4-byte loads, transposes them (__byte_perm), and
// plane p of a column's four bytes is four signed trits (plane_trits),
// B of mma.sync.m16n8k32; A is x's plane p at the same packed rows.
template <int NW, int MB, class Epi>
__global__ void __launch_bounds__(kGemvThreads)
    gemv_kernel(const int8_t* __restrict__ x, int m, int n4, int k,
                const uint8_t* __restrict__ w0, const uint8_t* __restrict__ w1, int rows,
                int stage_rows, int vec, int xvec, Epi epi) {
  namespace cg = cooperative_groups;
  extern __shared__ __align__(16) uint8_t gemv_smem[];
  const int sr = stage_rows;
  uint8_t* wt = gemv_smem;                                           // [NW][sr][64]
  int8_t* xt = reinterpret_cast<int8_t*>(wt + NW * sr * kGemvCols);  // [m][4][sr]
  int* red = reinterpret_cast<int*>(xt + m * 4 * sr);  // [4 planes][NW][m][64]
  const int part = NW * m * kGemvCols;                // one block's sums
  int* slots = red + 4 * part;                        // the leader's: [split - 1][part]

  const int tid = threadIdx.x;
  const int rank = blockIdx.x, split = gridDim.x;
  const int col0 = blockIdx.y * kGemvCols;
  const size_t n = 4 * (size_t)n4;
  cluster_arrive_relaxed();  // waited on before the first remote store
  if (rank == 0)
    for (int o = tid; o < m * kGemvCols; o += kGemvThreads)
      if (col0 + (o & 63) < k) epi.prefetch(o >> 6, col0 + (o & 63));

  const int warp = tid >> 5, lane = tid & 31, g = lane >> 2, tig = lane & 3;
  const int half = warp & 1, plane = warp >> 1;
  const int iend = min(n4, (rank + 1) * rows);  // past it: the next block's rows
  int acc[NW][4][4];
#pragma unroll
  for (int a = 0; a < NW; ++a)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[a][j][0] = acc[a][j][1] = acc[a][j][2] = acc[a][j][3] = 0;

  for (int s0 = 0; s0 < rows; s0 += sr) {
    const int i0 = rank * rows + s0;
    if (s0 > 0) __syncthreads();  // the previous stage is consumed
    if (vec) {
      for (int q = tid; q < NW * sr * 4; q += kGemvThreads) {
        const int a = q / (sr * 4), rr = (q >> 2) - a * sr, j = q & 3;
        const int i = i0 + rr, col = col0 + 16 * j;
        const uint8_t* w = a ? w1 : w0;
        const bool ok = i < iend && col < k;
        cp_async16(wt + (a * sr + rr) * kGemvCols + 16 * j, ok ? w + (size_t)i * k + col : w,
                   ok);
      }
    } else {
      for (int q = tid; q < NW * sr * kGemvCols; q += kGemvThreads) {
        const int a = q / (sr * kGemvCols), rr = (q >> 6) - a * sr;
        const int i = i0 + rr, col = col0 + (q & 63);
        wt[q] = i < iend && col < k ? (a ? w1 : w0)[(size_t)i * k + col] : 0;
      }
    }
    if (xvec) {  // a 16-byte chunk of a plane is all in range or all out
      const int c16 = sr / 16;
      for (int q = tid; q < m * 4 * c16; q += kGemvThreads) {
        const int rp = q / c16, i = i0 + 16 * (q - rp * c16);
        const bool ok = i < iend;
        cp_async16(xt + (size_t)q * 16, ok ? x + (rp >> 2) * n + (rp & 3) * n4 + i : x, ok);
      }
    } else {
      for (int q = tid; q < m * 4 * sr; q += kGemvThreads) {
        const int rp = q / sr, i = i0 + q - rp * sr;
        xt[q] = i < iend ? x[(rp >> 2) * n + (rp & 3) * n4 + i] : 0;
      }
    }
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();

    for (int c = 0; c < sr; c += 32) {
      // A: x rows g and g + 8 (MB = 16 only), packed rows c + 8 tig .. + 7
      uint32_t av[4] = {0, 0, 0, 0};
      if (g < m) {
        const uint2 r0 =
            *reinterpret_cast<const uint2*>(xt + (g * 4 + plane) * sr + c + 8 * tig);
        av[0] = r0.x;
        av[2] = r0.y;
      }
      if (MB > 8 && g + 8 < m) {
        const uint2 r8 =
            *reinterpret_cast<const uint2*>(xt + ((g + 8) * 4 + plane) * sr + c + 8 * tig);
        av[1] = r8.x;
        av[3] = r8.y;
      }
#pragma unroll
      for (int a = 0; a < NW; ++a) {
        const uint8_t* wr = wt + (a * sr + c + 8 * tig) * kGemvCols + 32 * half + 4 * g;
        uint32_t wl[8], lo[4], hi[4];
#pragma unroll
        for (int j = 0; j < 8; ++j) wl[j] = *reinterpret_cast<const uint32_t*>(wr + j * kGemvCols);
        transpose_bytes4(wl[0], wl[1], wl[2], wl[3], lo);
        transpose_bytes4(wl[4], wl[5], wl[6], wl[7], hi);
#pragma unroll
        for (int j = 0; j < 4; ++j)
          mma_s8(acc[a][j], av, plane_trits(lo[j], plane), plane_trits(hi[j], plane));
      }
    }
  }

  // acc[a][j]: elements 0, 1 at row g, columns 32 half + 8 tig + j and + 4;
  // elements 2, 3 eight rows down. The four planes' warps are summed in
  // shared memory, then the cluster's blocks in the leader.
#pragma unroll
  for (int a = 0; a < NW; ++a)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = g + 8 * (e >> 1);
      if (r >= m) continue;
#pragma unroll
      for (int j = 0; j < 4; ++j)
        red[plane * part + (a * m + r) * kGemvCols + 32 * half + 8 * tig + 4 * (e & 1) + j] =
            acc[a][j][e];
    }
  __syncthreads();
  for (int o = tid; o < part; o += kGemvThreads)
    red[o] += red[o + part] + red[o + 2 * part] + red[o + 3 * part];
  cluster_wait();  // every block of the cluster has started
  if (rank > 0) {
    int* dst = cg::this_cluster().map_shared_rank(slots, 0) + (rank - 1) * part;
    for (int o = tid; o < part; o += kGemvThreads) dst[o] = red[o];
    cluster_arrive();  // release: the stores before the leader's wait
    return;
  }
  __syncthreads();  // this block's sums
  cluster_arrive();
  cluster_wait();  // every block's sums are in `slots`
  for (int o = tid; o < m * kGemvCols; o += kGemvThreads) {
    const int col = col0 + (o & 63);
    if (col >= k) continue;
    int sum[NW];
#pragma unroll
    for (int a = 0; a < NW; ++a) sum[a] = red[a * m * kGemvCols + o];
    for (int b = 1; b < split; ++b)
#pragma unroll
      for (int a = 0; a < NW; ++a) sum[a] += slots[(b - 1) * part + a * m * kGemvCols + o];
    epi(o >> 6, col, sum);
  }
}

// The split of the contraction: 128 packed rows a block, 64 where that
// leaves fewer blocks than SMs, at most 8 blocks a cluster (more rows a
// block past N/4 = 1024); rows a multiple of 32, the mma chunk.
struct GemvSplit {
  int split, rows, stage_rows;
};

inline GemvSplit gemv_split(int n4, int tiles, int sms) {
  auto make = [n4](int rows) {
    int split = (n4 + rows - 1) / rows;
    if (split > kGemvMaxSplit) split = kGemvMaxSplit;
    if (split < 1) split = 1;
    rows = ((n4 + split - 1) / split + 31) / 32 * 32;
    split = (n4 + rows - 1) / rows;
    return GemvSplit{split < 1 ? 1 : split, rows, rows < kGemvMaxRows ? rows : kGemvMaxRows};
  };
  const GemvSplit big = make(128);
  return (long)big.split * tiles < sms ? make(64) : big;
}

template <int NW, int MB, class Epi>
inline cudaError_t launch_gemv_mb(const int8_t* x, int m, int n4, int k, const uint8_t* w0,
                                  const uint8_t* w1, Epi epi, cudaStream_t stream) {
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  const int tiles = (k + kGemvCols - 1) / kGemvCols;
  const GemvSplit s = gemv_split(n4, tiles, sms);
  const int vec = (k % 16 == 0) && ((uintptr_t)w0 % 16 == 0) &&
                  (NW == 1 || (uintptr_t)w1 % 16 == 0);
  const int xvec = (n4 % 16 == 0) && ((uintptr_t)x % 16 == 0);
  const size_t part = (size_t)NW * m * kGemvCols * 4;
  const size_t smem = (size_t)NW * s.stage_rows * kGemvCols + (size_t)m * 4 * s.stage_rows +
                      (4 + s.split - 1) * part;
  auto kernel = gemv_kernel<NW, MB, Epi>;
  err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(s.split, tiles);
  cfg.blockDim = dim3(kGemvThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = s.split;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, x, m, n4, k, w0, w1, s.rows, s.stage_rows, vec, xvec,
                           epi);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// The GEMV for 1 <= m <= 16: rows 8..15 of the m16 tile are loaded only
// by the MB = 16 instance.
template <int NW, class Epi>
inline cudaError_t launch_gemv(const int8_t* x, int m, int n4, int k, const uint8_t* w0,
                               const uint8_t* w1, Epi epi, cudaStream_t stream) {
  if (m == 0 || k == 0) return cudaSuccess;
  if (m <= 8) return launch_gemv_mb<NW, 8>(x, m, n4, k, w0, w1, epi, stream);
  if (m <= 16) return launch_gemv_mb<NW, 16>(x, m, n4, k, w0, w1, epi, stream);
  return cudaErrorInvalidValue;
}

constexpr int kRequantThreads = 256;

// The SwiGLU's row requant after pass 1: one block per row of h takes the
// absmax of all K values and writes the int8 codes and the row scale
// (quantize_act). A row of up to 4 x 16 bytes a thread (K <= 8192 in
// bf16) is read once, by 16-byte loads all issued together, and kept in
// registers for its codes; longer or unaligned rows take quantize_row's
// loops.
template <typename T>
__global__ void __launch_bounds__(kRequantThreads)
    requant_kernel(const T* __restrict__ h, int8_t* __restrict__ q, float* __restrict__ qs,
                   int k) {
  constexpr int kPer = 16 / sizeof(T), kVecs = 4;
  __shared__ float red[32];
  const size_t row = blockIdx.x;
  const T* hr = h + row * k;
  int8_t* qr = q + row * k;
  const int nv = k / kPer;
  if (k % kPer != 0 || nv > kVecs * kRequantThreads || (uintptr_t)hr % 16 != 0 ||
      (uintptr_t)qr % kPer != 0) {
    auto y = [&](int i) { return Num<T>::to_f(hr[i]); };
    quantize_row<T>(y, k, qr, qs + row, red);
    return;
  }
  uint4 v[kVecs];
#pragma unroll
  for (int b = 0; b < kVecs; ++b) {
    const int i = b * kRequantThreads + threadIdx.x;
    if (i < nv) v[b] = reinterpret_cast<const uint4*>(hr)[i];
  }
  float amax = 0.0f;
#pragma unroll
  for (int b = 0; b < kVecs; ++b) {
    if (b * kRequantThreads + threadIdx.x >= nv) continue;
    float f[8];
    const int cnt = h_floats(v[b], f, T());
    for (int e = 0; e < cnt; ++e) amax = fmaxf(amax, fabsf(f[e]));
  }
  const float scale = act_scale<T>(block_reduce<true>(amax, red));
#pragma unroll
  for (int b = 0; b < kVecs; ++b) {
    const int i = b * kRequantThreads + threadIdx.x;
    if (i >= nv) continue;
    float f[8];
    const int cnt = h_floats(v[b], f, T());
    uint32_t c[2] = {0, 0};
#pragma unroll
    for (int e = 0; e < cnt; ++e)
      c[e >> 2] |= (uint32_t)(uint8_t)act_code<T>(f[e], scale) << (8 * (e & 3));
    if (cnt == 8)
      reinterpret_cast<uint2*>(qr)[i] = make_uint2(c[0], c[1]);
    else
      reinterpret_cast<uint32_t*>(qr)[i] = c[0];
  }
  if (threadIdx.x == 0) qs[row] = scale;
}

template <typename T>
inline cudaError_t launch_requant(const T* h, int8_t* q, float* qs, int m, int k,
                                  cudaStream_t stream) {
  requant_kernel<T><<<m, kRequantThreads, 0, stream>>>(h, q, qs, k);
  return cudaGetLastError();
}

}  // namespace rtk
