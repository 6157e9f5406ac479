// Causal attention over a whole prompt: the one-shot prefill's attention.
//
// Replaces: repro/kernels/flash_attention/kernel.py::flash_attention_kernel
// (kernel.py:101, pallas_call at :126) around the body _kernel (:35-98).
//
// Computes, for q [B, H, S, D] and k/v [B, HK, S, D] (H % HK == 0; head hh
// of slot b reads kv head b*HK + hh / G, G = H / HK, the TPU kernel's index
// map at kernel.py:131-134): s = (q . k) * scale in f32, the -1e30 mask
// above the diagonal, online softmax with m and l in f32 and expf(s - m)
// (as the plain version takes it), probabilities cast to T before P.V,
// out = T(acc / max(l, 1e-30)).
// causal_skip = 1 visits only the kv tiles up to the block's causal
// frontier, the paper's causal-skip schedule (Table II); 0 visits every
// tile and masks each element, the dense ablation: the same output bit for
// bit (a fully masked tile adds exact zeros with alpha = 1), about twice
// the work. Any S: a ragged last tile is masked, nothing is padded.
//
// Bound on the H100: at S = 4096, D = 96, 16 heads, the live causal pairs
// are 16 * 4096 * 4097 / 2 = 134 M, 4 * D flops each: 51.6 GFLOP, 52 us on
// the bf16 tensor cores (989 TFLOP/s); q, k, v and out are 50 MB, 15 us.
// Long prompts are bound by operations, short ones (S = 128) by bytes and
// launch.
//
// bf16 runs on the tensor cores (flash_attention_tc_kernel): one block of
// 4 warps per (b * H + head, tile of 64 query rows), each warp 16 rows
// whose Q sits in registers as mma fragments for the whole walk. K and V
// stay bf16 in shared memory and stream in tiles of 64 rows through a
// two-stage cp.async ring, rows padded by 16 bytes so that ldmatrix reads
// them without bank conflicts. S = Q.K^T and O += P.V are
// mma.sync.m16n8k16 (bf16 in, f32 accumulators); the online softmax runs on
// the accumulator fragments (a row's max and sum over the quad of lanes
// that share it); P is rounded to bf16 in registers and is the A operand
// of P.V as it lies, V read with ldmatrix.trans. Only the tiles that reach
// past a warp's first row, or past S, are masked elementwise.
//
// f32 runs on the CUDA cores (flash_attention_f32_kernel), in f32
// throughout: the tensor cores would take f32 as TF32, which keeps about
// three decimal digits, and the f32 path is held within 1e-5. One block of
// 128 threads per (b * H + head, tile of 32 query rows); four threads share
// a query row, each holding D/4 of its q and of its accumulator in
// registers, their partial dots summed by two xor shuffles; kv rows stream
// through shared memory 32 at a time, each tile read as 16-byte vectors.
//
// Both issue the query tiles last first: the tiles near the end of the
// sequence walk the most kv tiles, so they start first and the short ones
// fill the tail. D is a template argument (16, 32, 64, 96 or 128).

#include <math.h>

#include "common.cuh"

namespace {

using bf16 = __nv_bfloat16;
constexpr float kNegInf = -1e30f;

// ---------------------------------------------------------------------------
// f32: CUDA cores
// ---------------------------------------------------------------------------

constexpr int kThreads = 128;
constexpr int kQuad = 4;                 // threads per query row
constexpr int kRows = kThreads / kQuad;  // query rows per block
constexpr int kTk = 32;                  // kv rows per shared-memory tile

// Rows [0, n) of a tile of kTk consecutive rows of src into shared memory,
// zeros past n; 16-byte vectors, all loads issued before use.
template <int D>
__device__ __forceinline__ void load_tile(const float* __restrict__ src, int n, float* dst) {
  constexpr int kPerRow = D / 4;  // 16-byte vectors per row
  constexpr int kTotal = kTk * kPerRow;
  constexpr int kIters = (kTotal + kThreads - 1) / kThreads;
  const float4* v4 = reinterpret_cast<const float4*>(src);
  float4 buf[kIters];
#pragma unroll
  for (int it = 0; it < kIters; ++it) {
    const int v = threadIdx.x + it * kThreads;
    buf[it] = v < kTotal && v / kPerRow < n ? v4[v] : make_float4(0.f, 0.f, 0.f, 0.f);
  }
#pragma unroll
  for (int it = 0; it < kIters; ++it) {
    const int v = threadIdx.x + it * kThreads;
    if (v >= kTotal) break;
    reinterpret_cast<float4*>(dst)[v] = buf[it];
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads)
    flash_attention_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                               const float* __restrict__ v, float* __restrict__ out, int h,
                               int hk, int s, float scale, int causal_skip) {
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
  const float* kb = k + (size_t)kvh * s * D;
  const float* vb = v + (size_t)kvh * s * D;

  float qr[kDp], acc[kDp];
  {
    const float* qp = q + ((size_t)bh * s + qpos) * D + part * kDp;
#pragma unroll
    for (int e = 0; e < kDp; ++e) {
      qr[e] = qp[e];
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
      sc[j] = p;
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
    load_tile<D>(kb + (size_t)t0 * D, n, k_s);
    load_tile<D>(vb + (size_t)t0 * D, n, v_s);
    __syncthreads();
    update(t0, n);
  }

  if (row_ok) {
    float* op = out + ((size_t)bh * s + row) * D + part * kDp;
    const float l = fmaxf(l_run, 1e-30f);
#pragma unroll
    for (int e = 0; e < kDp; ++e) op[e] = acc[e] / l;
  }
}

// ---------------------------------------------------------------------------
// bf16: tensor cores
// ---------------------------------------------------------------------------

constexpr int kTcWarps = 4;
constexpr int kTcThreads = 32 * kTcWarps;
constexpr int kTcRows = 16 * kTcWarps;  // query rows per block, 16 a warp
constexpr int kTcKeys = 64;             // kv rows per tile

// Shared memory of one block: K and V, two stages each, rows of D + 8
// elements (16 bytes of pad, so that the eight rows an ldmatrix reads fall
// on distinct banks).
template <int D>
constexpr size_t tc_smem_bytes() {
  return (size_t)4 * kTcKeys * (D + 8) * sizeof(bf16);
}

// Rows [row0, row0 + 64) of a [S, D] matrix into a padded tile by
// cp.async, zeros at rows >= s. Every thread of the block takes part.
template <int D>
__device__ __forceinline__ void tile_async(const bf16* __restrict__ src, int row0, int s,
                                           bf16* dst) {
  constexpr int kChunks = D / 8;  // 16-byte chunks per row
  static_assert(kTcKeys * kChunks % kTcThreads == 0, "whole rounds of chunks");
#pragma unroll
  for (int it = 0; it < kTcKeys * kChunks / kTcThreads; ++it) {
    const int c = threadIdx.x + it * kTcThreads;
    const int r = c / kChunks, col = (c - r * kChunks) * 8;
    const bool ok = row0 + r < s;
    rtk::cp_async16(dst + r * (D + 8) + col, src + (size_t)(ok ? row0 + r : 0) * D + col, ok);
  }
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&p);
}

template <int D>
__global__ void __launch_bounds__(kTcThreads)
    flash_attention_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                              const bf16* __restrict__ v, bf16* __restrict__ out, int h, int hk,
                              int s, float scale, int causal_skip) {
  constexpr int kStride = D + 8;              // elements per shared row
  constexpr int kTile = kTcKeys * kStride;    // elements per K or V tile
  constexpr int kSteps = D / 16;              // k-steps of Q.K^T
  constexpr int kDTiles = D / 8;              // n-tiles of P.V
  constexpr int kKTiles = kTcKeys / 8;        // n-tiles of Q.K^T
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* ks = reinterpret_cast<bf16*>(smem);   // [2][kTcKeys][kStride]
  bf16* vs = ks + 2 * kTile;                  // [2][kTcKeys][kStride]

  const int bh = blockIdx.x, b = bh / h;
  const int kvh = b * hk + (bh - b * h) / (h / hk);
  const int r0 = (gridDim.y - 1 - blockIdx.y) * kTcRows;  // last query tile first
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, tig = lane & 3;  // the fragments' row group and its lane
  const int mi = lane >> 3, mr = lane & 7;  // ldmatrix: the matrix and row this lane addresses
  const int wrow = 16 * warp;               // the warp's first row in the block
  const int qrow = r0 + wrow + g;           // this lane's rows: qrow and qrow + 8
  const bf16* kb = k + (size_t)kvh * s * D;
  const bf16* vb = v + (size_t)kvh * s * D;
  const int hi = causal_skip ? min(r0 + kTcRows, s) : s;
  const int ntiles = (hi + kTcKeys - 1) / kTcKeys;

  // Q goes through stage 1's K buffer, into registers as A fragments.
  tile_async<D>(q + (size_t)bh * s * D, r0, s, ks + kTile);
  tile_async<D>(kb, 0, s, ks);
  tile_async<D>(vb, 0, s, vs);
  rtk::cp_async_commit();
  rtk::cp_async_wait<0>();
  __syncthreads();
  uint32_t qf[kSteps][4];
  {
    const bf16* base = ks + kTile + (wrow + (mi & 1) * 8 + mr) * kStride + (mi >> 1) * 8;
#pragma unroll
    for (int kk = 0; kk < kSteps; ++kk) rtk::ldmatrix_x4<false>(qf[kk], base + kk * 16);
  }
  __syncthreads();  // stage 1 is free for tile 1

  float o[kDTiles][4];
#pragma unroll
  for (int dt = 0; dt < kDTiles; ++dt) o[dt][0] = o[dt][1] = o[dt][2] = o[dt][3] = 0.0f;
  float m_run[2] = {kNegInf, kNegInf}, l_run[2] = {0.0f, 0.0f};

  for (int it = 0; it < ntiles; ++it) {
    const int t0 = it * kTcKeys;
    if (it + 1 < ntiles) {
      tile_async<D>(kb, t0 + kTcKeys, s, ks + ((it + 1) & 1) * kTile);
      tile_async<D>(vb, t0 + kTcKeys, s, vs + ((it + 1) & 1) * kTile);
    }
    rtk::cp_async_commit();
    rtk::cp_async_wait<1>();  // this tile has landed; the next may be in flight
    __syncthreads();
    const bf16* kt = ks + (it & 1) * kTile;
    const bf16* vt = vs + (it & 1) * kTile;

    // S = Q.K^T: sc[j] holds keys t0 + 8j .. + 7; elements 0, 1 at row
    // qrow, keys + 2 tig + {0, 1}; elements 2, 3 at row qrow + 8.
    float sc[kKTiles][4];
#pragma unroll
    for (int j = 0; j < kKTiles; ++j) sc[j][0] = sc[j][1] = sc[j][2] = sc[j][3] = 0.0f;
    {
      const bf16* base = kt + ((mi >> 1) * 8 + mr) * kStride + (mi & 1) * 8;
#pragma unroll
      for (int kk = 0; kk < kSteps; ++kk)
#pragma unroll
        for (int np = 0; np < kKTiles / 2; ++np) {
          uint32_t kf[4];
          rtk::ldmatrix_x4<false>(kf, base + np * 16 * kStride + kk * 16);
          rtk::mma_bf16(sc[2 * np], qf[kk], kf[0], kf[1]);
          rtk::mma_bf16(sc[2 * np + 1], qf[kk], kf[2], kf[3]);
        }
    }
    // Scale; mask the tiles that reach past the warp's first row or past S.
    const bool masked = t0 + kTcKeys - 1 > r0 + wrow || t0 + kTcKeys > s;
#pragma unroll
    for (int j = 0; j < kKTiles; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = t0 + 8 * j + 2 * tig + (e & 1);
        const float x = sc[j][e] * scale;
        sc[j][e] = masked && (key > qrow + 8 * (e >> 1) || key >= s) ? kNegInf : x;
      }
    // Online softmax of rows qrow (rr = 0) and qrow + 8 (rr = 1); the four
    // lanes of a quad hold a row's 64 keys between them. A fully masked
    // tile gives alpha = expf(0) = 1 and p = 0 exactly, so the dense
    // schedule adds nothing.
    float alpha[2];
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      float tmax = kNegInf;
#pragma unroll
      for (int j = 0; j < kKTiles; ++j) tmax = fmaxf(tmax, fmaxf(sc[j][2 * rr], sc[j][2 * rr + 1]));
      tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, 1));
      tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, 2));
      const float m_new = fmaxf(m_run[rr], tmax);
      alpha[rr] = m_new == kNegInf ? 1.0f : expf(m_run[rr] - m_new);
      float psum = 0.0f;
#pragma unroll
      for (int j = 0; j < kKTiles; ++j)
#pragma unroll
        for (int e = 2 * rr; e < 2 * rr + 2; ++e) {
          const float p = sc[j][e] == kNegInf ? 0.0f : expf(sc[j][e] - m_new);
          psum += p;
          sc[j][e] = p;
        }
      psum += __shfl_xor_sync(0xffffffffu, psum, 1);
      psum += __shfl_xor_sync(0xffffffffu, psum, 2);
      l_run[rr] = l_run[rr] * alpha[rr] + psum;
      m_run[rr] = m_new;
    }
#pragma unroll
    for (int dt = 0; dt < kDTiles; ++dt) {
      o[dt][0] *= alpha[0];
      o[dt][1] *= alpha[0];
      o[dt][2] *= alpha[1];
      o[dt][3] *= alpha[1];
    }
    // O += P.V: P in bf16 is the A operand as the accumulators lie (keys
    // 16 kk .. + 15 are n-tiles 2 kk and 2 kk + 1); V via ldmatrix.trans.
    {
      const bf16* base = vt + ((mi & 1) * 8 + mr) * kStride + (mi >> 1) * 8;
#pragma unroll
      for (int kk = 0; kk < kTcKeys / 16; ++kk) {
        const uint32_t pa[4] = {pack_bf16(sc[2 * kk][0], sc[2 * kk][1]),
                                pack_bf16(sc[2 * kk][2], sc[2 * kk][3]),
                                pack_bf16(sc[2 * kk + 1][0], sc[2 * kk + 1][1]),
                                pack_bf16(sc[2 * kk + 1][2], sc[2 * kk + 1][3])};
#pragma unroll
        for (int dp = 0; dp < kDTiles / 2; ++dp) {
          uint32_t vf[4];
          rtk::ldmatrix_x4<true>(vf, base + kk * 16 * kStride + dp * 16);
          rtk::mma_bf16(o[2 * dp], pa, vf[0], vf[1]);
          rtk::mma_bf16(o[2 * dp + 1], pa, vf[2], vf[3]);
        }
      }
    }
    __syncthreads();  // the stage is consumed before the next load refills it
  }

#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    const int row = qrow + 8 * rr;
    if (row >= s) continue;
    const float l = fmaxf(l_run[rr], 1e-30f);
    uint32_t* op = reinterpret_cast<uint32_t*>(out + ((size_t)bh * s + row) * D + 2 * tig);
#pragma unroll
    for (int dt = 0; dt < kDTiles; ++dt)
      op[4 * dt] = pack_bf16(o[dt][2 * rr] / l, o[dt][2 * rr + 1] / l);
  }
}

template <int D>
int launch_d(const void* q, const void* k, const void* v, void* out, int b, int h, int hk,
             int s, float scale, int causal_skip, int dtype, cudaStream_t stream) {
  if (dtype == rtk::kF32) {
    const dim3 grid(b * h, (s + kRows - 1) / kRows);
    flash_attention_f32_kernel<D><<<grid, kThreads, 0, stream>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<float*>(out), h, hk, s, scale, causal_skip);
    return (int)cudaGetLastError();
  }
  const size_t smem = tc_smem_bytes<D>();
  const cudaError_t err = rtk::allow_smem(flash_attention_tc_kernel<D>, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(b * h, (s + kTcRows - 1) / kTcRows);
  flash_attention_tc_kernel<D><<<grid, kTcThreads, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<bf16*>(out), h, hk, s, scale, causal_skip);
  return (int)cudaGetLastError();
}

}  // namespace

// q, out [B, H, S, D], k, v [B, HK, S, D], all of the activation dtype:
// bf16 on the tensor cores, f32 on the CUDA cores.
extern "C" int tm_flash_attention(const void* q, const void* k, const void* v, void* out, int b,
                                  int h, int hk, int s, int d, float scale, int causal_skip,
                                  int dtype, void* stream) {
  if (b == 0 || s == 0) return 0;
  if (dtype != rtk::kBF16 && dtype != rtk::kF32) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
#define TM_FA_CASE(D) \
  case D:             \
    return launch_d<D>(q, k, v, out, b, h, hk, s, scale, causal_skip, dtype, st);
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
