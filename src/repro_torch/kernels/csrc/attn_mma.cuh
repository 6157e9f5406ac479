// The warp-level walk of the bf16 tensor-core attention kernels (sm_90a):
// flash attention (flash_attention.cu, the one-shot prefill) and the
// chunked prefill-append (prefill_append.cu).
//
// A block has 4 warps and 64 query rows, 16 a warp; each warp holds its
// rows' Q as mma.sync.m16n8k16 A fragments in registers for the whole walk.
// K and V are bf16 tiles of 64 rows in shared memory, rows padded by 16
// bytes (D + 8 elements) so that the eight rows an ldmatrix reads fall on
// distinct banks. Per tile: S = Q.K^T on the tensor cores (f32
// accumulators); scale, optional softcap and the -1e30 mask on the
// accumulator fragments; the online softmax with m and l in f32 and
// expf(s - m) (a row's max and sum over the quad of lanes that share it);
// P rounded to bf16 in registers as the A operand of O += P.V, V read with
// ldmatrix.trans. The finalize writes T(o / max(l, 1e-30)).
//
// Fragment layout (PTX ISA, m16n8k16): lane = 4 * gq + tig; an S or O
// n-tile j holds elements 0, 1 at row gq, columns 8j + 2 tig + {0, 1}, and
// elements 2, 3 at row gq + 8.
#pragma once

#include <math.h>

#include "common.cuh"

namespace rtk {
namespace attn {

using bf16 = __nv_bfloat16;

constexpr float kNegInf = -1e30f;
constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kRows = 16 * kWarps;  // query rows per block, 16 a warp
constexpr int kKeys = 64;           // kv rows per tile
constexpr int kKTiles = kKeys / 8;  // n-tiles of Q.K^T

template <int D>
struct Shape {
  static constexpr int kStride = D + 8;          // elements per shared row
  static constexpr int kTile = kKeys * kStride;  // elements per K or V tile
};

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&p);
}

// 64 rows of D bf16 into a padded tile by cp.async: row r is row
// row_of(r, ok) of base (zeros where ok comes back false). Every thread of
// the block takes part.
template <int D, class RowOf>
__device__ __forceinline__ void stage_rows(bf16* dst, const bf16* __restrict__ base,
                                           RowOf row_of) {
  constexpr int kChunks = D / 8;  // 16-byte chunks per row
  static_assert(kKeys * kChunks % kThreads == 0, "whole rounds of chunks");
#pragma unroll
  for (int it = 0; it < kKeys * kChunks / kThreads; ++it) {
    const int c = threadIdx.x + it * kThreads;
    const int r = c / kChunks, col = (c - r * kChunks) * 8;
    bool ok;
    const size_t row = row_of(r, ok);
    cp_async16(dst + r * (D + 8) + col, base + row * D + col, ok);
  }
}

// The K and V tiles of the same 64 rows, as stage_rows: row row_of(r, ok)
// of kbase into kd and of vbase into vd, the row resolved once for both.
template <int D, class RowOf>
__device__ __forceinline__ void stage_kv_rows(bf16* kd, bf16* vd, const bf16* __restrict__ kbase,
                                              const bf16* __restrict__ vbase, RowOf row_of) {
  constexpr int kChunks = D / 8;
  static_assert(kKeys * kChunks % kThreads == 0, "whole rounds of chunks");
#pragma unroll
  for (int it = 0; it < kKeys * kChunks / kThreads; ++it) {
    const int c = threadIdx.x + it * kThreads;
    const int r = c / kChunks, col = (c - r * kChunks) * 8;
    bool ok;
    const size_t row = row_of(r, ok);
    cp_async16(kd + r * (D + 8) + col, kbase + row * D + col, ok);
    cp_async16(vd + r * (D + 8) + col, vbase + row * D + col, ok);
  }
}

// The warp's 16 query rows (from row wrow of a staged tile) as A fragments.
template <int D>
__device__ __forceinline__ void load_q(uint32_t (&qf)[D / 16][4], const bf16* tile, int wrow) {
  const int lane = threadIdx.x & 31, mi = lane >> 3, mr = lane & 7;
  const bf16* base = tile + (wrow + (mi & 1) * 8 + mr) * (D + 8) + (mi >> 1) * 8;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) ldmatrix_x4<false>(qf[kk], base + kk * 16);
}

// S = Q.K^T against a staged K tile: sc[j] holds keys 8j .. 8j + 7.
template <int D>
__device__ __forceinline__ void qk(float (&sc)[kKTiles][4], const uint32_t (&qf)[D / 16][4],
                                   const bf16* kt) {
  const int lane = threadIdx.x & 31, mi = lane >> 3, mr = lane & 7;
#pragma unroll
  for (int j = 0; j < kKTiles; ++j) sc[j][0] = sc[j][1] = sc[j][2] = sc[j][3] = 0.0f;
  const bf16* base = kt + ((mi >> 1) * 8 + mr) * (D + 8) + (mi & 1) * 8;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
#pragma unroll
    for (int np = 0; np < kKTiles / 2; ++np) {
      uint32_t kf[4];
      ldmatrix_x4<false>(kf, base + np * 16 * (D + 8) + kk * 16);
      mma_bf16(sc[2 * np], qf[kk], kf[0], kf[1]);
      mma_bf16(sc[2 * np + 1], qf[kk], kf[2], kf[3]);
    }
}

// s * scale, softcap * tanh(s / softcap) when softcap > 0, and, on a
// masked tile, -1e30 wherever live(col, rr) is false: col is the key's
// column in the tile (0..63), rr = 0 the lane's row gq, rr = 1 row gq + 8.
template <class Live>
__device__ __forceinline__ void scale_mask(float (&sc)[kKTiles][4], float scale, float softcap,
                                           bool masked, Live live) {
  const int tig = threadIdx.x & 3;
#pragma unroll
  for (int j = 0; j < kKTiles; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float x = sc[j][e] * scale;
      if (softcap > 0.0f) x = softcap * tanhf(x / softcap);
      sc[j][e] = masked && !live(8 * j + 2 * tig + (e & 1), e >> 1) ? kNegInf : x;
    }
}

// Online softmax of the lane's two rows over one tile: sc becomes the
// probabilities, m, l and o are updated. A fully masked tile gives
// alpha = expf(0) = 1 and p = 0 exactly, so it adds nothing.
template <int D>
__device__ __forceinline__ void online_softmax(float (&sc)[kKTiles][4], float (&m_run)[2],
                                               float (&l_run)[2], float (&o)[D / 8][4]) {
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
  for (int dt = 0; dt < D / 8; ++dt) {
    o[dt][0] *= alpha[0];
    o[dt][1] *= alpha[0];
    o[dt][2] *= alpha[1];
    o[dt][3] *= alpha[1];
  }
}

// O += P.V: P in bf16 is the A operand as the accumulators lie (keys
// 16 kk .. + 15 are n-tiles 2 kk and 2 kk + 1); V via ldmatrix.trans.
template <int D>
__device__ __forceinline__ void pv(float (&o)[D / 8][4], const float (&sc)[kKTiles][4],
                                   const bf16* vt) {
  const int lane = threadIdx.x & 31, mi = lane >> 3, mr = lane & 7;
  const bf16* base = vt + ((mi & 1) * 8 + mr) * (D + 8) + (mi >> 1) * 8;
#pragma unroll
  for (int kk = 0; kk < kKeys / 16; ++kk) {
    const uint32_t pa[4] = {pack_bf16(sc[2 * kk][0], sc[2 * kk][1]),
                            pack_bf16(sc[2 * kk][2], sc[2 * kk][3]),
                            pack_bf16(sc[2 * kk + 1][0], sc[2 * kk + 1][1]),
                            pack_bf16(sc[2 * kk + 1][2], sc[2 * kk + 1][3])};
#pragma unroll
    for (int dp = 0; dp < D / 16; ++dp) {
      uint32_t vf[4];
      ldmatrix_x4<true>(vf, base + kk * 16 * (D + 8) + dp * 16);
      mma_bf16(o[2 * dp], pa, vf[0], vf[1]);
      mma_bf16(o[2 * dp + 1], pa, vf[2], vf[3]);
    }
  }
}

// The finalize of the lane's row rr into row (the output row's first
// element): bf16(o / max(l, 1e-30)).
template <int D>
__device__ __forceinline__ void store_row(bf16* row, const float (&o)[D / 8][4], int rr,
                                          float l_run) {
  const float l = fmaxf(l_run, 1e-30f);
  uint32_t* op = reinterpret_cast<uint32_t*>(row + 2 * (threadIdx.x & 3));
#pragma unroll
  for (int dt = 0; dt < D / 8; ++dt)
    op[4 * dt] = pack_bf16(o[dt][2 * rr] / l, o[dt][2 * rr + 1] / l);
}

}  // namespace attn
}  // namespace rtk
