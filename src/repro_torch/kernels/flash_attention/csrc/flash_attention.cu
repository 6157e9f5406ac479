// Causal attention over a whole prompt: the one-shot prefill's attention.
//
// Replaces: repro/kernels/flash_attention/kernel.py::flash_attention_kernel
// (kernel.py:101, pallas_call at :126) around the body _kernel (:35-98).
//
// Computes, for q, k [B, H|HK, S, DQK] and v [B, HK, S, DV] (H % HK == 0;
// head hh of slot b reads kv head b*HK + hh / G, G = H / HK, the TPU
// kernel's index map at kernel.py:131-134; DV may differ from DQK, as MLA's
// decompressed heads have it: DQK = 192, DV = 128): out [B, H, S, DV],
// s = (q . k) * scale in f32 (the caller's scale, kernel.py:111), capped as
// softcap * tanh(s / softcap) when softcap > 0, then the -1e30 mask above the
// diagonal and, with a sliding window > 0, at qpos - kpos >= window
// (kernel.py:68-75: the softcap before the mask), online softmax with m and
// l in f32 and expf(s - m) (as the plain version takes it), probabilities
// cast to T before P.V, out = T(acc / max(l, 1e-30)).
// causal_skip = 1 visits only the kv tiles from the tile that holds the
// block's window foot, max(r0 - window + 1, 0) (0 without a window), up to
// the block's causal frontier: the paper's causal-skip schedule (Table II)
// and the TPU kernel's window skip (kernel.py:49-54); the tiles at the foot
// and on the diagonal are masked element by element. 0 visits every tile
// and masks each element, the dense ablation: the same output bit for bit
// (a fully masked tile adds exact zeros with alpha = 1), about twice the
// work. Any S: a ragged last tile is masked, nothing is padded.
//
// Bound on the H100: at S = 4096, D = 96, 16 heads, the live causal pairs
// are 16 * 4096 * 4097 / 2 = 134 M, 4 * D flops each: 51.6 GFLOP, 52 us on
// the bf16 tensor cores (989 TFLOP/s); q, k, v and out are 50 MB, 15 us.
// Long prompts are bound by operations, short ones (S = 128) by bytes and
// launch. With a window W < S the live pairs fall to about S * W a head
// (gemma2's local layers: W = 4096), and so does the walk.
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
// past a warp's first row, past S, or below its last row's window foot are
// masked elementwise. The warp-level
// walk (fragments, mask, online softmax, P.V, finalize) is attn_mma.cuh's,
// shared with the chunked prefill-append.
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
// fill the tail. The head dims are template arguments (DQK, DV): (D, D) for
// D = 16, 32, 64, 96 and 128, and (192, 128); the wrapper zero-pads any other
// pair up to an instantiated one (zero columns add exact zeros to q . k and
// give zero output columns, which it slices off). At (192, 128) the bf16
// kernel's K/V ring is 84 KB of shared memory, above the 48 KB default, so
// the launch raises the block's dynamic shared-memory limit first.

#include <math.h>

#include "attn_mma.cuh"
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

template <int DQK, int DV>
__global__ void __launch_bounds__(kThreads)
    flash_attention_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                               const float* __restrict__ v, float* __restrict__ out, int h,
                               int hk, int s, float scale, int window, float softcap,
                               int causal_skip) {
  constexpr int kDq = DQK / kQuad;  // q . k dims per thread
  constexpr int kDp = DV / kQuad;   // output dims per thread
  __shared__ __align__(16) float k_s[kTk * DQK];
  __shared__ __align__(16) float v_s[kTk * DV];

  const int bh = blockIdx.x, tid = threadIdx.x;
  const int b = bh / h;
  const int kvh = b * hk + (bh - b * h) / (h / hk);
  const int part = tid & (kQuad - 1);
  const int r0 = (gridDim.y - 1 - blockIdx.y) * kRows;  // last query tile first
  const int row = r0 + tid / kQuad;
  const bool row_ok = row < s;
  const int qpos = row_ok ? row : s - 1;  // idle threads shadow the last row
  const float* kb = k + (size_t)kvh * s * DQK;
  const float* vb = v + (size_t)kvh * s * DV;

  float qr[kDq], acc[kDp];
  {
    const float* qp = q + ((size_t)bh * s + qpos) * DQK + part * kDq;
#pragma unroll
    for (int e = 0; e < kDq; ++e) qr[e] = qp[e];
#pragma unroll
    for (int e = 0; e < kDp; ++e) acc[e] = 0.0f;
  }
  float m_run = kNegInf, l_run = 0.0f;

  // Online-softmax update of this thread's row over the tile in shared
  // memory: its rows j < n sit at key positions kpos0 + j.
  auto update = [&](int kpos0, int n) {
    float sc[kTk];
    float tmax = kNegInf;
#pragma unroll
    for (int j = 0; j < kTk; ++j) {
      const float4* kr = reinterpret_cast<const float4*>(k_s + j * DQK + part * kDq);
      float dot = 0.0f;
#pragma unroll
      for (int e = 0; e < kDq / 4; ++e) {
        const float4 kv = kr[e];
        dot = fmaf(qr[4 * e], kv.x, dot);
        dot = fmaf(qr[4 * e + 1], kv.y, dot);
        dot = fmaf(qr[4 * e + 2], kv.z, dot);
        dot = fmaf(qr[4 * e + 3], kv.w, dot);
      }
      dot += __shfl_xor_sync(0xffffffffu, dot, 1);
      dot += __shfl_xor_sync(0xffffffffu, dot, 2);
      const int kpos = kpos0 + j;
      float x = dot * scale;
      if (softcap > 0.0f) x = softcap * tanhf(x / softcap);
      const bool live = j < n && kpos <= qpos && (window <= 0 || qpos - kpos < window);
      sc[j] = live ? x : kNegInf;
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
      const float4* vr = reinterpret_cast<const float4*>(v_s + j * DV + part * kDp);
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

  // kv rows from the tile of the block's window foot up to its last query
  // row, or every row for the dense schedule
  const int lo = causal_skip && window > 0 ? max(r0 - window + 1, 0) / kTk * kTk : 0;
  const int hi = causal_skip ? min(r0 + kRows, s) : s;
  for (int t0 = lo; t0 < hi; t0 += kTk) {
    const int n = min(kTk, s - t0);
    __syncthreads();  // the previous tile is consumed
    load_tile<DQK>(kb + (size_t)t0 * DQK, n, k_s);
    load_tile<DV>(vb + (size_t)t0 * DV, n, v_s);
    __syncthreads();
    update(t0, n);
  }

  if (row_ok) {
    float* op = out + ((size_t)bh * s + row) * DV + part * kDp;
    const float l = fmaxf(l_run, 1e-30f);
#pragma unroll
    for (int e = 0; e < kDp; ++e) op[e] = acc[e] / l;
  }
}

// ---------------------------------------------------------------------------
// bf16: tensor cores (the warp-level walk is attn_mma.cuh's)
// ---------------------------------------------------------------------------

namespace attn = rtk::attn;

// Shared memory of one block: K and V, two stages each, padded rows.
template <int DQK, int DV>
constexpr size_t tc_smem_bytes() {
  return (size_t)2 * (attn::Shape<DQK>::kTile + attn::Shape<DV>::kTile) * sizeof(bf16);
}

template <int DQK, int DV>
__global__ void __launch_bounds__(attn::kThreads)
    flash_attention_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                              const bf16* __restrict__ v, bf16* __restrict__ out, int h, int hk,
                              int s, float scale, int window, float softcap, int causal_skip) {
  constexpr int kTileK = attn::Shape<DQK>::kTile, kTileV = attn::Shape<DV>::kTile;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* ks = reinterpret_cast<bf16*>(smem);   // [2][kKeys][DQK + 8]
  bf16* vs = ks + 2 * kTileK;                 // [2][kKeys][DV + 8]

  const int bh = blockIdx.x, b = bh / h;
  const int kvh = b * hk + (bh - b * h) / (h / hk);
  const int r0 = (gridDim.y - 1 - blockIdx.y) * attn::kRows;  // last query tile first
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wrow = 16 * warp;               // the warp's first row in the block
  const int qrow = r0 + wrow + (lane >> 2);  // this lane's rows: qrow and qrow + 8
  const bf16* kb = k + (size_t)kvh * s * DQK;
  const bf16* vb = v + (size_t)kvh * s * DV;
  // kv tiles from the one that holds the block's window foot (tile 0
  // without a window, or for the dense schedule) up to the causal frontier
  const int it0 = causal_skip && window > 0 ? max(r0 - window + 1, 0) / attn::kKeys : 0;
  const int hi = causal_skip ? min(r0 + attn::kRows, s) : s;
  const int ntiles = (hi + attn::kKeys - 1) / attn::kKeys;
  const int wlast = r0 + wrow + 15;  // the warp's last row
  // rows t0 .. t0 + 63 of a [S, D] matrix, zeros at rows >= s
  auto rows_from = [s](int t0) {
    return [s, t0](int r, bool& ok) -> size_t {
      ok = t0 + r < s;
      return ok ? t0 + r : 0;
    };
  };

  // K and V rows t0 .. t0 + 63 into stage st (one pass when the dims agree)
  auto stage_kv = [&](int st, int t0) {
    if constexpr (DQK == DV) {
      attn::stage_kv_rows<DQK>(ks + st * kTileK, vs + st * kTileV, kb, vb, rows_from(t0));
    } else {
      attn::stage_rows<DQK>(ks + st * kTileK, kb, rows_from(t0));
      attn::stage_rows<DV>(vs + st * kTileV, vb, rows_from(t0));
    }
  };

  // Q goes through stage 1's K buffer, into registers as A fragments.
  attn::stage_rows<DQK>(ks + kTileK, q + (size_t)bh * s * DQK, rows_from(r0));
  stage_kv(0, it0 * attn::kKeys);
  rtk::cp_async_commit();
  rtk::cp_async_wait<0>();
  __syncthreads();
  uint32_t qf[DQK / 16][4];
  attn::load_q<DQK>(qf, ks + kTileK, wrow);
  __syncthreads();  // stage 1 is free for tile 1

  float o[DV / 8][4];
#pragma unroll
  for (int dt = 0; dt < DV / 8; ++dt) o[dt][0] = o[dt][1] = o[dt][2] = o[dt][3] = 0.0f;
  float m_run[2] = {attn::kNegInf, attn::kNegInf}, l_run[2] = {0.0f, 0.0f};

  for (int it = it0; it < ntiles; ++it) {
    const int t0 = it * attn::kKeys, st = (it - it0) & 1;
    if (it + 1 < ntiles) stage_kv(st ^ 1, t0 + attn::kKeys);
    rtk::cp_async_commit();
    rtk::cp_async_wait<1>();  // this tile has landed; the next may be in flight
    __syncthreads();
    float sc[attn::kKTiles][4];
    attn::qk<DQK>(sc, qf, ks + st * kTileK);
    // mask the tiles that reach past the warp's first row or past S, and
    // those that reach below its last row's window foot
    const bool masked = t0 + attn::kKeys - 1 > r0 + wrow || t0 + attn::kKeys > s ||
                        (window > 0 && wlast - t0 >= window);
    attn::scale_mask(sc, scale, softcap, masked, [&](int col, int rr) {
      const int key = t0 + col, row = qrow + 8 * rr;
      return key <= row && key < s && (window <= 0 || row - key < window);
    });
    attn::online_softmax<DV>(sc, m_run, l_run, o);
    attn::pv<DV>(o, sc, vs + st * kTileV);
    __syncthreads();  // the stage is consumed before the next load refills it
  }

#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    const int row = qrow + 8 * rr;
    if (row < s) attn::store_row<DV>(out + ((size_t)bh * s + row) * DV, o, rr, l_run[rr]);
  }
}

template <int DQK, int DV>
int launch_d(const void* q, const void* k, const void* v, void* out, int b, int h, int hk,
             int s, float scale, int window, float softcap, int causal_skip, int dtype,
             cudaStream_t stream) {
  if (dtype == rtk::kF32) {
    const dim3 grid(b * h, (s + kRows - 1) / kRows);
    flash_attention_f32_kernel<DQK, DV><<<grid, kThreads, 0, stream>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<float*>(out), h, hk, s, scale, window, softcap,
        causal_skip);
    return (int)cudaGetLastError();
  }
  const size_t smem = tc_smem_bytes<DQK, DV>();
  const cudaError_t err = rtk::allow_smem(flash_attention_tc_kernel<DQK, DV>, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(b * h, (s + attn::kRows - 1) / attn::kRows);
  flash_attention_tc_kernel<DQK, DV><<<grid, attn::kThreads, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<bf16*>(out), h, hk, s, scale, window, softcap, causal_skip);
  return (int)cudaGetLastError();
}

}  // namespace

// q [B, H, S, DQK], k [B, HK, S, DQK], v [B, HK, S, DV], out [B, H, S, DV],
// all of the activation dtype: bf16 on the tensor cores, f32 on the CUDA
// cores. (DQK, DV) must be an instantiated pair. window (0 = none) and
// softcap (0 = none) as above.
extern "C" int tm_flash_attention(const void* q, const void* k, const void* v, void* out, int b,
                                  int h, int hk, int s, int dqk, int dv, float scale, int window,
                                  float softcap, int causal_skip, int dtype, void* stream) {
  if (b == 0 || s == 0) return 0;
  if (dtype != rtk::kBF16 && dtype != rtk::kF32) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
#define TM_FA_CASE(DQK, DV)                                                                 \
  if (dqk == DQK && dv == DV)                                                                \
    return launch_d<DQK, DV>(q, k, v, out, b, h, hk, s, scale, window, softcap, causal_skip, \
                             dtype, st);
  TM_FA_CASE(16, 16)
  TM_FA_CASE(32, 32)
  TM_FA_CASE(64, 64)
  TM_FA_CASE(96, 96)
  TM_FA_CASE(128, 128)
  TM_FA_CASE(192, 128)
#undef TM_FA_CASE
  return (int)cudaErrorInvalidValue;
}
