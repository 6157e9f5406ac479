// Chunked RWKV-6 WKV from a zero state: the prefill's time-mix recurrence.
//
// Replaces: repro/kernels/wkv/kernel.py::wkv_kernel (kernel.py:75,
// pallas_call at :89) around the body _kernel (:27-71).
//
// Computes, for one head (b, hh) with r, k, v, w = log-decay [S, N] and the
// bonus u [N] (head hh of u [H, N]), chunk by chunk of kC = 64 rows, in f32:
//   lc = inclusive cumsum of w over the chunk's rows, e_t = lc_{t-1} (e_0 = 0);
//   A[t, s] = sum_i r[t, i] k[s, i] exp(e[t, i] - lc[s, i])   for s < t;
//   d[t]    = sum_i r[t, i] k[t, i] u[i];
//   y[t, m] = sum_{s<t} A[t, s] v[s, m] + d[t] v[t, m] + sum_i r[t, i] exp(e[t, i]) S_c[i, m];
//   S_{c+1}[i, m] = exp(lc_last[i]) S_c[i, m] + sum_s k[s, i] exp(lc_last[i] - lc[s, i]) v[s, m],
// the same function as the TPU kernel and the plain version
// (repro/models/rwkv.py:105-123), with the sums in another order. S_0 = 0;
// y [B, H, S, N] and the final state [B, H, N, N] are f32.
//
// Any S: the last chunk's rows past S enter with k = v = 0 and w = 0, so
// they add nothing and the state passes through them unchanged. No padded
// copies: the kernels read r, k, v and w through their batch, head and row
// strides (time_mix hands them [B, S, H, N] views as [B, H, S, N]), with
// the last axis contiguous.
//
// Bound on the H100 at [1 * 40, 4000, 64] (bf16 r/k/v, f32 w, y and
// state): 144 MB moved, 43 us at 3.35 TB/s; about 3.1 G f32 operations in
// the least form (chunks of 7 rows, the decay factored at 4; the form
// below takes about 4.3 G), 46 us at 67 TFLOP/s: bound by operations.
//
// Design: three launches on the caller's stream, no atomics, so that two
// calls on the same inputs are bit-equal and one head's result depends on
// that head's inputs and S alone (not on B, H or the strides).
//  1. wkv_chunk_state_kernel, a block per (head, chunk): the chunk's
//     decay-weighted outer products dS_c = (k * exp(lc_last - lc))^T v
//     [N, N] and g_c = exp(lc_last) [N], into scratch. With one chunk
//     (S <= 64) dS_0 is the final state and goes straight to s_out.
//  2. wkv_state_scan_kernel, a thread per (head, i, m .. m + 3): S walks the chunks
//     in order, S_{c+1} = g_c S_c + dS_c, storing each incoming S_c over
//     dS_c in place, and the last S to s_out. It only streams memory.
//     Skipped with one chunk.
//  3. wkv_output_kernel, a block per (head, chunk): A, then y = [A | r *
//     exp(e)] . [v ; S_c] as one register-tiled product (the bonus d on A's
//     diagonal; chunk 0 skips the state). A's exps are cut by factoring the
//     decay at 16-row sub-chunk boundaries: for a key row s in sub-chunk J
//     and a query row t in a later one, with b the last row of J,
//       exp(e_t - lc_s) = exp(e_t - lc_b) * exp(lc_b - lc_s),
//     both exponents <= 0, so nothing overflows at the model's decay clip
//     (-10 a row, where e_t - lc_s reaches -630 within a chunk) and each
//     off-diagonal 16 x 16 block of A is a product of factored r and k. The
//     four diagonal blocks take one expf per pair and channel, as before,
//     only for s < t (the exponent is <= 0 there; s >= t is never formed).
//     That is about 40,000 exps a chunk at N = 64, down from 129,024.
// The cumulative log-decay is a warp-shuffle scan over the rows, one warp
// a channel. The products are register tiles of __fmaf_rn: --fmad=false
// forbids contraction, not the intrinsic; the kernel is held to a
// tolerance against the plain version, not bit for bit. expf, not __expf.
//
// Scratch (chunks > 1): dS [B*H, nc, N, N] and g [B*H, nc, N] f32, right
// after y's B*H*S*N floats in the buffer the caller passes as y (the
// wrapper allocates both in one torch.empty of tm_wkv_buffer_floats; the
// kernels allocate nothing).

#include <math.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kC = 64;                    // rows a chunk
constexpr int kSub = 16;                  // rows a sub-chunk
constexpr int kNSub = kC / kSub;
constexpr int kTS = kC + 4;               // row stride of [channel][row] arrays: 16-byte rows
constexpr int kQfCols = kSub * kNSub * (kNSub - 1) / 2;  // 96: query rows past each key sub-chunk
constexpr int kQfS = kQfCols + 4;
constexpr int kKfCols = kC - kSub;        // 48: key rows with a later sub-chunk
constexpr int kKfS = kKfCols + 4;
constexpr int kTriPairs = kSub * (kSub - 1) / 2;  // 120 pairs s < t in a sub-chunk
constexpr int kScanBatch = 8;             // chunks of dS and g loaded ahead in the state scan

// Float runs of shared or global memory, as one vector access where the
// width allows (callers keep p aligned to the width).
template <int W>
__device__ __forceinline__ void load_vec(const float* p, float (&o)[W]) {
  if constexpr (W == 4) {
    const float4 q = *reinterpret_cast<const float4*>(p);
    o[0] = q.x, o[1] = q.y, o[2] = q.z, o[3] = q.w;
  } else if constexpr (W == 2) {
    const float2 q = *reinterpret_cast<const float2*>(p);
    o[0] = q.x, o[1] = q.y;
  } else {
#pragma unroll
    for (int w = 0; w < W; ++w) o[w] = p[w];
  }
}

template <int W>
__device__ __forceinline__ void store_vec(float* p, const float (&o)[W]) {
  if constexpr (W == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(o[0], o[1], o[2], o[3]);
  } else if constexpr (W == 2) {
    *reinterpret_cast<float2*>(p) = make_float2(o[0], o[1]);
  } else {
#pragma unroll
    for (int w = 0; w < W; ++w) p[w] = o[w];
  }
}

// acc[x][y] += a[x] * b[y]
template <int X, int Y>
__device__ __forceinline__ void outer_fma(float (&acc)[X][Y], const float (&a)[X],
                                          const float (&b)[Y]) {
#pragma unroll
  for (int x = 0; x < X; ++x)
#pragma unroll
    for (int y = 0; y < Y; ++y) acc[x][y] = __fmaf_rn(a[x], b[y], acc[x][y]);
}

// Element j of this thread's share of a chunk, idx = tid + j * kThreads:
// row t = idx / N, channel i = idx % N (consecutive threads, consecutive
// channels), zero past the chunk's rows. The loads are all issued before
// any is used; a bf16 value is widened where it is used, so that holding
// it does not wait for it.
template <typename T, int N, int L>
__device__ __forceinline__ void load_rows(const T* __restrict__ p, long long base, long long ss,
                                          int rows, T (&out)[L]) {
#pragma unroll
  for (int j = 0; j < L; ++j) {
    const int idx = threadIdx.x + j * kThreads, t = idx / N, i = idx - t * N;
    out[j] = t < rows ? p[base + (long long)t * ss + i] : rtk::Num<T>::from_f(0.0f);
  }
}

template <typename T>
__device__ __forceinline__ float widen(T x) {
  return rtk::Num<T>::to_f(x);
}

// lcx [N][kTS] holds lcx[i][0] = 0 and lcx[i][1 + t] = w[t, i] on entry; on
// exit lcx[i][1 + t] = lc[t, i], so lcx[i][t] is e[t, i]. Warp w takes
// channels w, w + 8, ..., all at once: rows lane and 32 + lane of each, a
// Kogge-Stone scan of each half by shuffles, then the first half's total
// added to the second.
template <int N>
__device__ __forceinline__ void scan_rows(float* lcx) {
  constexpr int kWarps = kThreads / 32, kPer = N / kWarps;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  float a[kPer], b[kPer];
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    const float* row = lcx + (warp + j * kWarps) * kTS + 1;
    a[j] = row[lane];
    b[j] = row[32 + lane];
  }
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      const float pa = __shfl_up_sync(0xffffffffu, a[j], o);
      const float pb = __shfl_up_sync(0xffffffffu, b[j], o);
      if (lane >= o) {
        a[j] = __fadd_rn(a[j], pa);
        b[j] = __fadd_rn(b[j], pb);
      }
    }
  }
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    float* row = lcx + (warp + j * kWarps) * kTS + 1;
    row[lane] = a[j];
    row[32 + lane] = __fadd_rn(b[j], __shfl_sync(0xffffffffu, a[j], 31));
  }
}

template <int N>
constexpr size_t state_smem_bytes() {
  return sizeof(float) * (2 * kC * (N + 4) + N * kTS);
}

// Phase 1: dS_c = (k * exp(lc_last - lc))^T v and g_c = exp(lc_last) of
// chunk c of head bh (s_out when the head has one chunk).
template <typename T, int N>
__global__ void __launch_bounds__(kThreads, 3)
    wkv_chunk_state_kernel(const T* __restrict__ k, const T* __restrict__ v,
                           const float* __restrict__ logw, float* __restrict__ ds,
                           float* __restrict__ gd, float* __restrict__ s_out, int h, int s,
                           int nc, long long sb, long long sh, long long ss) {
  constexpr int NS = N + 4, CT = N / 16, kL = kC * N / kThreads;
  extern __shared__ __align__(16) float smem[];
  float* kd = smem;            // [kC][NS] k * exp(lc_last - lc)
  float* vn = kd + kC * NS;    // [kC][NS]
  float* lcx = vn + kC * NS;   // [N][kTS]

  const int bh = blockIdx.x, c = blockIdx.y, tid = threadIdx.x;
  const int b = bh / h, hh = bh - b * h;
  const int c0 = c * kC, rows = min(kC, s - c0);
  const long long base = (long long)b * sb + (long long)hh * sh + (long long)c0 * ss;
  {
    T kv[kL];
    float wv[kL];
    load_rows<T, N>(k, base, ss, rows, kv);
    load_rows<float, N>(logw, base, ss, rows, wv);
#pragma unroll
    for (int j = 0; j < kL; ++j) {
      const int idx = tid + j * kThreads, t = idx / N, i = idx - t * N;
      kd[t * NS + i] = widen(kv[j]);
      lcx[i * kTS + 1 + t] = wv[j];
    }
  }
  if (tid < N) lcx[tid * kTS] = 0.0f;
  // v waits in registers through the scan and the decay factors
  T vv[kL];
  load_rows<T, N>(v, base, ss, rows, vv);
  __syncthreads();
  scan_rows<N>(lcx);
  __syncthreads();
#pragma unroll
  for (int j = 0; j < kL; ++j) {  // in place: each thread its own elements
    const int idx = tid + j * kThreads, t = idx / N, i = idx - t * N;
    const float* li = lcx + i * kTS;
    kd[t * NS + i] = __fmul_rn(kd[t * NS + i], expf(__fsub_rn(li[kC], li[1 + t])));
    vn[t * NS + i] = widen(vv[j]);
  }
  if (nc > 1 && tid < N) gd[((size_t)bh * nc + c) * N + tid] = expf(lcx[tid * kTS + kC]);
  __syncthreads();
  // out[i][m] = sum_s kd[s][i] v[s][m]: a CT x CT tile a thread
  const int i0 = (tid / 16) * CT, m0 = (tid % 16) * CT;
  float acc[CT][CT] = {};
  for (int sr = 0; sr < rows; ++sr) {
    float a[CT], bv[CT];
    load_vec<CT>(kd + sr * NS + i0, a);
    load_vec<CT>(vn + sr * NS + m0, bv);
    outer_fma(acc, a, bv);
  }
  float* out = nc == 1 ? s_out + (size_t)bh * N * N : ds + ((size_t)bh * nc + c) * N * N;
#pragma unroll
  for (int x = 0; x < CT; ++x) store_vec<CT>(out + (i0 + x) * N + m0, acc[x]);
}

// Phase 2: the state entering each chunk, S_0 = 0, S_{c+1} = g_c S_c + dS_c,
// four value columns (head, i, m .. m + 3) a thread, so that each load is
// 16 bytes; S_c replaces dS_c, the last S goes to s_out.
template <int N>
__global__ void __launch_bounds__(kThreads)
    wkv_state_scan_kernel(float* ds, const float* __restrict__ gd, float* __restrict__ s_out,
                          int bh_count, int nc) {
  constexpr int NN = N * N, NQ = NN / 4;
  const long long idx = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (idx >= (long long)bh_count * NQ) return;
  const int bh = (int)(idx / NQ), im = (int)(idx - (long long)bh * NQ) * 4, i = im / N;
  float4* p = reinterpret_cast<float4*>(ds + (size_t)bh * nc * NN + im);
  const float* gp = gd + (size_t)bh * nc * N + i;
  float4 st = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  for (int c0 = 0; c0 < nc; c0 += kScanBatch) {
    float4 d[kScanBatch];
    float g[kScanBatch];
#pragma unroll
    for (int j = 0; j < kScanBatch; ++j) {
      if (c0 + j < nc) {
        d[j] = p[(size_t)(c0 + j) * NQ];
        g[j] = gp[(size_t)(c0 + j) * N];
      }
    }
#pragma unroll
    for (int j = 0; j < kScanBatch; ++j) {
      if (c0 + j < nc) {
        p[(size_t)(c0 + j) * NQ] = st;
        st.x = __fadd_rn(__fmul_rn(g[j], st.x), d[j].x);
        st.y = __fadd_rn(__fmul_rn(g[j], st.y), d[j].y);
        st.z = __fadd_rn(__fmul_rn(g[j], st.z), d[j].z);
        st.w = __fadd_rn(__fmul_rn(g[j], st.w), d[j].w);
      }
    }
  }
  reinterpret_cast<float4*>(s_out + (size_t)bh * NN + im)[0] = st;
}

// The first row of key sub-chunk jb's query block in the stacked columns
// of qf: sub-chunk 0's later rows (48), then sub-chunk 1's (32), then 2's.
__device__ __forceinline__ int qf_offset(int jb) {
  return kSub * (jb * (kNSub - 1) - jb * (jb - 1) / 2);
}

__device__ __forceinline__ int qf_block(int q) {
  int jb = 0;
#pragma unroll
  for (int j = 1; j < kNSub - 1; ++j) jb += q >= qf_offset(j);
  return jb;
}

template <int N>
__host__ __device__ constexpr int output_region() {  // [N][kTS], or [kC][N + 4] once reused for v
  return N * kTS > kC * (N + 4) ? N * kTS : kC * (N + 4);
}

template <int N>
constexpr size_t output_smem_bytes() {
  return sizeof(float) * (3 * output_region<N>() + kC * kTS + N * kQfS + N * kKfS + N);
}

// Phase 3: y of chunk c of head bh from its rows and the state S_c
// entering it (scratch, written over dS_c by phase 2; zero for c = 0).
template <typename T, int N>
__global__ void __launch_bounds__(kThreads, 2)
    wkv_output_kernel(const T* __restrict__ r, const T* __restrict__ k,
                      const T* __restrict__ v, const float* __restrict__ logw,
                      const float* __restrict__ u, const float* __restrict__ s_in,
                      float* __restrict__ y, int h, int s, int nc, long long sb, long long sh,
                      long long ss) {
  constexpr int NS = N + 4, CT = N / 16, kReg = output_region<N>();
  constexpr int kVRegs = kC * N / kThreads, kSRegs = N * N / kThreads;
  extern __shared__ __align__(16) float smem[];
  float* rq = smem;              // [N][kTS] r, then r * exp(e)
  float* ks = rq + kReg;         // [N][kTS] k, then S_c [N][NS]
  float* lcx = ks + kReg;        // [N][kTS] 0, lc_0 .. lc_63; then v [kC][NS]
  float* at = lcx + kReg;        // [kC][kTS] A^T: at[s][t] = A[t][s], d[t] at [t][t]
  float* qf = at + kC * kTS;     // [N][kQfS] r_t exp(e_t - lc_b), stacked by key sub-chunk
  float* kf = qf + N * kQfS;     // [N][kKfS] k_s exp(lc_b - lc_s)
  float* us = kf + N * kKfS;     // [N]
  float* vn = lcx;
  float* sc = ks;

  // the last chunks first: chunk 0 (no state term) is the lightest and
  // fills the last wave
  const int bh = blockIdx.x, c = nc - 1 - (int)blockIdx.y, tid = threadIdx.x;
  const int b = bh / h, hh = bh - b * h;
  const int c0 = c * kC, rows = min(kC, s - c0);
  const long long base = (long long)b * sb + (long long)hh * sh + (long long)c0 * ss;

  const float uv = tid < N ? u[(size_t)hh * N + tid] : 0.0f;
  {
    T rv[kVRegs], kv[kVRegs];
    float wv[kVRegs];
    load_rows<T, N>(r, base, ss, rows, rv);
    load_rows<T, N>(k, base, ss, rows, kv);
    load_rows<float, N>(logw, base, ss, rows, wv);
#pragma unroll
    for (int j = 0; j < kVRegs; ++j) {
      const int idx = tid + j * kThreads, t = idx / N, i = idx - t * N;
      rq[i * kTS + t] = widen(rv[j]);
      ks[i * kTS + t] = widen(kv[j]);
      lcx[i * kTS + 1 + t] = wv[j];
    }
  }
  if (tid < N) {
    lcx[tid * kTS] = 0.0f;
    us[tid] = uv;
  }
  // v and S_c wait in registers until r, k and lc are spent
  T vreg[kVRegs];
  float sreg[kSRegs];
  load_rows<T, N>(v, base, ss, rows, vreg);
  if (c > 0) {
    const float* sp = s_in + ((size_t)bh * nc + c) * N * N;
#pragma unroll
    for (int j = 0; j < kSRegs; ++j) sreg[j] = sp[tid + j * kThreads];
  }
  __syncthreads();
  scan_rows<N>(lcx);
  __syncthreads();

  // A^T above the diagonal is zero; the bonus d sits on it
#pragma unroll
  for (int j = 0; j < kC * kC / kThreads; ++j) {
    const int idx = tid + j * kThreads, sr = idx / kC, t = idx - sr * kC;
    if (sr > t) at[sr * kTS + t] = 0.0f;
  }
  if (tid < kC) {
    float d = 0.0f;
#pragma unroll 8
    for (int i = 0; i < N; ++i)
      d = __fmaf_rn(__fmul_rn(rq[i * kTS + tid], ks[i * kTS + tid]), us[i], d);
    at[tid * kTS + tid] = d;
  }
  // the diagonal sub-chunks' pairs s < t: one expf a pair and channel
  for (int p = tid; p < kNSub * kTriPairs; p += kThreads) {
    const int blk = p / kTriPairs, q = p - blk * kTriPairs;
    int tl = (int)((1.0f + sqrtf(1.0f + 8.0f * (float)q)) * 0.5f);
    while (tl * (tl - 1) / 2 > q) --tl;
    while (tl * (tl + 1) / 2 <= q) ++tl;
    const int t = blk * kSub + tl, sr = blk * kSub + q - tl * (tl - 1) / 2;
    float acc = 0.0f;
#pragma unroll 8
    for (int i = 0; i < N; ++i) {
      const float* li = lcx + i * kTS;
      acc = __fmaf_rn(__fmul_rn(rq[i * kTS + t], ks[i * kTS + sr]),
                      expf(__fsub_rn(li[t], li[1 + sr])), acc);
    }
    at[sr * kTS + t] = acc;
  }
  // the factors of the off-diagonal blocks, b the last row of the key sub-chunk
#pragma unroll
  for (int j = 0; j < kKfCols * N / kThreads; ++j) {
    const int idx = tid + j * kThreads;
    const int i = idx / kKfCols, sr = idx - i * kKfCols, bnd = (sr / kSub + 1) * kSub;
    const float* li = lcx + i * kTS;
    kf[i * kKfS + sr] = __fmul_rn(ks[i * kTS + sr], expf(__fsub_rn(li[bnd], li[1 + sr])));
  }
#pragma unroll
  for (int j = 0; j < kQfCols * N / kThreads; ++j) {
    const int idx = tid + j * kThreads;
    const int i = idx / kQfCols, q = idx - i * kQfCols, jb = qf_block(q);
    const int bnd = (jb + 1) * kSub, t = bnd + q - qf_offset(jb);
    const float* li = lcx + i * kTS;
    qf[i * kQfS + q] = __fmul_rn(rq[i * kTS + t], expf(__fsub_rn(li[t], li[bnd])));
  }
  __syncthreads();

  // the off-diagonal 16 x 16 blocks of A: 4 query rows x 2 key rows a thread
  if (tid < (kQfCols / 4) * (kSub / 2)) {
    const int q0 = (tid / (kSub / 2)) * 4, jb = qf_block(q0);
    const int t0 = (jb + 1) * kSub + q0 - qf_offset(jb);
    const int s0 = jb * kSub + (tid % (kSub / 2)) * 2;
    float acc[4][2] = {};
#pragma unroll 8
    for (int i = 0; i < N; ++i) {
      float a[4], bk[2];
      load_vec<4>(qf + i * kQfS + q0, a);
      load_vec<2>(kf + i * kKfS + s0, bk);
      outer_fma(acc, a, bk);
    }
#pragma unroll
    for (int x = 0; x < 4; ++x)
#pragma unroll
      for (int yy = 0; yy < 2; ++yy) at[(s0 + yy) * kTS + t0 + x] = acc[x][yy];
  }
  if (c > 0) {  // r * exp(e) over r, and S_c over k
#pragma unroll
    for (int j = 0; j < kC * N / kThreads; ++j) {
      const int idx = tid + j * kThreads, i = idx / kC, t = idx - i * kC;
      rq[i * kTS + t] = __fmul_rn(rq[i * kTS + t], expf(lcx[i * kTS + t]));
    }
#pragma unroll
    for (int j = 0; j < kSRegs; ++j) {
      const int idx = tid + j * kThreads, i = idx / N, m = idx - i * N;
      sc[i * NS + m] = sreg[j];
    }
  }
  __syncthreads();  // lc is spent
#pragma unroll
  for (int j = 0; j < kVRegs; ++j) {
    const int idx = tid + j * kThreads, t = idx / N, i = idx - t * N;
    vn[t * NS + i] = widen(vreg[j]);
  }
  __syncthreads();

  // y = A v + (r * exp(e)) S_c: rows t0 .. t0 + 3, value columns m0 .. m0 + CT - 1
  const int tr = tid / 16, t0 = tr * 4, m0 = (tid % 16) * CT;
  const int s_end = ((tr | 1) + 1) * 4;  // the warp's last row + 1: A[t][s] = 0 for s > t
  float acc[4][CT] = {};
  for (int sr = 0; sr < s_end; ++sr) {
    float a[4], bv[CT];
    load_vec<4>(at + sr * kTS + t0, a);
    load_vec<CT>(vn + sr * NS + m0, bv);
    outer_fma(acc, a, bv);
  }
  if (c > 0) {
#pragma unroll 4
    for (int i = 0; i < N; ++i) {
      float a[4], bs[CT];
      load_vec<4>(rq + i * kTS + t0, a);
      load_vec<CT>(sc + i * NS + m0, bs);
      outer_fma(acc, a, bs);
    }
  }
#pragma unroll
  for (int x = 0; x < 4; ++x)
    if (t0 + x < rows) store_vec<CT>(y + ((size_t)bh * s + c0 + t0 + x) * N + m0, acc[x]);
}

int chunks(int s) { return (s + kC - 1) / kC; }

template <typename T, int N>
int launch_n(const void* r, const void* k, const void* v, const float* logw, const float* u,
             float* y, float* s_out, int bh, int h, int s, long long sb, long long sh,
             long long ss, cudaStream_t stream) {
  const int nc = chunks(s);
  if (nc > 65535) return (int)cudaErrorInvalidValue;
  float* ds = y + (size_t)bh * s * N;            // scratch after y: dS, then g
  float* gd = ds + (size_t)bh * nc * N * N;      // (tm_wkv_buffer_floats: the same layout)
  const T* rr = static_cast<const T*>(r);
  const T* kk = static_cast<const T*>(k);
  const T* vv = static_cast<const T*>(v);
  constexpr size_t smem1 = state_smem_bytes<N>(), smem3 = output_smem_bytes<N>();
  cudaError_t err = rtk::allow_smem(wkv_chunk_state_kernel<T, N>, smem1);
  if (err == cudaSuccess) err = rtk::allow_smem(wkv_output_kernel<T, N>, smem3);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(bh, nc);
  wkv_chunk_state_kernel<T, N><<<grid, kThreads, smem1, stream>>>(
      kk, vv, logw, ds, gd, s_out, h, s, nc, sb, sh, ss);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  if (nc > 1) {
    const long long chains = (long long)bh * N * N / 4;  // four columns a thread
    wkv_state_scan_kernel<N><<<(unsigned)((chains + kThreads - 1) / kThreads), kThreads, 0,
                               stream>>>(ds, gd, s_out, bh, nc);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  wkv_output_kernel<T, N><<<grid, kThreads, smem3, stream>>>(rr, kk, vv, logw, u, ds, y, h, s,
                                                            nc, sb, sh, ss);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const void* r, const void* k, const void* v, const float* logw, const float* u,
           float* y, float* s_out, int bh, int h, int s, int n, long long sb, long long sh,
           long long ss, cudaStream_t stream) {
  if (bh == 0) return 0;
  if (s == 0)  // no row: the final state is the zero state
    return (int)cudaMemsetAsync(s_out, 0, sizeof(float) * (size_t)bh * n * n, stream);
  switch (n) {
    case 16:
      return launch_n<T, 16>(r, k, v, logw, u, y, s_out, bh, h, s, sb, sh, ss, stream);
    case 32:
      return launch_n<T, 32>(r, k, v, logw, u, y, s_out, bh, h, s, sb, sh, ss, stream);
    case 64:
      return launch_n<T, 64>(r, k, v, logw, u, y, s_out, bh, h, s, sb, sh, ss, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// r, k, v [B, H, S, N] of the activation dtype and logw [B, H, S, N] f32,
// all four with the element strides sb, sh, ss and a contiguous last axis;
// u [H, N] f32; s_out [B, H, N, N] f32, contiguous. y is a contiguous f32
// buffer of tm_wkv_buffer_floats(B*H, S, N) floats: y [B, H, S, N] and,
// when S > 64, the scratch after it.
extern "C" int tm_wkv(const void* r, const void* k, const void* v, const void* logw,
                      const void* u, void* y, void* s_out, int bh, int h, int s, int n,
                      long long sb, long long sh, long long ss, int dtype, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* w = static_cast<const float*>(logw);
  const float* uu = static_cast<const float*>(u);
  float* yy = static_cast<float*>(y);
  float* so = static_cast<float*>(s_out);
  if (dtype == rtk::kBF16)
    return launch<__nv_bfloat16>(r, k, v, w, uu, yy, so, bh, h, s, n, sb, sh, ss, st);
  if (dtype == rtk::kF32) return launch<float>(r, k, v, w, uu, yy, so, bh, h, s, n, sb, sh, ss, st);
  return (int)cudaErrorInvalidValue;
}

// Floats of the buffer that tm_wkv takes as y, for bh heads of s rows and
// head size n: y [bh, s, n], then, past one chunk, dS [bh, nc, n, n] and
// g [bh, nc, n] (launch_n places them so).
extern "C" long long tm_wkv_buffer_floats(int bh, int s, int n) {
  const long long nc = chunks(s);
  return (long long)bh * s * n + (nc > 1 ? (long long)bh * nc * ((long long)n * n + n) : 0);
}
