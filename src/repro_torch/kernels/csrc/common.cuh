// Shared device helpers of the port's CUDA kernels (H100, sm_90a).
//
// Every kernel here reproduces the rounding points of the JAX reference:
// a value the reference holds in the activation dtype T (bf16 or f32) is
// rounded to T at the same place (`round_to<T>`), float arithmetic runs in
// IEEE f32 with no contraction (the build passes --fmad=false, and the
// epilogues spell __fmul_rn/__fadd_rn out), and int8 codes are rounded half
// to even with rintf, as jnp.round does.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace rtk {

enum DType : int { kF32 = 0, kBF16 = 1 };

template <typename T> struct Num;
template <> struct Num<float> {
  static __device__ __forceinline__ float to_f(float v) { return v; }
  static __device__ __forceinline__ float from_f(float v) { return v; }
};
template <> struct Num<__nv_bfloat16> {
  static __device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }
  static __device__ __forceinline__ __nv_bfloat16 from_f(float v) { return __float2bfloat16_rn(v); }
};

// f32 value rounded to T and back: the reference's `.astype(T)`.
template <typename T>
__device__ __forceinline__ float round_to(float v) {
  return Num<T>::to_f(Num<T>::from_f(v));
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// Block-wide sum or max of non-negative values (identity 0). blockDim.x is
// a multiple of 32; `red` holds 32 floats of shared memory. Every thread
// gets the result.
template <bool kMax>
__device__ __forceinline__ float block_reduce(float v, float* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  v = kMax ? warp_max(v) : warp_sum(v);
  __syncthreads();  // `red` may still be read by a previous reduction
  if (lane == 0) red[warp] = v;
  __syncthreads();
  if (warp == 0) {
    float r = lane < nwarps ? red[lane] : 0.0f;
    r = kMax ? warp_max(r) : warp_sum(r);
    if (lane == 0) red[0] = r;
  }
  __syncthreads();
  return red[0];
}

// quantize_act's scale (ternary.py:77-80) in the activation dtype T:
// max(absmax, T(1e-8)) / 127, rounded to T.
template <typename T>
__device__ __forceinline__ float act_scale(float amax) {
  const float eps = round_to<T>(1e-8f);
  return round_to<T>(__fdiv_rn(fmaxf(amax, eps), 127.0f));
}

// quantize_act's code (ternary.py:84-85): x / scale rounded to T, then
// half-to-even, clipped to ±127.
template <typename T>
__device__ __forceinline__ int8_t act_code(float y, float scale) {
  float q = rintf(round_to<T>(__fdiv_rn(y, scale)));
  return (int8_t)fminf(fmaxf(q, -127.0f), 127.0f);
}

// dequantize_kv (ternary.py:102): an int8 KV-cache code times its row's f32
// scale, in f32, rounded once to the attention dtype T.
template <typename T>
__device__ __forceinline__ float kv_dequant(int8_t code, float scale) {
  return round_to<T>(__fmul_rn((float)code, scale));
}

// Per-row absmax int8 of a row already rounded to T: `yval(i)` returns
// element i as float. Writes the codes to q[0..n) and the scale to *qs.
template <typename T, class F>
__device__ __forceinline__ void quantize_row(F yval, int n, int8_t* q, float* qs,
                                             float* red) {
  float amax = 0.0f;
  for (int i = threadIdx.x; i < n; i += blockDim.x) amax = fmaxf(amax, fabsf(yval(i)));
  const float scale = act_scale<T>(block_reduce<true>(amax, red));
  for (int i = threadIdx.x; i < n; i += blockDim.x) q[i] = act_code<T>(yval(i), scale);
  if (threadIdx.x == 0) *qs = scale;
}

// A 4x4 byte transpose: out[t] = (byte t of a, of b, of c, of d).
template <typename W>
__device__ __forceinline__ void transpose_bytes4(unsigned a, unsigned b, unsigned c, unsigned d,
                                                 W* out) {
  const unsigned ab_lo = __byte_perm(a, b, 0x5140), ab_hi = __byte_perm(a, b, 0x7362);
  const unsigned cd_lo = __byte_perm(c, d, 0x5140), cd_hi = __byte_perm(c, d, 0x7362);
  out[0] = (W)__byte_perm(ab_lo, cd_lo, 0x5410);
  out[1] = (W)__byte_perm(ab_lo, cd_lo, 0x7632);
  out[2] = (W)__byte_perm(ab_hi, cd_hi, 0x5410);
  out[3] = (W)__byte_perm(ab_hi, cd_hi, 0x7632);
}

// Where logical row r of (slot b = bh / hk, kv head h = bh % hk) lives, as
// an index of rows of D elements (and of the int8 cache's row scales): row
// bh * m + r of a contiguous cache [B*HK, M], or, through the page table pt
// [B, NB] int32, row (pt[b, r / ps] * HK + h) * ps + r % ps of a page pool
// [P*HK, ps] (the paged layout, repro/core/ternary.py:163-204).
template <bool kPaged>
__device__ __forceinline__ size_t kv_row(const int* __restrict__ pt, int bh, int hk, int m,
                                         int nb, int ps, int r) {
  if constexpr (kPaged) {
    const int b = bh / hk;
    return ((size_t)pt[b * nb + r / ps] * hk + (bh - b * hk)) * ps + r % ps;
  } else {
    return (size_t)bh * m + r;
  }
}

// Table-lookup (TL) engine, paper Algorithm 1 with G = 3: a group of three
// int8 activations (a0, a1, a2) has 27 table entries, entry c being
// sum_i a_i * (digit_i(c) - 1) with digit_i the base-3 digits of c
// (repro/core/packing.py combo_matrix, repro/core/tl_matmul.py
// build_tables). |entry| <= 381, an exact integer. Index 13 is the group
// of three zero trits, whose entry is 0: the pad column.
constexpr int kTlGroup = 3, kTlCombos = 27, kTlZeroGroup = 13;

__device__ __forceinline__ int tl_entry(int a0, int a1, int a2, int c) {
  const int d2 = c / 9, d1 = (c - 9 * d2) / 3, d0 = c - 9 * d2 - 3 * d1;
  return a0 * (d0 - 1) + a1 * (d1 - 1) + a2 * (d2 - 1);
}

// The three activations of group t of row xr [n] (zero past n: a ragged
// last group is padded with zero activations, after the norm).
__device__ __forceinline__ void tl_group(const int8_t* xr, int n, int t, int* a) {
#pragma unroll
  for (int i = 0; i < kTlGroup; ++i) {
    const int j = kTlGroup * t + i;
    a[i] = j < n ? (int)xr[j] : 0;
  }
}

// Tensor-core and asynchronous-copy primitives (PTX of sm_80, run on
// sm_90a). cp.async copies global -> shared without a register round trip;
// with `valid` false it reads nothing and writes zeros (src-size 0), which
// masks a ragged edge.
__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async8(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(smem_addr(dst)), "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most N committed groups are still in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Four 8x8 b16 matrices from shared memory, lanes 8i..8i+7 giving the row
// addresses of matrix i; `trans` loads each transposed.
template <bool kTrans>
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  if constexpr (kTrans)
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
                 : "r"(smem_addr(p)));
  else
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
                 : "r"(smem_addr(p)));
}

// d += a . b on the tensor cores, one warp: a 16x16 bf16 (row), b 16x8
// bf16 (col), d 16x8 f32. Fragments as in the PTX ISA's m16n8k16 layout.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d += a . b on the tensor cores, one warp: a 16x32 s8 (row), b 32x8 s8
// (col), d 16x8 s32, exact. Fragments as in the PTX ISA's m16n8k32 layout.
__device__ __forceinline__ void mma_s8(int (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                       uint32_t b1) {
  asm("mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Dynamic shared memory above 48 KB must be asked for per kernel.
template <class Kernel>
inline cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

}  // namespace rtk
