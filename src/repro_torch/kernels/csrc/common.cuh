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

// Four biased 2-bit trits of one pack2 byte -> four signed int8 lanes
// (lane j = plane j), ready for __dp4a.
__device__ __forceinline__ int trits4(unsigned b) {
  const unsigned s = (b & 0x3u) | ((b & 0xCu) << 6) | ((b & 0x30u) << 12) |
                     ((b & 0xC0u) << 18);
  return (int)__vsub4(s, 0x01010101u);
}

// The four activations that plane bytes of row i meet: x[i + j*n4], j=0..3,
// packed into int8 lanes in plane order.
__device__ __forceinline__ int x_word(const int8_t* xr, int i, int n4) {
  return (int)((unsigned)(uint8_t)xr[i] | ((unsigned)(uint8_t)xr[i + n4] << 8) |
               ((unsigned)(uint8_t)xr[i + 2 * n4] << 16) |
               ((unsigned)(uint8_t)xr[i + 3 * n4] << 24));
}

// Words for rows i..i+3 from one 4-byte load per plane (n4 % 4 == 0 and
// xr 4-byte aligned): out[t] = x_word(xr, i + t, n4), bytes transposed
// with __byte_perm instead of sixteen single-byte loads.
__device__ __forceinline__ void x_words4(const int8_t* xr, int i, int n4, int* out) {
  const unsigned a = *reinterpret_cast<const unsigned*>(xr + i);
  const unsigned b = *reinterpret_cast<const unsigned*>(xr + i + n4);
  const unsigned c = *reinterpret_cast<const unsigned*>(xr + i + 2 * n4);
  const unsigned d = *reinterpret_cast<const unsigned*>(xr + i + 3 * n4);
  const unsigned ab_lo = __byte_perm(a, b, 0x5140), ab_hi = __byte_perm(a, b, 0x7362);
  const unsigned cd_lo = __byte_perm(c, d, 0x5140), cd_hi = __byte_perm(c, d, 0x7362);
  out[0] = (int)__byte_perm(ab_lo, cd_lo, 0x5410);
  out[1] = (int)__byte_perm(ab_lo, cd_lo, 0x7632);
  out[2] = (int)__byte_perm(ab_hi, cd_hi, 0x5410);
  out[3] = (int)__byte_perm(ab_hi, cd_hi, 0x7632);
}

// Dynamic shared memory above 48 KB must be asked for per kernel.
template <class Kernel>
inline cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

}  // namespace rtk
