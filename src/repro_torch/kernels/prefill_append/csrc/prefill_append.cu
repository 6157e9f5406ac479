// Chunked prefill attention against each slot's contiguous cache prefix,
// with the chunk's K/V appended into the cache in place: the extern "C"
// entry of the contiguous layout, and its dense cache's quarter of the
// kernels. The kernels, their contract and their design are in
// prefill_append.cuh; prefill_append_int8.cu instantiates the int8 cache's
// quarter.
//
// Replaces: repro/kernels/prefill_append/kernel.py::prefill_append_kernel
// (kernel.py:532).

#include "prefill_append.cuh"

RTK_PA_QUARTER(rtk_prefill_append_dense) { RTK_PA_DISPATCH(false, false); }

// quant = 0: dense cache of T (ks, vs unused); quant = 1: int8 cache with
// f32 row scales ks, vs [B*HK, M].
extern "C" int tm_prefill_append(const void* q, const void* kn, const void* vn, void* kc,
                                 void* vc, void* ks, void* vs, const void* off, void* out,
                                 int bhk, int hk, int g, int c, int m, int d, int window,
                                 float softcap, float scale, int prefix_limit, int quant,
                                 int dtype, void* stream) {
  return (quant ? rtk_prefill_append_int8 : rtk_prefill_append_dense)(
      q, kn, vn, kc, vc, ks, vs, off, nullptr, out, bhk, hk, g, c, m, 0, 0, d, window, softcap,
      scale, prefix_limit, dtype, static_cast<cudaStream_t>(stream));
}
