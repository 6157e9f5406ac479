// Chunked prefill attention over a page pool: the extern "C" entry of the
// paged layout, and its dense cache's quarter of the kernels. The kernels,
// their contract and their design are in prefill_append.cuh;
// prefill_append_paged_int8.cu instantiates the int8 cache's quarter.
//
// Replaces: repro/kernels/prefill_append/kernel.py::prefill_append_paged_kernel
// (kernel.py:477).

#include "prefill_append.cuh"

RTK_PA_QUARTER(rtk_prefill_append_paged_dense) { RTK_PA_DISPATCH(true, false); }

// The paged variants: kc, vc pools [P*HK, ps, D] (ks, vs [P*HK, ps] for
// quant = 1) read and written through pt [B, NB] int32; the logical cache
// holds nb * ps rows.
extern "C" int tm_prefill_append_paged(const void* q, const void* kn, const void* vn, void* kc,
                                       void* vc, void* ks, void* vs, const void* pt,
                                       const void* off, void* out, int bhk, int hk, int g,
                                       int c, int nb, int ps, int d, int window, float softcap,
                                       float scale, int prefix_limit, int quant, int dtype,
                                       void* stream) {
  return (quant ? rtk_prefill_append_paged_int8 : rtk_prefill_append_paged_dense)(
      q, kn, vn, kc, vc, ks, vs, off, pt, out, bhk, hk, g, c, nb * ps, nb, ps, d, window,
      softcap, scale, prefix_limit, dtype, static_cast<cudaStream_t>(stream));
}
