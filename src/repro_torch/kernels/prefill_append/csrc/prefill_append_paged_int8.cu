// Chunked prefill attention over int8 page pools: their quarter of the
// kernels, which tm_prefill_append_paged (prefill_append_paged.cu) calls
// for quant = 1. The kernels, their contract and their design are in
// prefill_append.cuh.
//
// Replaces: repro/kernels/prefill_append/kernel.py::prefill_append_paged_kernel_quant
// (kernel.py:503).

#include "prefill_append.cuh"

RTK_PA_QUARTER(rtk_prefill_append_paged_int8) { RTK_PA_DISPATCH(true, true); }
