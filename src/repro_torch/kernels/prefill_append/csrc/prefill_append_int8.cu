// Chunked prefill attention against each slot's contiguous int8 cache: its
// quarter of the kernels, which tm_prefill_append (prefill_append.cu) calls
// for quant = 1. The kernels, their contract and their design are in
// prefill_append.cuh.
//
// Replaces: repro/kernels/prefill_append/kernel.py::prefill_append_kernel_quant
// (kernel.py:556).

#include "prefill_append.cuh"

RTK_PA_QUARTER(rtk_prefill_append_int8) { RTK_PA_DISPATCH(false, true); }
