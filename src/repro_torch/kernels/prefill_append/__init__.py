"""Chunked prefill attention with the in-place cache append (CUDA kernel
and plain version)."""
