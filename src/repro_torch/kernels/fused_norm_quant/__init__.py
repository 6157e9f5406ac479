"""Fused RMSNorm + absmax int8 prologue (CUDA kernel and plain version)."""
