"""Causal attention over a whole prompt, the one-shot prefill (CUDA kernel
and plain version)."""
