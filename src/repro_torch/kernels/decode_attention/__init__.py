"""Single-token KV-cache attention (CUDA kernel and plain version)."""
