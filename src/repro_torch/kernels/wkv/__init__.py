"""The chunked RWKV-6 WKV recurrence from a zero state, the prefill's time
mix (CUDA kernel and plain version)."""
