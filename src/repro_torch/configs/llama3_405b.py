"""LLaMA-3 405B, the largest dense model of the registry.

Same numbers and registry name as ``repro/configs/llama3_405b.py``: 126
layers, d_model 16384, 128 heads on 8 kv heads of head_dim 128 (groups
of 16), d_ff 53248, vocab 128256, RoPE theta 500000. Its packed weights
are about 100 GB at full depth, more than one 80 GB card holds: one card
runs it at full width with ``n_layers`` cut (``dataclasses.replace``).
"""

from .base import ModelConfig, register


def full() -> ModelConfig:
    return ModelConfig(
        name="llama3-405b",
        family="dense",
        n_layers=126,
        d_model=16384,
        n_heads=128,
        n_kv_heads=8,
        head_dim=128,
        d_ff=53248,
        vocab_size=128256,
        rope_theta=500000.0,
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="llama3-405b-smoke",
        family="dense",
        n_layers=2,
        d_model=64,
        n_heads=8,
        n_kv_heads=2,
        head_dim=16,
        d_ff=192,
        vocab_size=256,
        rope_theta=500000.0,
    )


register("llama3-405b", full, smoke)
