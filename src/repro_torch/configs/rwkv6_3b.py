"""RWKV-6 "Finch" 3B: an attention-free RNN with data-dependent decay.

Same numbers and registry name as ``repro/configs/rwkv6_3b.py``: 32
layers, d_model 2560, d_ff 8960, vocab 65536, WKV head size 64 (40 heads).
Decode carries an O(1) state per slot in place of a KV cache.
"""

from .base import ModelConfig, register


def full() -> ModelConfig:
    return ModelConfig(
        name="rwkv6-3b",
        family="ssm",
        n_layers=32,
        d_model=2560,
        n_heads=40,
        n_kv_heads=40,
        head_dim=64,
        d_ff=8960,
        vocab_size=65536,
        rwkv_head_dim=64,
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="rwkv6-3b-smoke",
        family="ssm",
        n_layers=2,
        d_model=64,
        n_heads=4,
        n_kv_heads=4,
        head_dim=16,
        d_ff=128,
        vocab_size=256,
        rwkv_head_dim=16,
    )


register("rwkv6-3b", full, smoke)
