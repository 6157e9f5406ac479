"""IBM Granite-8B (code), a llama-architecture dense transformer.

Same numbers and registry name as ``repro/configs/granite_8b.py``: 36
layers, d_model 4096, 32 heads on 8 kv heads of head_dim 128, d_ff 14336,
vocab 49152.
"""

from .base import ModelConfig, register


def full() -> ModelConfig:
    return ModelConfig(
        name="granite-8b",
        family="dense",
        n_layers=36,
        d_model=4096,
        n_heads=32,
        n_kv_heads=8,
        head_dim=128,
        d_ff=14336,
        vocab_size=49152,
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="granite-8b-smoke",
        family="dense",
        n_layers=2,
        d_model=64,
        n_heads=4,
        n_kv_heads=2,
        head_dim=16,
        d_ff=128,
        vocab_size=256,
    )


register("granite-8b", full, smoke)
