"""InternLM2-20B, a dense GQA transformer.

Same numbers and registry name as ``repro/configs/internlm2_20b.py``: 48
layers, d_model 6144, 48 heads on 8 kv heads of head_dim 128 (groups of
6), d_ff 16384, vocab 92544.
"""

from .base import ModelConfig, register


def full() -> ModelConfig:
    return ModelConfig(
        name="internlm2-20b",
        family="dense",
        n_layers=48,
        d_model=6144,
        n_heads=48,
        n_kv_heads=8,
        head_dim=128,
        d_ff=16384,
        vocab_size=92544,
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="internlm2-20b-smoke",
        family="dense",
        n_layers=2,
        d_model=64,
        n_heads=4,
        n_kv_heads=2,
        head_dim=16,
        d_ff=128,
        vocab_size=256,
    )


register("internlm2-20b", full, smoke)
