"""Gemma-2 27B: alternating local/global attention and logit softcapping.

Same numbers and registry name as ``repro/configs/gemma2_27b.py``: 46
layers, d_model 4608, 32 heads with 16 kv heads of head_dim 128, d_ff
36864, vocab 256000; a sliding window of 4096 on the local layers (period
2: local, global), an attention-logit softcap of 50 and a final-logit
softcap of 30.
"""

from .base import ModelConfig, register


def full() -> ModelConfig:
    return ModelConfig(
        name="gemma2-27b",
        family="dense",
        n_layers=46,
        d_model=4608,
        n_heads=32,
        n_kv_heads=16,
        head_dim=128,
        d_ff=36864,
        vocab_size=256000,
        attn_logit_softcap=50.0,
        final_logit_softcap=30.0,
        sliding_window=4096,
        local_global_period=2,
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="gemma2-27b-smoke",
        family="dense",
        n_layers=2,
        d_model=64,
        n_heads=4,
        n_kv_heads=2,
        head_dim=16,
        d_ff=128,
        vocab_size=256,
        attn_logit_softcap=50.0,
        final_logit_softcap=30.0,
        sliding_window=16,
        local_global_period=2,
    )


register("gemma2-27b", full, smoke)
