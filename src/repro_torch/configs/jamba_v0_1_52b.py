"""Jamba-v0.1 (52B): hybrid Mamba and attention (1:7) with a 16-expert MoE.

Same numbers and registry name as ``repro/configs/jamba_v0_1_52b.py``: 32
layers, d_model 4096, 32 heads with 8 kv heads of head_dim 128, d_ff 14336,
vocab 65536; an attention layer at offset 4 of every 8, Mamba mixers
elsewhere (d_state 16, d_conv 4, expand 2); MoE every second layer, 16
experts, top 2.
"""

from .base import ModelConfig, register


def full() -> ModelConfig:
    return ModelConfig(
        name="jamba-v0.1-52b",
        family="hybrid",
        n_layers=32,
        d_model=4096,
        n_heads=32,
        n_kv_heads=8,
        head_dim=128,
        d_ff=14336,
        vocab_size=65536,
        n_experts=16,
        experts_per_tok=2,
        moe_every=2,
        attn_layer_period=8,
        attn_layer_offset=4,
        mamba_d_state=16,
        mamba_d_conv=4,
        mamba_expand=2,
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="jamba-v0.1-52b-smoke",
        family="hybrid",
        n_layers=4,
        d_model=64,
        n_heads=4,
        n_kv_heads=2,
        head_dim=16,
        d_ff=96,
        vocab_size=256,
        n_experts=4,
        experts_per_tok=2,
        moe_every=2,
        attn_layer_period=4,
        attn_layer_offset=2,
        mamba_d_state=8,
        mamba_d_conv=4,
        mamba_expand=2,
    )


register("jamba-v0.1-52b", full, smoke)
