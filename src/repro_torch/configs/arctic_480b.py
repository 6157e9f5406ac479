"""Snowflake Arctic (480B): a 128-expert top-2 MoE with a parallel dense
residual.

Same numbers and registry name as ``repro/configs/arctic_480b.py``: 35
layers, d_model 7168, 56 heads (GQA, 8 kv heads), d_ff 4864, vocab 32000;
every layer is attention, then the dense residual MLP beside the MoE. Its
2-bit weights (about 117 GB) do not fit one 80 GB card, so only the smoke
config runs there.
"""

from .base import ModelConfig, register


def full() -> ModelConfig:
    return ModelConfig(
        name="arctic-480b",
        family="moe",
        n_layers=35,
        d_model=7168,
        n_heads=56,
        n_kv_heads=8,
        head_dim=128,
        d_ff=4864,
        vocab_size=32000,
        n_experts=128,
        experts_per_tok=2,
        dense_residual=True,
        dense_ff=4864,
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="arctic-480b-smoke",
        family="moe",
        n_layers=2,
        d_model=64,
        n_heads=4,
        n_kv_heads=2,
        head_dim=16,
        d_ff=48,
        vocab_size=256,
        n_experts=8,
        experts_per_tok=2,
        dense_residual=True,
        dense_ff=48,
    )


register("arctic-480b", full, smoke)
