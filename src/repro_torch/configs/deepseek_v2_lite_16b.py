"""DeepSeek-V2-Lite (16B total, 2.4B active): MLA and fine-grained MoE.

Same numbers and registry name as ``repro/configs/deepseek_v2_lite_16b.py``:
27 layers, d_model 2048, 16 heads, MLA with kv_lora_rank 512 (qk_nope 128,
qk_rope 64, v 128), 64 routed experts top-6 of d_ff 1408 plus 2 shared
experts, the first layer dense (d_ff 10944), vocab 102400.
"""

from .base import ModelConfig, register


def full() -> ModelConfig:
    return ModelConfig(
        name="deepseek-v2-lite-16b",
        family="mla_moe",
        n_layers=27,
        d_model=2048,
        n_heads=16,
        n_kv_heads=16,
        head_dim=128,
        d_ff=1408,
        vocab_size=102400,
        n_experts=64,
        experts_per_tok=6,
        n_shared_experts=2,
        shared_expert_ff=1408,
        first_dense_layers=1,
        dense_ff=10944,
        kv_lora_rank=512,
        qk_nope_head_dim=128,
        qk_rope_head_dim=64,
        v_head_dim=128,
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="deepseek-v2-lite-16b-smoke",
        family="mla_moe",
        n_layers=3,
        d_model=64,
        n_heads=4,
        n_kv_heads=4,
        head_dim=16,
        d_ff=48,
        vocab_size=256,
        n_experts=8,
        experts_per_tok=2,
        n_shared_experts=1,
        shared_expert_ff=48,
        first_dense_layers=1,
        dense_ff=128,
        kv_lora_rank=32,
        qk_nope_head_dim=16,
        qk_rope_head_dim=8,
        v_head_dim=16,
    )


register("deepseek-v2-lite-16b", full, smoke)
