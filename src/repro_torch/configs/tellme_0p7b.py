"""TeLLMe's own deployment target: BitNet-b1.58 0.7B (paper Table V row).

Same numbers and registry name as ``repro/configs/tellme_0p7b.py``:
24 layers, d_model 1536, 16 heads × head_dim 96 (no GQA), d_ff 4096,
vocab 32000.
"""

from .base import ModelConfig, register


def full() -> ModelConfig:
    return ModelConfig(
        name="tellme-0.7b",
        n_layers=24,
        d_model=1536,
        n_heads=16,
        n_kv_heads=16,
        head_dim=96,
        d_ff=4096,
        vocab_size=32000,
        prefill_chunk_sizes=(64, 128, 256),
        prefill_chunk_budget=512,
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="tellme-0.7b-smoke",
        n_layers=2,
        d_model=64,
        n_heads=4,
        n_kv_heads=4,
        head_dim=16,
        d_ff=128,
        vocab_size=256,
        prefill_chunk_sizes=(64, 128, 256),
        prefill_chunk_budget=256,
    )


register("tellme-0.7b", full, smoke)
