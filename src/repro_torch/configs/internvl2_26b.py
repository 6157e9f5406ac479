"""InternVL2-26B: an InternViT frontend (a stub) and an InternLM2 backbone.

Same numbers and registry name as ``repro/configs/internvl2_26b.py``: 48
layers, d_model 6144, 48 heads on 8 kv heads of head_dim 128, d_ff
16384, vocab 92553 (padded to 92672; the padded ids are not masked when
sampling, as in JAX). Precomputed patch embeddings ``[B, S, 1024]`` enter
through ``params["frontend"]`` (``models/transformer.py::embed_inputs``).
"""

from .base import ModelConfig, register


def full() -> ModelConfig:
    return ModelConfig(
        name="internvl2-26b",
        family="dense",
        n_layers=48,
        d_model=6144,
        n_heads=48,
        n_kv_heads=8,
        head_dim=128,
        d_ff=16384,
        vocab_size=92553,
        frontend="vision",
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="internvl2-26b-smoke",
        family="dense",
        n_layers=2,
        d_model=64,
        n_heads=4,
        n_kv_heads=2,
        head_dim=16,
        d_ff=128,
        vocab_size=256,
        frontend="vision",
    )


register("internvl2-26b", full, smoke)
