"""MusicGen-medium, a decoder-only transformer over EnCodec tokens.

Same numbers and registry name as ``repro/configs/musicgen_medium.py``:
48 layers, d_model 1536, 24 heads of head_dim 64 with no GQA, d_ff 6144,
vocab 2048. The audio frontend is a stub, as in JAX: precomputed EnCodec
frame embeddings ``[B, S, 128]`` enter through ``params["frontend"]``
(``models/transformer.py::embed_inputs``).
"""

from .base import ModelConfig, register


def full() -> ModelConfig:
    return ModelConfig(
        name="musicgen-medium",
        family="dense",
        n_layers=48,
        d_model=1536,
        n_heads=24,
        n_kv_heads=24,
        head_dim=64,
        d_ff=6144,
        vocab_size=2048,
        frontend="audio",
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="musicgen-medium-smoke",
        family="dense",
        n_layers=2,
        d_model=64,
        n_heads=4,
        n_kv_heads=4,
        head_dim=16,
        d_ff=128,
        vocab_size=256,
        frontend="audio",
    )


register("musicgen-medium", full, smoke)
