"""Plain-Python model configuration and registry.

Counterpart of ``repro/configs/base.py``, holding only the fields the
port's ``generate`` and ``ServingEngine`` paths read (the JAX module imports
JAX, so the port keeps its own copy). Field names and defaults match the JAX config, so a
test can hold each shared field against it. The options of other
architectures (softcaps, sliding windows, local/global layers, families
other than dense) come with the slice that ports a config using them.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 128
    prefill_chunk_sizes: tuple = (64, 128, 256)  # the prefill buckets
    prefill_chunk_budget: int = 512  # chunk tokens appended per engine tick
    kv_cache_dtype: str = "bf16"  # bf16 (the activation dtype) | int8 + f32 row scales
    admission_queue_cap: int = 0  # 0 = unbounded
    request_ttl_s: float = 0.0  # 0 = no deadline
    stats_ring_events: int = 4096  # engine event ring (0 = unbounded)
    norm_eps: float = 1e-5
    rope_theta: float = 10000.0
    dtype: torch.dtype = torch.bfloat16

    @property
    def padded_vocab(self) -> int:
        """Vocab padded to 256, as the JAX package pads it."""
        return ((self.vocab_size + 255) // 256) * 256


_REGISTRY: dict[str, Callable[[], ModelConfig]] = {}
_SMOKE: dict[str, Callable[[], ModelConfig]] = {}


def register(name: str, full: Callable[[], ModelConfig],
             smoke: Callable[[], ModelConfig]) -> None:
    _REGISTRY[name] = full
    _SMOKE[name] = smoke


def get_config(name: str, *, smoke: bool = False) -> ModelConfig:
    from . import tellme_0p7b  # noqa: F401  (registers itself)

    table = _SMOKE if smoke else _REGISTRY
    if name not in table:
        raise KeyError(f"unknown arch {name!r}; have {sorted(table)}")
    return table[name]()
