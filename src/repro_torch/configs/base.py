"""Plain-Python model configuration and registry.

Counterpart of ``repro/configs/base.py``, holding only the fields the
port's ``generate`` and ``ServingEngine`` paths read (the JAX module imports
JAX, so the port keeps its own copy). Field names and defaults match the JAX config, so a
test can hold each shared field against it. Two families are ported: the
dense transformer and ``ssm`` (RWKV-6). The options of other architectures
(softcaps, sliding windows, local/global layers, MoE, MLA, hybrids) come
with the slice that ports a config using them. ``sub_quadratic`` is left
out: only the JAX package's dry-run reads it.
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
    family: str = "dense"  # dense | ssm (RWKV-6)
    rwkv_head_dim: int = 64  # ssm: the WKV head size n (d_model // n heads)
    prefill_chunk_sizes: tuple = (64, 128, 256)  # the prefill buckets
    prefill_chunk_budget: int = 512  # chunk tokens appended per engine tick
    kv_cache_dtype: str = "bf16"  # bf16 (the activation dtype) | int8 + f32 row scales
    # The ServingEngine's KV layout: per-slot rows, or a page pool [P, HK, ps, D]
    # addressed through a per-slot page table (generate always runs contiguous).
    kv_layout: str = "contiguous"  # contiguous | paged
    kv_page_size: int = 64  # tokens per page; must divide prefill_chunk_sizes[0]
    kv_num_pages: int = 0  # pool size; 0 = auto (slots * cache_len / page_size + 1)
    prefix_cache: bool = True  # paged only: intern full prompt pages for reuse
    # The ternary matmul engine: "packed" pins the pack2 kernels, "tl" forces
    # the table-lookup engine, "auto" takes TL only where a measured TL win
    # is on record (kernels/autotune.py) and the tree carries w_idx.
    matmul_engine: str = "auto"  # packed | tl | auto
    # Speculative decoding (ServingEngine(speculative=True) opts in): gamma
    # tokens drafted per decoding slot by prompt lookup over the slot's
    # history (the longest n-gram suffix, n <= spec_ngram_max) and verified
    # in one gamma + 1-row chunk; the engine stops speculating once
    # spec_disable_after drafts were offered at an acceptance below
    # spec_min_acceptance.
    spec_gamma: int = 4
    spec_draft: str = "ngram"  # serving/speculative.py DRAFTERS key
    spec_ngram_max: int = 3
    spec_min_acceptance: float = 0.05
    spec_disable_after: int = 64
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
    from . import rwkv6_3b, tellme_0p7b  # noqa: F401  (each registers itself)

    table = _SMOKE if smoke else _REGISTRY
    if name not in table:
        raise KeyError(f"unknown arch {name!r}; have {sorted(table)}")
    return table[name]()
