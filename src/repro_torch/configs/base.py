"""Plain-Python model configuration and registry.

Counterpart of ``repro/configs/base.py``, holding only the fields the
port's ``generate`` and ``ServingEngine`` paths read (the JAX module imports
JAX, so the port keeps its own copy). Field names and defaults match the JAX config, so a
test can hold each shared field against it. Two families are ported: the
dense transformer and ``ssm`` (RWKV-6). The options of other architectures
(softcaps, sliding windows, local/global layers, MoE, MLA, hybrids) come
with the slice that ports a config using them. ``sub_quadratic`` is left
out: only the JAX package's dry-run reads it. The serving knobs of the
replica pool and the HTTP/SSE front door (``serving/pool.py``,
``serving/server.py``) and :func:`resolve_slo` are JAX's
(``base.py:115-153, 238-248``).
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
    # SLO classes of the replica pool: (name, priority, default deadline_s,
    # chunk-budget weight); a 0.0 deadline means none (request_ttl_s then
    # applies). A tuple of tuples, so the frozen config stays hashable.
    slo_classes: tuple = (
        ("interactive", 2, 0.0, 1.0),
        ("batch", 1, 0.0, 0.5),
        ("best_effort", 0, 0.0, 0.25),
    )
    # Replica pool health gating and failover (serving/pool.py): drain after
    # pool_health_fail_ticks failed ticks in a row or a dense straggler
    # window (pool_straggler_events of the last pool_straggler_window
    # ticks); quarantine under a backoff doubling from pool_backoff_s to
    # pool_backoff_max_s, then a probe request within pool_probe_timeout_s;
    # a driver whose heartbeat is pool_hang_timeout_s old is hung.
    pool_replicas: int = 2
    pool_health_fail_ticks: int = 3
    pool_backoff_s: float = 0.25
    pool_backoff_max_s: float = 8.0
    pool_hang_timeout_s: float = 2.0
    pool_probe_timeout_s: float = 10.0
    pool_poll_interval_s: float = 0.01
    pool_straggler_window: int = 8
    pool_straggler_events: int = 3
    # HTTP/SSE front door (serving/server.py): bind address, the SIGTERM
    # drain's hard-kill timeout and the driver thread's idle poll
    server_host: str = "127.0.0.1"
    server_port: int = 8080
    server_drain_timeout_s: float = 30.0
    server_poll_s: float = 0.001
    norm_eps: float = 1e-5
    rope_theta: float = 10000.0
    dtype: torch.dtype = torch.bfloat16

    @property
    def padded_vocab(self) -> int:
        """Vocab padded to 256, as the JAX package pads it."""
        return ((self.vocab_size + 255) // 256) * 256


def resolve_slo(cfg: ModelConfig, name: str) -> tuple[int, float | None, float]:
    """An SLO class name as the lifecycle fields ``(priority, deadline_s or
    None, chunk_budget_weight)``; a 0.0 class deadline is None. An unknown
    class raises ``KeyError`` (the front door's 400), never a silent
    demotion."""
    for cls, prio, deadline, weight in cfg.slo_classes:
        if cls == name:
            return int(prio), (float(deadline) if deadline else None), float(weight)
    raise KeyError(f"unknown SLO class {name!r}; have {[c[0] for c in cfg.slo_classes]}")


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
