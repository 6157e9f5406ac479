"""Attention paths (``repro/models/attention.py``), contiguous and paged KV
layouts.

* ``prefill_attention`` — causal attention over the whole prompt (the
  one-shot prefill), through the kernel set (the CUDA flash-attention
  kernel on the card, the counterpart of the JAX package's Pallas
  ``flash_attention`` and of its XLA form at ``attention.py:62``).
* ``decode_attention`` — one new token per slot against the cache, through
  the kernel set (the CUDA decode-attention kernel on the card, its int8
  variant for an int8 cache).
* ``prefill_append_attention`` — a chunk per slot against its cache prefix
  and itself, appending the chunk's K/V in place, through the kernel set
  (the CUDA prefill-append kernel on the card) at any offset: a prefill
  chunk's, a multiple of its size, or a speculative verify chunk's, at a
  decode frontier. The JAX package routes the unaligned case to its XLA
  form (``attention.py:249-262,374-386``), because its Pallas kernel writes
  aligned cache windows; the port's kernel appends row by row and takes
  any frontier on both layouts.
* ``update_kv_cache`` / ``update_kv_cache_quant`` — write each slot's new
  K/V row at its ``pos`` (int8: quantized, with its f32 row scale), and
  ``append_kv_cache`` / ``append_kv_cache_quant``, the chunk append that
  the prefill-append kernel fuses. All write in place where the JAX forms
  return new arrays; the values written are the same.

* ``decode_attention_paged`` / ``prefill_append_attention_paged``
  (``attention.py:306,350``) — the same over page pools ``[P, HK, ps, D]``
  addressed through a page table ``[B, NB]``, through the kernel set's
  paged wrappers. The decode row is written beforehand through the table
  (``core.ternary.update_kv_pages``); the chunk append is the kernel's.

An int8 cache carries ``k_scale``/``v_scale`` [B, HK, M] f32 (paged: scale
pools [P, HK, ps]) beside its int8 ``k``/``v``; passing them selects the
int8 path.

Every form takes gemma2's two options (``attention.py:46-47``): a sliding
``window`` (> 0: a query at qpos attends to keys with qpos - kpos < window)
and a ``softcap`` (> 0: scores become softcap * tanh(s / softcap), before
the mask); 0 leaves either off.
"""

from __future__ import annotations

import torch

from ..core.ternary import quantize_kv
from ..kernels.prefill_append.ref import append_kv_cache, append_kv_cache_quant  # noqa: F401


def prefill_attention(q, k, v, *, kernels, scale: float | None = None, window: int = 0,
                      softcap: float = 0.0) -> torch.Tensor:
    """q [B, H, S, D], k [B, HK, S, D], v [B, HK, S, Dv] -> [B, H, S, Dv]
    (GQA grouped), causal; scores times ``scale`` (default 1/sqrt(D))."""
    return kernels.flash_attention(q, k, v, scale=scale, window=window, softcap=softcap)


def decode_attention(q, k_cache, v_cache, pos, *, kernels, k_scale=None, v_scale=None,
                     window: int = 0, softcap: float = 0.0):
    """q [B, H, D] against k/v cache [B, HK, M, D], attending to <= pos[b]."""
    return kernels.decode_attention(q, k_cache, v_cache, pos, k_scale=k_scale,
                                    v_scale=v_scale, window=window, softcap=softcap)


def prefill_append_attention(q, k_new, v_new, k_cache, v_cache, offset, *, kernels,
                             k_scale=None, v_scale=None, prefix_limit: int = 0,
                             window: int = 0, softcap: float = 0.0):
    """A chunk ``q [B, H, C, D]`` at positions ``offset[b] + [0, C)`` attends
    to the slot's cache prefix and causally to itself; its K/V
    ``[B, HK, C, D]`` are appended at ``[offset, offset + C)`` in place, at
    any offset with ``offset + C <= M``. Offsets at or past
    ``prefix_limit > 0`` are write-only (the engine's trash-diverted
    slots)."""
    return kernels.prefill_append(q, k_new, v_new, k_cache, v_cache, offset,
                                  k_scale=k_scale, v_scale=v_scale, window=window,
                                  softcap=softcap, prefix_limit=prefix_limit)


def decode_attention_paged(q, k_pool, v_pool, page_table, pos, *, kernels, k_scale=None,
                           v_scale=None, window: int = 0, softcap: float = 0.0):
    """Page-indirect twin of :func:`decode_attention`: q [B, H, D] against
    k/v pools [P, HK, ps, D] through ``page_table [B, NB]``. The frontier
    row is already in the pools (``update_kv_pages``)."""
    return kernels.decode_attention_paged(q, k_pool, v_pool, page_table, pos,
                                          k_scale=k_scale, v_scale=v_scale, window=window,
                                          softcap=softcap)


def prefill_append_attention_paged(q, k_new, v_new, k_pool, v_pool, page_table, offset, *,
                                   kernels, k_scale=None, v_scale=None,
                                   prefix_limit: int = 0, window: int = 0,
                                   softcap: float = 0.0):
    """Page-indirect twin of :func:`prefill_append_attention`: row r of the
    chunk lands in pool page ``page_table[b, (offset + r) // ps]`` in place,
    which the engine has made exclusive to the slot (``ensure_writable``);
    a chunk may start anywhere in a page and straddle the next."""
    return kernels.prefill_append_paged(q, k_new, v_new, k_pool, v_pool, page_table,
                                        offset, k_scale=k_scale, v_scale=v_scale,
                                        window=window, softcap=softcap,
                                        prefix_limit=prefix_limit)


def update_kv_cache(k_cache, v_cache, k_new, v_new, pos) -> None:
    """Write k/v_new [B, HK, D] at row ``pos[b]`` of each slot, in place."""
    slots = torch.arange(k_cache.shape[0], device=k_cache.device)
    rows = pos.to(torch.int64)
    k_cache[slots, :, rows] = k_new.to(k_cache.dtype)
    v_cache[slots, :, rows] = v_new.to(v_cache.dtype)


def update_kv_cache_quant(k_cache, v_cache, k_scale, v_scale, k_new, v_new, pos) -> None:
    """Int8 twin of :func:`update_kv_cache`: the new rows are quantized
    (``quantize_kv``) and their codes and f32 scales written at ``pos``."""
    slots = torch.arange(k_cache.shape[0], device=k_cache.device)
    rows = pos.to(torch.int64)
    for cache, scales, new in ((k_cache, k_scale, k_new), (v_cache, v_scale, v_new)):
        codes, s = quantize_kv(new)
        cache[slots, :, rows] = codes
        scales[slots, :, rows] = s
