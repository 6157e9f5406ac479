"""Attention paths (``repro/models/attention.py``), contiguous KV layout.

* ``prefill_attention`` — causal attention over the whole prompt. The JAX
  package runs it in XLA outside any Pallas kernel (``attention.py:62``),
  so here it is plain PyTorch: f32 scores, ``-1e30`` mask, softmax with the
  unnormalized probabilities cast to the activation dtype before P·V.
* ``decode_attention`` — one new token per slot against the cache, through
  the kernel set (the CUDA decode-attention kernel on the card, its int8
  variant for an int8 cache).
* ``prefill_append_attention`` — a chunk per slot against its cache prefix
  and itself, appending the chunk's K/V in place, through the kernel set
  (the CUDA prefill-append kernel on the card).
* ``update_kv_cache`` / ``update_kv_cache_quant`` — write each slot's new
  K/V row at its ``pos`` (int8: quantized, with its f32 row scale), and
  ``append_kv_cache`` / ``append_kv_cache_quant``, the chunk append that
  the prefill-append kernel fuses. All write in place where the JAX forms
  return new arrays; the values written are the same.

An int8 cache carries ``k_scale``/``v_scale`` [B, HK, M] f32 beside its
int8 ``k``/``v``; passing them selects the int8 path.
"""

from __future__ import annotations

import math

import torch

from ..core.ternary import quantize_kv
from ..kernels.prefill_append.ref import append_kv_cache, append_kv_cache_quant  # noqa: F401

NEG_INF = -1e30


def prefill_attention(q, k, v) -> torch.Tensor:
    """q [B, H, S, D], k/v [B, HK, S, D] -> [B, H, S, D] (GQA grouped)."""
    b, h, s, d = q.shape
    hk = k.shape[1]
    g = h // hk
    qg = q.reshape(b, hk, g, s, d).to(torch.float32)
    kf = k.to(torch.float32)[:, :, None]
    sc = torch.matmul(qg, kf.transpose(-1, -2)) * (1.0 / math.sqrt(d))  # [B, HK, G, S, S]
    idx = torch.arange(s, device=q.device)
    mask = idx[:, None] >= idx[None, :]
    sc = torch.where(mask, sc, torch.full_like(sc, NEG_INF))
    p = torch.exp(sc - sc.amax(dim=-1, keepdim=True))
    l = p.sum(dim=-1, keepdim=True)
    o = torch.matmul(p.to(q.dtype).to(torch.float32), v.to(torch.float32)[:, :, None])
    o = o / torch.clamp(l, min=1e-30)
    return o.to(q.dtype).reshape(b, h, s, d)


def decode_attention(q, k_cache, v_cache, pos, *, kernels, k_scale=None, v_scale=None):
    """q [B, H, D] against k/v cache [B, HK, M, D], attending to <= pos[b]."""
    return kernels.decode_attention(q, k_cache, v_cache, pos, k_scale=k_scale,
                                    v_scale=v_scale)


def prefill_append_attention(q, k_new, v_new, k_cache, v_cache, offset, *, kernels,
                             k_scale=None, v_scale=None, prefix_limit: int = 0,
                             aligned: bool = True):
    """A chunk ``q [B, H, C, D]`` at positions ``offset[b] + [0, C)`` attends
    to the slot's cache prefix and causally to itself; its K/V
    ``[B, HK, C, D]`` are appended at ``[offset, offset + C)`` in place.
    Offsets at or past ``prefix_limit > 0`` are write-only (the engine's
    trash-diverted slots). The kernel writes whole chunk windows, so
    ``offset ≡ 0 (mod C)`` (``aligned``); the unaligned append of
    speculative verify is not ported, and asking for it raises, as the JAX
    kernel route does (``attention.py:256-262``)."""
    if not aligned:
        raise ValueError(
            "prefill_append_attention: the kernel requires chunk-aligned offsets "
            "(aligned=True); the unaligned append of speculative verify is not ported")
    return kernels.prefill_append(q, k_new, v_new, k_cache, v_cache, offset,
                                  k_scale=k_scale, v_scale=v_scale,
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
