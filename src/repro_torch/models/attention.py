"""Attention paths (``repro/models/attention.py``).

* ``prefill_attention`` — causal attention over the whole prompt. The JAX
  package runs it in XLA outside any Pallas kernel (``attention.py:62``),
  so here it is plain PyTorch: f32 scores, ``-1e30`` mask, softmax with the
  unnormalized probabilities cast to the activation dtype before P·V.
* ``decode_attention`` — one new token per slot against the cache, through
  the kernel set (the CUDA decode-attention kernel on the card).
* ``update_kv_cache`` — writes each slot's new K/V row at its ``pos``.
"""

from __future__ import annotations

import math

import torch

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


def decode_attention(q, k_cache, v_cache, pos, *, kernels):
    """q [B, H, D] against k/v cache [B, HK, M, D], attending to <= pos[b]."""
    return kernels.decode_attention(q, k_cache, v_cache, pos)


def update_kv_cache(k_cache, v_cache, k_new, v_new, pos) -> None:
    """Write k/v_new [B, HK, D] at row ``pos[b]`` of each slot, in place
    (the JAX form returns new arrays; the values written are the same)."""
    slots = torch.arange(k_cache.shape[0], device=k_cache.device)
    rows = pos.to(torch.int64)
    k_cache[slots, :, rows] = k_new.to(k_cache.dtype)
    v_cache[slots, :, rows] = v_new.to(v_cache.dtype)
