"""Plain PyTorch version of the decode-attention kernel.

It computes what ``repro/kernels/decode_attention/kernel.py`` computes with
the whole cache as one kv block: f32 scores, softcap, the ``-1e30`` mask past
each slot's frontier ``pos[b]`` and below its window foot, unnormalized
probabilities cast to the cache dtype before P·V, and the
``max(l, 1e-30)`` finalize. The kernel's online softmax rescales block by
block, so the two agree to rounding, not bit for bit. With an int8 cache
(``k_scale``/``v_scale`` [B, HK, M] f32) the cache is first dequantized to
q's dtype (``dequantize_kv``), which defines the quantized kernel
(``kernel.py:324``). The paged form gathers each slot's dense view of the
page pools (``gather_kv_pages``) and runs the contiguous version on it, as
``repro/models/attention.py:337-347`` defines the paged XLA form.
"""

from __future__ import annotations

import math

import torch

from ...core.ternary import dequantize_kv, gather_kv_pages

NEG_INF = -1e30


def decode_attention(q, k_cache, v_cache, pos, *, k_scale=None, v_scale=None,
                     window: int = 0, softcap: float = 0.0):
    """q [B, H, D]; k/v cache [B, HK, M, D]; pos [B] int -> [B, H, D]."""
    if k_scale is not None:
        k_cache = dequantize_kv(k_cache, k_scale, q.dtype)
        v_cache = dequantize_kv(v_cache, v_scale, q.dtype)
    b, h, d = q.shape
    hk, m = k_cache.shape[1], k_cache.shape[2]
    g = h // hk
    qg = q.reshape(b, hk, g, d).to(torch.float32)
    kf = k_cache.to(torch.float32)
    s = torch.matmul(qg, kf.transpose(-1, -2)) * (1.0 / math.sqrt(d))
    if softcap > 0:
        s = softcap * torch.tanh(s / softcap)
    kpos = torch.arange(m, device=q.device)[None, :]
    pos = pos.to(torch.int64).reshape(b, 1)
    mask = kpos <= pos
    if window > 0:
        mask &= (pos - kpos) < window
    s = torch.where(mask[:, None, None, :], s, torch.full_like(s, NEG_INF))
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    l = p.sum(dim=-1, keepdim=True)
    o = torch.matmul(p.to(v_cache.dtype).to(torch.float32), v_cache.to(torch.float32))
    o = o / torch.clamp(l, min=1e-30)
    return o.to(q.dtype).reshape(b, h, d)


def decode_attention_paged(q, k_pool, v_pool, page_table, pos, *, k_scale=None,
                           v_scale=None, window: int = 0, softcap: float = 0.0):
    """q [B, H, D] against k/v pools [P, HK, ps, D] (int8 with ``k_scale``/
    ``v_scale`` pools [P, HK, ps] f32) through ``page_table [B, NB]`` int32;
    pos [B] -> [B, H, D]."""
    kd, vd = gather_kv_pages(k_pool, page_table), gather_kv_pages(v_pool, page_table)
    ks = vs = None
    if k_scale is not None:
        ks, vs = gather_kv_pages(k_scale, page_table), gather_kv_pages(v_scale, page_table)
    return decode_attention(q, kd, vd, pos, k_scale=ks, v_scale=vs, window=window,
                            softcap=softcap)
