"""Plain PyTorch version of the chunked prefill-append kernel.

It computes what ``repro/kernels/prefill_append/kernel.py`` computes (body
``_kernel`` at ``kernel.py:53-157``; oracle ``ref.py``), with the whole
cache as one kv block: the chunk's K/V are written into the cache at
``[offset, offset + C)`` in place (int8 cache: ``quantize_kv`` codes and
f32 row scales), then the C chunk rows attend to the cache prefix and
causally to themselves through the updated cache (int8: dequantized to q's
dtype, so the chunk sees its own quantized rows) with f32 scores, softcap,
the ``-1e30`` mask, unnormalized probabilities cast to V's dtype before
P·V, and the ``max(l, 1e-30)`` finalize. Slots at ``offset >= prefix_limit
> 0`` only write: their output is garbage by contract, and zero here as in
the kernel, which reads nothing for them.
The kernel's online softmax rescales tile by tile, so the two agree to
rounding, not bit for bit; the cache bytes they write agree exactly.

The append indexes with device tensors (no per-slot host loop), so the
plain version makes no device-to-host transfer either.
"""

from __future__ import annotations

import math

import torch

from ...core.ternary import dequantize_kv, quantize_kv

NEG_INF = -1e30


def _rows(offset, c):
    """([B, 1] slot index, [B, C] cache rows [offset, offset + C))."""
    dev = offset.device
    slots = torch.arange(offset.shape[0], device=dev)[:, None]
    return slots, offset.to(torch.int64)[:, None] + torch.arange(c, device=dev)[None, :]


def append_kv_cache(k_cache, v_cache, k_new, v_new, offset) -> None:
    """Write k/v_new [B, HK, C, D] into k/v_cache [B, HK, M, D] at rows
    ``[offset[b], offset[b] + C)``, in place."""
    slots, rows = _rows(offset, k_new.shape[2])
    # advanced indices around a slice: the indexed view is [B, C, HK, D]
    k_cache[slots, :, rows] = k_new.transpose(1, 2).to(k_cache.dtype)
    v_cache[slots, :, rows] = v_new.transpose(1, 2).to(v_cache.dtype)


def append_kv_cache_quant(k_cache, v_cache, k_scale, v_scale, k_new, v_new,
                          offset) -> None:
    """Int8 twin of :func:`append_kv_cache`: the chunk's rows are quantized
    (``quantize_kv``) and the codes and f32 scales [B, HK, M] written in
    place."""
    slots, rows = _rows(offset, k_new.shape[2])
    for cache, scales, new in ((k_cache, k_scale, k_new), (v_cache, v_scale, v_new)):
        codes, s = quantize_kv(new)
        cache[slots, :, rows] = codes.transpose(1, 2)
        scales[slots, :, rows] = s.transpose(1, 2)


def prefill_append(q, k_new, v_new, k_cache, v_cache, offset, *, k_scale=None,
                   v_scale=None, window: int = 0, softcap: float = 0.0,
                   prefix_limit: int = 0):
    """q [B, H, C, D] at positions offset[b] + [0, C); k/v_new [B, HK, C, D];
    k/v cache [B, HK, M, D] (q's dtype, or int8 with ``k_scale``/``v_scale``
    [B, HK, M] f32); offset [B] int32. Appends in place; returns out
    [B, H, C, D]."""
    b, h, c, d = q.shape
    hk, m = k_cache.shape[1], k_cache.shape[2]
    g = h // hk
    if k_scale is not None:
        append_kv_cache_quant(k_cache, v_cache, k_scale, v_scale, k_new, v_new, offset)
        kd = dequantize_kv(k_cache, k_scale, q.dtype)
        vd = dequantize_kv(v_cache, v_scale, q.dtype)
    else:
        append_kv_cache(k_cache, v_cache, k_new, v_new, offset)
        kd, vd = k_cache, v_cache
    qg = q.reshape(b, hk, g, c, d).to(torch.float32)
    s = torch.matmul(qg, kd.to(torch.float32)[:, :, None].transpose(-1, -2))
    s = s * (1.0 / math.sqrt(d))  # [B, HK, G, C, M]
    if softcap > 0:
        s = softcap * torch.tanh(s / softcap)
    off = offset.to(torch.int64)[:, None, None]  # [B, 1, 1]
    qpos = off + torch.arange(c, device=q.device)[None, :, None]  # [B, C, 1]
    kpos = torch.arange(m, device=q.device)[None, None, :]  # [1, 1, M]
    mask = kpos <= qpos
    if window > 0:
        mask &= (qpos - kpos) < window
    s = torch.where(mask[:, None, None], s, torch.full_like(s, NEG_INF))
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    l = p.sum(dim=-1, keepdim=True)
    o = torch.matmul(p.to(vd.dtype).to(torch.float32), vd.to(torch.float32)[:, :, None])
    o = o / torch.clamp(l, min=1e-30)
    if prefix_limit > 0:  # write-only slots
        o = torch.where(off[:, :, :, None, None] >= prefix_limit, torch.zeros_like(o), o)
    return o.to(q.dtype).reshape(b, h, c, d)
