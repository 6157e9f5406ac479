"""Dispatch for decode attention: the plain version for CPU tensors, the
CUDA kernel (``csrc/decode_attention.cu``) for CUDA tensors. An int8 cache
(``k_scale``/``v_scale`` given) goes to :func:`decode_attention_quant`, the
kernel's int8 variant, with its own launch count. The paged layout (page
pools read through a page table) goes to :func:`decode_attention_paged`
and :func:`decode_attention_paged_quant`, the kernel's paged variants."""

from __future__ import annotations

import math

import torch

from .. import _build as B
from . import ref


def _check(name, q, k_cache, v_cache, pos, cache_dtype):
    B.require_dtype(name, pos, torch.int32, "pos")
    B.require_dtype(name, k_cache, cache_dtype, "k_cache")
    B.require_dtype(name, v_cache, cache_dtype, "v_cache")
    b, h, d = q.shape
    _, hk, m, dk = k_cache.shape
    if (k_cache.shape[0] != b or v_cache.shape != k_cache.shape or dk != d
            or h % hk or pos.shape != (b,)):
        raise ValueError(f"{name}: shapes q {tuple(q.shape)}, k/v "
                         f"{tuple(k_cache.shape)}/{tuple(v_cache.shape)}, "
                         f"pos {tuple(pos.shape)} do not fit")
    return b, h, hk, m, d


def decode_attention(q, k_cache, v_cache, pos, *, k_scale=None, v_scale=None,
                     window: int = 0, softcap: float = 0.0):
    """q [B, H, D]; k/v cache [B, HK, M, D] in q's dtype (or int8 with
    ``k_scale``/``v_scale`` [B, HK, M] f32); pos [B] int32 (attend to
    positions <= pos[b]) -> [B, H, D]."""
    if q.device.type == "cpu":
        return ref.decode_attention(q, k_cache, v_cache, pos, k_scale=k_scale,
                                    v_scale=v_scale, window=window, softcap=softcap)
    if k_scale is not None:
        return decode_attention_quant(q, k_cache, v_cache, k_scale, v_scale, pos,
                                      window=window, softcap=softcap)
    name = "decode_attention"
    B.require_cuda(name, q=q, k_cache=k_cache, v_cache=v_cache, pos=pos)
    b, h, hk, m, d = _check(name, q, k_cache, v_cache, pos, q.dtype)
    out = torch.empty_like(q)
    B.check(B.library().tm_decode_attention(
        q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(), pos.data_ptr(),
        out.data_ptr(), b * hk, hk, h // hk, m, d, int(window), float(softcap),
        1.0 / math.sqrt(d), B.dtype_code(q.dtype), B.stream(q.device)), name)
    decode_attention.launches += 1
    return out


def decode_attention_quant(q, k_cache, v_cache, k_scale, v_scale, pos, *,
                           window: int = 0, softcap: float = 0.0):
    """:func:`decode_attention` over an int8 cache with f32 row scales."""
    if q.device.type == "cpu":
        return ref.decode_attention(q, k_cache, v_cache, pos, k_scale=k_scale,
                                    v_scale=v_scale, window=window, softcap=softcap)
    name = "decode_attention_quant"
    B.require_cuda(name, q=q, k_cache=k_cache, v_cache=v_cache, k_scale=k_scale,
                   v_scale=v_scale, pos=pos)
    b, h, hk, m, d = _check(name, q, k_cache, v_cache, pos, torch.int8)
    for what, t in (("k_scale", k_scale), ("v_scale", v_scale)):
        B.require_dtype(name, t, torch.float32, what)
        if t.shape != (b, hk, m):
            raise ValueError(f"{name}: {what} {tuple(t.shape)} != {(b, hk, m)}")
    out = torch.empty_like(q)
    B.check(B.library().tm_decode_attention_quant(
        q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(), k_scale.data_ptr(),
        v_scale.data_ptr(), pos.data_ptr(), out.data_ptr(), b * hk, hk, h // hk, m,
        d, int(window), float(softcap), 1.0 / math.sqrt(d), B.dtype_code(q.dtype),
        B.stream(q.device)), name)
    decode_attention_quant.launches += 1
    return out


def decode_attention_paged(q, k_pool, v_pool, page_table, pos, *, k_scale=None,
                           v_scale=None, window: int = 0, softcap: float = 0.0):
    """q [B, H, D] against k/v pools [P, HK, ps, D] in q's dtype (or int8
    with ``k_scale``/``v_scale`` pools [P, HK, ps] f32), slot b's logical
    row r at row r % ps of page ``page_table[b, r // ps]`` (``page_table``
    [B, NB] int32); pos [B] int32 -> [B, H, D]."""
    if q.device.type == "cpu":
        return ref.decode_attention_paged(q, k_pool, v_pool, page_table, pos,
                                          k_scale=k_scale, v_scale=v_scale,
                                          window=window, softcap=softcap)
    if k_scale is not None:
        return decode_attention_paged_quant(q, k_pool, v_pool, k_scale, v_scale,
                                            page_table, pos, window=window,
                                            softcap=softcap)
    out = _launch_paged("decode_attention_paged", q, k_pool, v_pool, None, None,
                        page_table, pos, window, softcap)
    decode_attention_paged.launches += 1
    return out


def decode_attention_paged_quant(q, k_pool, v_pool, k_scale, v_scale, page_table, pos,
                                 *, window: int = 0, softcap: float = 0.0):
    """:func:`decode_attention_paged` over int8 pools with f32 row scales."""
    if q.device.type == "cpu":
        return ref.decode_attention_paged(q, k_pool, v_pool, page_table, pos,
                                          k_scale=k_scale, v_scale=v_scale,
                                          window=window, softcap=softcap)
    out = _launch_paged("decode_attention_paged_quant", q, k_pool, v_pool, k_scale,
                        v_scale, page_table, pos, window, softcap)
    decode_attention_paged_quant.launches += 1
    return out


def _launch_paged(name, q, k_pool, v_pool, k_scale, v_scale, page_table, pos, window,
                  softcap):
    quant = k_scale is not None
    tensors = dict(q=q, k_pool=k_pool, v_pool=v_pool, page_table=page_table, pos=pos)
    if quant:
        tensors.update(k_scale=k_scale, v_scale=v_scale)
    B.require_cuda(name, **tensors)
    B.require_dtype(name, pos, torch.int32, "pos")
    B.require_dtype(name, page_table, torch.int32, "page_table")
    for what in ("k_pool", "v_pool"):
        B.require_dtype(name, tensors[what], torch.int8 if quant else q.dtype, what)
    b, h, d = q.shape
    p, hk, ps, dk = k_pool.shape
    nb = page_table.shape[1]
    if (v_pool.shape != k_pool.shape or dk != d or h % hk or page_table.shape != (b, nb)
            or pos.shape != (b,)):
        raise ValueError(f"{name}: shapes q {tuple(q.shape)}, k/v pools "
                         f"{tuple(k_pool.shape)}/{tuple(v_pool.shape)}, page_table "
                         f"{tuple(page_table.shape)}, pos {tuple(pos.shape)} do not fit")
    if p * hk * ps >= 2 ** 31:
        raise ValueError(f"{name}: {p * hk * ps} pool rows overflow the kernel's int32 rows")
    if quant:
        for what, t in (("k_scale", k_scale), ("v_scale", v_scale)):
            B.require_dtype(name, t, torch.float32, what)
            if t.shape != (p, hk, ps):
                raise ValueError(f"{name}: {what} {tuple(t.shape)} != {(p, hk, ps)}")
    out = torch.empty_like(q)
    B.check(B.library().tm_decode_attention_paged(
        q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
        k_scale.data_ptr() if quant else None, v_scale.data_ptr() if quant else None,
        page_table.data_ptr(), pos.data_ptr(), out.data_ptr(), b * hk, hk, h // hk, nb, ps,
        d, int(window), float(softcap), 1.0 / math.sqrt(d), int(quant),
        B.dtype_code(q.dtype), B.stream(q.device)), name)
    return out


decode_attention.launches = 0
decode_attention_quant.launches = 0
decode_attention_paged.launches = 0
decode_attention_paged_quant.launches = 0
