"""Dispatch for decode attention: the plain version for CPU tensors, the
CUDA kernel (``csrc/decode_attention.cu``) for CUDA tensors. An int8 cache
(``k_scale``/``v_scale`` given) goes to :func:`decode_attention_quant`, the
kernel's int8 variant, with its own launch count. The paged layout (page
pools read through a page table) goes to :func:`decode_attention_paged`
and :func:`decode_attention_paged_quant`, the kernel's paged variants.

The kernel splits each slot's cache rows over blocks of ``SPLIT_ROWS``
rows and merges the splits' partial softmax sums in the launch: scratch for
the partials comes from ``torch.empty``, and the merge's arrival tickets
from one zeroed int32 buffer per device, which the kernel leaves zeroed. The
split is fixed, so a slot's live rows are cut at the same places whatever
the cache length: ``generate``'s short cache and the engine's long one round
alike. No wrapper reads ``pos`` on the host, so a call makes no
device-to-host transfer and can be captured in a CUDA graph once the
device's ticket buffer exists (made at the first call with more than one
split)."""

from __future__ import annotations

import math

import torch

from .. import _build as B
from . import ref

SPLIT_ROWS = 128  # cache rows per block of the kernel
HEAD_DIMS = (16, 32, 64, 96, 128)

_TICKETS: dict[int, torch.Tensor] = {}  # device index -> int32 zeros


def _scratch(name, q, b, h, m, d):
    """(partials, tickets) for a launch over an M-row cache; None with one
    split."""
    splits = -(-m // SPLIT_ROWS)
    if splits == 1:
        return None, None
    part = torch.empty(b * h * splits * (d + 2), dtype=torch.float32, device=q.device)
    index = q.device.index if q.device.index is not None else torch.cuda.current_device()
    tickets = _TICKETS.get(index)
    if tickets is None or tickets.numel() < b * h:
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError(f"{name}: the ticket buffer of cuda:{index} is made at the "
                               "first call; make one call outside graph capture first")
        tickets = torch.zeros(max(b * h, 4096), dtype=torch.int32, device=q.device)
        _TICKETS[index] = tickets
    return part, tickets


def _ptr(t):
    return None if t is None else t.data_ptr()


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
    _check_rows(name, d, k_cache, v_cache)
    return b, h, hk, m, d


def _check_rows(name, d, k_cache, v_cache):
    if d not in HEAD_DIMS:
        raise ValueError(f"{name}: head_dim {d} is not one of 16, 32, 64, 96, 128")
    for what, t in (("k", k_cache), ("v", v_cache)):  # read as 8- and 16-byte pieces
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: {what} is not 16-byte aligned")


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
    part, tickets = _scratch(name, q, b, h, m, d)
    B.check(B.library().tm_decode_attention(
        q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(), pos.data_ptr(),
        out.data_ptr(), _ptr(part), _ptr(tickets), b * hk, hk, h // hk, m, d, int(window),
        float(softcap), 1.0 / math.sqrt(d), SPLIT_ROWS, B.dtype_code(q.dtype),
        B.stream(q.device)), name)
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
    part, tickets = _scratch(name, q, b, h, m, d)
    B.check(B.library().tm_decode_attention_quant(
        q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(), k_scale.data_ptr(),
        v_scale.data_ptr(), pos.data_ptr(), out.data_ptr(), _ptr(part), _ptr(tickets),
        b * hk, hk, h // hk, m, d, int(window), float(softcap), 1.0 / math.sqrt(d),
        SPLIT_ROWS, B.dtype_code(q.dtype), B.stream(q.device)), name)
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
    _check_rows(name, d, k_pool, v_pool)
    if quant:
        for what, t in (("k_scale", k_scale), ("v_scale", v_scale)):
            B.require_dtype(name, t, torch.float32, what)
            if t.shape != (p, hk, ps):
                raise ValueError(f"{name}: {what} {tuple(t.shape)} != {(p, hk, ps)}")
    out = torch.empty_like(q)
    part, tickets = _scratch(name, q, b, h, nb * ps, d)
    B.check(B.library().tm_decode_attention_paged(
        q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(), _ptr(k_scale), _ptr(v_scale),
        page_table.data_ptr(), pos.data_ptr(), out.data_ptr(), _ptr(part), _ptr(tickets),
        b * hk, hk, h // hk, nb, ps, d, int(window), float(softcap), 1.0 / math.sqrt(d),
        SPLIT_ROWS, int(quant), B.dtype_code(q.dtype), B.stream(q.device)), name)
    return out


decode_attention.launches = 0
decode_attention_quant.launches = 0
decode_attention_paged.launches = 0
decode_attention_paged_quant.launches = 0
