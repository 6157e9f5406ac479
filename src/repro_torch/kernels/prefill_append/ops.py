"""Dispatch for chunked prefill-append attention: the plain version for
CPU tensors, the CUDA kernel (``csrc/prefill_append.cuh``, built as four
sources, one for each layout and cache dtype) for CUDA tensors.
An int8 cache (``k_scale``/``v_scale`` given) goes to
:func:`prefill_append_quant`, the kernel's int8 variant, with its own
launch count. Both write the chunk into the cache in place. The paged
layout (page pools read and written through a page table) goes to
:func:`prefill_append_paged` and :func:`prefill_append_paged_quant`, the
kernel's paged variants."""

from __future__ import annotations

import math

import torch

from .. import _build as B
from . import ref


def prefill_append(q, k_new, v_new, k_cache, v_cache, offset, *, k_scale=None,
                   v_scale=None, window: int = 0, softcap: float = 0.0,
                   prefix_limit: int = 0):
    """q [B, H, C, D] at positions offset[b] + [0, C) (any offset with
    offset + C <= M: a prefill chunk's, a multiple of C, or a speculative
    verify chunk's, at a decode frontier); k/v_new [B, HK, C, D]; k/v cache
    [B, HK, M, D] in q's
    dtype, or int8 with ``k_scale``/``v_scale`` [B, HK, M] f32; offset [B]
    int32. Slots at ``offset >= prefix_limit > 0`` only write; their output
    rows are zero. Appends the chunk in place and returns out [B, H, C, D]."""
    if q.device.type == "cpu":
        return ref.prefill_append(q, k_new, v_new, k_cache, v_cache, offset,
                                  k_scale=k_scale, v_scale=v_scale, window=window,
                                  softcap=softcap, prefix_limit=prefix_limit)
    if k_scale is not None:
        return prefill_append_quant(q, k_new, v_new, k_cache, v_cache, k_scale,
                                    v_scale, offset, window=window, softcap=softcap,
                                    prefix_limit=prefix_limit)
    out = _launch("prefill_append", q, k_new, v_new, k_cache, v_cache, None, None,
                  offset, window, softcap, prefix_limit)
    prefill_append.launches += 1
    return out


def prefill_append_quant(q, k_new, v_new, k_cache, v_cache, k_scale, v_scale,
                         offset, *, window: int = 0, softcap: float = 0.0,
                         prefix_limit: int = 0):
    """:func:`prefill_append` on an int8 cache with f32 row scales."""
    if q.device.type == "cpu":
        return ref.prefill_append(q, k_new, v_new, k_cache, v_cache, offset,
                                  k_scale=k_scale, v_scale=v_scale, window=window,
                                  softcap=softcap, prefix_limit=prefix_limit)
    out = _launch("prefill_append_quant", q, k_new, v_new, k_cache, v_cache,
                  k_scale, v_scale, offset, window, softcap, prefix_limit)
    prefill_append_quant.launches += 1
    return out


def prefill_append_paged(q, k_new, v_new, k_pool, v_pool, page_table, offset, *,
                         k_scale=None, v_scale=None, window: int = 0,
                         softcap: float = 0.0, prefix_limit: int = 0):
    """:func:`prefill_append` over k/v pools [P, HK, ps, D] (q's dtype, or
    int8 with ``k_scale``/``v_scale`` pools [P, HK, ps] f32): slot b's
    logical row r is row r % ps of page ``page_table[b, r // ps]``
    (``page_table`` [B, NB] int32, NB * ps the logical cache length; ps a
    multiple of 32). The chunk's rows may start anywhere in a page and
    straddle page boundaries, as a verify chunk at a decode frontier does;
    they are written into the pools in place, and every page a live chunk
    writes must be mapped by no other slot. Returns out [B, H, C, D]."""
    if q.device.type == "cpu":
        return ref.prefill_append_paged(q, k_new, v_new, k_pool, v_pool, page_table,
                                        offset, k_scale=k_scale, v_scale=v_scale,
                                        window=window, softcap=softcap,
                                        prefix_limit=prefix_limit)
    if k_scale is not None:
        return prefill_append_paged_quant(q, k_new, v_new, k_pool, v_pool, k_scale,
                                          v_scale, page_table, offset, window=window,
                                          softcap=softcap, prefix_limit=prefix_limit)
    out = _launch("prefill_append_paged", q, k_new, v_new, k_pool, v_pool, None, None,
                  offset, window, softcap, prefix_limit, page_table=page_table)
    prefill_append_paged.launches += 1
    return out


def prefill_append_paged_quant(q, k_new, v_new, k_pool, v_pool, k_scale, v_scale,
                               page_table, offset, *, window: int = 0,
                               softcap: float = 0.0, prefix_limit: int = 0):
    """:func:`prefill_append_paged` on int8 pools with f32 row scales."""
    if q.device.type == "cpu":
        return ref.prefill_append_paged(q, k_new, v_new, k_pool, v_pool, page_table,
                                        offset, k_scale=k_scale, v_scale=v_scale,
                                        window=window, softcap=softcap,
                                        prefix_limit=prefix_limit)
    out = _launch("prefill_append_paged_quant", q, k_new, v_new, k_pool, v_pool, k_scale,
                  v_scale, offset, window, softcap, prefix_limit, page_table=page_table)
    prefill_append_paged_quant.launches += 1
    return out


def _launch(name, q, k_new, v_new, k_cache, v_cache, k_scale, v_scale, offset,
            window, softcap, prefix_limit, page_table=None):
    """Check and launch; ``page_table`` (paged) makes k/v_cache and the
    scales page pools [P, HK, ps(, D)]."""
    quant, paged = k_scale is not None, page_table is not None
    q = q.contiguous()
    k_new, v_new = k_new.contiguous(), v_new.contiguous()
    tensors = dict(q=q, k_new=k_new, v_new=v_new, k_cache=k_cache, v_cache=v_cache,
                   offset=offset)
    if quant:
        tensors.update(k_scale=k_scale, v_scale=v_scale)
    if paged:
        tensors.update(page_table=page_table)
        B.require_dtype(name, page_table, torch.int32, "page_table")
    B.require_cuda(name, **tensors)  # the caches are written in place: no copies
    B.require_dtype(name, offset, torch.int32, "offset")
    for what in ("k_new", "v_new"):
        B.require_dtype(name, tensors[what], q.dtype, what)
    cache_dtype = torch.int8 if quant else q.dtype
    B.require_dtype(name, k_cache, cache_dtype, "k_cache")
    B.require_dtype(name, v_cache, cache_dtype, "v_cache")
    b, h, c, d = q.shape
    lead, hk, rows, dk = k_cache.shape  # [B, HK, M, D], or a pool [P, HK, ps, D]
    nb = page_table.shape[1] if paged else 0
    if (v_cache.shape != k_cache.shape or dk != d or h % hk
            or (page_table.shape != (b, nb) if paged else lead != b)
            or k_new.shape != (b, hk, c, d) or v_new.shape != k_new.shape
            or offset.shape != (b,)):
        raise ValueError(f"{name}: shapes q {tuple(q.shape)}, k/v_new "
                         f"{tuple(k_new.shape)}, cache {tuple(k_cache.shape)}, offset "
                         f"{tuple(offset.shape)}"
                         + (f", page_table {tuple(page_table.shape)}" if paged else "")
                         + " do not fit")
    if paged and rows % 32:
        raise ValueError(f"{name}: page size {rows} must be a multiple of 32 (one kv tile)")
    if d not in (16, 32, 64, 96, 128):
        raise ValueError(f"{name}: head_dim {d} is not one of 16, 32, 64, 96, 128")
    for what in ("k_new", "v_new", "k_cache", "v_cache"):  # read as 16-byte vectors
        if tensors[what].data_ptr() % 16:
            raise ValueError(f"{name}: {what} is not 16-byte aligned")
    if quant:
        for what, t in (("k_scale", k_scale), ("v_scale", v_scale)):
            B.require_dtype(name, t, torch.float32, what)
            if t.shape != k_cache.shape[:3]:
                raise ValueError(f"{name}: {what} {tuple(t.shape)} != "
                                 f"{tuple(k_cache.shape[:3])}")
    out = torch.empty_like(q)
    scales = (k_scale.data_ptr() if quant else None, v_scale.data_ptr() if quant else None)
    tail = (int(window), float(softcap), 1.0 / math.sqrt(d), int(prefix_limit), int(quant),
            B.dtype_code(q.dtype), B.stream(q.device))
    lib = B.library()
    if paged:
        if lead * hk * rows >= 2 ** 31:
            raise ValueError(f"{name}: {lead * hk * rows} pool rows overflow int32 rows")
        rc = lib.tm_prefill_append_paged(
            q.data_ptr(), k_new.data_ptr(), v_new.data_ptr(), k_cache.data_ptr(),
            v_cache.data_ptr(), *scales, page_table.data_ptr(), offset.data_ptr(),
            out.data_ptr(), b * hk, hk, h // hk, c, nb, rows, d, *tail)
    else:
        rc = lib.tm_prefill_append(
            q.data_ptr(), k_new.data_ptr(), v_new.data_ptr(), k_cache.data_ptr(),
            v_cache.data_ptr(), *scales, offset.data_ptr(), out.data_ptr(),
            b * hk, hk, h // hk, c, rows, d, *tail)
    B.check(rc, name)
    return out


prefill_append.launches = 0
prefill_append_quant.launches = 0
prefill_append_paged.launches = 0
prefill_append_paged_quant.launches = 0
