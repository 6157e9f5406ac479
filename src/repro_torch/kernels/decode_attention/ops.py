"""Dispatch for decode attention: the plain version for CPU tensors, the
CUDA kernel (``csrc/decode_attention.cu``) for CUDA tensors. An int8 cache
(``k_scale``/``v_scale`` given) goes to :func:`decode_attention_quant`, the
kernel's int8 variant, with its own launch count."""

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


decode_attention.launches = 0
decode_attention_quant.launches = 0
