"""Dispatch for decode attention: the plain version for CPU tensors, the
CUDA kernel (``csrc/decode_attention.cu``) for CUDA tensors."""

from __future__ import annotations

import math

import torch

from .. import _build as B
from . import ref


def decode_attention(q, k_cache, v_cache, pos, *, window: int = 0,
                     softcap: float = 0.0):
    """q [B, H, D]; k/v cache [B, HK, M, D] in q's dtype; pos [B] int32
    (attend to positions <= pos[b]) -> [B, H, D]."""
    if q.device.type == "cpu":
        return ref.decode_attention(q, k_cache, v_cache, pos, window=window,
                                    softcap=softcap)
    name = "decode_attention"
    B.require_cuda(name, q=q, k_cache=k_cache, v_cache=v_cache, pos=pos)
    B.require_dtype(name, pos, torch.int32, "pos")
    B.require_dtype(name, k_cache, q.dtype, "k_cache")
    B.require_dtype(name, v_cache, q.dtype, "v_cache")
    b, h, d = q.shape
    _, hk, m, dk = k_cache.shape
    if (k_cache.shape[0] != b or v_cache.shape != k_cache.shape or dk != d
            or h % hk or pos.shape != (b,)):
        raise ValueError(f"{name}: shapes q {tuple(q.shape)}, k/v "
                         f"{tuple(k_cache.shape)}/{tuple(v_cache.shape)}, "
                         f"pos {tuple(pos.shape)} do not fit")
    out = torch.empty_like(q)
    B.check(B.library().tm_decode_attention(
        q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(), pos.data_ptr(),
        out.data_ptr(), b * hk, hk, h // hk, m, d, int(window), float(softcap),
        1.0 / math.sqrt(d), B.dtype_code(q.dtype), B.stream(q.device)), name)
    decode_attention.launches += 1
    return out


decode_attention.launches = 0
