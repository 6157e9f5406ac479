"""Dispatch for causal prefill attention: the plain version for CPU
tensors, the CUDA kernel (``csrc/flash_attention.cu``) for CUDA tensors:
bf16 on the tensor cores, f32 on the CUDA cores."""

from __future__ import annotations

import math

from .. import _build as B
from . import ref


def flash_attention(q, k, v, *, causal_skip: bool = True):
    """q [B, H, S, D], k/v [B, HK, S, D] (H % HK == 0), one dtype (f32 or
    bf16) -> [B, H, S, D], causal. ``causal_skip=False`` runs the dense
    schedule (every kv tile visited and masked: the same output, the
    paper's Table II ablation)."""
    if q.device.type == "cpu":
        return ref.flash_attention(q, k, v, causal_skip=causal_skip)
    name = "flash_attention"
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    B.require_cuda(name, q=q, k=k, v=v)
    code = B.dtype_code(q.dtype)
    for what, t in (("k", k), ("v", v)):
        B.require_dtype(name, t, q.dtype, what)
    b, h, s, d = q.shape
    hk = k.shape[1]
    if k.shape != (b, hk, s, d) or v.shape != k.shape or hk == 0 or h % hk:
        raise ValueError(f"{name}: shapes q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)} do not fit")
    if d not in (16, 32, 64, 96, 128):
        raise ValueError(f"{name}: head_dim {d} is not one of 16, 32, 64, 96, 128")
    for what, t in (("q", q), ("k", k), ("v", v)):  # read as 16-byte vectors
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: {what} is not 16-byte aligned")
    out = q.new_empty(q.shape)
    rc = B.library().tm_flash_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, h, hk, s, d,
        1.0 / math.sqrt(d), int(bool(causal_skip)), code, B.stream(q.device))
    B.check(rc, name)
    flash_attention.launches += 1
    return out


flash_attention.launches = 0
