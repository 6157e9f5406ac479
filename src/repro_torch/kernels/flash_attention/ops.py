"""Dispatch for causal prefill attention: the plain version for CPU
tensors, the CUDA kernel (``csrc/flash_attention.cu``) for CUDA tensors:
bf16 on the tensor cores, f32 on the CUDA cores."""

from __future__ import annotations

import math

import torch

from .. import _build as B
from . import ref

# The kernel's instantiated (q/k head dim, v head dim) pairs.
HEAD_DIMS = ((16, 16), (32, 32), (64, 64), (96, 96), (128, 128), (192, 128))


def head_dims_for(dqk: int, dv: int) -> tuple[int, int]:
    """The smallest instantiated pair that holds (dqk, dv)."""
    for pair in HEAD_DIMS:
        if pair[0] >= dqk and pair[1] >= dv:
            return pair
    raise ValueError(f"flash_attention: head dims ({dqk}, {dv}) exceed every "
                     f"instantiated pair {HEAD_DIMS}")


def _pad_last(t: torch.Tensor, n: int) -> torch.Tensor:
    return t if t.shape[-1] == n else torch.nn.functional.pad(t, (0, n - t.shape[-1]))


def flash_attention(q, k, v, *, scale: float | None = None, window: int = 0,
                    softcap: float = 0.0, causal_skip: bool = True):
    """q [B, H, S, Dqk], k [B, HK, S, Dqk], v [B, HK, S, Dv] (H % HK == 0),
    one dtype (f32 or bf16) -> [B, H, S, Dv], causal, scores times
    ``scale`` (default 1/sqrt(Dqk)), capped as ``softcap * tanh(s /
    softcap)`` when ``softcap > 0``, and, with a sliding ``window > 0``,
    masked at ``qpos - kpos >= window``. A (Dqk, Dv) pair without an
    instantiation runs zero-padded up to the next one that holds it (zero
    columns add exact zeros to q.k and give zero output columns, sliced
    off). ``causal_skip=False`` runs the dense schedule (every kv tile
    visited and masked: the same output, the paper's Table II ablation)."""
    if q.device.type == "cpu":
        return ref.flash_attention(q, k, v, scale=scale, window=window, softcap=softcap,
                                   causal_skip=causal_skip)
    name = "flash_attention"
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    B.require_cuda(name, q=q, k=k, v=v)
    code = B.dtype_code(q.dtype)
    for what, t in (("k", k), ("v", v)):
        B.require_dtype(name, t, q.dtype, what)
    b, h, s, dqk = q.shape
    hk, dv = k.shape[1], v.shape[-1]
    if window < 0 or softcap < 0:
        raise ValueError(f"{name}: window {window} and softcap {softcap} must be >= 0")
    if (k.shape != (b, hk, s, dqk) or v.shape != (b, hk, s, dv) or hk == 0 or h % hk):
        raise ValueError(f"{name}: shapes q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)} do not fit")
    pq, pv = head_dims_for(dqk, dv)
    q, k, v = _pad_last(q, pq), _pad_last(k, pq), _pad_last(v, pv)
    for what, t in (("q", q), ("k", k), ("v", v)):  # read as 16-byte vectors
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: {what} is not 16-byte aligned")
    out = q.new_empty((b, h, s, pv))
    scale = 1.0 / math.sqrt(dqk) if scale is None else float(scale)
    rc = B.library().tm_flash_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, h, hk, s, pq, pv,
        scale, int(window), float(softcap), int(bool(causal_skip)), code, B.stream(q.device))
    B.check(rc, name)
    flash_attention.launches += 1
    return out if pv == dv else out[..., :dv]


flash_attention.launches = 0
