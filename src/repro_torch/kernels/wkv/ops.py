"""Dispatch for the WKV recurrence: the plain version for CPU tensors, the
CUDA kernel (``csrc/wkv.cu``) for CUDA tensors. Like
``repro/kernels/wkv/ops.py`` it starts from a zero state; a warm state is
the decode step's, which stays plain torch."""

from __future__ import annotations

import torch

from .. import _build as B
from . import ref


def wkv(r, k, v, logw, u):
    """r/k/v [B, H, S, n] (f32 or bf16, one dtype), logw [B, H, S, n] f32,
    u [H, n] f32 -> (y [B, H, S, n] f32, sN [B, H, n, n] f32). The four
    inputs may be strided views (``time_mix`` passes [B, S, H, n] tensors
    transposed) as long as they share their strides and the last axis is
    contiguous; u is contiguous."""
    if r.device.type == "cpu":
        return ref.wkv(r, k, v, logw, u)
    name = "wkv"
    ins = [r, k, v, logw]
    B.require_cuda(name, contiguous=False, r=r, k=k, v=v, logw=logw, u=u)
    code = B.dtype_code(r.dtype)
    for what, t in (("k", k), ("v", v)):
        B.require_dtype(name, t, r.dtype, what)
    for what, t in (("logw", logw), ("u", u)):
        B.require_dtype(name, t, torch.float32, what)
    b, h, s, n = r.shape
    if any(t.shape != r.shape for t in ins) or u.shape != (h, n):
        raise ValueError(f"{name}: shapes r/k/v/logw {[tuple(t.shape) for t in ins]}, "
                         f"u {tuple(u.shape)} do not fit")
    if r.stride(-1) != 1 or any(t.stride() != r.stride() for t in ins) or not u.is_contiguous():
        raise ValueError(f"{name}: r/k/v/logw must share their strides with a unit last "
                         f"stride, got {[t.stride() for t in ins]}, and u must be contiguous")
    if n not in (16, 32, 64):
        raise ValueError(f"{name}: head size {n} is not one of 16, 32, 64")
    y = torch.empty((b, h, s, n), dtype=torch.float32, device=r.device)
    s_n = torch.empty((b, h, n, n), dtype=torch.float32, device=r.device)
    sb, sh, ss, _ = r.stride()
    rc = B.library().tm_wkv(
        r.data_ptr(), k.data_ptr(), v.data_ptr(), logw.data_ptr(), u.data_ptr(), y.data_ptr(),
        s_n.data_ptr(), b * h, h, s, n, sb, sh, ss, code, B.stream(r.device))
    B.check(rc, name)
    wkv.launches += 1
    return y, s_n


wkv.launches = 0
