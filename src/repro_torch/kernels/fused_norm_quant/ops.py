"""Dispatch for the fused norm-quant prologue: the plain version for a CPU
tensor, the CUDA kernel (``csrc/norm_quant.cu``) for a CUDA tensor."""

from __future__ import annotations

import torch

from ... import _common as C
from .. import _build as B
from . import ref


def norm_quant(x: torch.Tensor, gamma: torch.Tensor, *, eps: float = 1e-5):
    """x [..., N] (f32/bf16), gamma [N] f32 -> (int8 [..., N], f32 [..., 1])."""
    if x.device.type == "cpu":
        return ref.norm_quant(x, gamma, eps=eps)
    name = "norm_quant"
    B.require_cuda(name, x=x, gamma=gamma)
    B.require_dtype(name, gamma, torch.float32, "gamma")
    x2, lead, m = C.flatten_lead(x)
    n = x2.shape[1]
    if gamma.shape != (n,):
        raise ValueError(f"{name}: gamma {tuple(gamma.shape)} != ({n},)")
    q = torch.empty((m, n), dtype=torch.int8, device=x.device)
    qs = torch.empty((m, 1), dtype=torch.float32, device=x.device)
    B.check(B.library().tm_norm_quant(
        x2.data_ptr(), gamma.data_ptr(), q.data_ptr(), qs.data_ptr(), m, n,
        float(eps), B.dtype_code(x.dtype), B.stream(x.device)), name)
    norm_quant.launches += 1
    return q.reshape(*lead, n), qs.reshape(*lead, 1)


norm_quant.launches = 0
