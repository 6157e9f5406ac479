"""Plain PyTorch version of the fused norm-quant prologue
(``repro/kernels/fused_norm_quant/ref.py``): exactly
``quantize_act(rmsnorm(x, gamma))``, with the normalized row cast back to
the input dtype before the absmax pass; ``norm_quant_tables`` adds the
table-lookup engine's tables of the int8 row (``build_tables``)."""

from __future__ import annotations

import torch

from ...core import ternary
from ...core.tl_matmul import GROUP, build_tables


def rmsnorm(x: torch.Tensor, gamma: torch.Tensor, *, eps: float = 1e-5) -> torch.Tensor:
    xf = x.to(torch.float32)
    rms = torch.rsqrt(torch.mean(xf * xf, dim=-1, keepdim=True) + eps)
    return (xf * rms * gamma.to(torch.float32)).to(x.dtype)


def norm_quant(x: torch.Tensor, gamma: torch.Tensor, *, eps: float = 1e-5):
    """x [..., N], gamma [N] -> (int8 [..., N], f32 scale [..., 1])."""
    return ternary.quantize_act(rmsnorm(x, gamma, eps=eps))


def norm_quant_tables(x: torch.Tensor, gamma: torch.Tensor, *, eps: float = 1e-5):
    """-> (int8 [..., N], f32 scale [..., 1], f32 tables [..., ⌈N/3⌉·27]):
    :func:`norm_quant`, then ``build_tables`` of the int8 row, zero-padded
    after the norm."""
    x_i8, scale = norm_quant(x, gamma, eps=eps)
    t = -(-x.shape[-1] // GROUP)
    return x_i8, scale, build_tables(x_i8, t=t)
