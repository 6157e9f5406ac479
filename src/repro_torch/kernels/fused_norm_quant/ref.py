"""Plain PyTorch version of the fused norm-quant prologue
(``repro/kernels/fused_norm_quant/ref.py``): exactly
``quantize_act(rmsnorm(x, gamma))``, with the normalized row cast back to
the input dtype before the absmax pass."""

from __future__ import annotations

import torch

from ...core import ternary


def rmsnorm(x: torch.Tensor, gamma: torch.Tensor, *, eps: float = 1e-5) -> torch.Tensor:
    xf = x.to(torch.float32)
    rms = torch.rsqrt(torch.mean(xf * xf, dim=-1, keepdim=True) + eps)
    return (xf * rms * gamma.to(torch.float32)).to(x.dtype)


def norm_quant(x: torch.Tensor, gamma: torch.Tensor, *, eps: float = 1e-5):
    """x [..., N], gamma [N] -> (int8 [..., N], f32 scale [..., 1])."""
    return ternary.quantize_act(rmsnorm(x, gamma, eps=eps))
