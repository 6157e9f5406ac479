"""Ternary weights and int8 activations (``repro/core/ternary.py:36-105,207``).

Weights: absmean scale, then {-1, 0, +1}. Activations and KV-cache rows:
per-token absmax int8. ``quantize_act`` computes the scale and ``x / scale`` in the *input*
dtype and rounds half to even (``torch.round``), as the JAX reference does,
so bf16 rows give the same codes on both sides.
"""

from __future__ import annotations

import torch

_EPS = 1e-8  # guards divisions by zero scales (all-zero tensors)


def ternary_scale(w: torch.Tensor) -> torch.Tensor:
    """BitNet-1.58 per-tensor absmean scale, gamma = mean(|W|)."""
    return torch.clamp(w.abs().mean(), min=_EPS)


def ternarize(w: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Hard-ternarize: ``(w_t int8 in {-1,0,1}, scale f32)``."""
    scale = ternary_scale(w)
    w_t = torch.clamp(torch.round(w / scale), -1, 1).to(torch.int8)
    return w_t, scale.to(torch.float32)


def absmax_scale(x: torch.Tensor) -> torch.Tensor:
    """Per-token absmax scale over the last axis, in ``x.dtype``. Clamping
    at the f32 ``1e-8`` equals the reference's max with ``1e-8`` rounded to
    ``x.dtype``: no value of that dtype lies strictly between the two. The
    divisor is a tensor, not a Python number: PyTorch's CUDA division by a
    number multiplies by its reciprocal, which can miss the quotient by an
    ulp, while the reference and the CUDA kernels divide."""
    amax = x.abs().amax(dim=-1, keepdim=True)
    return torch.clamp(amax, min=_EPS) / torch.full_like(amax, 127.0)


def quantize_act(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Hard int8 absmax quantization over the last axis: ``(x_i8, scale f32)``."""
    scale = absmax_scale(x)
    x_i8 = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return x_i8, scale.to(torch.float32)


def quantize_kv(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """KV-cache rows ``x [..., D]`` -> ``(x_i8 [..., D], scale f32 [...])``:
    :func:`quantize_act` with the scale axis squeezed, one f32 per row."""
    x_i8, scale = quantize_act(x)
    return x_i8, scale.squeeze(-1)


def dequantize_kv(x_i8: torch.Tensor, scale: torch.Tensor,
                  dtype=torch.float32) -> torch.Tensor:
    """Inverse of :func:`quantize_kv`: the product in f32, then one cast to
    ``dtype`` (the attention compute dtype)."""
    return (x_i8.to(torch.float32) * scale[..., None].to(torch.float32)).to(dtype)


def ternary_matmul_ref(x_i8: torch.Tensor, x_scale: torch.Tensor,
                       w_t: torch.Tensor, w_scale: torch.Tensor, *,
                       out_dtype=torch.float32) -> torch.Tensor:
    """(x_i8·sx) @ (w_t·sw) with an exact integer accumulator.

    The product runs in float32: every partial sum is an integer below
    127·N < 2^24 for N < 132104, so float32 holds it exactly whatever the
    summation order (and the TF32 input rounding keeps 127 and ±1 exact).
    The epilogue is ``(acc · x_scale) · w_scale``, then one cast.
    """
    n = x_i8.shape[-1]
    if 127 * n >= 2 ** 24:
        raise ValueError(f"contraction {n} too long for an exact f32 accumulator")
    acc = torch.matmul(x_i8.to(torch.float32), w_t.to(torch.float32))
    return (acc * x_scale * w_scale).to(out_dtype)
