"""Plain PyTorch versions of the packed ternary kernels
(``repro/kernels/ternary_matmul/ref.py`` and the XLA forms of
``repro/core/bitlinear.py``): unpack the planar pack2 weights, integer
matmul, dequant epilogue ``(acc · x_scale) · w_scale``, then the residual
add in the output dtype; SwiGLU is gate and up in the act dtype,
``silu(g) · u`` at the reference's rounding points, then ``quantize_act``."""

from __future__ import annotations

import torch

from ...core import ternary
from ...core.packing import unpack2


def ternary_matmul(x_i8, x_scale, wp, w_scale, *, out_dtype=torch.float32,
                   residual=None):
    """x_i8 [..., N] int8, x_scale [..., 1] f32, wp uint8 [N/4, K], w_scale
    f32 scalar -> [..., K] out_dtype (+ residual, added in out_dtype)."""
    out = ternary.ternary_matmul_ref(x_i8, x_scale, unpack2(wp), w_scale,
                                     out_dtype=out_dtype)
    return out if residual is None else out + residual.to(out_dtype)


ternary_gemv = ternary_matmul  # same function; the kernels differ by M only


def silu(g: torch.Tensor) -> torch.Tensor:
    """``g · sigmoid(g)`` in g's dtype, rounded after each op."""
    sig = torch.sigmoid(g.to(torch.float32)).to(g.dtype)
    return g * sig


def ternary_swiglu(x_i8, x_scale, wg, wg_scale, wu, wu_scale, *,
                   act_dtype=torch.bfloat16):
    """-> (h_i8 [..., K], h_scale [..., 1]), h = silu(x·Wg) · (x·Wu)."""
    g = ternary_matmul(x_i8, x_scale, wg, wg_scale, out_dtype=act_dtype)
    u = ternary_matmul(x_i8, x_scale, wu, wu_scale, out_dtype=act_dtype)
    return ternary.quantize_act(silu(g) * u)
