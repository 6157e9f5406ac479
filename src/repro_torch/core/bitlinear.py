"""BitLinear on the packed serving path (``repro/core/bitlinear.py``).

Only ``mode="packed"`` with the fused pipeline is ported: weights live
2-bit packed (``wp`` uint8 [N/4, K], per-matrix f32 ``scale``); the input is
a float row (quantized here) or the pre-quantized ``(x_i8, x_scale)`` pair
from the norm-quant prologue or the SwiGLU epilogue; a ``residual`` is
added in the dequant epilogue. The matmul goes through the kernel set
(``repro_torch.kernels``), whose wrappers launch the CUDA kernels on a CUDA
tensor and run the plain versions on a CPU tensor.
"""

from __future__ import annotations

import torch

from . import ternary
from .packing import pack2
from .params import ParamSpec


def spec(n_in: int, n_out: int) -> dict:
    """Declare a ternary BitLinear weight [n_in, n_out]."""
    return {"w": ParamSpec((n_in, n_out), quant="ternary")}


def dense_spec(n_in: int, n_out: int) -> dict:
    return {"w": ParamSpec((n_in, n_out))}


def pack_params(w: torch.Tensor) -> dict:
    """Latent float weight [..., N, K] -> ``{"wp": uint8 [..., N/4, K],
    "scale": f32 [...]}``, one absmean scale per stacked matrix."""
    if w.ndim == 2:
        w_t, w_scale = ternary.ternarize(w)
        return {"wp": pack2(w_t), "scale": w_scale}
    flat = w.reshape((-1,) + tuple(w.shape[-2:]))
    packed, scales = [], []
    for i in range(flat.shape[0]):
        w_t, w_scale = ternary.ternarize(flat[i])
        packed.append(pack2(w_t))
        scales.append(w_scale)
    wp = torch.stack(packed).reshape(tuple(w.shape[:-2]) + (w.shape[-2] // 4, w.shape[-1]))
    return {"wp": wp, "scale": torch.stack(scales).reshape(w.shape[:-2])}


def apply(params: dict, x, *, kernels, out_dtype=None, residual=None):
    """Packed BitLinear: ``x [..., N]`` float or ``(x_i8, x_scale)`` ->
    ``[..., K]`` in ``out_dtype`` (default: the residual's or x's dtype)."""
    if out_dtype is None:
        if isinstance(x, tuple) and residual is None:
            raise ValueError("pre-quantized input requires out_dtype= "
                             "(or a residual to infer it from)")
        out_dtype = residual.dtype if residual is not None else x.dtype
    x_i8, x_scale = x if isinstance(x, tuple) else ternary.quantize_act(x)
    return kernels.ternary_gemv(x_i8, x_scale, params["wp"], params["scale"],
                                out_dtype=out_dtype, residual=residual)


def swiglu(gate_params: dict, up_params: dict, xq: tuple, *, kernels,
           act_dtype=torch.bfloat16) -> tuple:
    """Fused packed SwiGLU: ``(x_i8, x_scale) -> (h_i8, h_scale)``."""
    x_i8, x_scale = xq
    return kernels.ternary_swiglu(
        x_i8, x_scale, gate_params["wp"], gate_params["scale"],
        up_params["wp"], up_params["scale"], act_dtype=act_dtype)


def dense_apply(params: dict, x: torch.Tensor, *, out_dtype=None) -> torch.Tensor:
    """High-precision linear (LM head): ``x @ w`` in x's dtype, then cast."""
    out_dtype = out_dtype or x.dtype
    return torch.matmul(x, params["w"].to(x.dtype)).to(out_dtype)
