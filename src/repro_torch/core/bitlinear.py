"""BitLinear on the packed serving path (``repro/core/bitlinear.py``).

Only ``mode="packed"`` with the fused pipeline is ported: weights live
2-bit packed (``wp`` uint8 [N/4, K], per-matrix f32 ``scale``); the input is
a float row (quantized here), the pre-quantized ``(x_i8, x_scale)`` pair
from the norm-quant prologue or the SwiGLU epilogue, or the prologue's
``(x_i8, x_scale, tables)`` triple; a ``residual`` is added in the dequant
epilogue. The matmul goes through the kernel set (``repro_torch.kernels``),
whose wrappers launch the CUDA kernels on a CUDA tensor and run the plain
versions on a CPU tensor.

Two engines compute the same product bit for bit (``bitlinear.py:128-147``):
the packed kernels, and the table-lookup (TL) engine, which reads the group
indices ``w_idx`` [⌈N/3⌉, K] uint8 that :func:`with_tl_tree` adds to every
packed node once. ``engine="tl"`` forces TL, ``"packed"`` pins packed, and
``"auto"`` takes TL only for a node with ``w_idx`` whose shape has a
measured TL win on record (``kernels/autotune.py``).
"""

from __future__ import annotations

import torch

from . import ternary
from .packing import pack2, unpack2
from .params import ParamSpec
from .tl_matmul import GROUP as TL_GROUP
from .tl_matmul import tl_indices

ENGINES = ("packed", "tl", "auto")


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


def with_tl_indices(params: dict) -> dict:
    """A packed node with its group indices ``w_idx [..., ⌈N/3⌉, K]`` uint8
    added (``core.tl_matmul.tl_indices``, on the device of ``wp``)."""
    return dict(params, w_idx=tl_indices(params["wp"]))


def with_tl_tree(params):
    """Add ``w_idx`` to every packed node of a tree, once, before serving;
    idempotent, and nodes without packed weights pass through."""
    if isinstance(params, dict):
        if "wp" in params and "scale" in params:
            return params if "w_idx" in params else with_tl_indices(params)
        return {k: with_tl_tree(v) for k, v in params.items()}
    return params


def _quantized_input(x) -> tuple:
    """``(x_i8, x_scale, tables | None)`` from a float row (quantized here),
    a pre-quantized pair, or the prologue's triple."""
    if isinstance(x, tuple):
        return x if len(x) == 3 else (*x, None)
    return (*ternary.quantize_act(x), None)


def resolve_engine(params: dict, m: int, *, engine: str = "auto") -> str:
    """The engine of one projection over ``m`` rows: ``"tl"`` or
    ``"packed"``. ``"tl"`` forces TL; ``"auto"`` takes it only for a node
    with ``w_idx`` (2-D weights) whose (M, N, K) has a measured TL win on
    record; everything else, ``"packed"`` included, resolves to packed."""
    if engine == "tl":
        return "tl"
    if engine not in ENGINES:
        raise ValueError(f"matmul engine must be one of {ENGINES}, got {engine!r}")
    if engine == "auto" and "w_idx" in params and params["wp"].ndim == 2:
        from ..kernels import autotune

        n4, k = params["wp"].shape
        if autotune.choose_engine(m, n4 * 4, k) == "tl":
            return "tl"
    return "packed"


def _rows(x_i8) -> int:
    return x_i8.numel() // x_i8.shape[-1]


def _node_indices(params: dict):
    """The node's ``w_idx``, derived from ``wp`` when not precomputed."""
    if params["wp"].ndim != 2:
        raise ValueError("the TL engine takes 2-D weights only")
    w_idx = params.get("w_idx")
    return tl_indices(params["wp"]) if w_idx is None else w_idx


def _tables_for(tables, w_idx):
    """The prologue's tables, if they are for this contraction width."""
    if tables is not None and tables.shape[-1] != w_idx.shape[0] * 3 ** TL_GROUP:
        return None
    return tables


def apply(params: dict, x, *, kernels, out_dtype=None, residual=None, engine: str = "auto"):
    """BitLinear: ``x [..., N]`` float, ``(x_i8, x_scale)`` or ``(x_i8,
    x_scale, tables)`` -> ``[..., K]`` in ``out_dtype`` (default: the
    residual's or x's dtype), through the engine :func:`resolve_engine`
    picks."""
    if out_dtype is None:
        if isinstance(x, tuple) and residual is None:
            raise ValueError("pre-quantized input requires out_dtype= "
                             "(or a residual to infer it from)")
        out_dtype = residual.dtype if residual is not None else x.dtype
    x_i8, x_scale, tables = _quantized_input(x)
    if resolve_engine(params, _rows(x_i8), engine=engine) == "tl":
        w_idx = _node_indices(params)
        return kernels.tl_matmul(x_i8, x_scale, w_idx, params["scale"],
                                 tables=_tables_for(tables, w_idx), residual=residual,
                                 out_dtype=out_dtype)
    return kernels.ternary_gemv(x_i8, x_scale, params["wp"], params["scale"],
                                out_dtype=out_dtype, residual=residual)


def swiglu(gate_params: dict, up_params: dict, xq: tuple, *, kernels,
           act_dtype=torch.bfloat16, engine: str = "auto") -> tuple:
    """Fused SwiGLU: ``(x_i8, x_scale[, tables]) -> (h_i8, h_scale)``; the
    engine is the gate's, and under TL gate and up share one table set."""
    x_i8, x_scale, tables = _quantized_input(xq)
    if resolve_engine(gate_params, _rows(x_i8), engine=engine) == "tl":
        wg_idx, wu_idx = _node_indices(gate_params), _node_indices(up_params)
        return kernels.tl_swiglu(
            x_i8, x_scale, wg_idx, gate_params["scale"], wu_idx, up_params["scale"],
            tables=_tables_for(tables, wg_idx), act_dtype=act_dtype)
    return kernels.ternary_swiglu(
        x_i8, x_scale, gate_params["wp"], gate_params["scale"],
        up_params["wp"], up_params["scale"], act_dtype=act_dtype)


def material_weight(params: dict, *, dtype=torch.bfloat16) -> torch.Tensor:
    """The effective float weight of a packed node, ``unpack2(wp) · scale``
    in f32, then cast to ``dtype`` (``bitlinear.py:326-337``, packed mode):
    for paths that need the matrix itself, MLA's weight-absorbed decode."""
    w = unpack2(params["wp"]).to(torch.float32) * params["scale"].to(torch.float32)
    return w.to(dtype)


def dense_apply(params: dict, x: torch.Tensor, *, out_dtype=None) -> torch.Tensor:
    """High-precision linear (LM head): ``x @ w`` in x's dtype, then cast."""
    out_dtype = out_dtype or x.dtype
    return torch.matmul(x, params["w"].to(x.dtype)).to(out_dtype)
