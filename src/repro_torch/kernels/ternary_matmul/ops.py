"""Dispatch for the packed ternary kernels: the plain versions for CPU
tensors, the CUDA kernels (``csrc/ternary_matmul.cu``,
``csrc/ternary_swiglu.cu``) for CUDA tensors. ``ternary_gemv`` owns the
decode-shape dispatch, as ``repro/kernels/ternary_matmul/ops.py:30`` does:
up to 16 rows take the weight-streaming GEMV, more rows the tiled matmul."""

from __future__ import annotations

import torch

from ... import _common as C
from .. import _build as B
from . import ref

GEMV_MAX_ROWS = 16


def _check_operands(name, x_i8, x_scale, wp, w_scale):
    """Validate one packed projection; returns (x2 [M, N], lead, M, N, K)."""
    B.require_cuda(name, x_i8=x_i8, x_scale=x_scale, wp=wp, w_scale=w_scale)
    B.require_dtype(name, x_i8, torch.int8, "x_i8")
    B.require_dtype(name, x_scale, torch.float32, "x_scale")
    B.require_dtype(name, wp, torch.uint8, "wp")
    B.require_dtype(name, w_scale, torch.float32, "w_scale")
    x2, lead, m = C.flatten_lead(x_i8)
    n = x2.shape[1]
    if wp.ndim != 2 or wp.shape[0] * 4 != n:
        raise ValueError(f"{name}: wp {tuple(wp.shape)} does not pack N={n}")
    if x_scale.numel() != m or w_scale.numel() != 1:
        raise ValueError(f"{name}: x_scale needs {m} elements and w_scale one")
    return x2, lead, m, n, wp.shape[1]


def _projection(entry, name, x_i8, x_scale, wp, w_scale, out_dtype, residual):
    x2, lead, m, n, k = _check_operands(name, x_i8, x_scale, wp, w_scale)
    out = torch.empty((m, k), dtype=out_dtype, device=x_i8.device)
    res_ptr = None
    if residual is not None:
        residual = residual.to(out_dtype)
        B.require_cuda(name, x_i8=x_i8, residual=residual)
        if residual.numel() != m * k:
            raise ValueError(f"{name}: residual {tuple(residual.shape)} != [{m}, {k}]")
        res_ptr = residual.data_ptr()
    B.check(entry(x2.data_ptr(), x_scale.data_ptr(), wp.data_ptr(),
                  w_scale.data_ptr(), res_ptr, out.data_ptr(), m, n, k,
                  B.dtype_code(out_dtype), B.stream(x_i8.device)), name)
    return out.reshape(*lead, k)


def ternary_gemv(x_i8, x_scale, wp, w_scale, *, out_dtype=torch.float32,
                 residual=None):
    """x_i8 [..., N] int8 × packed wp [N/4, K] -> [..., K] in out_dtype,
    ``residual [..., K]`` added in the epilogue. More than 16 rows go to
    :func:`ternary_matmul`."""
    if x_i8.device.type == "cpu":
        return ref.ternary_gemv(x_i8, x_scale, wp, w_scale, out_dtype=out_dtype,
                                residual=residual)
    m = x_i8.numel() // x_i8.shape[-1]
    if m > GEMV_MAX_ROWS:
        return ternary_matmul(x_i8, x_scale, wp, w_scale, out_dtype=out_dtype,
                              residual=residual)
    out = _projection(B.library().tm_ternary_gemv, "ternary_gemv", x_i8,
                      x_scale, wp, w_scale, out_dtype, residual)
    ternary_gemv.launches += 1
    return out


def ternary_matmul(x_i8, x_scale, wp, w_scale, *, out_dtype=torch.float32,
                   residual=None):
    """Tiled twin of :func:`ternary_gemv` for any number of rows."""
    if x_i8.device.type == "cpu":
        return ref.ternary_matmul(x_i8, x_scale, wp, w_scale, out_dtype=out_dtype,
                                  residual=residual)
    out = _projection(B.library().tm_ternary_matmul, "ternary_matmul", x_i8,
                      x_scale, wp, w_scale, out_dtype, residual)
    ternary_matmul.launches += 1
    return out


def ternary_swiglu(x_i8, x_scale, wg, wg_scale, wu, wu_scale, *,
                   act_dtype=torch.bfloat16):
    """int8 x [..., N] × packed gate/up [N/4, K] -> (h_i8 [..., K],
    h_scale [..., 1]) with h = silu(x·Wg)·(x·Wu) requantized per row."""
    if x_i8.device.type == "cpu":
        return ref.ternary_swiglu(x_i8, x_scale, wg, wg_scale, wu, wu_scale,
                                  act_dtype=act_dtype)
    name = "ternary_swiglu"
    x2, lead, m, n, k = _check_operands(name, x_i8, x_scale, wg, wg_scale)
    _check_operands(name, x_i8, x_scale, wu, wu_scale)
    if wu.shape != wg.shape:
        raise ValueError(f"{name}: gate {tuple(wg.shape)} != up {tuple(wu.shape)}")
    dev = x_i8.device
    h = torch.empty((m, k), dtype=act_dtype, device=dev)  # pass-1 scratch
    q = torch.empty((m, k), dtype=torch.int8, device=dev)
    qs = torch.empty((m, 1), dtype=torch.float32, device=dev)
    B.check(B.library().tm_ternary_swiglu(
        x2.data_ptr(), x_scale.data_ptr(), wg.data_ptr(), wg_scale.data_ptr(),
        wu.data_ptr(), wu_scale.data_ptr(), h.data_ptr(), q.data_ptr(),
        qs.data_ptr(), m, n, k, B.dtype_code(act_dtype), B.stream(dev)), name)
    ternary_swiglu.launches += 1
    return q.reshape(*lead, k), qs.reshape(*lead, 1)


ternary_gemv.launches = 0
ternary_matmul.launches = 0
ternary_swiglu.launches = 0
