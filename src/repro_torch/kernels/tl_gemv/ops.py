"""Dispatch for the table-lookup kernels: the plain versions for CPU
tensors, the CUDA kernels (``csrc/tl_gemv.cu``) for CUDA tensors.

``tl_matmul`` serves every number of rows, as ``_apply_tl`` calls the JAX
``tl_matmul`` at decode too (``repro/core/bitlinear.py:232``); the kernel
picks its decode or tiled configuration by M. ``tl_gemv`` is the decode
GEMV of ``repro/kernels/tl_gemv/kernel.py:91`` (int8 rows, tables built in
the kernel, f32 out); no model path calls it, as in the JAX package. More
than 16 rows go to :func:`tl_matmul`, as ``ternary_gemv`` does."""

from __future__ import annotations

import torch

from ... import _common as C
from .. import _build as B
from ..ternary_matmul.ops import GEMV_MAX_ROWS
from . import ref


def _operands(name, x_i8, tables, x_scale, w_idx):
    """Validate the activations (int8 rows or tables) against ``w_idx [T,
    K]``; returns (x2 [M, N] | None, tables2 [M, T·27] | None, lead, M, N)."""
    if tables is None and x_i8 is None:
        raise ValueError(f"{name}: needs x_i8 or tables")
    t = w_idx.shape[0]
    B.require_dtype(name, w_idx, torch.uint8, "w_idx")
    B.require_dtype(name, x_scale, torch.float32, "x_scale")
    x2 = tab2 = None
    n = 3 * t
    if tables is not None:
        B.require_cuda(name, tables=tables, x_scale=x_scale, w_idx=w_idx)
        B.require_dtype(name, tables, torch.float32, "tables")
        tab2, lead, m = C.flatten_lead(tables)
        if tab2.shape[1] != t * 27:
            raise ValueError(f"{name}: tables [.., {tab2.shape[1]}] != {t} groups x 27")
    else:
        B.require_cuda(name, x_i8=x_i8, x_scale=x_scale, w_idx=w_idx)
        B.require_dtype(name, x_i8, torch.int8, "x_i8")
        x2, lead, m = C.flatten_lead(x_i8)
        n = x2.shape[1]
        if not 3 * (t - 1) < n <= 3 * t:
            raise ValueError(f"{name}: x [.., {n}] does not fill {t} groups of 3")
    if w_idx.ndim != 2 or x_scale.numel() != m:
        raise ValueError(f"{name}: w_idx must be [T, K] and x_scale hold {m} elements")
    return x2, tab2, lead, m, n


def _w_scale(name, w_scale, k):
    """The scale and its stride: one scalar (0) or a per-channel [K] row (1)."""
    B.require_dtype(name, w_scale, torch.float32, "w_scale")
    if w_scale.numel() == 1:
        return w_scale, 0
    if w_scale.numel() == k:
        return w_scale.contiguous(), 1
    raise ValueError(f"{name}: w_scale needs 1 or {k} elements, has {w_scale.numel()}")


def _ptr(t):
    return None if t is None else t.data_ptr()


def tl_gemv(x_i8, x_scale, w_idx, w_scale, *, out_dtype=torch.float32):
    """x_i8 [..., N] int8 × group indices w_idx [⌈N/3⌉, K] uint8 -> [..., K]
    (computed in f32, then cast to out_dtype); ``w_scale`` a scalar or [K]."""
    if x_i8.device.type == "cpu":
        return ref.tl_gemv(x_i8, x_scale, w_idx, w_scale, out_dtype=out_dtype)
    name = "tl_gemv"
    if x_i8.numel() // x_i8.shape[-1] > GEMV_MAX_ROWS:
        return tl_matmul(x_i8, x_scale, w_idx, w_scale).to(out_dtype)
    x2, _, lead, m, n = _operands(name, x_i8, None, x_scale, w_idx)
    t, k = w_idx.shape
    ws, stride = _w_scale(name, w_scale, k)
    B.require_cuda(name, x_i8=x_i8, w_scale=ws)
    out = torch.empty((m, k), dtype=torch.float32, device=x_i8.device)
    B.check(B.library().tm_tl_gemv(
        x2.data_ptr(), x_scale.data_ptr(), w_idx.data_ptr(), ws.data_ptr(), stride,
        out.data_ptr(), m, n, t, k, B.stream(x_i8.device)), name)
    tl_gemv.launches += 1
    return out.reshape(*lead, k).to(out_dtype)


def tl_matmul(x_i8, x_scale, w_idx, w_scale, *, tables=None, residual=None,
              out_dtype=torch.float32):
    """x_i8 [..., N] int8, or the prologue's ``tables [..., T·27]`` f32 (then
    used instead of x_i8, which may be None), × w_idx [T, K] uint8 ->
    [..., K] in out_dtype, ``residual [..., K]`` added in the epilogue."""
    src = tables if tables is not None else x_i8
    if src.device.type == "cpu":
        return ref.tl_matmul(x_i8, x_scale, w_idx, w_scale, tables=tables,
                             residual=residual, out_dtype=out_dtype)
    name = "tl_matmul"
    x2, tab2, lead, m, n = _operands(name, x_i8, tables, x_scale, w_idx)
    t, k = w_idx.shape
    ws, stride = _w_scale(name, w_scale, k)
    B.require_cuda(name, src=src, w_scale=ws)
    out = torch.empty((m, k), dtype=out_dtype, device=src.device)
    if residual is not None:
        residual = residual.to(out_dtype)
        B.require_cuda(name, src=src, residual=residual)
        if residual.numel() != m * k:
            raise ValueError(f"{name}: residual {tuple(residual.shape)} != [{m}, {k}]")
    B.check(B.library().tm_tl_matmul(
        _ptr(x2), _ptr(tab2), x_scale.data_ptr(), w_idx.data_ptr(), ws.data_ptr(), stride,
        _ptr(residual), out.data_ptr(), m, n, t, k, B.dtype_code(out_dtype),
        B.stream(src.device)), name)
    tl_matmul.launches += 1
    return out.reshape(*lead, k)


def tl_swiglu(x_i8, x_scale, wg_idx, wg_scale, wu_idx, wu_scale, *, tables=None,
              act_dtype=torch.bfloat16):
    """int8 x [..., N] (or the prologue's tables) × gate/up group indices
    [T, K] -> (h_i8 [..., K], h_scale [..., 1]), h = silu(x·Wg)·(x·Wu)
    requantized per row; gate and up share one staged table set."""
    src = tables if tables is not None else x_i8
    if src.device.type == "cpu":
        return ref.tl_swiglu(x_i8, x_scale, wg_idx, wg_scale, wu_idx, wu_scale,
                             tables=tables, act_dtype=act_dtype)
    name = "tl_swiglu"
    x2, tab2, lead, m, n = _operands(name, x_i8, tables, x_scale, wg_idx)
    if wu_idx.shape != wg_idx.shape:
        raise ValueError(f"{name}: gate {tuple(wg_idx.shape)} != up {tuple(wu_idx.shape)}")
    B.require_cuda(name, src=src, wu_idx=wu_idx, wg_scale=wg_scale, wu_scale=wu_scale)
    B.require_dtype(name, wu_idx, torch.uint8, "wu_idx")
    for s, what in ((wg_scale, "wg_scale"), (wu_scale, "wu_scale")):
        B.require_dtype(name, s, torch.float32, what)
        if s.numel() != 1:
            raise ValueError(f"{name}: {what} must be a scalar")
    t, k = wg_idx.shape
    dev = src.device
    h = torch.empty((m, k), dtype=act_dtype, device=dev)  # pass-1 scratch
    q = torch.empty((m, k), dtype=torch.int8, device=dev)
    qs = torch.empty((m, 1), dtype=torch.float32, device=dev)
    B.check(B.library().tm_tl_swiglu(
        _ptr(x2), _ptr(tab2), x_scale.data_ptr(), wg_idx.data_ptr(), wg_scale.data_ptr(),
        wu_idx.data_ptr(), wu_scale.data_ptr(), h.data_ptr(), q.data_ptr(), qs.data_ptr(),
        m, n, t, k, B.dtype_code(act_dtype), B.stream(dev)), name)
    tl_swiglu.launches += 1
    return q.reshape(*lead, k), qs.reshape(*lead, 1)


tl_gemv.launches = 0
tl_matmul.launches = 0
tl_swiglu.launches = 0
