"""Plain PyTorch versions of the table-lookup kernels
(``repro/kernels/tl_gemv/ref.py``): the exact Algorithm-1 lookup sum of
``core/tl_matmul.py`` (from the int8 row, or from the prologue's precomputed
tables), then the packed path's epilogues op for op: ``(acc · x_scale) ·
w_scale``, one cast, the residual added in the output dtype; SwiGLU's gate
and up in the act dtype, ``silu(g) · u``, then ``quantize_act``."""

from __future__ import annotations

import torch

from ...core import ternary
from ...core.tl_matmul import GROUP, build_tables, lookup_sum
from ..ternary_matmul.ref import silu

__all__ = ["build_tables", "tl_gemv", "tl_matmul", "tl_swiglu"]


def _acc(x_i8, w_idx, tables):
    """int32 [M, K] and the lead shape: the lookup sum over the tables, built
    here from ``x_i8`` (zero-padded to 3T) unless given."""
    t = w_idx.shape[0]
    src = tables if tables is not None else x_i8
    lead = tuple(src.shape[:-1])
    if tables is None:
        x2 = x_i8.reshape(-1, x_i8.shape[-1])
        if x2.shape[1] > t * GROUP or x2.shape[1] <= (t - 1) * GROUP:
            raise ValueError(f"x [.., {x2.shape[1]}] does not fill {t} groups of {GROUP}")
        tables = build_tables(x2, t=t)
    tables = tables.reshape(-1, tables.shape[-1])
    if tables.shape[1] != t * 3 ** GROUP:
        raise ValueError(f"tables [.., {tables.shape[1]}] != {t} groups x {3 ** GROUP}")
    return lookup_sum(tables, w_idx), lead


def tl_matmul(x_i8, x_scale, w_idx, w_scale, *, tables=None, residual=None,
              out_dtype=torch.float32):
    """x_i8 [..., N] int8 (or ``tables [..., T·27]``) × w_idx [T, K] ->
    [..., K] in out_dtype, ``residual`` added after the cast; ``w_scale`` a
    scalar or a per-output-channel [K]."""
    acc, lead = _acc(x_i8, w_idx, tables)
    xs = x_scale.reshape(-1, 1)
    out = (acc.to(torch.float32) * xs * w_scale.reshape(-1)).to(out_dtype)
    out = out.reshape(*lead, w_idx.shape[1])
    return out if residual is None else out + residual.to(out_dtype)


def tl_gemv(x_i8, x_scale, w_idx, w_scale, *, out_dtype=torch.float32):
    """The decode GEMV: int8 rows in, tables built here, no residual."""
    return tl_matmul(x_i8, x_scale, w_idx, w_scale, out_dtype=out_dtype)


def tl_swiglu(x_i8, x_scale, wg_idx, wg_scale, wu_idx, wu_scale, *, tables=None,
              act_dtype=torch.bfloat16):
    """-> (h_i8 [..., K], h_scale [..., 1]), h = silu(x·Wg) · (x·Wu), gate and
    up from one table set."""
    gate = tl_matmul(x_i8, x_scale, wg_idx, wg_scale, tables=tables, out_dtype=act_dtype)
    up = tl_matmul(x_i8, x_scale, wu_idx, wu_scale, tables=tables, out_dtype=act_dtype)
    return ternary.quantize_act(silu(gate) * up)
