"""Table-lookup ternary matmul, the paper's Algorithm 1
(``repro/core/tl_matmul.py``).

Offline, ``tl_indices`` turns the planar pack2 weights into group indices
``w_idx [⌈N/3⌉, K]``: the contraction axis is padded with zero trits to a
multiple of 3 and every 3 trits become one base-3 index. The port
stores them as uint8 (values below 27): a quarter of the JAX
package's int32 bytes. Online, ``build_tables`` precomputes, for every
group of 3 int8 activations, all 27 signed sums (``a @ COMBOS``),
and the product is ``out[m, k] = Σ_t table[m, t, w_idx[t, k]]``. Every table
entry is an exact integer (``|entry| <= 381``), so the lookup sum is
exact in int32 and equals ``x_i8 @ w_t``.

The reference gathers a ``[M, T, K]`` tensor at once (1.6 GB for one
512-row projection at N = 1536); ``lookup_sum`` sums over chunks of the
group axis instead, which leaves the exact integer result unchanged.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .packing import combo_matrix, encode_groups, unpack2

GROUP = 3  # trits per table index (paper: G = 3 -> 27-entry tables)
_LOOKUP_CHUNK = 1 << 24  # gathered elements per chunk of the group axis


def tl_indices(wp: torch.Tensor) -> torch.Tensor:
    """Packed weights ``wp [..., N/4, K]`` uint8 -> group indices
    ``[..., ⌈N/3⌉, K]`` uint8; leading stack axes map through, one matrix
    at a time."""
    if wp.ndim > 2:
        flat = wp.reshape((-1,) + tuple(wp.shape[-2:]))
        idx = torch.stack([tl_indices(p) for p in flat])
        return idx.reshape(tuple(wp.shape[:-2]) + tuple(idx.shape[-2:]))
    w_t = unpack2(wp)
    pad = (-w_t.shape[0]) % GROUP
    if pad:
        w_t = F.pad(w_t, (0, 0, 0, pad))
    return encode_groups(w_t, GROUP)


def build_tables(x_i8: torch.Tensor, *, t: int) -> torch.Tensor:
    """``x_i8 [..., N]`` -> tables ``[..., t·27]`` f32, flattened over
    (group, combo); the row is zero-padded to ``3t`` first."""
    n = x_i8.shape[-1]
    if t * GROUP - n:
        x_i8 = F.pad(x_i8, (0, t * GROUP - n))
    groups = x_i8.reshape(tuple(x_i8.shape[:-1]) + (t, GROUP)).to(torch.float32)
    tables = groups @ combo_matrix(GROUP, device=x_i8.device)
    return tables.reshape(tuple(x_i8.shape[:-1]) + (t * 3 ** GROUP,))


def lookup_sum(tables: torch.Tensor, w_idx: torch.Tensor, *,
               chunk: int = _LOOKUP_CHUNK) -> torch.Tensor:
    """``tables [M, T·C]`` (exact integers, any dtype) × ``w_idx [T, K]`` ->
    int32 ``[M, K]``, ``Σ_t tables[m, t·C + w_idx[t, k]]``, summed over
    chunks of T (about ``chunk`` gathered elements each) so that no
    ``[M, T, K]`` tensor is made."""
    t, k = w_idx.shape
    m = tables.shape[0]
    combos = tables.shape[1] // t
    tab = tables.to(torch.int32)
    offsets = torch.arange(t, device=w_idx.device, dtype=torch.int64)[:, None] * combos
    flat = w_idx.to(torch.int64) + offsets  # [T, K] columns of tab
    acc = torch.zeros((m, k), dtype=torch.int32, device=tables.device)
    step = max(1, chunk // max(m * k, 1))
    for t0 in range(0, t, step):
        part = flat[t0:t0 + step]
        got = tab.index_select(1, part.reshape(-1)).reshape(m, part.shape[0], k)
        acc += got.sum(dim=1, dtype=torch.int32)
    return acc


def tl_matmul_int(x_i8: torch.Tensor, w_idx: torch.Tensor) -> torch.Tensor:
    """``x_i8 [M, N]`` int8 × ``w_idx [N/3, K]`` -> int32 ``[M, K]``, equal to
    ``x_i8 @ decode(w_idx)``."""
    m, n = x_i8.shape
    t = w_idx.shape[0]
    if t * GROUP != n:
        raise ValueError(f"W_idx groups {t}*{GROUP} != N {n}")
    return lookup_sum(build_tables(x_i8, t=t), w_idx)


def tl_matmul(x_i8, x_scale, w_idx, w_scale, *, out_dtype=torch.float32):
    """Dequantized TL matmul: ``(acc · x_scale) · w_scale``, then one cast
    (the drop-in for ``ternary_matmul_ref``)."""
    acc = tl_matmul_int(x_i8, w_idx)
    return (acc.to(torch.float32) * x_scale * w_scale).to(out_dtype)


def preprocess_weights(w_t: torch.Tensor) -> torch.Tensor:
    """Offline_preprocess(W): ternary [N, K] -> group indices [N/3, K]."""
    return encode_groups(w_t, GROUP)
