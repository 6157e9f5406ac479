"""Ternary weights, int8 activations, the frontier mask and the KV page
helpers (``repro/core/ternary.py:36-105,121-145,163-207``).

Weights: absmean scale, then {-1, 0, +1}. Activations and KV-cache rows:
per-token absmax int8. ``quantize_act`` computes the scale and ``x / scale`` in the *input*
dtype and rounds half to even (``torch.round``), as the JAX reference does,
so bf16 rows give the same codes on both sides.

The paged KV layout keeps K/V in a page pool ``[P, HK, ps, ...]`` addressed
through a page table ``[B, NB]`` int32; ``gather_kv_pages`` gives the dense
per-slot view, which is exactly the contiguous cache layout.
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


def mask_past_frontier(x: torch.Tensor, frontier, *, seq_axis: int,
                       batch_axis: int = 0) -> torch.Tensor:
    """``x`` with every element at sequence positions ``>= frontier`` zeroed
    (``core/ternary.py:121``). Rows at or past a slot's frontier are dead:
    every attention read stops below the frontier and the next append lands
    on them, so rejecting drafted tokens is a rewind of the frontier, and
    two caches hold the same state when they agree under this mask.
    ``frontier`` is a number or a per-slot [B] tensor along ``batch_axis``."""
    n = x.shape[seq_axis]
    idx_shape = [1] * x.ndim
    idx_shape[seq_axis] = n
    idx = torch.arange(n, device=x.device).reshape(idx_shape)
    frontier = torch.as_tensor(frontier, device=x.device).to(torch.int64)
    if frontier.ndim:
        f_shape = [1] * x.ndim
        f_shape[batch_axis] = frontier.shape[0]
        frontier = frontier.reshape(f_shape)
    return torch.where(idx < frontier, x, torch.zeros_like(x))


def gather_kv_pages(pool: torch.Tensor, page_table: torch.Tensor) -> torch.Tensor:
    """Dense per-slot view of a page pool: ``[P, HK, ps, ...]`` gathered by
    ``page_table [B, NB]`` -> ``[B, HK, NB*ps, ...]``, a new tensor. Rows of
    garbage-page entries land at masked positions."""
    view = pool[page_table.to(torch.int64)].movedim(1, 2)  # [B, HK, NB, ps, ...]
    b, hk, nb, ps = view.shape[:4]
    return view.reshape(b, hk, nb * ps, *view.shape[4:])


def scatter_kv_pages(pool: torch.Tensor, page_table: torch.Tensor,
                     view: torch.Tensor) -> None:
    """Inverse of :func:`gather_kv_pages`, in place: write a dense ``[B, HK,
    NB*ps, ...]`` view back through the table. A page that several entries
    map is either a shared prefix page written back unmodified (the same
    values) or the garbage page (content free), so which duplicate lands
    last does not matter."""
    b, hk, m = view.shape[:3]
    nb = page_table.shape[1]
    blocks = view.reshape(b, hk, nb, m // nb, *view.shape[3:]).movedim(2, 1)
    pool[page_table.reshape(-1).to(torch.int64)] = blocks.reshape(
        b * nb, *blocks.shape[2:]).to(pool.dtype)


def kv_page_rows(page_table: torch.Tensor, pos: torch.Tensor,
                 page_size: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Where each slot's frontier row ``pos [B]`` lives in the pool: (page
    ``table[b, pos // page_size]``, row ``pos % page_size``), both [B] int64."""
    pos = pos.to(torch.int64)
    page = page_table.to(torch.int64).gather(1, (pos // page_size)[:, None])[:, 0]
    return page, pos % page_size


def update_kv_pages(pool: torch.Tensor, page_table: torch.Tensor, val: torch.Tensor,
                    pos: torch.Tensor, page_size: int, *, rows=None) -> None:
    """The decode append through the table, in place: ``val [B, HK, ...]``
    lands at row ``pos % page_size`` of page ``table[b, pos // page_size]``.
    Slots whose block is unmapped write the shared garbage page. ``rows``
    passes :func:`kv_page_rows` computed once for every leaf and layer of a
    step."""
    page, row = kv_page_rows(page_table, pos, page_size) if rows is None else rows
    pool[page, :, row] = val.to(pool.dtype)


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
