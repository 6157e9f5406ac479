"""2-bit planar packing of ternary weights (``repro/core/packing.py:43-69``).

``pack2`` stores 4 trits per byte, biased to {0, 1, 2} = value + 1, in the
*planar* layout: byte ``i`` of a [N, ...] matrix holds rows
``{i, i + N/4, i + 2N/4, i + 3N/4}`` in bit-planes 0..3, so plane ``j`` of
the packed [N/4, K] matrix contracts against the contiguous activation slab
``x[:, jN/4:(j+1)N/4]``. A byte of four zero trits is ``0x55``.

The table-lookup engine's weight layout (``packing.py:100-153``):
``encode_groups`` turns every ``g`` consecutive trits of the contraction
axis into one base-3 index in ``[0, 3^g)`` (trit ``i`` is digit ``i``),
stored as uint8; ``combo_matrix`` is ``COMBOS [g, 3^g]``, whose column
``c`` holds the trits of index ``c``.
"""

from __future__ import annotations

import torch

PACK2_RATIO = 4  # trits per byte
ZERO_TRITS_BYTE = 0x55  # four biased-zero trits: the pad byte


def pack2(w_t: torch.Tensor) -> torch.Tensor:
    """Ternary int8 {-1,0,1} [N, ...] -> uint8 [N//4, ...], planar layout."""
    n = w_t.shape[0]
    if n % PACK2_RATIO:
        raise ValueError(f"first axis ({n}) must be divisible by {PACK2_RATIO}")
    n4 = n // PACK2_RATIO
    biased = (w_t.to(torch.int16) + 1).to(torch.uint8)
    g = biased.reshape((PACK2_RATIO, n4) + tuple(w_t.shape[1:]))
    return g[0] | (g[1] << 2) | (g[2] << 4) | (g[3] << 6)


def unpack2(packed: torch.Tensor, *, dtype=torch.int8) -> torch.Tensor:
    """Inverse of :func:`pack2`: uint8 [N//4, ...] -> {-1,0,1} [N, ...]."""
    parts = [((packed >> (2 * i)) & 0x3).to(torch.int8) - 1
             for i in range(PACK2_RATIO)]
    stacked = torch.stack(parts, dim=0)  # [4, N//4, ...] plane-major
    n4 = packed.shape[0]
    return stacked.reshape((n4 * PACK2_RATIO,) + tuple(packed.shape[1:])).to(dtype)


def encode_groups(w_t: torch.Tensor, g: int) -> torch.Tensor:
    """Ternary {-1,0,1} [N, ...] -> uint8 [N//g, ...] base-3 group indices
    (the JAX function returns int32; the values are the same, all below
    ``3^g <= 243``)."""
    n = w_t.shape[0]
    if n % g:
        raise ValueError(f"first axis ({n}) must be divisible by {g}")
    if 3 ** g > 256:
        raise ValueError(f"group of {g} trits does not fit a byte")
    biased = (w_t.to(torch.int16) + 1).to(torch.uint8)
    grouped = biased.reshape((n // g, g) + tuple(w_t.shape[1:]))
    idx = torch.zeros_like(grouped[:, 0])
    for i in range(g):
        idx += grouped[:, i] * (3 ** i)
    return idx


def decode_groups(idx: torch.Tensor, g: int, *, dtype=torch.int8) -> torch.Tensor:
    """Inverse of :func:`encode_groups`: [T, ...] -> {-1,0,1} [T*g, ...]."""
    rem = idx.to(torch.int32)
    parts = []
    for _ in range(g):
        parts.append((rem % 3).to(torch.int8) - 1)
        rem = rem // 3
    stacked = torch.stack(parts, dim=1)
    return stacked.reshape((idx.shape[0] * g,) + tuple(idx.shape[1:])).to(dtype)


def combo_matrix(g: int, dtype=torch.float32, device=None) -> torch.Tensor:
    """COMBOS [g, 3^g]: column ``c`` holds the trits decoded from ``c``."""
    rem = torch.arange(3 ** g, device=device)
    digits = []
    for _ in range(g):
        digits.append(rem % 3 - 1)
        rem = rem // 3
    return torch.stack(digits).to(dtype)
