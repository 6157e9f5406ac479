"""Device policy, dtype map and the shape helpers every kernel wrapper uses.

Counterpart of ``repro/kernels/_common.py``. The device policy replaces the
JAX package's "interpret everywhere but TPU": an entry point runs on the CUDA
device unless the caller names ``device="cpu"``, and with no card and no
explicit CPU it raises instead of carrying on quietly on the host.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}  # by the JAX names


def resolve_device(device=None) -> torch.device:
    """``None`` means the CUDA device; raises when there is none."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch runs on a CUDA device; none is available. Pass "
            "device='cpu' to run the plain PyTorch versions on the host.")
    return dev


def round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def flatten_lead(x: torch.Tensor) -> tuple[torch.Tensor, tuple, int]:
    """[..., N] -> ([M, N], lead_shape, M): one row per leading-dim element."""
    *lead, n = x.shape
    m = 1
    for d in lead:
        m *= d
    return x.reshape(m, n), tuple(lead), m


def pad_to(x: torch.Tensor, axis: int, target: int, value=0) -> torch.Tensor:
    """Pad ``axis`` up to ``target`` elements with ``value`` (no-op when
    already there)."""
    n = x.shape[axis]
    if n == target:
        return x
    axis = axis % x.ndim
    pads = [0, 0] * (x.ndim - axis - 1) + [0, target - n]
    return F.pad(x, pads, value=value)
