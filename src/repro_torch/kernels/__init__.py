"""The port's kernels: hand-written CUDA for the H100 beside their plain
PyTorch versions.

Each wrapper in a package's ``ops.py`` runs the plain version (``ref.py``)
for a CPU tensor and, for a CUDA tensor, launches its kernel or raises; it
counts its launches in a plain-integer ``launches`` attribute. The model
reaches them through a :class:`KernelSet`: :data:`KERNELS` holds the
dispatching wrappers (the main path), :data:`PLAIN` the plain versions,
which the on-card check runs the same model through for comparison.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

from .decode_attention import ops as _da_ops
from .decode_attention import ref as _da_ref
from .fused_norm_quant import ops as _nq_ops
from .fused_norm_quant import ref as _nq_ref
from .prefill_append import ops as _pa_ops
from .prefill_append import ref as _pa_ref
from .ternary_matmul import ops as _tm_ops
from .ternary_matmul import ref as _tm_ref


@dataclasses.dataclass(frozen=True)
class KernelSet:
    norm_quant: Callable
    ternary_gemv: Callable  # dispatches more than 16 rows to the tiled matmul
    ternary_swiglu: Callable
    decode_attention: Callable  # an int8 cache (k_scale=...) takes the int8 variant
    prefill_append: Callable  # likewise


KERNELS = KernelSet(_nq_ops.norm_quant, _tm_ops.ternary_gemv,
                    _tm_ops.ternary_swiglu, _da_ops.decode_attention,
                    _pa_ops.prefill_append)
PLAIN = KernelSet(_nq_ref.norm_quant, _tm_ref.ternary_gemv,
                  _tm_ref.ternary_swiglu, _da_ref.decode_attention,
                  _pa_ref.prefill_append)

# The eight launching wrappers, by the TPU entry point each replaces.
WRAPPERS = {
    "norm_quant": _nq_ops.norm_quant,
    "ternary_gemv": _tm_ops.ternary_gemv,
    "ternary_matmul": _tm_ops.ternary_matmul,
    "ternary_swiglu": _tm_ops.ternary_swiglu,
    "decode_attention": _da_ops.decode_attention,
    "decode_attention_quant": _da_ops.decode_attention_quant,
    "prefill_append": _pa_ops.prefill_append,
    "prefill_append_quant": _pa_ops.prefill_append_quant,
}


def launch_counts() -> dict[str, int]:
    return {name: fn.launches for name, fn in WRAPPERS.items()}


def reset_launch_counts() -> None:
    for fn in WRAPPERS.values():
        fn.launches = 0
