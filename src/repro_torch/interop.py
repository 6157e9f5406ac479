"""Bring the JAX package's packed parameters into the port.

``from_jax_params`` takes the JAX *packed* tree (``T.pack_tree(P.init_params
(...))`` fetched to numpy) and returns the port's tree with the same keys:
the stacked period ``blocks/b{i}`` and the unstacked ``prelude_{i}``
layers, the f32 MoE router ``[d, E]``, the 3-D (prelude) or 4-D (period)
packed expert ``wp`` with their per-expert ``scale``, MLA's ``kv_norm``,
and a Mamba layer's float leaves (``conv_w``, ``conv_b``, ``dt_proj``,
``a_log``, ``d_skip``) in JAX's f32, which each use site casts as JAX's
does (``models/mamba.py``).
The ``wp`` bytes and f32 ``scale``s cross as they are, so both packages run
identical ternary weights; nothing is re-ternarized (``ternary_scale`` is an
f32 mean whose summation order would differ). The embedding table and the
LM head weight are cast to ``cfg.dtype`` once, the cast the JAX forms apply
per call; a frontend's projection (``frontend/w``, f32 in JAX's packed
tree) crosses as its f32 bytes, cast at each use as in JAX. A tree that
``with_tl_tree`` prepared carries its int32 group indices ``w_idx``
across as the port's uint8, after checking that every value lies in [0,
27). This module imports neither JAX nor ``repro``:
numpy in, torch out.
"""

from __future__ import annotations

import numpy as np
import torch

from . import _common as C
from .models.transformer import DENSE_LEAVES


def _to_torch(a, device) -> torch.Tensor:
    a = np.array(a)  # a writable copy: device_get arrays are read-only
    if a.dtype.name == "bfloat16":  # ml_dtypes bfloat16: carry the bits
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16).to(device)
    return torch.from_numpy(a).to(device)


def from_jax_params(np_tree, cfg, device=None) -> dict:
    dev = C.resolve_device(device)

    def rec(node, path):
        if isinstance(node, dict):
            return {k: rec(v, path + (k,)) for k, v in node.items()}
        if path[-1] == "w_idx":
            node = np.asarray(node)
            if node.size and not (node.min() >= 0 and node.max() < 27):
                raise ValueError(f"{'/'.join(path)}: group indices outside [0, 27)")
            return _to_torch(node.astype(np.uint8), dev)
        t = _to_torch(node, dev)
        if path[-2:] in DENSE_LEAVES:
            t = t.to(cfg.dtype)
        return t

    return rec(np_tree, ())
