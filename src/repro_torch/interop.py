"""Bring the JAX package's packed parameters into the port.

``from_jax_params`` takes the JAX *packed* tree (``T.pack_tree(P.init_params
(...))`` fetched to numpy) and returns the port's tree with the same keys.
The ``wp`` bytes and f32 ``scale``s cross as they are, so both packages run
identical ternary weights; nothing is re-ternarized (``ternary_scale`` is an
f32 mean whose summation order would differ). The embedding table and the
LM head weight are cast to ``cfg.dtype`` once, the cast the JAX forms apply
per call. This module imports neither JAX nor ``repro``: numpy in, torch out.
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
        t = _to_torch(node, dev)
        if path[-2:] in DENSE_LEAVES:
            t = t.to(cfg.dtype)
        return t

    return rec(np_tree, ())
