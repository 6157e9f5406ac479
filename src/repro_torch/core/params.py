"""Parameter declarations and random initialisation (``repro/core/params.py``).

A model declares a tree (nested dicts) of :class:`ParamSpec`; ``init_params``
materialises it with the JAX package's distributions (``params.py:73-91``):
``normal`` draws N(0, 1/fan_in), ``embed`` N(0, scale²), ``ones``/``zeros``
are constants. The draws come from a ``torch.Generator`` seeded per leaf
from ``(seed, path)``, so a tree is reproducible leaf by leaf; they are not
the JAX package's numbers (tests bridge JAX weights through ``interop``).
``init_packed_params`` makes the serving tree directly, one ternary leaf's
f32 latent at a time, so the peak is one leaf, not the whole latent tree
(DeepSeek-V2-Lite's latents are about 64 GB, its largest leaf 19 GB).
"""

from __future__ import annotations

import dataclasses
import hashlib
import math

import torch


@dataclasses.dataclass(frozen=True)
class ParamSpec:
    shape: tuple[int, ...]
    init: str = "normal"  # normal | zeros | ones | embed
    scale: float | None = None  # stddev; None -> 1/sqrt(fan_in)
    quant: str = "none"  # "ternary" -> packed on the serving path


def map_specs(fn, tree, path: str = ""):
    """Apply ``fn(path, spec)`` to every leaf of a spec tree."""
    if isinstance(tree, ParamSpec):
        return fn(path, tree)
    return {k: map_specs(fn, v, f"{path}/{k}") for k, v in tree.items()}


def _leaf_seed(seed: int, path: str) -> int:
    digest = hashlib.sha256(f"{seed}:{path}".encode()).digest()
    return int.from_bytes(digest[:8], "little") & ((1 << 63) - 1)


def _init_one(path: str, spec: ParamSpec, seed: int, device) -> torch.Tensor:
    if spec.init == "zeros":
        return torch.zeros(spec.shape, device=device)
    if spec.init == "ones":
        return torch.ones(spec.shape, device=device)
    if spec.init == "embed":
        std = spec.scale if spec.scale is not None else 1.0
    elif spec.init == "normal":
        fan_in = spec.shape[-2] if len(spec.shape) >= 2 else spec.shape[-1]
        std = spec.scale if spec.scale is not None else 1.0 / math.sqrt(max(fan_in, 1))
    else:
        raise ValueError(f"unknown init {spec.init!r} at {path}")
    gen = torch.Generator(device=device)
    gen.manual_seed(_leaf_seed(seed, path))
    return torch.randn(spec.shape, generator=gen, device=device) * std


def init_params(tree, seed: int, device) -> dict:
    """Materialise a spec tree in f32 on ``device`` (deterministic in
    ``seed``)."""
    return map_specs(lambda p, s: _init_one(p, s, seed, device), tree)


def init_packed_params(tree, seed: int, device, *, dtype=None,
                       dense_leaves=frozenset()) -> dict:
    """The packed serving tree of a spec tree, equal to ``pack_tree(
    init_params(tree, seed, device), tree, dtype=dtype)``: each ternary
    ``{"w"}`` node's f32 latent is drawn from its own per-path seed, packed
    (``bitlinear.pack_params``) and freed before the next; every other leaf
    is drawn as ``init_params`` draws it, and the ``dense_leaves`` (path
    suffixes, e.g. ``("embed", "table")``) are cast to ``dtype``."""
    from .bitlinear import pack_params

    def rec(node, path, keys):
        if isinstance(node, ParamSpec):
            t = _init_one(path, node, seed, device)
            return t.to(dtype) if dtype is not None and keys[-2:] in dense_leaves else t
        w = node.get("w")
        if set(node) == {"w"} and isinstance(w, ParamSpec) and w.quant == "ternary":
            latent = _init_one(f"{path}/w", w, seed, device)
            packed = pack_params(latent)
            del latent
            return packed
        return {k: rec(v, f"{path}/{k}", keys + (k,)) for k, v in node.items()}

    return rec(tree, "", ())
