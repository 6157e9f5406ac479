"""The measured-dispatch store (``repro/kernels/autotune.py``): a versioned
JSON file of per-shape measurements, read lazily once per process.

The port keeps the store and the TL-vs-packed engine table
(``choose_engine``/``record_engine``), which ``bitlinear.resolve_engine``
reads under ``matmul_engine="auto"``. With no entry on record every lookup
returns None and every caller keeps its default, so an absent file is
exactly the behaviour without a store. The block-size sweep of the JAX
module (``tune``, ``_candidates``, ``_runner``, ``main``) is not ported: no
port kernel reads a tuned knob yet.

The file is the port's own, never the JAX package's ``autotune-*.json``:
``build/repro_torch/autotune-<device>.json`` at the repo root (beside the
kernel builds) unless :func:`set_cache_path` points elsewhere, one file per
device, keyed on ``torch.cuda.get_device_name(0)`` or ``cpu``. Format (version 1):

    {"version": 1, "device": "NVIDIA_H100_80GB_HBM3",
     "kernels": {"engine": {"k1536-m4-n1536": {"knobs": {"engine": "tl"},
                                               "us": 5.1,
                                               "losers": {"packed": 4.9}}}}}
"""

from __future__ import annotations

import json
import os
from pathlib import Path
from typing import Any

import torch

_VERSION = 1
_DEFAULT_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"

_CACHE: dict[str, dict[str, dict]] | None = None
_CACHE_PATH: Path | None = None
_DEVICE: str | None = None


def device_key() -> str:
    """The device the store is keyed on: the CUDA card's name, else ``cpu``."""
    global _DEVICE
    if _DEVICE is None:
        name = torch.cuda.get_device_name(0) if torch.cuda.is_available() else "cpu"
        _DEVICE = name.replace(" ", "_")
    return _DEVICE


def cache_path() -> Path:
    """The store's file: the override set with :func:`set_cache_path`, else
    the per-device default."""
    if _CACHE_PATH is not None:
        return _CACHE_PATH
    return _DEFAULT_DIR / f"autotune-{device_key()}.json"


def set_cache_path(path: str | os.PathLike | None) -> None:
    """Point the store at ``path`` (None: the default) and drop what was
    loaded, so that the next lookup reads the file anew."""
    global _CACHE, _CACHE_PATH
    _CACHE = None
    _CACHE_PATH = Path(path) if path is not None else None


def _valid_kernels(raw) -> dict[str, dict[str, dict]] | None:
    """The ``kernels`` table of a parsed file, or None when the file is not
    a version-1 store of ``{kernel: {shape_key: {"knobs": {...}}}}``."""
    if not isinstance(raw, dict) or raw.get("version") != _VERSION:
        return None
    kernels = raw.get("kernels", {})
    if not isinstance(kernels, dict):
        return None
    for entries in kernels.values():
        if not isinstance(entries, dict):
            return None
        for entry in entries.values():
            if not isinstance(entry, dict) or not isinstance(entry.get("knobs"), dict):
                return None
    return kernels


def _store() -> dict[str, dict[str, dict]]:
    """The loaded store; an absent, unreadable, corrupt or other-version file
    reads as empty (and is left on disk until the next :func:`record`)."""
    global _CACHE
    if _CACHE is None:
        _CACHE = {}
        try:
            kernels = _valid_kernels(json.loads(cache_path().read_text()))
        except (OSError, ValueError):
            kernels = None
        if kernels is not None:
            _CACHE = kernels
    return _CACHE


def _save() -> None:
    path = cache_path()
    path.parent.mkdir(parents=True, exist_ok=True)
    payload = {"version": _VERSION, "device": device_key(), "kernels": _store()}
    tmp = path.with_suffix(f".{os.getpid()}.tmp")
    tmp.write_text(json.dumps(payload, indent=1, sort_keys=True))
    tmp.replace(path)


def shape_key(**dims: int) -> str:
    """``shape_key(m=8, n=4096, k=4096)`` -> ``"k4096-m8-n4096"``."""
    return "-".join(f"{k}{v}" for k, v in sorted(dims.items()))


def lookup(kernel: str, key: str) -> dict | None:
    """The knobs on record for (kernel, shape key), or None."""
    entry = _store().get(kernel, {}).get(key)
    return dict(entry["knobs"]) if entry else None


def best(kernel: str, key: str, default: dict) -> dict:
    """The knobs on record merged over ``default``."""
    tuned = lookup(kernel, key)
    return {**default, **tuned} if tuned else dict(default)


def record(kernel: str, key: str, knobs: dict, us: float, *, losers: dict | None = None,
           save: bool = True) -> None:
    entry: dict[str, Any] = {"knobs": dict(knobs), "us": float(us)}
    if losers:
        entry["losers"] = {k: float(v) for k, v in losers.items()}
    _store().setdefault(kernel, {})[key] = entry
    if save:
        _save()


def choose_engine(m: int, n: int, k: int) -> str | None:
    """The measured engine of an [M, N] x [N, K] ternary matmul, ``"tl"`` or
    ``"packed"``, or None when the shape was never measured."""
    knobs = lookup("engine", shape_key(m=m, n=n, k=k))
    return knobs["engine"] if knobs else None


def record_engine(m: int, n: int, k: int, timings_us: dict[str, float], *,
                  save: bool = True) -> str:
    """Record each engine's time for one shape; returns the winner."""
    winner = min(timings_us, key=timings_us.get)
    losers = {e: t for e, t in timings_us.items() if e != winner}
    record("engine", shape_key(m=m, n=n, k=k), {"engine": winner}, timings_us[winner],
           losers=losers, save=save)
    return winner
