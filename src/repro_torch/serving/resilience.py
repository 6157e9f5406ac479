"""Request lifecycle and numerics guards (``repro/serving/resilience.py``).

The host-only subset the chunked ``ServingEngine`` needs: every request
ends in exactly one terminal :class:`Status`, and two in-tick guards flag a
slot whose logits (:data:`GUARD_LOGITS`) or freshly written int8-cache
scales (:data:`GUARD_SCALES`) are not finite. The guards run on the device
and ride the tick's one host transfer as a packed flag row; a flagged slot
is quarantined without touching the others. The fault-injection harness
(``FaultPlan``) is not ported yet.
"""

from __future__ import annotations

import enum

import torch


class Status(enum.Enum):
    """Request lifecycle states. The last six are terminal."""

    PENDING = "PENDING"    # constructed, not yet submitted
    QUEUED = "QUEUED"      # in the admission queue (or requeued by preemption)
    RUNNING = "RUNNING"    # admitted into a slot (prefilling or decoding)
    OK = "OK"                              # EOS emitted or budget spent
    CANCELLED = "CANCELLED"                # host-side cancel()
    DEADLINE_EXCEEDED = "DEADLINE_EXCEEDED"  # TTL expired (queued or running)
    CACHE_EXHAUSTED = "CACHE_EXHAUSTED"    # frontier hit the cache ceiling
    QUARANTINED = "QUARANTINED"            # numerics guard tripped on the slot
    FAILED = "FAILED"                      # rejected at admission

    def __str__(self) -> str:
        return self.value


TERMINAL = frozenset({Status.OK, Status.CANCELLED, Status.DEADLINE_EXCEEDED,
                      Status.CACHE_EXHAUSTED, Status.QUARANTINED,
                      Status.FAILED})

# Guard-flag bit layout (one packed int32 row per tick, [slots]):
GUARD_LOGITS = 1  # non-finite / overflowing logits at an emitting row
GUARD_SCALES = 2  # non-finite int8-cache quant scale at a row written this tick


def logits_guard(logits: torch.Tensor, where=None) -> torch.Tensor:
    """Per-slot bool: any non-finite or near-overflow logit. ``logits``
    [B, ...]; ``where`` [B] masks the slots whose rows mean something this
    tick (a trash-diverted row may echo a previous occupant's poison)."""
    lim = 0.5 * torch.finfo(logits.dtype).max
    bad = ~torch.isfinite(logits) | (logits.abs() > lim)
    bad = bad.reshape(logits.shape[0], -1).any(dim=1)
    return bad & where if where is not None else bad


def scale_guard(caches, rows: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """Per-slot bool: any non-finite scale among this tick's written cache
    rows. ``rows`` [B, R] int seq indices, ``valid`` [B, R] the rows written
    live this tick. Only the int8 layout's ``*_scale`` leaves [L, B, HK, M]
    are judged, so a bf16 cache gives all False."""
    b, r = rows.shape
    bad = torch.zeros((b,), dtype=torch.bool, device=rows.device)
    for leaves in caches["blocks"].values():
        for name, leaf in leaves.items():
            if not name.endswith("_scale"):
                continue
            idx = rows.to(torch.int64).clamp(0, leaf.shape[-1] - 1)
            taken = leaf.gather(-1, idx[None, :, None, :].expand(
                leaf.shape[0], b, leaf.shape[2], r))  # [L, B, HK, R]
            nf = (~torch.isfinite(taken)).any(dim=2).any(dim=0)  # [B, R]
            bad |= (nf & valid).any(dim=1)
    return bad
