"""Request lifecycle, numerics guards and fault injection
(``repro/serving/resilience.py``).

Three pieces, wired into the tick paths by ``serving/engine.py``:

* every request ends in exactly one terminal :class:`Status`;
* two in-tick guards flag a slot whose logits (:data:`GUARD_LOGITS`) or
  freshly written int8-cache scales (:data:`GUARD_SCALES`) are not finite.
  They run on the device and ride the tick's one host transfer as a packed
  flag row; a flagged slot is quarantined without touching the others;
* :class:`FaultPlan`, a deterministic schedule of :class:`Fault` entries
  that the engine asks at fixed points of its tick: a NaN at the guards'
  observation point, a raising tick (:class:`FaultInjected`), a slow tick,
  a forced cache-exhausted retirement, deranged speculative drafts
  (:func:`scramble_tokens`). The plan is host data on numpy; on a tick
  where no slot is targeted the engine passes no mask at all, so an armed
  plan that never fires launches nothing more than no plan. The replica
  kinds (:data:`REPLICA_FAULT_KINDS`) are carried for a replica pool; the
  engine ignores them.
"""

from __future__ import annotations

import dataclasses
import enum

import numpy as np
import torch

from ..models.transformer import tree_leaves


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
    FAILED = "FAILED"                      # rejected at admission / tick failure

    def __str__(self) -> str:
        return self.value


TERMINAL = frozenset({Status.OK, Status.CANCELLED, Status.DEADLINE_EXCEEDED,
                      Status.CACHE_EXHAUSTED, Status.QUARANTINED,
                      Status.FAILED})

# Guard-flag bit layout (one packed int32 row per tick, [slots]):
GUARD_LOGITS = 1  # non-finite / overflowing logits at an emitting row
GUARD_SCALES = 2  # non-finite int8-cache quant scale at a row written this tick


class FaultInjected(RuntimeError):
    """Raised by the tick's fault hook to emulate a failing kernel launch."""


def logits_guard(logits: torch.Tensor, where=None) -> torch.Tensor:
    """Per-slot bool: any non-finite or near-overflow logit. ``logits``
    [B, ...]; ``where`` [B] masks the slots whose rows mean something this
    tick (a trash-diverted row may echo a previous occupant's poison)."""
    lim = 0.5 * torch.finfo(logits.dtype).max
    bad = ~torch.isfinite(logits) | (logits.abs() > lim)
    bad = bad.reshape(logits.shape[0], -1).any(dim=1)
    return bad & where if where is not None else bad


def scale_guard(caches, rows: torch.Tensor, valid: torch.Tensor, *,
                paged: bool = False) -> torch.Tensor:
    """Per-slot bool: any non-finite scale among this tick's written cache
    rows. ``rows`` [B, R] int seq indices, ``valid`` [B, R] the rows written
    live this tick. Only the int8 layout's attention ``*_scale`` leaves
    [L, B, HK, M] are judged, wherever they sit in the tree, so a bf16
    cache, and an MLA layer's latents under either cache dtype, give all
    False. With ``paged`` (the caches
    are page pools) nothing is judged: ``repro/serving/resilience.py:118``
    judges only scale leaves whose axes carry ``act_kv_seq``, and the paged
    pools' scale leaves carry ``("kv_pages", "act_kv_heads",
    "kv_page_seq")`` (``transformer.py:725-726``), so on the paged layout
    only the logits guard acts. The port keeps that behaviour."""
    b, r = rows.shape
    bad = torch.zeros((b,), dtype=torch.bool, device=rows.device)
    if paged:
        return bad
    for path, leaf in tree_leaves(caches):
        if not path[-1].endswith("_scale"):
            continue
        leaf = leaf.reshape((-1,) + tuple(leaf.shape[-3:]))  # [L, B, HK, M], L = 1 unstacked
        idx = rows.to(torch.int64).clamp(0, leaf.shape[-1] - 1)
        taken = leaf.gather(-1, idx[None, :, None, :].expand(
            leaf.shape[0], b, leaf.shape[2], r))  # [L, B, HK, R]
        nf = (~torch.isfinite(taken)).any(dim=2).any(dim=0)  # [B, R]
        bad |= (nf & valid).any(dim=1)
    return bad


def scramble_tokens(tokens: torch.Tensor, mask: torch.Tensor, vocab: int) -> torch.Tensor:
    """Derange drafted tokens for the ``drafter_garbage`` fault: mapped
    tokens stay valid ids but (for vocab > 1) never equal the original, so
    acceptance collapses without indexing out of range. ``mask`` [B]
    selects slots; unselected rows pass through bit for bit."""
    garbled = (tokens + max(vocab // 2, 1)) % vocab
    return torch.where(mask[:, None], garbled, tokens)


# ---------------------------------------------------------------------------
# Deterministic fault injection (host data, asked by the engine each tick)
# ---------------------------------------------------------------------------

FAULT_KINDS = ("nan", "tick_exception", "slow_tick", "cache_growth",
               "drafter_garbage", "replica_crash", "replica_hang")

# Pool-scoped kinds (a replica pool consumes these; the engine ignores
# them): the fault targets a replica, fires once when that replica's engine
# reaches ``tick``, and emulates process death (crash) or a wedged runtime
# that stalls ``duration_s`` (hang).
REPLICA_FAULT_KINDS = ("replica_crash", "replica_hang")


@dataclasses.dataclass(frozen=True)
class Fault:
    """One injected fault.

    kind
        ``"nan"``: the slot's logits this tick become NaN at the guards'
        observation point; ``"tick_exception"``: the tick raises
        :class:`FaultInjected` before any device work; ``"slow_tick"``: the
        tick stalls ``duration_s`` (the straggler path); ``"cache_growth"``:
        the slot's request retires ``CACHE_EXHAUSTED``; ``"drafter_garbage"``:
        the slot's speculative drafts are deranged (acceptance collapses and
        the engine stops speculating); ``"replica_crash"`` and
        ``"replica_hang"``: pool-scoped, see :data:`REPLICA_FAULT_KINDS`.
    tick
        0-based scheduler tick on which the fault fires (replica kinds: the
        target replica's engine tick that arms it).
    slot
        Target slot of slot-scoped kinds; ``None`` targets every slot.
    replica
        Target replica of the pool-scoped kinds; ignored by the others.
    duration_s
        ``slow_tick`` / ``replica_hang`` stall length.
    repeat
        Fire on ticks ``[tick, tick + repeat)``.
    """

    kind: str
    tick: int
    slot: int | None = None
    replica: int | None = None
    duration_s: float = 0.25
    repeat: int = 1

    def __post_init__(self):
        if self.kind not in FAULT_KINDS:
            raise ValueError(f"unknown fault kind {self.kind!r}; "
                             f"have {FAULT_KINDS}")
        if self.tick < 0 or self.repeat < 1:
            raise ValueError(f"fault window [{self.tick}, +{self.repeat}) "
                             f"must be non-negative")


@dataclasses.dataclass(frozen=True)
class FaultPlan:
    """A deterministic schedule of :class:`Fault` entries, asked per tick.
    Two runs of one plan over the same requests take the same actions on
    the same ticks."""

    faults: tuple = ()

    def __post_init__(self):
        object.__setattr__(self, "faults", tuple(self.faults))

    def at(self, tick: int, kind: str) -> list[Fault]:
        return [f for f in self.faults
                if f.kind == kind and f.tick <= tick < f.tick + f.repeat]

    def slot_mask(self, tick: int, kind: str, slots: int) -> np.ndarray:
        """[slots] bool mask of the slots ``kind`` targets on ``tick``."""
        mask = np.zeros((slots,), bool)
        for f in self.at(tick, kind):
            if f.slot is None:
                mask[:] = True
            elif 0 <= f.slot < slots:
                mask[f.slot] = True
        return mask

    def replica_faults(self, kind: str, replica: int) -> list[Fault]:
        """Pool-scoped faults of ``kind`` targeting ``replica`` (``None``
        targets every replica); a pool fires each at most once, when the
        replica's engine reaches ``f.tick``."""
        return [f for f in self.faults if f.kind == kind
                and (f.replica is None or f.replica == replica)]

    def any_after(self, tick: int) -> bool:
        """Whether any fault could still fire at or after ``tick``."""
        return any(tick < f.tick + f.repeat for f in self.faults)
