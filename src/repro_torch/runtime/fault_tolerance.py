"""Straggler monitoring (``repro/runtime/fault_tolerance.py``).

``ServingEngine.step()`` feeds :class:`StragglerMonitor` each scheduler
tick's wall time; a tick slower than ``threshold`` times the EWMA of the
earlier ones is flagged (a ``straggler`` event in the engine's stats), and
:meth:`StragglerMonitor.degraded` is the health gate a replica pool reads.
The training half of the reference module (``PreemptionHandler``,
``ResilientExecutor``) belongs to the training port and is not here.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass
class StragglerEvent:
    step: int
    duration: float
    ewma: float


class StragglerMonitor:
    """EWMA step-time tracker with threshold-based straggler detection."""

    def __init__(self, *, alpha: float = 0.1, threshold: float = 2.0, warmup: int = 5):
        self.alpha = alpha
        self.threshold = threshold
        self.warmup = warmup
        self.ewma: float | None = None
        self.count = 0
        self.events: list[StragglerEvent] = []

    def record(self, step: int, duration: float) -> bool:
        """Returns True if this step is flagged as a straggler."""
        self.count += 1
        if self.ewma is None:
            self.ewma = duration
            return False
        flagged = self.count > self.warmup and duration > self.threshold * self.ewma
        if flagged:
            self.events.append(StragglerEvent(step, duration, self.ewma))
        else:  # stragglers do not move the baseline
            self.ewma = (1 - self.alpha) * self.ewma + self.alpha * duration
        return flagged

    def degraded(self, *, window: int = 8, min_events: int = 3) -> bool:
        """True when at least ``min_events`` of the last ``window`` recorded
        steps were flagged: a dense straggler window, not one slow tick."""
        if self.count <= self.warmup:
            return False
        recent = [e for e in self.events if e.step > self.count - window]
        return len(recent) >= min_events

    def report(self) -> dict:
        return {
            "steps": self.count,
            "ewma_s": self.ewma,
            "straggler_events": len(self.events),
        }
