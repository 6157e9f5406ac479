"""Replica pool: SLO-class admission, health-gated routing, crash failover
(``repro/serving/pool.py``).

A :class:`ReplicaPool` owns N :class:`~repro_torch.serving.server.
EngineDriver`-wrapped ``ServingEngine`` replicas behind one shared admission
queue. All replicas share one card, one params tree and its default stream
(see ``serving/server.py``). Four contracts, in order of importance:

* **Deterministic request migration** (crash failover). A replica whose
  driver thread dies (an injected ``replica_crash``, a real thread kill, an
  uncontainable tick or a failed warmup) or whose heartbeat goes stale (a
  hang) has its unfinished requests exported as resumable snapshots
  (``ServingEngine.export_requests``: prompt, emitted tokens, the budget
  left and the lifecycle fields, host state only) and requeued *at their
  original pool sequence number*. Greedy decoding is a function of
  (weights, prompt, emitted tokens), so a surviving replica that prefills
  them again continues the stream as an uncontended run would. The
  per-request emit **watermark** (``delivered``, the tokens pushed to the
  sink so far) makes delivery exactly-once across the migration: every
  emission is served as ``req.generated[delivered:]`` from the
  authoritative request object, so tokens appended on the dead replica
  after its last delivered emission are flushed by the first emission
  after the migration, and nothing is pushed twice. On the card the first
  run decoded through decode attention and the resumed one prefills the
  same tokens through prefill-append, so at full width in bf16 a migrated
  stream may part from the solo run at a near-tie of two logits; exactly-
  once delivery holds regardless.

* **SLO-class admission** (:class:`SLOQueue`). A request's class from
  ``cfg.slo_classes`` (``interactive | batch | best_effort``) seeds its
  priority, deadline and the prefill chunk-budget weight the engine folds
  into its tick budget. The queue pops in one total order: **priority
  DESC, then admission sequence ASC**; deadlines expire queued requests but
  never reorder them. Routing is head-of-line strict: if the head cannot be
  placed, nothing overtakes it.

* **Health-gated routing.** Dispatch goes to the least-loaded ``ready``
  replica (ties: the lowest index). A replica drains when its engine
  reports ``consecutive_tick_failures >= cfg.pool_health_fail_ticks`` or
  its ``StragglerMonitor`` a dense straggler window (``degraded()``);
  draining replicas finish their work, then sit quarantined under an
  exponential backoff (``pool_backoff_s`` doubling to
  ``pool_backoff_max_s``). Reinstatement is by probe: after the backoff a
  small negative-rid request must complete ``OK`` within
  ``pool_probe_timeout_s``, or the backoff doubles again. A dead replica is
  restarted from the engine factory and must pass the same probe.

* **Saturation preemption.** When every ready replica is slot-saturated,
  the head request still dispatches onto a replica holding a strictly
  lower-priority request; the engine's own admission preemption frees the
  slot and resumes the victim as it would any preempted request.

Threading: a supervisor loop (``poll()``, on a daemon thread via
``start()``) plus the replicas' driver threads, which call back into
``_on_emit``/``_on_finish`` under the pool lock. The lock is held for host
bookkeeping only, never across a wait on a driver thread. ``clock`` (the
heartbeats, backoffs, probe deadlines and queue expiry) can be injected, so
a test decides when time passes.
"""

from __future__ import annotations

import dataclasses
import heapq
import itertools
import threading
import time

import numpy as np

from ..configs.base import resolve_slo
from . import engine as E
from . import resilience as R
from .server import EngineDriver

# replica_crash raises a bare SystemExit: the driver's ``except Exception``
# never catches it, so the thread dies mid-loop as in a real crash, and
# ``threading.excepthook`` stays silent for SystemExit.


class SLOQueue:
    """The pool's admission queue. Total order: **priority DESC, sequence
    ASC**. Deadlines expire entries, never move them; the sequence number is
    unique, so any interleaving pops in one deterministic order."""

    def __init__(self, cap: int = 0):
        self.cap = int(cap)  # 0 = unbounded
        self._heap: list = []  # (-priority, seq, Request)
        self._seqs = itertools.count()

    def push(self, req: E.Request, seq: int | None = None) -> bool:
        """False when the bounded queue is full (the pool's 429). ``seq``
        pins the admission sequence: a migration requeues at the request's
        original one, so failover neither demotes nor promotes it."""
        if self.cap and len(self._heap) >= self.cap:
            return False
        if seq is None:
            seq = next(self._seqs)
        heapq.heappush(self._heap, (-int(req.priority), int(seq), req))
        return True

    def peek(self) -> E.Request | None:
        return self._heap[0][2] if self._heap else None

    def pop(self) -> E.Request | None:
        return heapq.heappop(self._heap)[2] if self._heap else None

    def remove(self, rid: int) -> E.Request | None:
        for i, (_, _, req) in enumerate(self._heap):
            if req.rid == rid:
                self._heap.pop(i)
                heapq.heapify(self._heap)
                return req
        return None

    def expire(self, now: float) -> list:
        """Remove and return every deadline-expired request."""
        dead = [req for _, _, req in self._heap if req.expired(now)]
        if dead:
            self._heap = [e for e in self._heap if not e[2].expired(now)]
            heapq.heapify(self._heap)
        return dead

    def __len__(self) -> int:
        return len(self._heap)


# Replica health states:
#   starting -> ready <-> draining -> quarantined -> probing -> ready
# a crash or hang goes straight to quarantined (after migrating its
# requests); a failed probe goes back to quarantined with a doubled backoff.
_ACTIVE = ("ready", "draining", "probing")


@dataclasses.dataclass
class _Replica:
    idx: int
    engine: object
    driver: EngineDriver
    state: str = "starting"
    inflight: int = 0  # dispatched, no terminal event yet
    backoff_s: float = 0.0  # the next quarantine's hold
    until: float = 0.0  # the quarantine's end
    probe_rid: int | None = None
    probe_ok: bool | None = None
    probe_deadline: float = 0.0
    restarts: int = 0
    crashes: int = 0
    straggler_archive: int = 0  # straggler events archived at quarantines
    fired: set = dataclasses.field(default_factory=set)  # injected faults


@dataclasses.dataclass
class _Stream:
    """The pool's record of one tracked request. ``req`` is authoritative
    (swapped for the snapshot on migration); ``delivered`` is the emit
    watermark. A driver's events count only when both the replica index and
    the object identity match (``st.req is req``), so a hung replica that
    wakes after its requests migrated can never deliver twice."""
    req: E.Request
    sink: object  # _StreamSink or any object with push(); None runs sinkless
    seq: int  # the pool admission sequence, kept across migrations
    replica: int | None = None
    delivered: int = 0
    cancelled: bool = False


class ReplicaPool:
    """N engine replicas behind one SLO-aware queue; see the module
    docstring."""

    IS_POOL = True  # ServingServer's backend discriminator

    def __init__(self, factory, cfg, *, replicas: int | None = None,
                 queue_cap: int | None = None, fault_plan=None, warmup=True,
                 poll_s: float | None = None, clock=time.monotonic):
        """``factory(replica_id) -> ServingEngine`` builds a replica, and
        builds it again after a crash; share one params tree across calls
        (resumed streams rely on identical weights). ``fault_plan`` is read
        for the pool's kinds only (``replica_crash``, ``replica_hang``);
        engine faults stay the factory's choice."""
        self.cfg = cfg
        self.factory = factory
        self._clock = clock
        self._warmup = warmup
        self._poll_s = poll_s
        self._fault_plan = fault_plan
        self._poll_interval = float(getattr(cfg, "pool_poll_interval_s", 0.01))
        n = int(getattr(cfg, "pool_replicas", 2) if replicas is None else replicas)
        cap = (int(getattr(cfg, "admission_queue_cap", 0)) if queue_cap is None
               else int(queue_cap))
        self.queue = SLOQueue(cap=cap)
        self._lock = threading.RLock()
        self._rids = itertools.count(1)
        self._probe_rids = itertools.count(1)
        self._seqs = itertools.count()
        self._streams: dict[int, _Stream] = {}
        self.status_counts: dict[str, int] = {}
        self.migrated_total = 0
        self.draining = False
        self.stopped = False
        self._stop_evt = threading.Event()
        self._wake_evt = threading.Event()
        self._thread: threading.Thread | None = None
        self.replicas = [self._make_replica(i) for i in range(max(n, 1))]

    # -- replica construction and wiring -------------------------------------

    def _make_replica(self, idx: int, *, restarts: int = 0,
                      fired: set | None = None) -> _Replica:
        eng = self.factory(idx)
        if eng.replica_id is None:
            eng.replica_id = idx
        # the POOL queue is the admission bound (it answers the 429s); a
        # replica's own queue must never reject a dispatched request
        eng.queue_cap = 0
        driver = EngineDriver(eng, warmup=self._warmup, poll_s=self._poll_s,
                              name=f"replica-{idx}", clock=self._clock)
        rep = _Replica(idx=idx, engine=eng, driver=driver, restarts=restarts,
                       fired=fired if fired is not None else set())
        driver.emit_listener = lambda req, toks: self._on_emit(idx, req, toks)
        driver.finish_listener = lambda req: self._on_finish(idx, req)
        self._install_fault_hook(rep)
        return rep

    def _install_fault_hook(self, rep: _Replica) -> None:
        plan = self._fault_plan
        if plan is None:
            return
        crash = plan.replica_faults("replica_crash", rep.idx)
        hang = plan.replica_faults("replica_hang", rep.idx)
        if not crash and not hang:
            return

        def hook(driver):
            tick = driver.engine.tick_count
            for f in hang:
                key = ("hang", f.tick, f.replica)
                if tick >= f.tick and key not in rep.fired:
                    rep.fired.add(key)
                    time.sleep(f.duration_s)  # the heartbeat goes stale
            for f in crash:
                key = ("crash", f.tick, f.replica)
                if tick >= f.tick and key not in rep.fired:
                    rep.fired.add(key)
                    raise SystemExit(f"replica_crash @ tick {tick}")

        rep.driver.fault_hook = hook

    # -- lifecycle -----------------------------------------------------------

    def start(self, *, supervise: bool = True) -> "ReplicaPool":
        """Start every replica's driver and, by default, the supervisor
        thread; ``supervise=False`` leaves :meth:`poll` to the caller."""
        for rep in self.replicas:
            rep.driver.start()
        if supervise:
            self._thread = threading.Thread(target=self._supervise, name="pool-supervisor",
                                            daemon=True)
            self._thread.start()
        return self

    def _supervise(self) -> None:
        while not self._stop_evt.is_set():
            try:
                self.poll()
            except Exception:  # noqa: BLE001 -- the supervisor never dies
                pass
            self._wake_evt.wait(self._poll_interval)
            self._wake_evt.clear()

    @property
    def ready(self) -> bool:
        return any(r.state == "ready" for r in self.replicas)

    def idle(self) -> bool:
        with self._lock:
            return (len(self.queue) == 0 and not self._streams
                    and all(r.inflight == 0 for r in self.replicas))

    def tracked_rids(self) -> list[int]:
        with self._lock:
            return list(self._streams)

    def begin_drain(self) -> None:
        self.draining = True

    def stop(self) -> None:
        """Stop the supervisor and every driver; fail any stream still
        tracked so that no connection is left waiting."""
        self.draining = True
        self._stop_evt.set()
        self._wake_evt.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
        for rep in self.replicas:  # outside the lock: joins driver threads
            try:
                rep.driver.stop()
            except Exception:  # noqa: BLE001
                pass
        with self._lock:
            for st in list(self._streams.values()):
                self._finish_stream_locked(st, R.Status.FAILED, "pool_shutdown")
            self.stopped = True

    # -- client API ----------------------------------------------------------

    def submit(self, prompt, *, max_new: int, slo: str | None = None,
               priority: int | None = None, deadline_s: float | None = None,
               budget_weight: float | None = None, sink=None) -> int | None:
        """Admit one request into the pool queue (thread-safe; dispatch runs
        under the lock, the supervisor mops up). Returns the rid, or None
        when draining, stopped or the bounded queue is full (429). The SLO
        class seeds priority, deadline and chunk-budget weight; explicit
        keywords override it; an unknown class raises ``KeyError``.
        ``submitted_at`` is stamped here, so a deadline spans the pool
        queue's wait too."""
        if self.draining or self.stopped:
            return None
        prio, dl, weight = 0, None, 1.0
        if slo is not None:
            prio, dl, weight = resolve_slo(self.cfg, slo)
        if priority is not None:
            prio = int(priority)
        if deadline_s is not None:
            dl = float(deadline_s)
        if budget_weight is not None:
            weight = float(budget_weight)
        if dl is None and getattr(self.cfg, "request_ttl_s", 0) > 0:
            dl = float(self.cfg.request_ttl_s)
        with self._lock:
            rid = next(self._rids)
            req = E.Request(rid=rid, prompt=np.asarray(prompt, np.int64), max_new=int(max_new),
                            priority=prio, deadline_s=dl, slo=slo, budget_weight=weight)
            req.submitted_at = self._clock()
            seq = next(self._seqs)
            if not self.queue.push(req, seq=seq):
                return None
            self._streams[rid] = _Stream(req=req, sink=sink, seq=seq)
            self._dispatch_locked()
        self._wake_evt.set()
        return rid

    def cancel(self, rid: int) -> bool:
        with self._lock:
            st = self._streams.get(rid)
            if st is None:
                return False
            st.cancelled = True
            st.req.cancel_requested = True
            if st.replica is None:  # still in the pool queue: retire it now
                self.queue.remove(rid)
                self._finish_stream_locked(st, R.Status.CANCELLED)
                return True
            rep = self.replicas[st.replica]
        try:
            rep.driver.cancel(rid)
        except ConnectionError:
            pass  # a dead replica: the failover honours st.cancelled
        return True

    def stats(self, *, per_replica_timeout_s: float = 0.25) -> dict:
        """Pool and per-replica stats, waiting at most
        ``per_replica_timeout_s`` a replica: a live driver answers on its
        thread, a dead one is read directly (its thread is gone), a wedged
        one reports ``engine: None``."""
        with self._lock:
            snap = {
                "pool": True,
                "replicas": len(self.replicas),
                "queued": len(self.queue),
                "live": sum(r.inflight for r in self.replicas),
                "tracked_streams": len(self._streams),
                "migrated_total": self.migrated_total,
                "statuses": dict(self.status_counts),
            }
            reps = list(self.replicas)
        out = []
        for rep in reps:  # outside the lock: stats_blocking waits on drivers
            entry = {
                "replica_id": rep.engine.replica_id,
                "state": rep.state,
                "inflight": rep.inflight,
                "restarts": rep.restarts,
                "crashes": rep.crashes,
                "backoff_s": rep.backoff_s,
            }
            if rep.driver.stopped or rep.driver.crashed:
                try:
                    entry["engine"] = rep.engine.stats()
                except Exception:  # noqa: BLE001
                    entry["engine"] = None
            else:
                entry["engine"] = rep.driver.stats_blocking(per_replica_timeout_s)
            out.append(entry)
        snap["per_replica"] = out
        return snap

    # -- supervisor ----------------------------------------------------------

    def poll(self) -> None:
        """One supervision pass: check every replica (crash and hang
        failover, the drain, quarantine and probe transitions), expire
        queued deadlines, dispatch the queue's head(s)."""
        now = self._clock()
        with self._lock:
            for rep in self.replicas:
                self._check_replica_locked(rep, now)
            for req in self.queue.expire(now):
                st = self._streams.get(req.rid)
                if st is not None:
                    self._finish_stream_locked(st, R.Status.DEADLINE_EXCEEDED)
            self._dispatch_locked()

    def _check_replica_locked(self, rep: _Replica, now: float) -> None:
        drv = rep.driver
        if drv.crashed and rep.state != "quarantined":
            self._failover_locked(rep, now, "replica_crash")
            return
        if (rep.state in _ACTIVE and drv.ready.is_set()
                and now - drv.beat > float(self.cfg.pool_hang_timeout_s)):
            self._failover_locked(rep, now, "replica_hang")
            return
        if rep.state == "starting":
            if drv.ready.is_set():
                rep.state = "ready"
            return
        if rep.state == "ready":
            eng = rep.engine
            fail_gate = eng.consecutive_tick_failures >= int(self.cfg.pool_health_fail_ticks)
            slow_gate = eng.straggler.degraded(window=int(self.cfg.pool_straggler_window),
                                               min_events=int(self.cfg.pool_straggler_events))
            if fail_gate or slow_gate:
                rep.state = "draining"  # no new work; in-flight requests finish
            return
        if rep.state == "draining":
            if rep.inflight == 0:
                self._quarantine_locked(rep, now)
            return
        if rep.state == "quarantined":
            if now >= rep.until:
                self._begin_probe_locked(rep, now)
            return
        if rep.state == "probing":
            self._check_probe_locked(rep, now)

    # -- health state machine ------------------------------------------------

    def _quarantine_locked(self, rep: _Replica, now: float) -> None:
        """Enter quarantine: the exponential backoff, the straggler evidence
        archived (a past dense window cannot trip the gate again after a
        clean probe), the tick-failure gate reset."""
        rep.backoff_s = (float(self.cfg.pool_backoff_s) if rep.backoff_s <= 0
                         else min(rep.backoff_s * 2.0, float(self.cfg.pool_backoff_max_s)))
        rep.until = now + rep.backoff_s
        rep.state = "quarantined"
        rep.probe_rid = None
        rep.probe_ok = None
        try:
            rep.straggler_archive += len(rep.engine.straggler.events)
            rep.engine.straggler.events.clear()
            rep.engine.consecutive_tick_failures = 0
        except Exception:  # noqa: BLE001 -- a dead engine must not stop us
            pass

    def _begin_probe_locked(self, rep: _Replica, now: float) -> None:
        """The backoff is over: restart a dead replica from the factory,
        then demand that one small request complete OK before reinstating.
        The dead engine's device state lives until its replacement is
        built."""
        drv = rep.driver
        if drv.crashed or drv.stopped:
            try:
                drv.stop()  # a dead thread: the join returns at once
            except Exception:  # noqa: BLE001
                pass
            fresh = self._make_replica(rep.idx, restarts=rep.restarts + 1, fired=rep.fired)
            rep.engine = fresh.engine
            rep.driver = fresh.driver
            rep.restarts += 1
            rep.driver.start()
        rep.state = "probing"
        rep.probe_rid = None  # submitted once the driver reports ready
        rep.probe_ok = None
        rep.probe_deadline = now + float(self.cfg.pool_probe_timeout_s)

    def _check_probe_locked(self, rep: _Replica, now: float) -> None:
        if rep.probe_ok is True:
            rep.state = "ready"
            rep.backoff_s = 0.0  # healthy again: the backoff is forgiven
            rep.probe_rid = None
            return
        if now >= rep.probe_deadline or rep.probe_ok is False:
            self._quarantine_locked(rep, now)  # a doubled backoff
            return
        if rep.probe_rid is None and rep.driver.ready.is_set():
            vocab = int(getattr(rep.engine.cfg, "vocab_size", 2))
            rid = -next(self._probe_rids)
            probe = E.Request(rid=rid, prompt=np.arange(1, 9, dtype=np.int64) % vocab,
                              max_new=2)
            rep.probe_rid = rid
            try:
                rep.driver.submit_request(probe)
            except ConnectionError:
                rep.probe_ok = False

    # -- crash failover ------------------------------------------------------

    def _failover_locked(self, rep: _Replica, now: float, reason: str) -> None:
        """A replica died (thread gone) or hung (heartbeat stale): requeue
        every request it owns at its original sequence, then quarantine the
        replica. See the module docstring for why the resumed streams
        continue as a solo run and delivery stays exactly-once."""
        rep.crashes += 1
        try:
            snaps = {r.rid: r for r in rep.engine.export_requests()}
        except Exception:  # noqa: BLE001 -- at worst, no snapshots
            snaps = {}
        for st in list(self._streams.values()):
            if st.replica != rep.idx:
                continue
            snap = snaps.get(st.req.rid)
            if snap is None and st.req.done:
                # ended just before the death (terminal stamped, its event
                # maybe never fired): deliver from the pool's own copy
                self._finish_stream_locked(st, st.req.status, st.req.status_detail)
                continue
            if snap is None:
                # the dispatch command died unrun in the driver's queue: the
                # engine never saw it, and the pool's own object is whole
                snap = E.snapshot_request(st.req)
            if st.cancelled:  # a cancel raced the crash: honour it
                st.req = snap
                self._finish_stream_locked(st, R.Status.CANCELLED)
                continue
            # a hung replica may wake: flag its copy cancelled so the zombie
            # stops spending ticks (its events are already disowned)
            st.req.cancel_requested = True
            snap.migrations += 1
            st.req = snap  # the snapshot is now authoritative
            st.replica = None
            self.queue.push(snap, seq=st.seq)  # the original order
            self.migrated_total += 1
        rep.inflight = 0
        self._quarantine_locked(rep, now)

    # -- dispatch ------------------------------------------------------------

    def _dispatch_locked(self) -> None:
        """Head-of-line strict: place the queue's head on the least-loaded
        ready replica (or, all saturated, on one it can preempt); if the
        head cannot be placed, nothing overtakes it."""
        while True:
            req = self.queue.peek()
            if req is None:
                return
            rep = self._route_locked(req)
            if rep is None:
                return
            self.queue.pop()
            st = self._streams.get(req.rid)
            if st is None:  # cancelled while queued
                continue
            st.replica = rep.idx
            rep.inflight += 1
            try:
                rep.driver.submit_request(req, self._dispatch_cb(rep, req))
            except ConnectionError:
                # the driver died between the health check and now: undo and
                # leave the request queued; the next poll fails the replica
                # over and the head routes elsewhere
                st.replica = None
                rep.inflight = max(rep.inflight - 1, 0)
                self.queue.push(req, seq=st.seq)
                return

    def _dispatch_cb(self, rep: _Replica, req: E.Request):
        def cb(ok: bool) -> None:  # driver thread, right after engine.submit
            if ok:
                return
            with self._lock:
                st = self._streams.get(req.rid)
                if st is not None and st.req is req:
                    rep.inflight = max(rep.inflight - 1, 0)
                    self._finish_stream_locked(st, R.Status.FAILED,
                                               req.status_detail or "replica_reject")
        return cb

    def _route_locked(self, req: E.Request) -> _Replica | None:
        ready = sorted((r for r in self.replicas
                        if r.state == "ready" and not r.driver.stopped and not r.driver.crashed),
                       key=lambda r: (r.inflight, r.idx))
        if not ready:
            return None
        for rep in ready:
            if rep.inflight < rep.engine.slots:
                return rep
        for rep in ready:  # all saturated: dispatch to preempt (the engine's)
            floor = min((s.req.priority for s in self._streams.values()
                         if s.replica == rep.idx), default=None)
            if floor is not None and req.priority > floor:
                return rep
        return None

    # -- driver-thread listeners ---------------------------------------------

    def _on_emit(self, ridx: int, req: E.Request, toks) -> None:
        with self._lock:
            st = self._streams.get(req.rid)
            if st is None or st.replica != ridx or st.req is not req:
                return  # disowned: a stale replica, a migrated or unknown rid
            new = req.generated[st.delivered:]
            if new and st.sink is not None:
                st.sink.push(("tokens", [int(t) for t in new]))
            st.delivered += len(new)

    def _on_finish(self, ridx: int, req: E.Request) -> None:
        with self._lock:
            if req.rid < 0:  # a health probe
                rep = self.replicas[ridx]
                if rep.probe_rid == req.rid:
                    rep.probe_ok = req.status is R.Status.OK
                return
            st = self._streams.get(req.rid)
            if st is None or st.replica != ridx or st.req is not req:
                return
            rep = self.replicas[ridx]
            rep.inflight = max(rep.inflight - 1, 0)
            self._finish_stream_locked(st, req.status, req.status_detail)
            self._dispatch_locked()  # a slot just freed

    def _finish_stream_locked(self, st: _Stream, status: R.Status,
                              detail: str | None = None) -> None:
        """Terminal delivery: flush the tokens past the watermark, then
        exactly one final event; the stream is no longer tracked."""
        req = st.req
        if not req.done:
            req.done = True
            req.status = status
            req.status_detail = detail
            req.finished_at = self._clock()
        rem = req.generated[st.delivered:]
        if rem and st.sink is not None:
            st.sink.push(("tokens", [int(t) for t in rem]))
        st.delivered += len(rem)
        if st.sink is not None:
            st.sink.push(("final", req.status.name, req.status_detail, len(req.generated)))
        self._streams.pop(req.rid, None)
        name = req.status.name
        self.status_counts[name] = self.status_counts.get(name, 0) + 1
