"""PyTorch port, the replica pool (``repro_torch/serving/pool.py``) on the
tellme-0.7b smoke config in f32, against the JAX package's ``ReplicaPool``
and ``ServingEngine(mode="packed")`` on the same packed weights.

Bars:
* the pool's config knobs and ``resolve_slo`` equal JAX's; an SLO class
  seeds priority, deadline and budget weight, explicit values override it,
  an unknown class raises, and the engine receives the class's fields;
* least-loaded routing (4 requests over 2 x 2 slots: 2 each), streams
  equal to JAX's engine and the port's solo engine; cancel of a queued and
  of a dispatched request; the SLO queue's total order;
* the health gate: the tick-failure gate and the straggler gate (a
  monitor fed through ``record()``) drain a replica; it is quarantined
  under backoff, probed and reinstated, all on an injected clock;
* failover: an injected ``replica_crash`` (N = 2) gives JAX's pool's
  streams and the solo streams, byte for byte, one terminal event each; a
  real thread kill (N = 3) the solo streams; a ``replica_hang`` (detected
  by advancing the injected clock while the replica sleeps) migrates with
  no token delivered twice after the replica wakes; a crashed replica is
  restarted from the factory and serves again; a replica whose warmup
  raises is treated as a crash, restarted, and serves;
* ``stats()`` aggregates per replica; the HTTP front door over a pool of 3
  survives a replica kill mid-stream (injected or a thread kill) with
  contiguous token indexes and the solo streams.

Engines get a ``StragglerMonitor`` that load cannot trip, the pool is
driven by ``poll()`` (``start(supervise=False)``), hangs and backoffs move
on the injected clock, every wait is bounded and every pool and server is
stopped in a ``finally``.
"""

import asyncio
import ctypes
import dataclasses
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config
from repro.configs import resolve_slo as j_resolve_slo
from repro.core import params as P
from repro.models import transformer as jT
from repro.serving import engine as jE
from repro.serving import resilience as jR
from repro.serving.pool import ReplicaPool as JReplicaPool
from repro_torch import interop
from repro_torch.configs import get_config as t_get_config
from repro_torch.configs import resolve_slo
from repro_torch.runtime import fault_tolerance as FT
from repro_torch.serving import engine as TE
from repro_torch.serving import resilience as TR
from repro_torch.serving.pool import ReplicaPool, SLOQueue
from repro_torch.serving.server import ServingServer, sse_request

# replica_crash and the thread kill end driver threads with SystemExit on
# purpose; pytest's thread-exception hook would warn on each one
pytestmark = pytest.mark.filterwarnings(
    "ignore::pytest.PytestUnhandledThreadExceptionWarning")

MAX_LEN = 192
MAX_NEW = 10
POOL_KNOBS = ("slo_classes", "pool_replicas", "pool_health_fail_ticks", "pool_backoff_s",
              "pool_backoff_max_s", "pool_hang_timeout_s", "pool_probe_timeout_s",
              "pool_poll_interval_s", "pool_straggler_window", "pool_straggler_events",
              "server_host", "server_port", "server_drain_timeout_s", "server_poll_s")


@pytest.fixture(scope="module")
def models():
    jcfg = dataclasses.replace(get_config("tellme-0.7b", smoke=True), dtype=jnp.float32)
    tcfg = dataclasses.replace(t_get_config("tellme-0.7b", smoke=True), dtype=torch.float32)
    specs = jT.param_specs(jcfg)
    jp = jT.pack_tree(P.init_params(specs, jax.random.PRNGKey(0)), specs)
    tp = interop.from_jax_params(jax.device_get(jp), tcfg, device="cpu")
    return jcfg, tcfg, jp, tp


@pytest.fixture(scope="module")
def jax_solo(models):
    """Streams of JAX's engine, each prompt served to the end (greedy f32
    streams do not depend on what else is in the batch)."""
    jcfg, _, jp, _ = models
    eng = jE.ServingEngine(jp, jcfg, mode="packed", slots=2, max_len=MAX_LEN, eos_id=-2)
    memo = {}

    def run(prompts, max_new=MAX_NEW):
        todo = [p for p in prompts if (tuple(p), max_new) not in memo]
        reqs = [jE.Request(rid=i, prompt=np.asarray(p), max_new=max_new)
                for i, p in enumerate(todo)]
        for r in reqs:
            assert eng.submit(r)
        eng.run()
        for p, r in zip(todo, reqs):
            memo[(tuple(p), max_new)] = tuple(int(t) for t in r.generated)
        return [memo[(tuple(p), max_new)] for p in prompts]

    return run


def _cfg(models, **kw):
    # the hang detector reads the injected clock, which moves only when a
    # test moves it; 300 s keeps the real-clock tests (through HTTP) clear
    # of a driver the load starves
    kw.setdefault("pool_hang_timeout_s", 300.0)
    return dataclasses.replace(models[1], **kw)


def _calm():
    """A straggler monitor the machine's load cannot trip."""
    return FT.StragglerMonitor(threshold=1e9)


def _factory(models, cfg, engine_cls=TE.ServingEngine, **kw):
    tp = models[3]
    kw = {"slots": 2, "max_len": MAX_LEN, "eos_id": -2, **kw}

    def factory(idx):
        return engine_cls(tp, cfg, device="cpu", straggler=_calm(), **kw)

    return factory


def _prompts(lens, seed=0):
    rng = np.random.default_rng(seed)
    return [[int(t) for t in rng.integers(1, 256, size=n)] for n in lens]


def _solo(models, prompts, max_new=MAX_NEW):
    _, tcfg, _, tp = models
    eng = TE.ServingEngine(tp, tcfg, slots=2, max_len=MAX_LEN, eos_id=-2, device="cpu")
    reqs = [TE.Request(rid=i, prompt=np.asarray(p), max_new=max_new)
            for i, p in enumerate(prompts)]
    for r in reqs:
        assert eng.submit(r)
    eng.run()
    return [tuple(int(t) for t in r.generated) for r in reqs]


class Clock:
    """A clock that moves only when told to."""

    def __init__(self, t: float = 1000.0):
        self.t = t

    def __call__(self) -> float:
        return self.t

    def advance(self, dt: float) -> None:
        self.t += dt


class _Sink:
    """A pool sink that records every push, for the exactly-once holds."""

    def __init__(self):
        self.items = []

    def push(self, item):
        self.items.append(item)

    @property
    def tokens(self):
        return tuple(t for it in self.items if it[0] == "tokens" for t in it[1])

    @property
    def finals(self):
        return [it for it in self.items if it[0] == "final"]


def _until(pool, pred, what, timeout_s=120.0, each=None):
    t0 = time.monotonic()
    while True:
        if pool is not None:
            pool.poll()
        if each is not None:
            each()
        if pred():
            return
        if time.monotonic() - t0 > timeout_s:
            raise AssertionError(f"timed out waiting for {what}"
                                 + (f": {pool.stats()}" if pool is not None else ""))
        time.sleep(0.005)


def _ready(pool, n=None):
    want = len(pool.replicas) if n is None else n
    _until(pool, lambda: sum(r.state == "ready" for r in pool.replicas) >= want,
           "the replicas to become ready")


def _drive(pool, timeout_s=120.0, each=None):
    _until(pool, pool.idle, "the pool to go idle", timeout_s, each)


def _kill_thread(thread) -> None:
    n = ctypes.pythonapi.PyThreadState_SetAsyncExc(ctypes.c_long(thread.ident),
                                                   ctypes.py_object(SystemExit))
    assert n == 1


def _assert_exactly_once(sinks, want):
    for s, w in zip(sinks, want):
        assert s.tokens == w  # byte-identical, no duplicate, no loss
        assert len(s.finals) == 1 and s.finals[0][1] == "OK" and s.finals[0][3] == len(w)


# ---------------------------------------------------------------------------
# SLO-class admission
# ---------------------------------------------------------------------------


def test_pool_knobs_and_resolve_slo_equal_jax(models):
    jcfg, tcfg = models[0], models[1]
    assert {k: getattr(tcfg, k) for k in POOL_KNOBS} == {k: getattr(jcfg, k) for k in POOL_KNOBS}
    for name, *_ in tcfg.slo_classes:
        assert resolve_slo(tcfg, name) == j_resolve_slo(jcfg, name)
    with pytest.raises(KeyError, match="unknown SLO class"):
        resolve_slo(tcfg, "platinum")


class _Recording(TE.ServingEngine):
    """Records the lifecycle fields of every request it is given."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.seen = []

    def submit(self, req):
        self.seen.append((req.rid, req.priority, req.deadline_s, req.slo, req.budget_weight))
        return super().submit(req)


@pytest.mark.parametrize("slo", ["interactive", "batch", "best_effort"])
def test_slo_class_seeds_the_request_and_reaches_the_engine(models, slo):
    cfg = _cfg(models)
    clock = Clock()
    pool = ReplicaPool(_factory(models, cfg, _Recording), cfg, replicas=1, warmup=False,
                       clock=clock)
    try:
        prio, dl, weight = resolve_slo(cfg, slo)
        rid = pool.submit([1, 2, 3], max_new=4, slo=slo)
        req = pool._streams[rid].req
        assert (req.priority, req.deadline_s, req.budget_weight, req.slo) == (prio, dl, weight,
                                                                              slo)
        assert req.submitted_at == clock()
        over = pool.submit([1, 2, 3], max_new=4, slo=slo, priority=7, deadline_s=9.0,
                           budget_weight=0.75)
        assert (pool._streams[over].req.priority, pool._streams[over].req.deadline_s,
                pool._streams[over].req.budget_weight) == (7, 9.0, 0.75)
        with pytest.raises(KeyError):
            pool.submit([1], max_new=1, slo="no_such_class")
        pool.start(supervise=False)
        _ready(pool)
        _drive(pool)
        assert sorted(pool.replicas[0].engine.seen) == [
            (rid, prio, dl, slo, weight), (over, 7, 9.0, slo, 0.75)]
    finally:
        pool.stop()


def test_slo_queue_total_order():
    q = SLOQueue()
    reqs = [TE.Request(rid=i, prompt=[1], max_new=1, priority=p)
            for i, p in enumerate((0, 2, 1, 2, 0, 1))]
    for r in reqs:
        q.push(r)
    late = TE.Request(rid=9, prompt=[1], max_new=1, priority=2)
    q.push(late, seq=0)  # a migration keeps its original sequence: first of its class
    assert [q.pop().rid for _ in range(len(q))] == [9, 1, 3, 2, 5, 0, 4]
    capped = SLOQueue(cap=1)
    assert capped.push(reqs[0]) and not capped.push(reqs[1])


# ---------------------------------------------------------------------------
# Routing and plain serving
# ---------------------------------------------------------------------------


def test_least_loaded_routing_and_solo_bit_identity(models, jax_solo):
    cfg = _cfg(models)
    prompts = _prompts((40, 70, 30, 17))
    pool = ReplicaPool(_factory(models, cfg), cfg, replicas=2, warmup=False, clock=Clock())
    pool.start(supervise=False)
    try:
        _ready(pool)
        sinks = [_Sink() for _ in prompts]
        for p, s in zip(prompts, sinks):
            pool.submit(p, max_new=MAX_NEW, sink=s)
        assert [r.inflight for r in pool.replicas] == [2, 2]  # 2 x 2 slots, 2 each
        assert [pool._streams[i + 1].replica for i in range(4)] == [0, 1, 0, 1]
        _drive(pool)
        want = jax_solo(prompts)
        assert want == _solo(models, prompts)
        _assert_exactly_once(sinks, want)
        assert pool.stats()["statuses"] == {"OK": len(prompts)}
    finally:
        pool.stop()


def test_pool_cancel_queued_and_dispatched(models):
    cfg = _cfg(models)
    pool = ReplicaPool(_factory(models, cfg, slots=1), cfg, replicas=1, warmup=False,
                       clock=Clock())
    try:
        sink = _Sink()  # no replica is ready yet: a queued cancel ends at once
        rid = pool.submit([1, 2, 3], max_new=4, sink=sink)
        assert pool.cancel(rid)
        assert sink.items == [("final", "CANCELLED", None, 0)]
        assert rid not in pool._streams and len(pool.queue) == 0
        pool.start(supervise=False)
        _ready(pool)
        sink2 = _Sink()
        rid2 = pool.submit(_prompts((60,))[0], max_new=150, sink=sink2)
        assert pool._streams[rid2].replica == 0  # dispatched
        assert pool.cancel(rid2)
        _drive(pool)
        assert len(sink2.finals) == 1 and sink2.finals[0][1] == "CANCELLED"
        assert not pool.cancel(rid2)  # no longer tracked
    finally:
        pool.stop()


# ---------------------------------------------------------------------------
# The health state machine, on the injected clock
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("gate", ["tick_failures", "stragglers"])
def test_health_gate_drain_quarantine_probe_reinstate(models, gate):
    cfg = _cfg(models, pool_backoff_s=0.5, pool_probe_timeout_s=60.0)
    clock = Clock()
    pool = ReplicaPool(_factory(models, cfg), cfg, replicas=2, warmup=False, clock=clock)
    pool.start(supervise=False)
    try:
        _ready(pool)
        rep = pool.replicas[0]
        if gate == "tick_failures":
            rep.engine.consecutive_tick_failures = cfg.pool_health_fail_ticks
        else:  # a dense window, fed straight into the replica's monitor
            mon = rep.engine.straggler
            for step in range(6):
                assert not mon.record(step, 1e-3)
            for step in range(6, 9):
                assert mon.record(step, 1e7)
            assert mon.degraded(window=cfg.pool_straggler_window,
                                min_events=cfg.pool_straggler_events)
        pool.poll()
        assert rep.state == "draining"
        pool.poll()  # nothing in flight: quarantined under the backoff
        assert rep.state == "quarantined" and rep.backoff_s == 0.5
        assert rep.until == clock() + 0.5
        assert rep.engine.consecutive_tick_failures == 0
        assert not rep.engine.straggler.events  # archived
        sink = _Sink()  # routing never touches a replica that is not ready
        rid = pool.submit([1, 2, 3, 4], max_new=4, sink=sink)
        assert pool._streams[rid].replica == 1
        pool.poll()
        assert rep.state == "quarantined"  # the clock has not moved
        clock.advance(0.6)
        _until(pool, lambda: rep.state == "ready", "the probe to reinstate replica 0")
        assert rep.backoff_s == 0.0 and rep.restarts == 0  # forgiven, never restarted
        _drive(pool)
        assert sink.finals == [("final", "OK", None, 4)]
        rid = pool.submit([5, 6, 7], max_new=3, sink=_Sink())
        assert pool._streams[rid].replica == 0  # routed to again
        _drive(pool)
    finally:
        pool.stop()


def test_failed_probe_doubles_the_backoff(models):
    cfg = _cfg(models, pool_backoff_s=0.5, pool_probe_timeout_s=5.0)
    clock = Clock()
    pool = ReplicaPool(_factory(models, cfg), cfg, replicas=1, warmup=False, clock=clock)
    pool.start(supervise=False)
    try:
        _ready(pool)
        rep = pool.replicas[0]
        rep.engine.consecutive_tick_failures = cfg.pool_health_fail_ticks
        pool.poll()
        pool.poll()
        assert rep.state == "quarantined" and rep.backoff_s == 0.5
        clock.advance(0.6)
        pool.poll()
        assert rep.state == "probing"
        clock.advance(5.1)  # the probe's deadline passes on the clock
        pool.poll()
        assert rep.state == "quarantined" and rep.backoff_s == 1.0
    finally:
        pool.stop()


# ---------------------------------------------------------------------------
# Failover: the streams continue byte for byte
# ---------------------------------------------------------------------------


def _run_pool(pool, prompts, *, kill=None, max_new=MAX_NEW, each=None):
    """Serve ``prompts`` on ``pool`` (started, unsupervised); ``kill(pool)``
    fires once, after the first token reaches a sink. Returns the sinks."""
    pool.start(supervise=False)
    _ready(pool)
    sinks = [_Sink() for _ in prompts]
    for p, s in zip(prompts, sinks):
        pool.submit(p, max_new=max_new, sink=s)
    fired = [kill is None]

    def step():
        if not fired[0] and any(s.tokens for s in sinks):
            kill(pool)
            fired[0] = True
        if each is not None:
            each()

    _until(pool, lambda: fired[0] and pool.idle(), "the pool to serve every request",
           each=step)
    return sinks


def test_injected_replica_crash_equals_jax_pool_and_solo(models, jax_solo):
    jcfg, _, jp, _ = models
    prompts = _prompts((40, 70, 30, 17, 25, 55))
    cfg = _cfg(models, pool_backoff_s=0.1)
    clock = Clock()
    pool = ReplicaPool(_factory(models, cfg), cfg, replicas=2, warmup=False, clock=clock,
                       fault_plan=TR.FaultPlan(faults=(TR.Fault("replica_crash", tick=3,
                                                                replica=0),)))
    try:
        sinks = _run_pool(pool, prompts)
        stats = pool.stats()
    finally:
        pool.stop()
    assert stats["migrated_total"] >= 1 and stats["statuses"] == {"OK": len(prompts)}
    assert stats["per_replica"][0]["crashes"] == 1
    want = jax_solo(prompts)
    _assert_exactly_once(sinks, want)
    assert want == _solo(models, prompts)

    jcfg2 = dataclasses.replace(jcfg, pool_backoff_s=0.1, pool_hang_timeout_s=300.0)
    jpool = JReplicaPool(
        lambda idx: jE.ServingEngine(jp, jcfg2, mode="packed", slots=2, max_len=MAX_LEN,
                                     eos_id=-2),
        jcfg2, replicas=2, warmup=False,
        fault_plan=jR.FaultPlan((jR.Fault("replica_crash", tick=3, replica=0),)))
    try:
        jsinks = _run_pool(jpool, prompts)
        jstats = jpool.stats()
    finally:
        jpool.stop()
    assert jstats["migrated_total"] == stats["migrated_total"]
    assert [s.tokens for s in jsinks] == [s.tokens for s in sinks]
    assert [s.finals for s in jsinks] == [s.finals for s in sinks]


def test_real_thread_kill_n3_migrates_byte_identical(models, jax_solo):
    prompts = _prompts((40, 70, 30, 17, 25, 55, 45, 33, 20), seed=3)
    cfg = _cfg(models, pool_backoff_s=0.1)
    pool = ReplicaPool(_factory(models, cfg), cfg, replicas=3, warmup=False, clock=Clock())
    try:
        sinks = _run_pool(pool, prompts,
                          kill=lambda p: _kill_thread(p.replicas[0].driver._thread))
        stats = pool.stats()
    finally:
        pool.stop()
    assert stats["migrated_total"] >= 1 and stats["statuses"] == {"OK": len(prompts)}
    assert stats["per_replica"][0]["crashes"] == 1
    _assert_exactly_once(sinks, jax_solo(prompts))


def test_replica_hang_migrates_with_no_zombie_duplicates(models, jax_solo):
    """Replica 0 sleeps 1 s at its tick 3 (its heartbeat stops); the test
    moves the injected clock past the hang timeout while it sleeps, so the
    pool migrates its requests. When it wakes, its late events are
    disowned (``st.req is req``): every stream stays exactly-once."""
    prompts = _prompts((40, 70, 30, 17), seed=5)
    cfg = _cfg(models, pool_hang_timeout_s=2.0, pool_backoff_s=0.1)
    clock = Clock()
    pool = ReplicaPool(_factory(models, cfg), cfg, replicas=2, warmup=False, clock=clock,
                       fault_plan=TR.FaultPlan(faults=(TR.Fault("replica_hang", tick=3,
                                                                replica=0, duration_s=1.0),)))
    hung = pool.replicas[0]
    woke = []

    def each():
        if ("hang", 3, 0) in hung.fired and not woke:
            woke.append(clock())
            clock.advance(cfg.pool_hang_timeout_s + 1.0)
            healthy = pool.replicas[1].driver
            _until(None, lambda: healthy.beat >= clock(), "replica 1's heartbeat")

    try:
        sinks = _run_pool(pool, prompts, each=each)
        _until(None, lambda: hung.driver.beat >= clock(), "the hung replica to wake")
        zombie = hung.engine  # it retires its cancelled copies; their events are disowned
        _until(None, lambda: not zombie.queue and all(r is None for r in zombie.live),
               "the woken replica to retire its copies")
        stats = pool.stats()
    finally:
        pool.stop()
    assert woke and stats["migrated_total"] >= 1
    assert stats["per_replica"][0]["crashes"] == 1  # the hang failed it over
    _assert_exactly_once(sinks, jax_solo(prompts))


def test_restarted_replica_serves_again(models):
    cfg = _cfg(models, pool_backoff_s=0.5, pool_probe_timeout_s=60.0)
    clock = Clock()
    built = []

    def factory(idx):
        built.append(idx)
        return _factory(models, cfg)(idx)

    pool = ReplicaPool(factory, cfg, replicas=1, warmup=False, clock=clock,
                       fault_plan=TR.FaultPlan(faults=(TR.Fault("replica_crash", tick=1,
                                                                replica=0),)))
    pool.start(supervise=False)
    try:
        _ready(pool)
        first = pool.replicas[0].engine
        sink = _Sink()
        prompt = [1, 2, 3, 4, 5]
        pool.submit(prompt, max_new=4, sink=sink)
        _until(pool, lambda: pool.replicas[0].state == "quarantined", "the crash")
        clock.advance(0.6)
        _drive(pool)
        rep = pool.replicas[0]
        assert built == [0, 0] and rep.restarts == 1 and rep.state == "ready"
        assert rep.engine is not first and rep.engine.replica_id == 0
        assert sink.finals == [("final", "OK", None, 4)]
        assert sink.tokens == _solo(models, [prompt], max_new=4)[0]
    finally:
        pool.stop()


def test_failed_warmup_is_a_crash_then_a_restart(models):
    """A replica whose warmup raises ends its driver crashed (the port's
    deliberate difference); the pool fails it over, restarts it from the
    factory after the backoff, and the rebuilt replica serves."""
    cfg = _cfg(models, pool_backoff_s=0.5, pool_probe_timeout_s=60.0)
    clock = Clock()
    calls = []

    def warmup():
        calls.append(1)
        if len(calls) == 1:
            raise RuntimeError("kernel library failed to load")

    pool = ReplicaPool(_factory(models, cfg), cfg, replicas=1, warmup=warmup, clock=clock)
    pool.start(supervise=False)
    try:
        rep = pool.replicas[0]
        _until(pool, lambda: rep.state == "quarantined", "the failed warmup's failover")
        assert rep.crashes == 1 and isinstance(rep.driver.error, RuntimeError)
        assert not pool.ready
        clock.advance(0.6)
        _ready(pool)
        assert rep.restarts == 1 and len(calls) == 2
        sink = _Sink()
        pool.submit([9, 8, 7], max_new=3, sink=sink)
        _drive(pool)
        assert sink.finals == [("final", "OK", None, 3)]
    finally:
        pool.stop()


# ---------------------------------------------------------------------------
# Stats and the front door over a pool
# ---------------------------------------------------------------------------


def test_stats_aggregation_per_replica(models):
    cfg = _cfg(models)
    pool = ReplicaPool(_factory(models, cfg), cfg, replicas=2, warmup=False, clock=Clock())
    pool.start(supervise=False)
    try:
        _ready(pool)
        pool.submit([1, 2, 3, 4, 5, 6], max_new=4, sink=_Sink())
        _drive(pool)
        s = pool.stats()
        assert s["pool"] is True and s["replicas"] == 2 and s["statuses"] == {"OK": 1}
        assert [r["replica_id"] for r in s["per_replica"]] == [0, 1]
        for r in s["per_replica"]:
            eng = r["engine"]
            assert eng is not None and eng["replica_id"] == r["replica_id"]
            assert eng["ticks"] >= 0 and "consecutive_tick_failures" in eng
            assert r["state"] == "ready" and r["crashes"] == 0
        assert sum(r["engine"]["ticks"] for r in s["per_replica"]) > 0
    finally:
        pool.stop()


@pytest.mark.parametrize("mode", ["injected", "thread_kill"])
def test_server_pool_sse_survives_replica_kill(models, jax_solo, mode):
    """Three replicas behind the HTTP front door (supervised, real clock);
    one dies mid-serve. Every SSE stream ends ``done OK`` with contiguous
    token indexes and the solo stream; ``/v1/stats`` counts the
    migration; an unknown SLO class is a 400."""
    prompts = _prompts((40, 70, 30, 17, 25, 55), seed=7)
    max_new = 8
    cfg = _cfg(models, pool_backoff_s=0.1)
    plan = (TR.FaultPlan(faults=(TR.Fault("replica_crash", tick=3, replica=0),))
            if mode == "injected" else None)
    pool = ReplicaPool(_factory(models, cfg), cfg, replicas=3, warmup=False, fault_plan=plan)

    async def body():
        server = ServingServer(pool, host="127.0.0.1", port=0)
        await server.start()
        try:
            t0 = time.monotonic()
            while not server.ready:
                assert time.monotonic() - t0 < 60
                await asyncio.sleep(0.01)
            tasks = [asyncio.ensure_future(sse_request(
                server.host, server.port, {"prompt": p, "max_new": max_new, "slo": "batch"}))
                for p in prompts]
            if mode == "thread_kill":
                while pool.replicas[0].inflight == 0:
                    assert time.monotonic() - t0 < 60
                    await asyncio.sleep(0.005)
                _kill_thread(pool.replicas[0].driver._thread)
            recs = await asyncio.wait_for(asyncio.gather(*tasks), 120.0)
            bad = await sse_request(server.host, server.port,
                                    {"prompt": [1, 2], "max_new": 2, "slo": "platinum"})
            return recs, bad, pool.migrated_total
        finally:
            await asyncio.wait_for(server.drain_and_stop(10.0), 60.0)

    recs, bad, migrated = asyncio.run(asyncio.wait_for(body(), 180.0))
    assert pool.stopped and bad["http"] == 400
    assert migrated >= 1
    for rec, want in zip(recs, jax_solo(prompts, max_new)):
        assert rec["http"] == 200 and rec["status"] == "OK"
        assert rec["events"].count("done") == 1 and rec["events"][-1] == "done"
        assert rec["indexes"] == list(range(max_new))
        assert tuple(rec["tokens"]) == want
