"""PyTorch port, serving resilience: ``FaultPlan`` injection and the
engine's containment, the straggler monitor, request export and the SLO
budget weight, on the tellme-0.7b smoke config in f32 (and the rwkv6-3b
smoke config for the legacy engine), against the JAX package's
``ServingEngine(mode="packed", fault_plan=...)`` on the same packed weights.

Bars:
* against JAX, per request: token streams, terminal statuses and status
  details equal; the event logs equal, entry for entry, without the
  wall-clock ``straggler`` events. Scenarios: ``nan`` (bf16 plain, int8
  speculative, the rwkv legacy engine), ``cache_growth``,
  ``drafter_garbage`` (acceptance collapse, the watchdog's
  ``spec_disabled``, streams equal to JAX's engine without speculation), a
  schedule under per-request ``budget_weight`` (the same ticks and first-token
  ticks), and ``export_requests`` after a few ticks re-submitted to a fresh
  engine;
* ``Fault``, ``FaultPlan``, ``scramble_tokens`` and ``StragglerMonitor``:
  equal to JAX's own on the same inputs, the same errors;
* against the port's own fault-free run, where JAX's engine differs by
  design (it retries a raising tick on its XLA attention; the port has no
  second implementation): under ``tick_exception`` the live requests end
  ``FAILED`` with a prefix of their fault-free stream, the device state is
  rebuilt (a fresh page pool on the paged layout), later requests equal the
  fault-free run, and ``consecutive_tick_failures`` is back to 0; each tick
  kind raises before any device work; a kernel that raises inside the
  model leaves no reference to the old caches by the rebuild; ``step()``
  never raises on JAX's repeated-fault plan; an armed plan that never
  fires is a bitwise no-op (streams and caches); two identical faulted
  runs give equal streams, statuses and events.
"""

import dataclasses
import weakref

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config
from repro.core import params as P
from repro.models import transformer as jT
from repro.runtime import fault_tolerance as jFT
from repro.serving import engine as jE
from repro.serving import resilience as jR
from repro_torch import interop
from repro_torch.configs import get_config as t_get_config
from repro_torch.kernels import PLAIN
from repro_torch.runtime import fault_tolerance as TFT
from repro_torch.serving import engine as TE
from repro_torch.serving import resilience as TR
from repro_torch.serving.paging import PagedKV

MAX_LEN = 192
LENS = (40, 70, 30, 17)


def _setup(arch):
    jcfg = dataclasses.replace(get_config(arch, smoke=True), dtype=jnp.float32)
    tcfg = dataclasses.replace(t_get_config(arch, smoke=True), dtype=torch.float32)
    specs = jT.param_specs(jcfg)
    jp = jT.pack_tree(P.init_params(specs, jax.random.PRNGKey(0)), specs)
    tp = interop.from_jax_params(jax.device_get(jp), tcfg, device="cpu")
    return jcfg, tcfg, jp, tp


@pytest.fixture(scope="module")
def models():
    return _setup("tellme-0.7b")


def _prompts(lengths=LENS, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, 256, n).astype(np.int32) for n in lengths]


def _plan(side, faults):
    R = jR if side == "jax" else TR
    return R.FaultPlan(faults=tuple(R.Fault(**f) for f in faults))


def _events(eng):
    return [e for e in eng.events if e["kind"] != "straggler"]


def _engine(side, models, faults=None, cfg_kw=None, **kw):
    jcfg, tcfg, jp, tp = models
    kw = {"slots": 2, "max_len": MAX_LEN, "eos_id": -2, **kw}
    if faults is not None:
        kw["fault_plan"] = _plan(side, faults)
    if side == "jax":
        cfg = dataclasses.replace(jcfg, **(cfg_kw or {}))
        return jE.ServingEngine(jp, cfg, mode="packed", **kw), jE.Request
    cfg = dataclasses.replace(tcfg, **(cfg_kw or {}))
    return TE.ServingEngine(tp, cfg, device="cpu", **{"kernels": PLAIN, **kw}), TE.Request


def _serve(side, models, prompts, max_new=8, faults=None, fields=None, cfg_kw=None, **kw):
    """Serve ``prompts`` to the end on the JAX or the port's engine; returns
    ({rid: (tokens, status, detail, first-token tick)}, engine)."""
    eng, Req = _engine(side, models, faults, cfg_kw, **kw)
    first = {}
    eng.on_emit = lambda req, toks: first.setdefault(req.rid, eng.tick_count)
    reqs = [Req(rid=i, prompt=p, max_new=max_new) for i, p in enumerate(prompts)]
    for r, f in zip(reqs, fields or [{}] * len(reqs)):
        for k, v in f.items():
            setattr(r, k, v)
        assert eng.submit(r)
    eng.run()
    return {r.rid: ([int(t) for t in r.generated], r.status.name, r.status_detail,
                    first.get(r.rid)) for r in reqs}, eng


def _same(models, prompts, **kw):
    want, jeng = _serve("jax", models, prompts, **kw)
    got, eng = _serve("torch", models, prompts, **kw)
    assert got == want
    assert _events(eng) == _events(jeng)
    assert eng.tick_count == jeng.tick_count
    assert eng.stats()["host_transfers"] == eng.tick_count
    return got, eng


# ---------------------------------------------------------------------------
# Against JAX's engine under the same plan
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kv,spec", [("bf16", False), ("int8", True)])
def test_nan_quarantine_equals_jax(models, kv, spec):
    """A NaN in slot 0's logits at tick 3 quarantines exactly that request
    (the logits guard's bit); the others finish as in the fault-free run.
    The int8 smoke model is chaotic at the ulp level: without any fault the
    port's and JAX's int8 engines already part on the 17-token prompt at a
    near-tie (see test_torch_engine.py). A request whose fault-free streams
    part is held against the port's own fault-free stream; every other
    request, every status and detail, and the events are held against JAX."""
    faults = [dict(kind="nan", tick=3, slot=0)]
    kw = dict(speculative=spec, cfg_kw=dict(kv_cache_dtype=kv))
    want, jeng = _serve("jax", models, _prompts(), faults=faults, **kw)
    got, eng = _serve("torch", models, _prompts(), faults=faults, **kw)
    jbase, _ = _serve("jax", models, _prompts(), **kw)
    base, _ = _serve("torch", models, _prompts(), **kw)
    parted = [rid for rid in base if base[rid][0] != jbase[rid][0]]
    assert kv == "int8" or not parted
    for rid in got:
        assert got[rid][1:] == want[rid][1:]
        assert got[rid][0] == (base if rid in parted else want)[rid][0]
    # a parted stream may take another number of spec ticks
    assert _events(eng) == _events(jeng) and (parted or eng.tick_count == jeng.tick_count)
    bad = [rid for rid, g in got.items() if g[1] == "QUARANTINED"]
    assert len(bad) == 1 and got[bad[0]][2] == f"guard_flag={TR.GUARD_LOGITS}"
    assert bad[0] not in parted
    for rid, g in got.items():
        if rid not in bad:
            assert g[:3] == base[rid][:3] and g[1] == "OK"
    assert [e["kind"] for e in _events(eng)] == ["quarantine"]
    assert eng.stats()["quarantined"] == 1
    assert eng.stats()["host_transfers"] == eng.tick_count


def test_cache_growth_equals_jax(models):
    faults = [dict(kind="cache_growth", tick=4, slot=0)]
    got, eng = _same(models, _prompts((40, 30)), faults=faults, max_new=16)
    hit = [g for g in got.values() if g[1] == "CACHE_EXHAUSTED"]
    assert len(hit) == 1 and hit[0][2] == "fault_injected" and len(hit[0][0]) > 0
    assert [e["kind"] for e in _events(eng)] == ["cache_growth_fault"]


def test_drafter_garbage_disables_speculation_as_jax(models):
    """Deranged drafts from tick 0 collapse the acceptance; the watchdog
    stops speculating once, and the streams are the engine's without
    speculation (garbage drafts are rejected, never emitted)."""
    cfg_kw = dict(spec_disable_after=8, spec_min_acceptance=0.3)
    faults = [dict(kind="drafter_garbage", tick=0, repeat=1000)]
    got, eng = _same(models, _prompts(), max_new=12, faults=faults, speculative=True,
                     cfg_kw=cfg_kw)
    assert not eng.speculative and eng.spec_ticks > 0
    dis = [e for e in _events(eng) if e["kind"] == "spec_disabled"]
    assert len(dis) == 1 and dis[0]["acceptance"] < 0.3
    plain, _ = _serve("jax", models, _prompts(), max_new=12, cfg_kw=cfg_kw)
    assert [g[:3] for g in got.values()] == [g[:3] for g in plain.values()]
    assert all(g[1] == "OK" for g in got.values())


def test_budget_weight_schedule_equals_jax(models):
    """Per-request budget weights scale the tick's chunk budget by the
    highest weight mid-prefill: the same ticks and first-token ticks as
    JAX's, and another schedule than the unweighted one."""
    prompts = _prompts((180, 150, 100, 60, 130), seed=3)
    weights = [0.125, 0.25, 0.5, 1.0, 0.125]
    fields = [dict(budget_weight=w, slo=f"class{w}") for w in weights]
    got, eng = _same(models, prompts, fields=fields, slots=3)
    plain, peng = _serve("torch", models, prompts, slots=3)
    assert [g[:3] for g in got.values()] == [g[:3] for g in plain.values()]
    assert ([g[3] for g in got.values()] != [g[3] for g in plain.values()]
            or eng.tick_count != peng.tick_count)


def test_chunk_budget_weighting(models):
    _, tcfg, _, tp = models
    eng = TE.ServingEngine(tp, tcfg, slots=3, max_len=MAX_LEN, device="cpu", kernels=PLAIN)
    assert eng._chunk_budget() == tcfg.prefill_chunk_budget  # nothing mid-prefill
    for i, (w, n) in enumerate(((0.25, 150), (0.5, 130), (2.0, 100))):
        eng.submit(TE.Request(rid=i, prompt=_prompts((n,))[0], max_new=2, budget_weight=w))
    eng._admission()
    assert eng._chunk_budget() == round(tcfg.prefill_chunk_budget * 2.0)
    eng.live[2].budget_weight = 0.001
    assert eng._chunk_budget() == round(tcfg.prefill_chunk_budget * 0.5)
    for s in range(3):
        eng.live[s].budget_weight = 1e-6
    assert eng._chunk_budget() == 1  # floored; _plan_chunks still takes one chunk


@pytest.mark.parametrize("layout", ["contiguous", "paged"])
def test_export_and_resume_equals_jax(models, layout):
    """After three ticks every unfinished request is exported and served by
    a fresh engine: the streams of an uninterrupted run, on both sides."""
    prompts = _prompts()
    out = {}
    for side in ("jax", "torch"):
        eng, Req = _engine(side, models, cfg_kw=dict(kv_layout=layout))
        reqs = [Req(rid=i, prompt=p, max_new=8, slo="batch", budget_weight=0.5)
                for i, p in enumerate(prompts)]
        for r in reqs:
            eng.submit(r)
        for _ in range(3):
            eng.step()
        snaps = eng.export_requests()
        assert [s.rid for s in snaps] == [r.rid for r in eng.queue] + [
            r.rid for r in eng.live if r is not None]
        fresh, _ = _engine(side, models, cfg_kw=dict(kv_layout=layout))
        for s in snaps:
            s.migrations += 1
            assert fresh.submit(s)
        fresh.run()
        done = {r.rid: r for r in reqs if r.done}
        done.update({s.rid: s for s in snaps})
        out[side] = {rid: ([int(t) for t in r.generated], r.status.name, r.migrations,
                           r.slo, r.budget_weight) for rid, r in sorted(done.items())}
    assert out["torch"] == out["jax"]
    base, _ = _serve("torch", models, prompts, cfg_kw=dict(kv_layout=layout))
    assert {rid: v[0] for rid, v in out["torch"].items()} == {
        rid: g[0] for rid, g in base.items()}


def test_snapshot_request_copies(models):
    req = TE.Request(rid=7, prompt=torch.arange(5, dtype=torch.int32), max_new=9,
                     generated=[1, 2], priority=3, deadline_s=4.0, submitted_at=1.5,
                     preemptions=2, migrations=1, slo="interactive", budget_weight=2.0)
    snap = TE.snapshot_request(req)
    req.generated.append(3)
    assert snap.generated == [1, 2] and snap.status is TR.Status.PENDING
    assert isinstance(snap.prompt, np.ndarray) and snap.prompt.tolist() == list(range(5))
    fields = ("rid", "max_new", "priority", "deadline_s", "submitted_at", "preemptions",
              "migrations", "slo", "budget_weight")
    assert [getattr(snap, f) for f in fields] == [getattr(req, f) for f in fields]
    j = jE.snapshot_request(jE.Request(rid=7, prompt=np.arange(5), max_new=9,
                                       generated=[1, 2], priority=3, deadline_s=4.0,
                                       submitted_at=1.5, preemptions=2, migrations=1,
                                       slo="interactive", budget_weight=2.0))
    assert [getattr(j, f) for f in fields] == [getattr(snap, f) for f in fields]


def test_rwkv_legacy_engine_nan_equals_jax():
    """The ssm family's legacy engine: a NaN at tick 2 on slot 1 (its
    ``_advance``) quarantines that request only, as in JAX."""
    rwkv = _setup("rwkv6-3b")
    prompts = _prompts((9, 30, 20))
    faults = [dict(kind="nan", tick=2, slot=1)]
    got, eng = _same(rwkv, prompts, faults=faults, max_new=6, max_len=64)
    assert eng.prefill == "legacy"
    assert sorted(g[1] for g in got.values()) == ["OK", "OK", "QUARANTINED"]


# ---------------------------------------------------------------------------
# The host pieces against JAX's own
# ---------------------------------------------------------------------------


def test_fault_and_plan_equal_jax():
    assert TR.FAULT_KINDS == jR.FAULT_KINDS
    assert TR.REPLICA_FAULT_KINDS == jR.REPLICA_FAULT_KINDS
    assert issubclass(TR.FaultInjected, RuntimeError)
    for bad in (dict(kind="bogus", tick=0), dict(kind="nan", tick=-1),
                dict(kind="nan", tick=0, repeat=0)):
        with pytest.raises(ValueError):
            jR.Fault(**bad)
        with pytest.raises(ValueError):
            TR.Fault(**bad)
    assert dataclasses.asdict(TR.Fault(kind="slow_tick", tick=3)) == dataclasses.asdict(
        jR.Fault(kind="slow_tick", tick=3))
    faults = [dict(kind="nan", tick=2, slot=1, repeat=3), dict(kind="nan", tick=4),
              dict(kind="nan", tick=1, slot=9), dict(kind="drafter_garbage", tick=0, repeat=5),
              dict(kind="replica_crash", tick=7, replica=1),
              dict(kind="replica_hang", tick=3, duration_s=1.0)]
    tp, jp = _plan("torch", faults), _plan("jax", faults)
    for tick in range(10):
        for kind in TR.FAULT_KINDS:
            assert ([dataclasses.asdict(f) for f in tp.at(tick, kind)]
                    == [dataclasses.asdict(f) for f in jp.at(tick, kind)])
            np.testing.assert_array_equal(tp.slot_mask(tick, kind, 3),
                                          jp.slot_mask(tick, kind, 3))
        assert tp.any_after(tick) == jp.any_after(tick)
    for kind in TR.REPLICA_FAULT_KINDS:
        for replica in range(3):
            assert ([dataclasses.asdict(f) for f in tp.replica_faults(kind, replica)]
                    == [dataclasses.asdict(f) for f in jp.replica_faults(kind, replica)])
    np.testing.assert_array_equal(tp.slot_mask(4, "nan", 3), [True, True, True])
    assert not tp.any_after(10)


@pytest.mark.parametrize("vocab", [1, 2, 7, 32000])
def test_scramble_tokens_equal_jax(vocab):
    rng = np.random.default_rng(vocab)
    toks = rng.integers(0, vocab, (4, 5)).astype(np.int32)
    mask = np.array([True, False, True, False])
    got = TR.scramble_tokens(torch.from_numpy(toks), torch.from_numpy(mask), vocab)
    want = np.asarray(jR.scramble_tokens(jnp.asarray(toks), jnp.asarray(mask), vocab))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got.numpy()[~mask], toks[~mask])  # bit for bit
    if vocab > 1:
        assert (got.numpy()[mask] != toks[mask]).all()
    assert ((got.numpy() >= 0) & (got.numpy() < vocab)).all()


def test_straggler_monitor_equals_jax():
    rng = np.random.default_rng(5)
    durations = list(rng.uniform(0.01, 0.02, 12)) + [0.5, 0.011, 0.6, 0.7, 0.012, 0.9]
    for kw in ({}, dict(alpha=0.3, threshold=1.5, warmup=2)):
        t, j = TFT.StragglerMonitor(**kw), jFT.StragglerMonitor(**kw)
        for step, d in enumerate(durations):
            assert t.record(step, d) == j.record(step, d)
            assert t.degraded() == j.degraded()
            assert t.degraded(window=4, min_events=2) == j.degraded(window=4, min_events=2)
        assert t.report() == j.report()
        assert [dataclasses.astuple(e) for e in t.events] == [
            dataclasses.astuple(e) for e in j.events]
    assert t.degraded()


# ---------------------------------------------------------------------------
# Containment, against the port's own fault-free run
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("layout,spec", [("contiguous", False), ("paged", False),
                                         ("contiguous", True)])
def test_tick_exception_fails_live_and_serves_on(models, layout, spec):
    """A raising tick ends its live requests FAILED with the tokens they
    emitted (a prefix of the fault-free stream); the queue is then served
    from rebuilt device state, as in the fault-free run."""
    cfg_kw = dict(kv_layout=layout)
    prompts = _prompts((40, 70, 30, 17, 90))
    base, _ = _serve("torch", models, prompts, cfg_kw=cfg_kw, speculative=spec)
    eng, Req = _engine("torch", models, [dict(kind="tick_exception", tick=2)], cfg_kw,
                       speculative=spec, replica_id="r0")
    reqs = [Req(rid=i, prompt=p, max_new=8) for i, p in enumerate(prompts)]
    for r in reqs:
        eng.submit(r)
    eng.step()
    eng.step()
    live = [r.rid for r in eng.live if r is not None]
    assert eng.step()  # the faulted tick: contained, not raised
    assert eng.consecutive_tick_failures == 1
    assert all(r is None for r in eng.live) and not eng._pending_first
    assert eng.prefilling_slots == 0
    if layout == "paged":
        fresh = PagedKV(slots=eng.slots, cache_len=eng.cache_len,
                        page_size=eng.paged.page_size, num_pages=eng.paged.num_pages,
                        prefix_cache=eng.paged.prefix_cache)
        assert eng.paged.stats() == fresh.stats()
        assert not eng._pos_host.any()
    for leaves in eng.caches["blocks"].values():
        assert all(not leaf.any() for leaf in leaves.values())
    assert not (eng.pos.any() or eng.cur_tok.any() or eng.done.any() or eng.gen_count.any())
    eng.run()
    detail = "FaultInjected: injected tick exception @ tick 2"
    for r in reqs:
        tokens = base[r.rid][0]
        if r.rid in live:
            assert (r.status.name, r.status_detail) == ("FAILED", detail)
            assert r.generated == tokens[:len(r.generated)]
        else:
            assert r.status.name == "OK" and r.generated == tokens
    st = eng.stats()
    assert len(live) > 0 and st["statuses"]["FAILED"] == len(live)
    assert st["consecutive_tick_failures"] == 0 and st["replica_id"] == "r0"
    assert st["host_transfers"] == st["ticks"] - 1
    assert st["straggler"]["steps"] == st["ticks"]
    assert "attn_impl" not in st and "xla_fallback" not in st
    assert [e["kind"] for e in _events(eng)] == ["tick_failure"]
    assert _events(eng)[0]["detail"] == detail


def test_tick_hook_raises_before_device_work(models):
    """Each tick kind calls the hook first: nothing of the tick has run
    when ``FaultInjected`` leaves it."""
    for spec, method in ((False, "_fused_tick"), (False, "_decode_tick"),
                         (True, "_spec_tick")):
        eng, Req = _engine("torch", models, [dict(kind="tick_exception", tick=0, repeat=99)],
                           speculative=spec)
        eng.submit(Req(rid=0, prompt=_prompts((40,))[0], max_new=4))
        eng._admission()
        prefilling = [s for s in range(eng.slots) if eng._plan[s] is not None]
        plan = (eng._plan[0].ci, eng._plan[0].off)
        pos = eng.pos.clone()
        args = () if method == "_decode_tick" else (prefilling,)
        with pytest.raises(TR.FaultInjected, match="injected tick exception @ tick 0"):
            getattr(eng, method)(*args)
        assert eng.host_transfers == eng.fused_ticks == eng.spec_ticks == 0
        assert (eng._plan[0].ci, eng._plan[0].off) == plan and torch.equal(eng.pos, pos)


def test_kernel_error_frees_the_old_caches_before_the_rebuild(models, monkeypatch):
    """A kernel that raises inside ``decode_step``, whose frames hold the
    caches: by the time the containment allocates the new caches, no
    reference to the old ones is left, so a full-size rebuild never needs
    room for two caches. The tick is contained like an injected one."""
    armed = [False]

    def decode_attention(*args, **kw):
        if armed[0]:
            raise RuntimeError("kernel error")
        return PLAIN.decode_attention(*args, **kw)

    kset = dataclasses.replace(PLAIN, decode_attention=decode_attention)
    eng, Req = _engine("torch", models, kernels=kset)
    reqs = [Req(rid=i, prompt=p, max_new=8) for i, p in enumerate(_prompts((40, 30)))]
    for r in reqs:
        eng.submit(r)
    while eng.prefilling_slots or eng._pending_first:
        assert eng.step()
    old = [weakref.ref(leaf) for leaves in eng.caches["blocks"].values()
           for leaf in leaves.values()]
    alive_at_rebuild = []
    init_caches = TE.init_caches

    def spy(*args, **kw):
        alive_at_rebuild.append(sum(ref() is not None for ref in old))
        return init_caches(*args, **kw)

    monkeypatch.setattr(TE, "init_caches", spy)
    armed[0] = True
    assert eng.step()  # decode-only: the raising kernel runs inside decode_step
    assert alive_at_rebuild == [0]
    assert eng.consecutive_tick_failures == 1
    assert [(r.status.name, r.status_detail) for r in reqs] == [
        ("FAILED", "RuntimeError: kernel error")] * 2
    assert [e["kind"] for e in _events(eng)] == ["tick_failure"]


def test_step_never_raises_on_repeated_faults(models):
    """JAX's repeated-fault plan, one fault a tick: every request ends in a
    terminal status and ``step()`` returns each time."""
    faults = [dict(kind=k, tick=t, duration_s=0.01) for t, k in enumerate(
        ["tick_exception", "nan", "cache_growth", "slow_tick"])]
    got, eng = _serve("torch", models, _prompts(LENS * 2), faults=faults)
    assert all(TR.Status[g[1]] in TR.TERMINAL for g in got.values())
    assert eng.tick_count > 0 and eng.consecutive_tick_failures == 0
    kinds = [e["kind"] for e in _events(eng)]
    assert kinds[0] == "tick_failure" and "slow_tick_fault" in kinds


def test_armed_idle_plan_is_a_bitwise_noop(models):
    """A plan whose faults never fire changes no stream, no event and no
    cache byte."""
    idle = [dict(kind=k, tick=10_000) for k in TR.FAULT_KINDS]
    for spec in (False, True):
        base, beng = _serve("torch", models, _prompts(), speculative=spec)
        armed, aeng = _serve("torch", models, _prompts(), faults=idle, speculative=spec)
        assert armed == base and _events(aeng) == _events(beng) == []
        assert aeng.tick_count == beng.tick_count
        for b in beng.caches["blocks"]:
            for name, leaf in beng.caches["blocks"][b].items():
                assert torch.equal(aeng.caches["blocks"][b][name], leaf)


def test_slow_tick_feeds_the_straggler_monitor(models):
    """The slow tick's stall lies inside the timed region; a flagged tick
    records a ``straggler`` event and the monitor's report reaches stats."""

    class FlagSlow(TFT.StragglerMonitor):
        def __init__(self):
            super().__init__()
            self.durations = []

        def record(self, step, duration):
            super().record(step, duration)
            self.durations.append(duration)
            return duration >= 0.2

    mon = FlagSlow()
    _, eng = _serve("torch", models, _prompts(),
                    faults=[dict(kind="slow_tick", tick=3, duration_s=0.2)], straggler=mon)
    assert eng.straggler is mon and len(mon.durations) == eng.tick_count
    assert mon.durations[3] >= 0.2
    kinds = [(e["kind"], e["tick"]) for e in eng.events]
    assert ("slow_tick_fault", 3) in kinds and ("straggler", 3) in kinds
    assert eng.stats()["straggler"] == mon.report()


def test_two_identical_faulted_runs_agree(models):
    faults = [dict(kind="nan", tick=3, slot=0), dict(kind="cache_growth", tick=5, slot=1),
              dict(kind="tick_exception", tick=7)]
    a, ea = _serve("torch", models, _prompts((40, 70, 30, 17, 60, 25)), faults=faults)
    b, eb = _serve("torch", models, _prompts((40, 70, 30, 17, 60, 25)), faults=faults)
    assert a == b and _events(ea) == _events(eb)
    assert {"quarantine", "cache_growth_fault", "tick_failure"} <= {
        e["kind"] for e in _events(ea)}
