"""PyTorch port, serving: the chunked continuous-batching ``ServingEngine``
and ``prefill_chunk_step`` on the tellme-0.7b smoke config in f32, against
the JAX package's ``ServingEngine(mode="packed")`` and
``prefill_chunk_step`` on the same packed weights, for both KV-cache dtypes.

Bars:
* per-request token streams, terminal statuses and status details: equal
  to JAX's, through ragged prompts (all three chunk sizes, mixed ticks,
  admission after retirement), ``max_new=1``, an EOS mid-stream, an
  oversized prompt, queue backpressure, ``cancel``, a deadline on a fake
  clock, and priority preemption; and equal to the port's own ``generate``
  per request;
* one device-to-host transfer per tick;
* ``prefill_chunk_step``, bf16 cache layout (here in f32): logits and cache
  rows within 1e-5 of JAX's (RoPE and XLA's fusions round differently by an
  ulp); int8 layout: layer-0 codes within 1, at most 0.1 % of them off (3
  of 8192 at these inputs), and scales within rtol 5e-7 (four f32 ulps):
  the K/V rows differ by RoPE's ulps and XLA turns ``/ 127`` into a
  reciprocal, which moves a value on a rounding boundary; logits within
  2 % of max |logit|, argmax equal. The int8 smoke model is chaotic at the ulp level: the JAX package's
  own jitted and eager chunk steps differ by 0.050 on a max |logit| of 4.5
  at these inputs, so no tighter bar holds between two implementations;
* the numerics guards: equal to JAX's on crafted NaN/inf tensors.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config
from repro.core import params as P
from repro.models import transformer as jT
from repro.serving import engine as jE
from repro.serving import resilience as jR
from repro_torch import interop
from repro_torch.configs import get_config as t_get_config
from repro_torch.kernels import PLAIN
from repro_torch.models import transformer as TT
from repro_torch.serving import engine as TE
from repro_torch.serving import resilience as TR

MAX_LEN = 256
RAGGED = (9, 30, 70, 130, 200)  # chunk schedules [64], [64], [128], [128, 64], [256]


@pytest.fixture(scope="module")
def models():
    jcfg = dataclasses.replace(get_config("tellme-0.7b", smoke=True), dtype=jnp.float32)
    tcfg = dataclasses.replace(t_get_config("tellme-0.7b", smoke=True), dtype=torch.float32)
    specs = jT.param_specs(jcfg)
    jp = jT.pack_tree(P.init_params(specs, jax.random.PRNGKey(0)), specs)
    tp = interop.from_jax_params(jax.device_get(jp), tcfg, device="cpu")
    return jcfg, tcfg, jp, tp


def _cfgs(models, kv):
    jcfg, tcfg, jp, tp = models
    return (dataclasses.replace(jcfg, kv_cache_dtype=kv),
            dataclasses.replace(tcfg, kv_cache_dtype=kv), jp, tp)


def _prompts(lengths, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, n).astype(np.int32) for n in lengths]


def _drive(side, models, kv, script, **engine_kw):
    """Run ``script`` on the JAX (``side="jax"``) or the port's engine;
    returns {rid: (tokens, status, detail, preemptions)} and the engine.
    Script items: ("submit", rid, prompt, max_new, request fields),
    ("step", n), ("cancel", rid), ("clock", t), ("run",)."""
    jcfg, tcfg, jp, tp = _cfgs(models, kv)
    now = [0.0]
    kw = dict(slots=2, max_len=MAX_LEN, clock=lambda: now[0], **engine_kw)
    if side == "jax":
        eng, Req = jE.ServingEngine(jp, jcfg, mode="packed", **kw), jE.Request
    else:
        eng, Req = TE.ServingEngine(tp, tcfg, device="cpu", kernels=PLAIN, **kw), TE.Request
    reqs, accepted = {}, {}
    for op, *args in script:
        if op == "submit":
            rid, prompt, max_new, fields = args
            reqs[rid] = Req(rid=rid, prompt=prompt, max_new=max_new)
            for k, v in fields.items():
                setattr(reqs[rid], k, v)
            accepted[rid] = eng.submit(reqs[rid])
        elif op == "step":
            for _ in range(args[0]):
                eng.step()
        elif op == "cancel":
            eng.cancel(args[0])
        elif op == "clock":
            now[0] = args[0]
        elif op == "run":
            eng.run()
    out = {rid: ([int(t) for t in r.generated], r.status.name, r.status_detail,
                 r.preemptions, accepted[rid]) for rid, r in reqs.items()}
    return out, eng


def _assert_same(models, kv, script, **engine_kw):
    want, _ = _drive("jax", models, kv, script, **engine_kw)
    got, eng = _drive("torch", models, kv, script, **engine_kw)
    assert got == want
    assert eng.stats()["host_transfers"] == eng.tick_count > 0
    return got, eng


def _submit_all(prompts, max_new, **fields):
    return [("submit", i, p, max_new, fields) for i, p in enumerate(prompts)]


KV = pytest.mark.parametrize("kv", ["bf16", "int8"])


@KV
def test_ragged_streams_equal_jax(models, kv):
    got, eng = _assert_same(models, kv, _submit_all(_prompts(RAGGED), 8) + [("run",)])
    assert all(s == "OK" and len(t) == 8 for t, s, *_ in got.values())
    assert eng.prefilling_slots == eng.decoding_slots == 0
    assert eng.stats()["statuses"] == {"OK": len(RAGGED)}


@KV
def test_edge_requests_equal_jax(models, kv):
    """``max_new=1`` ends on the prefill token; a prompt as long as
    ``max_len`` fails at admission; the fifth submit meets a full queue."""
    ok, short, long_ = _prompts((40, 12, MAX_LEN), seed=1)
    script = [("submit", 0, ok, 1, {}), ("submit", 1, long_, 4, {}),
              ("submit", 2, short, 5, {}), ("submit", 3, ok, 3, {}),
              ("submit", 4, short, 2, {}), ("run",)]
    got, _ = _assert_same(models, kv, script, queue_cap=4)
    assert len(got[0][0]) == 1 and got[0][1] == "OK"
    assert got[1][1:3] == ("FAILED", "bad_prompt") and got[1][0] == []
    assert got[4][1:3] == ("FAILED", "queue_full") and got[4][4] is False


@KV
def test_cancel_and_deadline_equal_jax(models, kv):
    """One request cancelled mid-stream, one expiring on a fake clock while
    running, one expiring in the queue."""
    a, b, c, d = _prompts((20, 100, 50, 9), seed=2)
    script = [("submit", 0, a, 20, {}), ("submit", 1, b, 20, {"deadline_s": 5.0}),
              ("submit", 2, c, 20, {}), ("submit", 3, d, 6, {"deadline_s": 5.0}),
              ("step", 4), ("cancel", 0), ("step", 1), ("clock", 6.0), ("run",)]
    got, _ = _assert_same(models, kv, script)
    assert got[0][1] == "CANCELLED" and 0 < len(got[0][0]) < 20
    assert got[1][1] == "DEADLINE_EXCEEDED" and got[3][1] == "DEADLINE_EXCEEDED"
    assert got[3][0] == [] and got[2][1] == "OK"


@KV
def test_priority_preemption_equal_jax(models, kv):
    """A higher-priority arrival evicts the latest low-priority slot, which
    re-prefills its prompt and emitted tokens and finishes its stream."""
    a, b, c = _prompts((60, 90, 30), seed=3)
    script = [("submit", 0, a, 12, {}), ("submit", 1, b, 12, {}), ("step", 5),
              ("submit", 2, c, 4, {"priority": 3}), ("run",)]
    got, eng = _assert_same(models, kv, script)
    assert got[1][3] == 1 and got[0][3] == 0  # the latest low-priority slot went
    assert all(s == "OK" for _, s, *_ in got.values())
    assert eng.stats()["preemptions"] == 1


def test_eos_mid_stream_equal_jax(models):
    base, _ = _drive("jax", models, "bf16", _submit_all(_prompts(RAGGED[:3]), 8) + [("run",)])
    eos = base[0][0][3]
    got, _ = _assert_same(models, "bf16", _submit_all(_prompts(RAGGED[:3]), 8) + [("run",)],
                          eos_id=eos)
    assert got[0][0] == base[0][0][: base[0][0].index(eos) + 1] and got[0][1] == "OK"


def test_streams_equal_the_ports_generate(models):
    """Chunked prefill + continuous batching give each request the stream a
    one-shot ``generate`` of that prompt alone gives."""
    _, tcfg, _, tp = models
    prompts = _prompts(RAGGED[:4], seed=4)
    eng = TE.ServingEngine(tp, tcfg, slots=2, max_len=MAX_LEN, device="cpu")
    reqs = [TE.Request(rid=i, prompt=p, max_new=8) for i, p in enumerate(prompts)]
    for r in reqs:
        eng.submit(r)
    eng.run()
    for p, r in zip(prompts, reqs):
        want = TE.generate(tp, tcfg, p[None], steps=8, device="cpu").tokens[0].tolist()
        assert r.generated == want


def test_hooks_and_stats(models):
    _, tcfg, _, tp = models
    eng = TE.ServingEngine(tp, tcfg, slots=2, max_len=MAX_LEN, device="cpu")
    emitted, finished = {}, []
    eng.on_emit = lambda req, toks: emitted.setdefault(req.rid, []).extend(toks)
    eng.on_finish = lambda req: finished.append(req.rid)
    reqs = [TE.Request(rid=i, prompt=p, max_new=5) for i, p in enumerate(_prompts((9, 70, 30)))]
    for r in reqs:
        eng.submit(r)
    eng.run()
    assert {r.rid: r.generated for r in reqs} == emitted
    assert sorted(finished) == [0, 1, 2]
    st = eng.stats()
    assert st["host_transfers"] == st["ticks"] == eng.tick_count
    assert st["statuses"] == {"OK": 3} and st["queued"] == st["live"] == 0
    assert eng.trash_base == 256 and eng.cache_len == 512
    assert eng.chunk_sizes == (64, 128, 256)
    small = TE.ServingEngine(tp, tcfg, slots=1, max_len=64, device="cpu")
    assert small.chunk_sizes == (64,) and small.cache_len == 128


@pytest.mark.parametrize("length", [1, 9, 63, 64, 65, 128, 130, 200, 256, 257, 700, 1000])
def test_chunk_schedule_and_bucket_length_match_jax(length):
    for sizes in ((64, 128, 256), (64, 128), (32,)):
        assert TE.chunk_schedule(length, sizes) == jE.chunk_schedule(length, sizes)
        assert TE.bucket_length(length, sizes) == jE.bucket_length(length, sizes)


def test_chunk_schedule_rejects_broken_chain():
    with pytest.raises(ValueError, match="divisibility"):
        TE.chunk_schedule(10, (48, 64))


@KV
def test_grow_and_fit_caches_match_jax(models, kv):
    jcfg, tcfg, _, _ = _cfgs(models, kv)
    jc = jE.init_caches(jcfg, 2, 40, dtype=jcfg.dtype)
    rng = np.random.default_rng(7)
    jc = jax.tree.map(lambda a: jnp.asarray(rng.integers(-100, 100, a.shape)).astype(a.dtype), jc)
    tc = {"blocks": {b: {k: torch.from_numpy(np.array(v)) for k, v in leaves.items()}
                     for b, leaves in jc["blocks"].items()}}
    for fn, n in ((jE.grow_caches, 70), (jE.grow_caches, 30), (jE.fit_caches, 30),
                  (jE.fit_caches, 64)):
        want = fn(jc, jcfg, n)["blocks"]["b0"]
        got = getattr(TE, fn.__name__)(tc, tcfg, n)["blocks"]["b0"]
        assert set(got) == set(want)
        for k in want:
            np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
    other = dataclasses.replace(tcfg, kv_cache_dtype="int8" if kv == "bf16" else "bf16")
    with pytest.raises(ValueError, match="layout"):
        TE.grow_caches(tc, other, 70)


@KV
def test_prefill_chunk_step_matches_jax(models, kv):
    """Two chunk steps from empty caches: a 64-token chunk at offset 0 in
    both slots, then one at offsets (64, trash 192) with ``last_row``, slot
    1 write-only. The JAX side runs its Pallas kernel in interpret mode and
    its XLA form."""
    jcfg, tcfg, jp, tp = _cfgs(models, kv)
    rng = np.random.default_rng(5)
    t1, t2 = rng.integers(0, 256, (2, 2, 64))
    off, last = np.array([64, 192], np.int32), np.array([10, 3], np.int32)
    tc = TE.init_caches(tcfg, 2, 256, device="cpu")
    tl1, _ = TT.prefill_chunk_step(tp, torch.from_numpy(t1), tc, torch.zeros(2, dtype=torch.int32),
                                   tcfg, kernels=PLAIN)
    tl2, _ = TT.prefill_chunk_step(tp, torch.from_numpy(t2), tc, torch.from_numpy(off), tcfg,
                                   kernels=PLAIN, last_row=torch.from_numpy(last),
                                   prefix_limit=192)
    assert tuple(tl1.shape) == (2, 64, 256) and tuple(tl2.shape) == (2, 256)
    for impl in ("kernel", "xla"):
        jc = jE.init_caches(jcfg, 2, 256, dtype=jcfg.dtype)
        jl1, jc = jT.prefill_chunk_step(jp, {"tokens": jnp.asarray(t1, jnp.int32)}, jc,
                                        jnp.zeros(2, jnp.int32), jcfg, mode="packed",
                                        attn_impl=impl)
        jl2, jc = jT.prefill_chunk_step(jp, {"tokens": jnp.asarray(t2, jnp.int32)}, jc,
                                        jnp.asarray(off), jcfg, mode="packed", attn_impl=impl,
                                        last_row=jnp.asarray(last), prefix_limit=192)
        for got, want in ((tl1.numpy(), np.asarray(jl1)), (tl2.numpy()[:1], np.asarray(jl2)[:1])):
            bar = 1e-5 if kv == "bf16" else 0.02 * np.abs(want).max()
            np.testing.assert_allclose(got, want, atol=bar, rtol=0)
            np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))
        tcb, jcb = tc["blocks"]["b0"], jc["blocks"]["b0"]
        # live rows: slot 0 [0, 128), slot 1 [0, 64) (its second chunk went to the trash)
        for name in tcb:
            for slot, n in ((0, 128), (1, 64)):
                got = tcb[name].numpy()[:, slot, :, :n]
                want = np.asarray(jcb[name])[:, slot, :, :n]
                if kv == "bf16":
                    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
                elif name.endswith("_scale"):
                    np.testing.assert_allclose(got[0], want[0], rtol=5e-7, atol=0)
                else:
                    off_by = np.abs(got[0].astype(np.int32) - want[0])
                    assert off_by.max() <= 1 and (off_by > 0).mean() <= 1e-3


def test_int8_generate_matches_jax(models):
    """One-shot prefill into an int8 cache quantizes K/V and attends to their
    dequantized rows, as JAX's does: the greedy stream of ``generate``."""
    jcfg, tcfg, jp, tp = _cfgs(models, "int8")
    prompts = np.stack(_prompts((13, 13, 13), seed=11))
    want = jE.generate(jp, jcfg, jnp.asarray(prompts), steps=6, mode="packed")
    got = TE.generate(tp, tcfg, prompts, steps=6, device="cpu")
    np.testing.assert_array_equal(got.tokens.numpy(), np.asarray(want.tokens))


def test_guards_match_jax():
    logits = np.zeros((4, 6), np.float32)
    logits[0, 2] = np.nan
    logits[1, 0] = np.inf
    logits[2, 5] = 0.6 * np.finfo(np.float32).max
    where = np.array([True, True, False, True])
    for w in (None, where):
        want = jR.logits_guard(jnp.asarray(logits), where=None if w is None else jnp.asarray(w))
        got = TR.logits_guard(torch.from_numpy(logits),
                              where=None if w is None else torch.from_numpy(w))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    jcfg = dataclasses.replace(get_config("tellme-0.7b", smoke=True), kv_cache_dtype="int8")
    shapes, axes = jT.cache_specs(jcfg, 3, 10)
    rng = np.random.default_rng(1)
    caches = jax.tree.map(lambda s: rng.uniform(0.1, 1, s.shape).astype(np.float32)
                          if s.dtype == jnp.float32 else np.zeros(s.shape, np.int8), shapes)
    caches["blocks"]["b0"]["k_scale"][1, 0, 1, 4] = np.nan  # slot 0, row 4
    caches["blocks"]["b0"]["v_scale"][0, 2, 0, 7] = np.inf  # slot 2, row 7
    rows = np.array([[4, 5], [4, 5], [6, 9]], np.int32)
    for valid in (np.ones((3, 2), bool), np.array([[False, True], [True, True], [True, True]])):
        want = jR.scale_guard(jax.tree.map(jnp.asarray, caches), axes, jnp.asarray(rows),
                              jnp.asarray(valid))
        got = TR.scale_guard(jax.tree.map(torch.from_numpy, caches), torch.from_numpy(rows),
                             torch.from_numpy(valid))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    bf16 = {"blocks": {"b0": {"k": torch.full((2, 3, 4, 10, 16), float("nan")),
                              "v": torch.zeros((2, 3, 4, 10, 16))}}}
    assert not TR.scale_guard(bf16, torch.from_numpy(rows), torch.ones((3, 2), dtype=torch.bool)).any()


def test_guard_quarantines_one_slot(models):
    """A slot whose cache turns non-finite is quarantined on its next tick;
    the other slot's stream is that of a clean run."""
    _, tcfg, _, tp = _cfgs(models, "int8")
    prompts = _prompts((9, 30), seed=6)

    def run(poison):
        eng = TE.ServingEngine(tp, tcfg, slots=2, max_len=MAX_LEN, device="cpu")
        reqs = [TE.Request(rid=i, prompt=p, max_new=6) for i, p in enumerate(prompts)]
        for r in reqs:
            eng.submit(r)
        eng.step()
        eng.step()
        if poison:  # slot 1's prompt rows: its next decode reads them
            eng.caches["blocks"]["b0"]["k_scale"][:, 1, :, :30] = float("nan")
        eng.run()
        return reqs, eng

    clean, _ = run(False)
    bad, eng = run(True)
    assert bad[0].generated == clean[0].generated and bad[0].status.name == "OK"
    assert bad[1].status.name == "QUARANTINED" and eng.stats()["quarantined"] == 1
    assert bad[1].generated == clean[1].generated[:len(bad[1].generated)]


def test_engine_raises_without_cuda(models):
    """No card and no explicit CPU: the engine refuses to start on the host."""
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour on a machine without a CUDA device")
    _, tcfg, _, tp = models
    with pytest.raises(RuntimeError, match="CUDA"):
        TE.ServingEngine(tp, tcfg, slots=1, max_len=64)
