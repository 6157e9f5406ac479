"""PyTorch port, speculative decoding: the prompt-lookup drafter, the
acceptance rule, the unaligned (verify) append, ``verify_chunk_step`` and
``ServingEngine(speculative=True)`` on the tellme-0.7b smoke config in f32,
against the JAX package on the same numpy inputs and packed weights.

Bars:
* ``ngram_draft``, greedy ``accept_tokens``, ``make_drafter``'s errors and
  ``mask_past_frontier``: exact. Sampling (``temperature > 0``, a
  ``torch.Generator`` where JAX takes a key): JAX's three properties;
* the plain prefill-append at unaligned offsets against JAX's XLA form
  (``aligned=False``): caches exact (pools: the mapped pages), outputs
  within 1e-6 (f32) and 1e-2 (bf16: three bf16 ulps at |out| <= 3.1);
* ``verify_chunk_step`` against JAX's from the same 64-token prefill (the
  bars of ``prefill_chunk_step`` in test_torch_engine.py): bf16 layout (in
  f32) logits and live cache rows within 1e-5; int8 layout logits within
  2 % of max |logit|, argmax equal, codes within 1. Its row j against j + 1
  teacher-forced decode steps of the port: within rtol 1e-4, atol 1e-5
  (chunk and single-row attention sum in another order), argmax equal;
* the engine: per-request streams, statuses, ``spec_drafted`` and
  ``spec_accepted`` equal to JAX's speculative engine, streams and
  statuses equal to the port's plain engine, on both layouts and cache
  dtypes, with an EOS inside an accepted window and an odd ``max_new``;
  one host transfer per tick; after a run, frontier, counts and live cache
  equal the plain engine's (int8 codes exact, floats within the chunk
  bar). A tiled phrase is accepted above 0.2 of its drafts; there the
  int8 streams are held against the port's plain engine only, because the
  port's and JAX's plain int8 engines already part on that prompt at a
  near-tie of the chaotic int8 smoke model (see test_torch_engine.py).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config
from repro.core import params as P
from repro.core import ternary as jTe
from repro.models import attention as jA
from repro.models import transformer as jT
from repro.serving import engine as jE
from repro.serving import speculative as jSp
from repro_torch import interop
from repro_torch.configs import get_config as t_get_config
from repro_torch.core import params as TP
from repro_torch.core import ternary as TTe
from repro_torch.kernels import PLAIN
from repro_torch.kernels.prefill_append import ref as pa_ref
from repro_torch.models import transformer as TT
from repro_torch.serving import engine as TE
from repro_torch.serving import speculative as TSp

MAX_LEN = 128
TORCH_DT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
OUT_TOL = {"float32": 1e-6, "bfloat16": 1e-2}


@pytest.fixture(scope="module")
def models():
    jcfg = dataclasses.replace(get_config("tellme-0.7b", smoke=True), dtype=jnp.float32)
    tcfg = dataclasses.replace(t_get_config("tellme-0.7b", smoke=True), dtype=torch.float32)
    specs = jT.param_specs(jcfg)
    jp = jT.pack_tree(P.init_params(specs, jax.random.PRNGKey(0)), specs)
    tp = interop.from_jax_params(jax.device_get(jp), tcfg, device="cpu")
    return jcfg, tcfg, jp, tp


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy() if x.dtype == torch.bfloat16 else x.numpy()
    return np.asarray(x.astype(jnp.float32) if x.dtype == jnp.bfloat16 else x)


def _t(a, dtype=None):
    t = torch.from_numpy(np.array(a))
    return t if dtype is None else t.to(dtype)


# ---------------------------------------------------------------------------
# drafting and acceptance
# ---------------------------------------------------------------------------

DRAFT_CASES = [  # (hist, pos, gamma, ngram_max): JAX's cases, then stale rows
    ([[5, 6, 7, 1, 5, 6, 9, 5, 6]], [8], 3, 3),  # the most recent match continues
    ([[1, 2, 3, 8, 9, 2, 3, 2, 3]], [8], 3, 3),  # the longest n-gram wins, clamped
    ([[4, 5, 6, 7, 0, 0]], [3], 4, 3),  # no match: the current token repeats
    ([[1, 2, 1, 2, 99, 98, 97]], [3], 3, 3),  # stale rows past pos are never read
    ([[1, 2, 1, 2, 0, 0, 0], [3, 3, 3, 3, 3, 1, 2]], [3, 0], 5, 2),
]


@pytest.mark.parametrize("case", range(len(DRAFT_CASES)))
def test_ngram_draft_cases_equal_jax(case):
    hist, pos, gamma, nmax = DRAFT_CASES[case]
    want = jSp.ngram_draft(jnp.asarray(hist, jnp.int32), jnp.asarray(pos, jnp.int32),
                           gamma=gamma, ngram_max=nmax)
    got = TSp.ngram_draft(torch.tensor(hist, dtype=torch.int32),
                          torch.tensor(pos, dtype=torch.int32), gamma=gamma, ngram_max=nmax)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("gamma,nmax", [(4, 3), (2, 1), (6, 4)])
def test_ngram_draft_random_equal_jax(gamma, nmax):
    """Small vocabularies make matches common; the stale tail past each
    frontier is random and must not change the drafts."""
    for seed in range(4):
        rng = np.random.default_rng(seed)
        b, length = 5, 48
        hist = rng.integers(0, 4, (b, length)).astype(np.int32)
        pos = rng.integers(0, length, b).astype(np.int32)
        want = jSp.ngram_draft(jnp.asarray(hist), jnp.asarray(pos), gamma=gamma,
                               ngram_max=nmax)
        got = TSp.ngram_draft(_t(hist), _t(pos), gamma=gamma, ngram_max=nmax)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        stale = hist.copy()
        for s in range(b):
            stale[s, pos[s] + 1:] = rng.integers(0, 4, length - pos[s] - 1)
        again = TSp.ngram_draft(_t(stale), _t(pos), gamma=gamma, ngram_max=nmax)
        assert torch.equal(again, got)


def test_accept_tokens_greedy_equal_jax():
    rng = np.random.default_rng(3)
    b, gamma, v = 6, 4, 32
    logits = rng.standard_normal((b, gamma + 1, v)).astype(np.float32)
    greedy = logits.argmax(-1)
    drafts = greedy[:, :gamma].copy()
    for s in range(b):  # slot s: its first wrong draft at s (none past gamma)
        if s < gamma:
            drafts[s, s] = (drafts[s, s] + 1) % v
    drafts[5, 1] = (drafts[5, 1] + 3) % v  # a hole: a later right draft does not count
    want_t, want_k = jSp.accept_tokens(jnp.asarray(drafts), jnp.asarray(logits))
    got_t, got_k = TSp.accept_tokens(_t(drafts.astype(np.int32)), _t(logits))
    np.testing.assert_array_equal(got_t.numpy(), np.asarray(want_t))
    np.testing.assert_array_equal(got_k.numpy(), np.asarray(want_k))
    assert got_k.tolist() == [0, 1, 2, 3, 4, 1]


def test_accept_tokens_sampling_properties():
    """JAX's three properties (test_speculative.py:158-185) with a
    torch.Generator: a draft of almost no mass is rejected and never
    re-emitted; sure drafts are all accepted with the bonus row; no
    generator, no sampling."""
    v = 16
    logits = torch.zeros((1, 2, v))
    logits[0, :, 7] = -20.0
    gen = torch.Generator().manual_seed(0)
    for _ in range(20):
        targets, k = TSp.accept_tokens(torch.tensor([[7]], dtype=torch.int32), logits,
                                       temperature=1.0, generator=gen)
        assert int(k[0]) == 0 and int(targets[0, 0]) != 7
    sure = torch.full((1, 3, v), -30.0)
    for j, t in enumerate([2, 9, 4]):
        sure[0, j, t] = 30.0
    targets, k = TSp.accept_tokens(torch.tensor([[2, 9]], dtype=torch.int32), sure,
                                   temperature=1.0, generator=gen)
    assert int(k[0]) == 2 and targets.tolist() == [[2, 9, 4]]
    with pytest.raises(ValueError, match="Generator"):
        TSp.accept_tokens(torch.zeros((1, 1), dtype=torch.int32), torch.zeros((1, 2, 4)),
                          temperature=1.0)


def test_make_drafter_errors_equal_jax(models):
    jcfg, tcfg, _, _ = models
    for over, match in ((dict(spec_draft="model"), "unknown spec_draft"),
                        (dict(spec_gamma=0), "spec_gamma")):
        for mod, cfg in ((jSp, jcfg), (TSp, tcfg)):
            with pytest.raises(ValueError, match=match):
                mod.make_drafter(dataclasses.replace(cfg, **over))
    for f in ("spec_gamma", "spec_draft", "spec_ngram_max", "spec_min_acceptance",
              "spec_disable_after"):
        assert getattr(tcfg, f) == getattr(jcfg, f), f
    hist = np.array([[1, 2, 3, 1, 2, 3, 1, 2]], np.int32)
    got = TSp.make_drafter(tcfg)(_t(hist), torch.tensor([7], dtype=torch.int32))
    want = jSp.make_drafter(jcfg)(jnp.asarray(hist), jnp.asarray([7]))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("dtype", ["float32", "int8"])
def test_mask_past_frontier_equal_jax(dtype):
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 3, 4, 10, 5)).astype(np.float32)
    if dtype == "int8":
        x = (x * 40).astype(np.int8)
    for frontier, seq, batch in (([3, 7, 0], 3, 1), (6, 3, 1), ([1, 9], 1, 0)):
        want = jTe.mask_past_frontier(jnp.asarray(x), jnp.asarray(frontier), seq_axis=seq,
                                      batch_axis=batch)
        got = TTe.mask_past_frontier(_t(x), torch.tensor(frontier), seq_axis=seq,
                                     batch_axis=batch)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# ---------------------------------------------------------------------------
# the unaligned append
# ---------------------------------------------------------------------------

B, HK, C, M, D, PS = 4, 2, 5, 96, 16, 32
OFFSETS = np.array([3, 29, 62, 90], np.int32)  # slot 1 straddles a page; slot 3 write-only
PREFIX_LIMIT = 90


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("quant", [False, True], ids=["dense", "int8"])
@pytest.mark.parametrize("paged", [False, True], ids=["contiguous", "paged"])
def test_unaligned_append_plain_vs_jax_xla(dtype, quant, paged):
    """A verify-sized chunk (C = 5) at decode frontiers, G = 2: the plain
    version against JAX's XLA form, contiguous and paged (a page table over
    a permuted pool, each slot's blocks mapped up to its chunk's end)."""
    rng = np.random.default_rng(20 + quant + 2 * paged)
    jd, td = getattr(jnp, dtype), TORCH_DT[dtype]
    q, kn, vn = (rng.standard_normal(s).astype(np.float32)
                 for s in ((B, 2 * HK, C, D), (B, HK, C, D), (B, HK, C, D)))
    lead = (B * (M // PS) + 1, HK, PS) if paged else (B, HK, M)
    if quant:
        arrs = [rng.integers(-127, 128, lead + (D,)).astype(np.int8) for _ in range(2)]
        arrs += [rng.uniform(1e-3, 2e-2, lead).astype(np.float32) for _ in range(2)]
        jc, tc = [jnp.asarray(a) for a in arrs], [_t(a) for a in arrs]
    else:
        arrs = [rng.standard_normal(lead + (D,)).astype(np.float32) for _ in range(2)]
        jc, tc = [jnp.asarray(a).astype(jd) for a in arrs], [_t(a, td) for a in arrs]
    jx = [jnp.asarray(a).astype(jd) for a in (q, kn, vn)]
    tx = [_t(a, td) for a in (q, kn, vn)]
    jkw = dict(k_scale=jc[2], v_scale=jc[3]) if quant else {}
    tkw = dict(k_scale=tc[2], v_scale=tc[3]) if quant else {}
    off = jnp.asarray(OFFSETS)
    if paged:
        mapped = [-(-(o + C) // PS) for o in OFFSETS[:3]]
        perm = list(rng.permutation(np.arange(1, lead[0])))
        table = np.zeros((B, M // PS), np.int32)
        for s, n in enumerate(mapped):
            table[s, :n] = [perm.pop() for _ in range(n)]
        want = jA.prefill_append_attention_paged(*jx, jc[0], jc[1], jnp.asarray(table), off,
                                                 impl="xla", aligned=False,
                                                 prefix_limit=PREFIX_LIMIT, **jkw)
        got = pa_ref.prefill_append_paged(*tx, tc[0], tc[1], _t(table), _t(OFFSETS),
                                          prefix_limit=PREFIX_LIMIT, **tkw)
        live = np.zeros(lead[0], bool)
        live[table[table > 0]] = True
        for mine, ref_ in zip(tc, want[1:]):
            np.testing.assert_array_equal(_np(mine)[live], _np(ref_)[live])
    else:
        want = jA.prefill_append_attention(*jx, jc[0], jc[1], off, impl="xla", aligned=False,
                                           prefix_limit=PREFIX_LIMIT, **jkw)
        got = pa_ref.prefill_append(*tx, tc[0], tc[1], _t(OFFSETS), prefix_limit=PREFIX_LIMIT,
                                    **tkw)
        for mine, ref_ in zip(tc, want[1:]):
            np.testing.assert_array_equal(_np(mine), _np(ref_))
    tol = OUT_TOL[dtype]
    np.testing.assert_allclose(_np(got)[:3], _np(want[0])[:3], atol=tol, rtol=tol)
    assert got[3].eq(0).all()  # the write-only slot


# ---------------------------------------------------------------------------
# verify_chunk_step
# ---------------------------------------------------------------------------

KV = pytest.mark.parametrize("kv", ["bf16", "int8"])
VERIFY_POS = np.array([37, 61], np.int32)


def _cfgs(models, kv, **over):
    jcfg, tcfg, jp, tp = models
    return (dataclasses.replace(jcfg, kv_cache_dtype=kv, **over),
            dataclasses.replace(tcfg, kv_cache_dtype=kv, **over), jp, tp)


@KV
def test_verify_chunk_step_matches_jax(models, kv):
    """From a 64-token chunk at offset 0 in both slots, a 5-token verify
    chunk at frontiers 37 and 61: logits at every row and the live cache
    rows against JAX's verify_chunk_step."""
    jcfg, tcfg, jp, tp = _cfgs(models, kv)
    rng = np.random.default_rng(6)
    t1, chunk = rng.integers(0, 256, (2, 64)), rng.integers(0, 256, (2, 5))
    tc = TE.init_caches(tcfg, 2, 128, device="cpu")
    TT.prefill_chunk_step(tp, _t(t1), tc, torch.zeros(2, dtype=torch.int32), tcfg,
                          kernels=PLAIN)
    got, _ = TT.verify_chunk_step(tp, _t(chunk), tc, _t(VERIFY_POS), tcfg, kernels=PLAIN)
    jc = jE.init_caches(jcfg, 2, 128, dtype=jcfg.dtype)
    _, jc = jT.prefill_chunk_step(jp, {"tokens": jnp.asarray(t1, jnp.int32)}, jc,
                                  jnp.zeros(2, jnp.int32), jcfg, mode="packed")
    want, jc = jT.verify_chunk_step(jp, {"tokens": jnp.asarray(chunk, jnp.int32)}, jc,
                                    jnp.asarray(VERIFY_POS), jcfg, mode="packed")
    got, want = got.numpy(), np.asarray(want)
    assert got.shape == want.shape == (2, 5, 256)
    bar = 1e-5 if kv == "bf16" else 0.02 * np.abs(want).max()
    np.testing.assert_allclose(got, want, atol=bar, rtol=0)
    np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))
    tcb, jcb = tc["blocks"]["b0"], jc["blocks"]["b0"]
    for name in tcb:
        for slot, p in enumerate(VERIFY_POS):
            a, b = tcb[name].numpy()[:, slot, :, :p + 5], np.asarray(jcb[name])[:, slot, :, :p + 5]
            if kv == "bf16":
                np.testing.assert_allclose(a, b, atol=1e-5, rtol=0)
            elif name.endswith("_scale"):
                np.testing.assert_allclose(a[0], b[0], rtol=5e-7, atol=0)
            else:
                assert np.abs(a[0].astype(np.int32) - b[0]).max() <= 1


@KV
def test_verify_rows_match_teacher_forced_decode(models, kv):
    """Row j of the verify logits against the port's (j + 1)-th decode step
    fed the same tokens, from the same caches; the chunk is the greedy
    continuation, so every draft is accepted; the rows the chunk wrote equal
    the decode steps' under the live mask."""
    _, tcfg, _, tp = _cfgs(models, kv)
    rng = np.random.default_rng(8)
    prompts = _t(rng.integers(0, 256, (2, 9)))
    last, caches = TE.prefill_bucketed(tp, tcfg, prompts, kernels=PLAIN)
    caches = TE.fit_caches(caches, tcfg, 32)
    dec = {"blocks": {b: {n: t.clone() for n, t in leaves.items()}
                      for b, leaves in caches["blocks"].items()}}
    pos = torch.full((2,), 9, dtype=torch.int32)
    seq, rows = [torch.argmax(last, -1)], []
    for j in range(5):
        logits, _ = TT.decode_step(tp, seq[-1][:, None], dec, pos + j, tcfg, kernels=PLAIN)
        rows.append(logits)
        seq.append(torch.argmax(logits, -1))
    chunk = torch.stack(seq[:5], dim=1)
    ver, _ = TT.verify_chunk_step(tp, chunk, caches, pos, tcfg, kernels=PLAIN)
    for j in range(5):
        torch.testing.assert_close(ver[:, j], rows[j], rtol=1e-4, atol=1e-5)
        assert torch.equal(ver[:, j].argmax(-1), rows[j].argmax(-1))
    drafts = chunk[:, 1:].to(torch.int32)
    assert TSp.accept_tokens(drafts, ver)[1].tolist() == [4, 4]
    a, b = (TE.live_cache_state(c, tcfg, pos + 5)["blocks"]["b0"] for c in (caches, dec))
    for name in a:
        if a[name].dtype == torch.int8:
            assert torch.equal(a[name], b[name])
        else:
            torch.testing.assert_close(a[name], b[name], rtol=1e-4, atol=1e-5)


# ---------------------------------------------------------------------------
# the speculative engine
# ---------------------------------------------------------------------------

ENGINE_LENS = (8, 60, 24, 40, 50)
MAX_NEW = (16, 16, 7, 16, 11)  # odd budgets cut an accepted window short


def _prompts(lengths, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, n).astype(np.int32) for n in lengths]


def _serve(side, models, kv, layout, prompts, max_new, *, speculative=True, eos_id=-1,
           slots=2, max_len=MAX_LEN, gamma=None):
    """Serve to the end; returns ({rid: (tokens, status, drafted, accepted)},
    engine)."""
    jcfg, tcfg, jp, tp = _cfgs(models, kv, kv_layout=layout)
    kw = dict(slots=slots, max_len=max_len, eos_id=eos_id, speculative=speculative,
              spec_gamma=gamma)
    if side == "jax":
        eng, Req = jE.ServingEngine(jp, jcfg, mode="packed", **kw), jE.Request
    else:
        eng, Req = TE.ServingEngine(tp, tcfg, device="cpu", kernels=PLAIN, **kw), TE.Request
    reqs = [Req(rid=i, prompt=p, max_new=n) for i, (p, n) in enumerate(zip(prompts, max_new))]
    for r in reqs:
        eng.submit(r)
    eng.run()
    return {r.rid: ([int(t) for t in r.generated], r.status.name, r.spec_drafted,
                    r.spec_accepted) for r in reqs}, eng


@pytest.mark.parametrize("layout", ["contiguous", "paged"])
@KV
def test_spec_engine_equals_jax_and_plain(models, kv, layout):
    """Ragged prompts admitted while others decode (mixed verify + chunk
    ticks), odd budgets, and an EOS taken from the middle of a plain
    stream, so that it lands inside an accepted window."""
    prompts = _prompts(ENGINE_LENS, seed=1)
    plain, _ = _serve("torch", models, kv, layout, prompts, MAX_NEW, speculative=False)
    eos = plain[1][0][5]
    plain, _ = _serve("torch", models, kv, layout, prompts, MAX_NEW, speculative=False,
                      eos_id=eos)
    got, eng = _serve("torch", models, kv, layout, prompts, MAX_NEW, eos_id=eos)
    want, jeng = _serve("jax", models, kv, layout, prompts, MAX_NEW, eos_id=eos)
    assert got == want
    assert {r: g[:2] for r, g in got.items()} == {r: p[:2] for r, p in plain.items()}
    assert any(t[-1] == eos and len(t) < n for (t, *_), n in zip(got.values(), MAX_NEW))
    st = eng.stats()
    assert st["speculative"] and st["spec_ticks"] > 0
    assert st["host_transfers"] == st["ticks"] == jeng.tick_count
    assert st["spec_acceptance"] == jeng.spec_acceptance_rate
    assert all(0 <= a <= d for _, _, d, a in got.values())
    if layout == "paged":
        assert st["paged"] == jeng.stats()["paged"]


@KV
def test_rollback_state_equals_plain_engine(models, kv):
    """After serving to the end, one slot: tokens, frontier and count equal
    the plain engine's, and so does the live cache (rows past the frontier
    are dead, so the rejected drafts' rows are left out)."""
    prompts = _prompts((10,), seed=9)
    (plain, pe), (spec, se) = (_serve("torch", models, kv, "contiguous", prompts, (12,),
                                      speculative=sp, slots=1, max_len=64)
                               for sp in (False, True))
    assert plain[0][:2] == spec[0][:2] and spec[0][2] > 0
    assert torch.equal(pe.pos, se.pos) and torch.equal(pe.gen_count, se.gen_count)
    tcfg = _cfgs(models, kv)[1]
    a, b = (TE.live_cache_state(e.caches, tcfg, e.pos)["blocks"]["b0"] for e in (pe, se))
    for name in a:
        if a[name].dtype == torch.int8:
            assert torch.equal(a[name], b[name])
        else:
            torch.testing.assert_close(a[name], b[name], rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("layout", ["contiguous", "paged"])
@KV
def test_tiled_phrase_acceptance(models, kv, layout):
    """A prompt that is one phrase tiled: the greedy continuation falls into
    a loop and prompt lookup accepts well above the random floor, so
    multi-token emissions and rollbacks both run. Streams equal the plain
    engine's."""
    rng = np.random.default_rng(4)
    prompts = [np.tile(rng.integers(0, 256, 6).astype(np.int32), 5), _prompts((20,), 5)[0]]
    got, eng = _serve("torch", models, kv, layout, prompts, (24, 24), max_len=96)
    plain, _ = _serve("torch", models, kv, layout, prompts, (24, 24), speculative=False,
                      max_len=96)
    assert {r: g[:2] for r, g in got.items()} == {r: p[:2] for r, p in plain.items()}
    assert eng.spec_acceptance_rate > 0.2 and got[0][3] > 0
    assert any(a < d for _, _, d, a in got.values())  # some drafts rolled back


def test_spec_engine_checks_and_fallbacks(models):
    """The spec_gamma check (JAX's message), the ssm family staying on plain
    decode, and the acceptance watchdog switching speculation off."""
    _, tcfg, _, tp = models
    for g in (0, 256):
        with pytest.raises(ValueError, match="spec_gamma"):
            TE.ServingEngine(tp, tcfg, slots=1, max_len=32, device="cpu", kernels=PLAIN,
                             speculative=True, spec_gamma=g)
    rcfg = dataclasses.replace(t_get_config("rwkv6-3b", smoke=True), dtype=torch.float32)
    specs = TT.param_specs(rcfg)
    rparams = TT.pack_tree(TP.init_params(specs, seed=0, device="cpu"), specs,
                           dtype=rcfg.dtype)
    eng = TE.ServingEngine(rparams, rcfg, slots=1, max_len=32, device="cpu", kernels=PLAIN,
                           speculative=True)
    req = TE.Request(rid=0, prompt=np.arange(1, 9), max_new=4)
    eng.submit(req)
    eng.run()
    assert not eng.speculative and eng.hist is None
    assert len(req.generated) == 4 and req.spec_drafted == 0
    # random prompts draft badly: a high bar switches speculation off
    strict = dataclasses.replace(tcfg, spec_min_acceptance=0.99, spec_disable_after=8)
    eng = TE.ServingEngine(tp, strict, slots=2, max_len=MAX_LEN, device="cpu", kernels=PLAIN,
                           speculative=True)
    reqs = [TE.Request(rid=i, prompt=p, max_new=12) for i, p in enumerate(_prompts((9, 30)))]
    for r in reqs:
        eng.submit(r)
    eng.run()
    assert not eng.speculative
    assert [e["kind"] for e in eng.events].count("spec_disabled") == 1
    assert all(r.status.name == "OK" and len(r.generated) == 12 for r in reqs)


def test_one_host_transfer_per_spec_tick(models):
    """The tick's one transfer carries [gamma + 4 (+ guards), slots]."""
    _, tcfg, _, tp = models
    eng = TE.ServingEngine(tp, tcfg, slots=2, max_len=MAX_LEN, device="cpu", kernels=PLAIN,
                           speculative=True, spec_gamma=3)
    shapes = []
    transfer = eng._transfer
    eng._transfer = lambda packed: (shapes.append(tuple(packed.shape)), transfer(packed))[1]
    for i, p in enumerate(_prompts((100, 100, 100), seed=2)):
        eng.submit(TE.Request(rid=i, prompt=p, max_new=6))
    eng.run()
    st = eng.stats()
    assert st["host_transfers"] == st["ticks"] == len(shapes) and st["spec_ticks"] > 0
    assert shapes.count((3 + 5, 2)) == st["spec_ticks"]
