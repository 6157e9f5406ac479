"""PyTorch port, the paged KV layout: the page pool, prefix trie and
copy-on-write of ``serving/paging.py``, the page helpers, the paged
attention forms and the ``ServingEngine`` with ``kv_layout="paged"``,
against the JAX package on the same inputs (the model mirrored is
``tests/test_paged_kv.py``).

Bars:
* host bookkeeping (``PageAllocator``, ``PrefixTrie``, ``PagedKV``): table,
  refcounts, free list, trie size and ``stats()`` equal to JAX's after every
  operation of the same sequences, errors included;
* ``gather_kv_pages`` / ``scatter_kv_pages`` / ``update_kv_pages``: exact.
  A scatter or an update that several slots send to the garbage page leaves
  that page's content free by contract, so it is left out;
* the paged attention forms, plain versions: pools and scales after the
  append exact against JAX's XLA forms (garbage page left out); outputs
  within 1e-6 (f32) and 1e-2 (bf16, the bar of test_torch_prefill_append.py:
  three bf16 ulps at |out| <= 3.1) of the XLA forms, and within 1e-5 (f32)
  and 1e-2 (bf16) of the JAX paged kernels in interpret mode, whose scales
  XLA divides by a reciprocal (within one ulp) and whose online softmax
  rescales block by block;
* the engine in f32 on the smoke config: streams, statuses, status details
  and ``stats()["paged"]`` equal to the JAX ``ServingEngine(mode="packed")``
  with ``kv_layout="paged"``, for both cache dtypes; equal to the port's own
  contiguous engine; one host transfer per tick.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config
from repro.core import params as P
from repro.core import ternary as jT
from repro.kernels.decode_attention import ops as j_da_ops
from repro.kernels.prefill_append import ops as j_pa_ops
from repro.models import attention as jA
from repro.models import transformer as jTr
from repro.serving import engine as jE
from repro.serving import paging as jpg
from repro.serving import resilience as jR
from repro_torch import interop
from repro_torch.configs import get_config as t_get_config
from repro_torch.core import ternary as TT
from repro_torch.kernels import PLAIN
from repro_torch.kernels.decode_attention import ref as da_ref
from repro_torch.kernels.prefill_append import ref as pa_ref
from repro_torch.models import attention as TA
from repro_torch.models import transformer as TTr
from repro_torch.serving import engine as TE
from repro_torch.serving import paging as tpg
from repro_torch.serving import resilience as TR

TORCH_DT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
XLA_TOL = {"float32": 1e-6, "bfloat16": 1e-2}
KERNEL_TOL = {"float32": 1e-5, "bfloat16": 1e-2}
SCALE_ULP = {"float32": 2.0 ** -23, "bfloat16": 2.0 ** -7}
PAGED_EVENTS = ("prefix_hit", "cow_fork", "page_pool_exhausted", "preempt", "quarantine")


def _t(a, dtype=None):
    t = torch.from_numpy(np.array(a))  # a writable copy
    return t if dtype is None else t.to(dtype)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy() if x.dtype == torch.bfloat16 else x.numpy()
    return np.asarray(x.astype(jnp.float32) if x.dtype == jnp.bfloat16 else x)


# ---------------------------------------------------------------------------
# (a) host bookkeeping, operation by operation against JAX
# ---------------------------------------------------------------------------


def _kv_state(kv):
    return (kv.table.tolist(), kv.allocator.refs.tolist(), list(kv.allocator.free_list),
            kv.trie.size, kv.stats())


def _both(fn_jax, fn_port):
    """Run one operation on both sides; returns (result or error, ...) and
    asserts they agree."""
    out = []
    for fn in (fn_jax, fn_port):
        try:
            out.append(("ok", fn()))
        except (ValueError, jpg.PagePoolExhausted, tpg.PagePoolExhausted) as e:
            out.append(("raise", type(e).__name__, str(e)))
    assert out[0] == out[1]
    return out[0]


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_paged_kv_op_sequences_equal_jax(seed):
    """Random admit / ensure_writable / insert_prefix / release sequences on
    a small pool (eviction and exhaustion included); the shedding contract of
    the engine on exhaustion (release the requester)."""
    rng = np.random.default_rng(seed)
    kw = dict(slots=3, cache_len=40, page_size=4, num_pages=14)
    jkv, tkv = jpg.PagedKV(**kw), tpg.PagedKV(**kw)
    families = [rng.integers(1, 1000, 41) for _ in range(4)]
    active = set()
    names = ("admit", "write", "intern", "release")
    for _ in range(300):
        op, slot = names[rng.integers(4)], int(rng.integers(3))
        fam, n = int(rng.integers(4)), int(rng.integers(1, 11))
        if op == "admit" and slot not in active:
            toks = families[fam][:4 * n + fam]
            _both(lambda: jkv.admit(slot, toks, chunk0=8), lambda: tkv.admit(slot, toks, chunk0=8))
            active.add(slot)
        elif op == "write" and slot in active:
            res = _both(lambda: jkv.ensure_writable(slot, range(n)),
                        lambda: tkv.ensure_writable(slot, range(n)))
            if res[0] == "raise":
                _both(lambda: jkv.release(slot), lambda: tkv.release(slot))
                active.discard(slot)
        elif op == "intern" and slot in active:
            _both(lambda: jkv.insert_prefix(slot), lambda: tkv.insert_prefix(slot))
        elif op == "release" and slot in active:
            _both(lambda: jkv.release(slot), lambda: tkv.release(slot))
            active.discard(slot)
        assert _kv_state(tkv) == _kv_state(jkv)
    while _both(jkv.trie.evict_lru, tkv.trie.evict_lru)[1]:
        pass
    assert _kv_state(tkv) == _kv_state(jkv)


def test_allocator_errors_and_order_equal_jax():
    """LIFO reuse, exhaustion, double free and ref of a free page: the same
    results and the same errors."""
    ja, ta = jpg.PageAllocator(4), tpg.PageAllocator(4)
    pages = [_both(ja.alloc, ta.alloc)[1] for _ in range(4)]
    assert pages == [0, 1, 2, 3]
    assert _both(ja.alloc, ta.alloc)[:2] == ("raise", "PagePoolExhausted")
    assert _both(lambda: ja.deref(2), lambda: ta.deref(2)) == ("ok", True)
    assert _both(lambda: ja.deref(2), lambda: ta.deref(2))[2].startswith("double free")
    assert _both(lambda: ja.ref(2), lambda: ta.ref(2))[2].startswith("ref of free")
    assert _both(ja.alloc, ta.alloc) == ("ok", 2)
    assert (ta.refs.tolist(), ta.free_list, ta.high_water) == (
        ja.refs.tolist(), ja.free_list, ja.high_water)
    with pytest.raises(ValueError, match=">= 2 pages"):
        tpg.PageAllocator(1)


def test_trie_eviction_and_cow_equal_jax():
    """A prefix interned, matched by a second slot (tail floored to the
    chunk), forked on write, then evicted under pressure."""
    kw = dict(slots=2, cache_len=16, page_size=4, num_pages=6)
    jkv, tkv = jpg.PagedKV(**kw), tpg.PagedKV(**kw)
    toks = np.random.default_rng(4).integers(1, 1000, 16)
    for kv in (jkv, tkv):
        kv.ensure_writable(0, range(4))
        kv._tokens[0] = toks
    assert _both(lambda: jkv.insert_prefix(0), lambda: tkv.insert_prefix(0)) == ("ok", 4)
    assert _both(lambda: jkv.admit(1, toks, chunk0=4), lambda: tkv.admit(1, toks, chunk0=4)) \
        == ("ok", 12)
    pairs = _both(lambda: jkv.ensure_writable(1, [3]), lambda: tkv.ensure_writable(1, [3]))[1]
    assert len(pairs) == 1
    for slot in (0, 1):
        _both(lambda: jkv.release(slot), lambda: tkv.release(slot))
    _both(lambda: jkv.ensure_writable(0, range(4)), lambda: tkv.ensure_writable(0, range(4)))
    assert _kv_state(tkv) == _kv_state(jkv) and tkv.evictions > 0


# ---------------------------------------------------------------------------
# (b) page helpers
# ---------------------------------------------------------------------------


def _table(rng, b, nb, pages, mapped, share=(1, 0, 0)):
    """A page table over pages 1..pages-1 in a random order: slot s maps its
    first ``mapped[s]`` blocks, the rest hold the garbage page 0; with
    ``share = (dst, src, n)`` slot dst's first n blocks are slot src's pages
    (shared, read-only)."""
    perm = list(rng.permutation(np.arange(1, pages)))
    table = np.zeros((b, nb), np.int32)
    dst, src, n = share
    for s in range(b):
        for blk in range(mapped[s]):
            table[s, blk] = table[src, blk] if s == dst and blk < n else perm.pop()
    return table


def _bits(t):
    return t.view(torch.int16) if t.dtype == torch.bfloat16 else t


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
def test_page_helpers_exact_vs_jax(dtype):
    rng = np.random.default_rng(3)
    b, hk, ps, nb, d, pages = 3, 2, 4, 5, 8, 16
    table = _table(rng, b, nb, pages, mapped=(5, 3, 2), share=(1, 0, 2))
    if dtype == "int8":
        pool = rng.integers(-127, 128, (pages, hk, ps, d)).astype(np.int8)
        jpool, tpool = jnp.asarray(pool), _t(pool)
        new = rng.integers(-127, 128, (b, hk, d)).astype(np.int8)
        jnew, tnew = jnp.asarray(new), _t(new)
    else:
        pool = rng.standard_normal((pages, hk, ps, d)).astype(np.float32)
        jpool, tpool = jnp.asarray(pool).astype(getattr(jnp, dtype)), _t(pool, TORCH_DT[dtype])
        new = rng.standard_normal((b, hk, d)).astype(np.float32)
        jnew, tnew = jnp.asarray(new).astype(jpool.dtype), _t(new, TORCH_DT[dtype])
    scales = rng.uniform(1e-3, 1e-2, (pages, hk, ps)).astype(np.float32)
    jt, tt = jnp.asarray(table), _t(table)
    live = np.ones(pages, bool)
    live[0] = False  # the garbage page: several slots write it
    for jp, tp in ((jpool, tpool), (jnp.asarray(scales), _t(scales))):
        view = TT.gather_kv_pages(tp, tt)
        np.testing.assert_array_equal(_np(view), _np(jT.gather_kv_pages(jp, jt)))
        assert tuple(view.shape) == (b, hk, nb * ps) + tuple(tp.shape[3:])
        # an edited view scattered back: rows of the mapped blocks only
        edited = torch.flip(view, dims=[-1]) if view.ndim == 4 else view * 2
        jedited = jnp.asarray(_np(edited)).astype(jp.dtype)
        want = jT.scatter_kv_pages(jp, jt, jedited)
        got = tp.clone()
        TT.scatter_kv_pages(got, tt, edited)
        np.testing.assert_array_equal(_np(got)[live], _np(want)[live])
    # the decode append: slot 2's frontier block is unmapped (the garbage page)
    pos = np.array([19, 9, 13], np.int32)
    want = jT.update_kv_pages(jpool, jt, jnew, jnp.asarray(pos), ps)
    got = tpool.clone()
    TT.update_kv_pages(got, tt, tnew, _t(pos), ps)
    np.testing.assert_array_equal(_np(got)[live], _np(want)[live])
    assert torch.equal(_bits(got[table[0, 4], :, 3]), _bits(tnew[0]))


# ---------------------------------------------------------------------------
# (c) the paged attention forms, plain versions
# ---------------------------------------------------------------------------

B, HK, PS, NB, D, C = 4, 2, 32, 8, 32, 64
PAGES = B * NB + 1 + 4  # every block of every slot, the garbage page, four spare


def _pools(rng, dtype, quant):
    """(jax, torch) pools [P, HK, ps, D] (+ int8 scales)."""
    if quant:
        arrs = [rng.integers(-127, 128, (PAGES, HK, PS, D)).astype(np.int8) for _ in range(2)]
        arrs += [rng.uniform(1e-3, 2e-2, (PAGES, HK, PS)).astype(np.float32) for _ in range(2)]
        return [jnp.asarray(a) for a in arrs], [_t(a) for a in arrs]
    arrs = [rng.standard_normal((PAGES, HK, PS, D)).astype(np.float32) for _ in range(2)]
    return ([jnp.asarray(a).astype(getattr(jnp, dtype)) for a in arrs],
            [_t(a, TORCH_DT[dtype]) for a in arrs])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("quant", [False, True], ids=["dense", "int8"])
@pytest.mark.parametrize("g,window,softcap", [(1, 0, 0.0), (2, 40, 5.0)])
def test_decode_attention_paged_plain_vs_jax(dtype, quant, g, window, softcap):
    rng = np.random.default_rng(30 + g + 2 * quant)
    pos = np.array([NB * PS - 1, 17, 130, 64], np.int32)
    table = _table(rng, B, NB, PAGES, mapped=[p // PS + 1 for p in pos], share=(1, 0, 1))
    (jp, tp) = _pools(rng, dtype, quant)
    q = rng.standard_normal((B, HK * g, D)).astype(np.float32)
    jq, tq = jnp.asarray(q).astype(getattr(jnp, dtype)), _t(q, TORCH_DT[dtype])
    jkw = dict(k_scale=jp[2], v_scale=jp[3]) if quant else {}
    tkw = dict(k_scale=tp[2], v_scale=tp[3]) if quant else {}
    jargs = (jq, jp[0], jp[1], jnp.asarray(table), jnp.asarray(pos))
    targs = (tq, tp[0], tp[1], _t(table), _t(pos))
    got = da_ref.decode_attention_paged(*targs, window=window, softcap=softcap, **tkw)
    want_x = jA.decode_attention_paged(*jargs, window=window, softcap=softcap, impl="xla", **jkw)
    want_k = j_da_ops.decode_attention_paged(*jargs, window=window, softcap=softcap,
                                             interpret=True, **jkw)
    for want, tol in ((want_x, XLA_TOL[dtype]), (want_k, KERNEL_TOL[dtype])):
        np.testing.assert_allclose(_np(got), _np(want), atol=tol, rtol=tol)
    if window == 0:  # the model-level form, through the plain kernel set
        got_m = TA.decode_attention_paged(*targs, kernels=PLAIN, **tkw)
        assert torch.equal(got_m, got)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("quant", [False, True], ids=["dense", "int8"])
@pytest.mark.parametrize("g,window,softcap", [(1, 0, 0.0), (2, 40, 5.0)])
def test_prefill_append_paged_plain_vs_jax(dtype, quant, g, window, softcap):
    """Offsets 0, C and 2C, and one write-only slot at 3C = prefix_limit
    whose window maps the garbage page, as the engine's trash tail does."""
    rng = np.random.default_rng(40 + g + 2 * quant)
    off = np.array([0, C, 2 * C, 3 * C], np.int32)
    # each live slot maps its prefix and its chunk window, slot 2's first two
    # (prefix) pages are slot 1's, and slot 3 (write-only) maps nothing
    table = _table(rng, B, NB, PAGES, mapped=[o // PS + C // PS for o in off[:3]] + [0],
                   share=(2, 1, 2))
    jp, tp = _pools(rng, dtype, quant)
    q = rng.standard_normal((B, HK * g, C, D)).astype(np.float32)
    kn = rng.standard_normal((B, HK, C, D)).astype(np.float32)
    vn = rng.standard_normal((B, HK, C, D)).astype(np.float32)
    jd, td = getattr(jnp, dtype), TORCH_DT[dtype]
    jx = [jnp.asarray(a).astype(jd) for a in (q, kn, vn)]
    tx = [_t(a, td) for a in (q, kn, vn)]
    kw = dict(window=window, softcap=softcap, prefix_limit=3 * C)
    jkw = dict(k_scale=jp[2], v_scale=jp[3]) if quant else {}
    pools = [t.clone() for t in tp]
    tkw = dict(k_scale=pools[2], v_scale=pools[3]) if quant else {}
    got = pa_ref.prefill_append_paged(*tx, pools[0], pools[1], _t(table), _t(off), **tkw,
                                      **kw)
    jargs = (*jx, jp[0], jp[1], jnp.asarray(table), jnp.asarray(off))
    want_x = jA.prefill_append_attention_paged(*jargs, impl="xla", **jkw, **kw)
    want_k = j_pa_ops.prefill_append_paged(*jargs, interpret=True, **jkw, **kw)
    live = np.ones(PAGES, bool)
    live[0] = False  # the garbage page: content free
    for mine, ref_x, ref_k in zip(pools, want_x[1:], want_k[1:]):
        np.testing.assert_array_equal(_np(mine)[live], _np(ref_x)[live])
        if mine.dtype == torch.float32 and quant:
            np.testing.assert_allclose(_np(mine)[live], _np(ref_k)[live],
                                       rtol=SCALE_ULP[dtype], atol=0)
        else:
            np.testing.assert_array_equal(_np(mine)[live], _np(ref_k)[live])
    for want, tol in ((want_x[0], XLA_TOL[dtype]), (want_k[0], KERNEL_TOL[dtype])):
        np.testing.assert_allclose(_np(got)[:3], _np(want)[:3], atol=tol, rtol=tol)
    assert got[3].eq(0).all()  # the write-only slot's output rows
    if window == 0:  # the model-level form, through the plain kernel set
        pools_m = [t.clone() for t in tp]
        tkw_m = dict(k_scale=pools_m[2], v_scale=pools_m[3]) if quant else {}
        got_m = TA.prefill_append_attention_paged(
            *tx, pools_m[0], pools_m[1], _t(table), _t(off), kernels=PLAIN,
            prefix_limit=3 * C, **tkw_m)
        assert torch.equal(got_m, got)
        assert all(torch.equal(_bits(a)[1:], _bits(b_)[1:]) for a, b_ in zip(pools_m, pools))
        # chunks at unaligned offsets, each straddling page boundaries, on a
        # table that maps every block they write: the contiguous form on the
        # gathered view, output and written rows alike
        off_u = np.array([7, C + PS - 3, 2 * C + 1, 3 * C], np.int32)
        mapped_u = [-(-(o + C) // PS) for o in off_u[:3]]
        table_u = _t(_table(rng, B, NB, PAGES, mapped=mapped_u + [0], share=(2, 1, 2)))
        views = [TT.gather_kv_pages(t, table_u) for t in pools_m]
        vkw = dict(k_scale=views[2], v_scale=views[3]) if quant else {}
        twin = TA.prefill_append_attention(*tx, views[0], views[1], _t(off_u), kernels=PLAIN,
                                           prefix_limit=3 * C, **vkw)
        got_u = TA.prefill_append_attention_paged(*tx, pools_m[0], pools_m[1], table_u,
                                                  _t(off_u), kernels=PLAIN, prefix_limit=3 * C,
                                                  **tkw_m)
        assert torch.equal(got_u, twin)
        for pool, view in zip(pools_m, views):  # the rows of mapped blocks
            after = TT.gather_kv_pages(pool, table_u)
            for slot, n in enumerate(mapped_u):
                assert torch.equal(_bits(after[slot, :, :n * PS]), _bits(view[slot, :, :n * PS]))


def test_cache_specs_paged_match_jax():
    for kv in ("bf16", "int8"):
        jcfg = dataclasses.replace(get_config("tellme-0.7b", smoke=True), kv_cache_dtype=kv)
        tcfg = dataclasses.replace(t_get_config("tellme-0.7b", smoke=True), kv_cache_dtype=kv)
        shapes, _ = jTr.cache_specs(jcfg, 3, 512, kv_pages=17)
        got = TTr.cache_specs(tcfg, 3, 512, kv_pages=17)["blocks"]["b0"]
        want = shapes["blocks"]["b0"]
        assert set(got) == set(want)
        for name, (shape, dt) in got.items():
            assert shape == want[name].shape, name
            assert str(dt).split(".")[-1] == jnp.dtype(want[name].dtype).name


def test_scale_guard_judges_no_paged_pool():
    """resilience.py:118 judges only scale leaves with a sequence axis; the
    paged pools' have none, so NaN scales in a pool flag no slot on either
    side."""
    jcfg = dataclasses.replace(get_config("tellme-0.7b", smoke=True), kv_cache_dtype="int8")
    shapes, axes = jTr.cache_specs(jcfg, 3, 64, kv_pages=9)
    caches = jax.tree.map(lambda s: np.full(s.shape, np.nan, np.float32)
                          if s.dtype == jnp.float32 else np.zeros(s.shape, np.int8), shapes)
    rows = np.array([[4, 5], [4, 5], [6, 9]], np.int32)
    valid = np.ones((3, 2), bool)
    want = jR.scale_guard(jax.tree.map(jnp.asarray, caches), axes, jnp.asarray(rows),
                          jnp.asarray(valid))
    got = TR.scale_guard(jax.tree.map(torch.from_numpy, caches), _t(rows), _t(valid),
                         paged=True)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert not got.any()


# ---------------------------------------------------------------------------
# (d)-(g) the engine
# ---------------------------------------------------------------------------

MAX_LEN = 256
RAGGED = (9, 30, 70, 130, 200)


@pytest.fixture(scope="module")
def models():
    jcfg = dataclasses.replace(get_config("tellme-0.7b", smoke=True), dtype=jnp.float32)
    tcfg = dataclasses.replace(t_get_config("tellme-0.7b", smoke=True), dtype=torch.float32)
    specs = jTr.param_specs(jcfg)
    jp = jTr.pack_tree(P.init_params(specs, jax.random.PRNGKey(0)), specs)
    tp = interop.from_jax_params(jax.device_get(jp), tcfg, device="cpu")
    return jcfg, tcfg, jp, tp


def _prompts(lengths, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, n).astype(np.int32) for n in lengths]


def _drive(side, models, script, *, kv="bf16", layout="paged", num_pages=0, max_len=MAX_LEN,
           **engine_kw):
    """Run ``script`` on the JAX (``side="jax"``) or the port's engine;
    returns ({rid: (tokens, status, detail, preemptions, accepted)}, engine).
    Script items: ("submit", rid, prompt, max_new, request fields),
    ("step", n), ("cancel", rid), ("clock", t), ("run",), ("poison",)."""
    jcfg, tcfg, jp, tp = models
    over = dict(kv_cache_dtype=kv, kv_layout=layout, kv_num_pages=num_pages)
    now = [0.0]
    kw = dict(slots=2, max_len=max_len, clock=lambda: now[0], **engine_kw)
    if side == "jax":
        eng = jE.ServingEngine(jp, dataclasses.replace(jcfg, **over), mode="packed", **kw)
        Req = jE.Request
    else:
        eng = TE.ServingEngine(tp, dataclasses.replace(tcfg, **over), device="cpu",
                               kernels=PLAIN, **kw)
        Req = TE.Request
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
        elif op == "poison":  # NaN into every free page of every pool leaf
            assert side == "torch"
            free = torch.tensor(eng.paged.free_pages(), dtype=torch.int64)
            assert len(free) > 0
            for leaf in eng.caches["blocks"]["b0"].values():
                leaf[:, free] = (torch.iinfo(torch.int8).min if leaf.dtype == torch.int8
                                 else float("nan"))
    out = {rid: ([int(t) for t in r.generated], r.status.name, r.status_detail,
                 r.preemptions, accepted[rid]) for rid, r in reqs.items()}
    return out, eng


def _events(eng):
    return [{k: v for k, v in e.items()} for e in eng.events if e["kind"] in PAGED_EVENTS]


def _assert_same(models, script, **kw):
    want, jeng = _drive("jax", models, script, **kw)
    got, eng = _drive("torch", models, script, **kw)
    assert got == want
    st = eng.stats()
    assert st["kv_layout"] == "paged" and st["paged"] == jeng.stats()["paged"]
    assert _events(eng) == _events(jeng)
    assert st["host_transfers"] == eng.tick_count > 0
    return got, eng


def _submit_all(prompts, max_new, **fields):
    return [("submit", i, p, max_new, fields) for i, p in enumerate(prompts)]


def _scenario(name):
    """The scripted scenarios of tests/test_torch_engine.py, with extra
    engine arguments."""
    if name == "ragged":
        return _submit_all(_prompts(RAGGED), 8) + [("run",)], {}
    if name == "edge":
        ok, short, long_ = _prompts((40, 12, MAX_LEN), seed=1)
        return [("submit", 0, ok, 1, {}), ("submit", 1, long_, 4, {}),
                ("submit", 2, short, 5, {}), ("submit", 3, ok, 3, {}),
                ("submit", 4, short, 2, {}), ("run",)], {"queue_cap": 4}
    if name == "cancel_deadline":
        a, b, c, d = _prompts((20, 100, 50, 9), seed=2)
        return [("submit", 0, a, 20, {}), ("submit", 1, b, 20, {"deadline_s": 5.0}),
                ("submit", 2, c, 20, {}), ("submit", 3, d, 6, {"deadline_s": 5.0}),
                ("step", 4), ("cancel", 0), ("step", 1), ("clock", 6.0), ("run",)], {}
    if name == "preemption":
        a, b, c = _prompts((60, 90, 30), seed=3)
        return [("submit", 0, a, 12, {}), ("submit", 1, b, 12, {}), ("step", 5),
                ("submit", 2, c, 4, {"priority": 3}), ("run",)], {}
    raise KeyError(name)


@pytest.mark.parametrize("kv", ["bf16", "int8"])
@pytest.mark.parametrize("name", ["ragged", "edge", "cancel_deadline", "preemption"])
def test_paged_engine_equals_jax(models, kv, name):
    script, kw = _scenario(name)
    got, eng = _assert_same(models, script, kv=kv, **kw)
    # and the port's own contiguous layout gives the same streams
    contiguous, _ = _drive("torch", models, script, kv=kv, layout="contiguous", **kw)
    assert got == contiguous
    if name == "preemption":
        assert eng.stats()["preemptions"] == 1 and got[1][3] == 1


def test_paged_engine_eos_equals_jax(models):
    base, _ = _drive("jax", models, _submit_all(_prompts(RAGGED[:3]), 8) + [("run",)])
    eos = base[0][0][3]
    got, _ = _assert_same(models, _submit_all(_prompts(RAGGED[:3]), 8) + [("run",)],
                          eos_id=eos)
    assert got[0][0] == base[0][0][: base[0][0].index(eos) + 1] and got[0][1] == "OK"


def _shared_prefix_script(seed=11, tails=(32, 17, 8), max_new=4):
    """TestPrefixReuse's workload: a 320-token prefix with distinct tails;
    the first request runs alone, then the others."""
    rng = np.random.default_rng(seed)
    prefix = rng.integers(1, 256, 320)
    prompts = [np.concatenate([prefix, rng.integers(1, 256, n)]) for n in tails]
    script = [("submit", 0, prompts[0], max_new, {}), ("run",)]
    return script + [("submit", i, p, max_new, {}) for i, p in enumerate(prompts)
                     if i] + [("run",)]


@pytest.mark.parametrize("kv", ["bf16", "int8"])
def test_prefix_reuse_and_cow(models, kv):
    """Both followers map the 5 interned pages and prefill from 256 (the
    prefix floored to the largest chunk); their first chunk rewrites the
    shared page 4, which forks it. Streams equal the contiguous run."""
    script = _shared_prefix_script()
    got, eng = _assert_same(models, script, kv=kv, max_len=512)
    contiguous, _ = _drive("torch", models, script, kv=kv, layout="contiguous", max_len=512)
    assert got == contiguous
    st = eng.stats()["paged"]
    assert st["prefix_hits"] == 2 and st["prefix_hit_tokens"] == 2 * 256
    assert st["cow_forks"] >= 1 and st["prefix_hit_rate"] > 0
    kinds = {e["kind"] for e in eng.events}
    assert "prefix_hit" in kinds and "cow_fork" in kinds


@pytest.mark.parametrize("kv", ["bf16", "int8"])
def test_page_pool_exhaustion_equals_jax(models, kv):
    """A pool of the garbage page and 3 more: the 200-token prompt needs 4
    pages for its 256-chunk and fails, the others are served, the interned
    prefix is evicted for a later request."""
    a, b, c = _prompts((130, 200, 150), seed=5)
    script = [("submit", 0, a, 8, {}), ("submit", 1, b, 8, {}), ("run",),
              ("submit", 2, c, 8, {}), ("run",)]
    got, eng = _assert_same(models, script, kv=kv, num_pages=4)
    assert got[1][1:3] == ("FAILED", "page_pool_exhausted")
    assert got[0][1] == got[2][1] == "OK"
    assert [e["kind"] for e in eng.events].count("page_pool_exhausted") == 1
    assert eng.stats()["paged"]["evictions"] > 0


@pytest.mark.parametrize("kv", ["bf16", "int8"])
def test_free_pages_are_dead(models, kv):
    """NaN (int8: -128) in every free page between two runs changes no
    stream: a live table never reaches a free page, and the pages handed out
    again are written before any unmasked read. The followers' decode rows
    stay inside pages their chunks wrote: the plain versions, like JAX's
    XLA forms, multiply masked probabilities (exact zeros) by V, which a NaN
    left in a masked row of a freshly allocated page would turn into NaN."""
    script = _shared_prefix_script(seed=13, tails=(32, 17))
    poisoned = script[:2] + [("poison",)] + script[2:]
    clean, _ = _drive("torch", models, script, kv=kv, max_len=512)
    got, eng = _drive("torch", models, poisoned, kv=kv, max_len=512)
    assert got == clean and all(v[1] == "OK" for v in got.values())
    assert eng.stats()["paged"]["prefix_hits"] == 1


def test_engine_rejects_bad_paged_config(models):
    _, tcfg, _, tp = models
    with pytest.raises(ValueError, match="kv_page_size"):
        TE.ServingEngine(tp, dataclasses.replace(tcfg, kv_layout="paged", kv_page_size=48),
                         slots=1, max_len=256, device="cpu")
    with pytest.raises(ValueError, match="kv_layout"):
        TE.ServingEngine(tp, dataclasses.replace(tcfg, kv_layout="ring"), slots=1,
                         max_len=256, device="cpu")


def test_paged_pool_bytes(models):
    """The auto pool holds one page per slot and block plus the garbage page:
    (P / (slots * NB)) times the contiguous cache."""
    _, tcfg, _, tp = models
    for kv in ("bf16", "int8"):
        c = dataclasses.replace(tcfg, kv_cache_dtype=kv)
        contiguous = TE.ServingEngine(tp, c, slots=2, max_len=MAX_LEN, device="cpu")
        paged = TE.ServingEngine(tp, dataclasses.replace(c, kv_layout="paged"), slots=2,
                                 max_len=MAX_LEN, device="cpu")
        nb = paged.cache_len // c.kv_page_size
        assert paged.paged.num_pages == 2 * nb + 1
        assert (TE.cache_nbytes(paged.caches) * 2 * nb
                == TE.cache_nbytes(contiguous.caches) * (2 * nb + 1))
        assert contiguous.stats()["paged"] is None
