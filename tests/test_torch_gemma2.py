"""PyTorch port, Gemma-2 27B at its smoke config: local and global attention
layers (a sliding window of 16 on the local ones), the attention-logit
softcap (50) and the final-logit softcap (30), through the JAX package and
the port on the same packed weights (``interop.from_jax_params``), on the
same numpy inputs, f32 unless stated.

Bars:
* the plain ``flash_attention`` with ``window`` and ``softcap`` against the
  JAX package's XLA ``prefill_attention(window=, softcap=)``: 1e-5 in f32
  (one softmax over the row against an online softmax over four query
  chunks: rounding only), at G = 1 and 2, windows shorter than S and off
  the XLA form's query chunks; against the Pallas kernel in interpret mode
  and the oracle ``mha_reference`` at the JAX package's own bars for its
  kernel (2e-3 f32), a window of 1 among them;
* the config fields, the block plan (``b0`` local, ``b1`` global), the
  spec trees and the packed spec shapes and dtypes: equal to JAX's; the
  bridged tree equal to JAX's packed tree byte for byte;
* ``forward`` and ``decode_step`` logits at positions past the window,
  both KV-cache dtypes: within 1e-4 of max |logit| (2e-7 at these inputs:
  RoPE and XLA's fusions round differently by an ulp; an ulp can move one
  int8 code of a projection's input, which the bar leaves room for) and
  every row's argmax equal; the final softcap bounds every logit by 30;
* greedy streams of ``generate`` and of the chunked ``ServingEngine``
  (contiguous bf16 and int8 caches, the paged layout, speculative
  decoding) with prompts of 20 to 60 tokens against the window of 16 and
  chunks of 32: equal to JAX's ``mode="packed"`` ones token for
  token, with the same statuses, one host transfer a tick;
* ``fused=False`` equal to ``fused=True`` bit for bit (logits and caches),
  and both layer kinds take the fused branch: two norm-quant prologues a
  layer, none unfused.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config
from repro.core import params as P
from repro.kernels.flash_attention import ops as j_fa_ops
from repro.kernels.flash_attention import ref as j_fa_ref
from repro.models import attention as jA
from repro.models import transformer as jT
from repro.serving import engine as jE
from repro_torch import interop
from repro_torch.configs import get_config as t_get_config
from repro_torch.core import params as TP
from repro_torch.kernels import PLAIN
from repro_torch.kernels.flash_attention import ref as fa_ref
from repro_torch.models import transformer as TT
from repro_torch.serving import engine as TE

ARCH = "gemma2-27b"
LOGIT_TOL = 1e-4  # of max |logit|
MAX_LEN = 96
# chunks of 32 against the window of 16, so that a chunk's rows cross the
# window foot within the chunk and into the one before; pages of 16 divide
# the chunk; one chunk size keeps JAX's engine to one fused-tick compile
ENGINE_FIELDS = dict(prefill_chunk_sizes=(32,), kv_page_size=16)


@pytest.fixture(scope="module")
def models():
    """(JAX config, port config, JAX packed tree, port tree)."""
    jcfg = dataclasses.replace(get_config(ARCH, smoke=True), dtype=jnp.float32)
    tcfg = dataclasses.replace(t_get_config(ARCH, smoke=True), dtype=torch.float32)
    specs = jT.param_specs(jcfg)
    latent = P.init_params(specs, jax.random.PRNGKey(0))
    jp = jax.jit(lambda w: jT.pack_tree(w, specs))(latent)
    tp = interop.from_jax_params(jax.device_get(jp), tcfg, device="cpu")
    return jcfg, tcfg, jp, tp


def _tokens(b, s, seed):
    return np.random.default_rng(seed).integers(0, 256, (b, s)).astype(np.int32)


def _close(got, want, tol=LOGIT_TOL):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    err = np.abs(got - want).max() / np.abs(want).max()
    assert err <= tol, err
    assert (got.argmax(-1) == want.argmax(-1)).all()


# ---------------------------------------------------------------------------
# the plain flash attention with a window and a softcap
# ---------------------------------------------------------------------------

XLA_TOL = 1e-5
HK, D = 2, 32


def _attn_inputs(g, s, seed):
    """f32 q, k, v as torch tensors and as JAX arrays."""
    rng = np.random.default_rng(seed)
    q = 3 * rng.standard_normal((2, HK * g, s, D)).astype(np.float32)
    k = rng.standard_normal((2, HK, s, D)).astype(np.float32)
    v = rng.standard_normal((2, HK, s, D)).astype(np.float32)
    return [torch.from_numpy(a) for a in (q, k, v)], [jnp.asarray(a) for a in (q, k, v)]


# (G, S, window, softcap): S = 200 splits into the XLA form's four query
# chunks of 50, which no window here divides
WINDOW_CASES = [(1, 200, 37, 50.0), (2, 128, 100, 5.0)]


@pytest.mark.parametrize("g,s,window,softcap", WINDOW_CASES)
def test_flash_attention_window_softcap_matches_jax_xla(g, s, window, softcap):
    (q, k, v), (jq, jk, jv) = _attn_inputs(g, s, seed=s + 10 * g + window)
    got = fa_ref.flash_attention(q, k, v, window=window, softcap=softcap)
    want = jA.prefill_attention(jq, jk, jv, window=window, softcap=softcap)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=XLA_TOL, rtol=XLA_TOL)
    causal = fa_ref.flash_attention(q, k, v, softcap=softcap)
    assert not torch.equal(got, causal)  # the window acts at these lengths


@pytest.mark.parametrize("g,window,softcap", [(1, 37, 50.0), (2, 1, 0.0)])
def test_flash_attention_window_softcap_matches_jax_kernel(g, window, softcap):
    """Against the Pallas kernel (interpret mode; its window skip at
    ``kernel.py:49-54``, its element mask at ``:68-75``) and the oracle."""
    (q, k, v), (jq, jk, jv) = _attn_inputs(g, 200, seed=window)
    got = fa_ref.flash_attention(q, k, v, window=window, softcap=softcap).numpy()
    for want in (j_fa_ops.flash_attention(jq, jk, jv, window=window, softcap=softcap),
                 j_fa_ref.mha_reference(jq, jk, jv, window=window, softcap=softcap)):
        np.testing.assert_allclose(got, np.asarray(want), atol=2e-3, rtol=2e-3)


# ---------------------------------------------------------------------------
# config, plan, specs, weights
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("smoke", [False, True])
def test_config_plan_and_specs_match_jax(smoke):
    from repro.core.params import _iter_specs

    jc, tc = get_config(ARCH, smoke=smoke), t_get_config(ARCH, smoke=smoke)
    for f in dataclasses.fields(tc):
        if f.name != "dtype":
            assert getattr(tc, f.name) == getattr(jc, f.name), f.name
    assert (tc.sliding_window, tc.local_global_period) == ((16, 2) if smoke else (4096, 2))
    jpre, jper, jn = jT.block_plan(jc)
    tpre, tper, tn = TT.block_plan(tc)
    assert jpre == tpre == []
    assert [(k.mixer, k.ffn, k.local) for k in tper] == [(k.mixer, k.ffn, k.local) for k in jper]
    assert [k.local for k in tper] == [True, False] and tn == jn == tc.n_layers // 2
    want = {p: s.shape for p, s in _iter_specs(jT.param_specs(jc))}
    got = {}
    TP.map_specs(lambda p, s: got.__setitem__(p, s.shape), TT.param_specs(tc))
    assert got == want and set(TT.param_specs(tc)["blocks"]) == {"b0", "b1"}
    want = {p: (tuple(s.shape), np.dtype(s.dtype).name)
            for p, s in _iter_specs(jT.packed_param_specs(jc))}
    got = {"/" + "/".join(p): (tuple(shape), str(dt).removeprefix("torch."))
           for p, (shape, dt) in _spec_leaves(TT.packed_param_specs(tc))}
    assert got == want


def _spec_leaves(tree, path=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _spec_leaves(v, path + (k,))
        else:
            yield path + (k,), v


def test_from_jax_params_keeps_bytes(models):
    _, tcfg, jp, tp = models
    want = dict(TT.tree_leaves(jax.device_get(jp)))
    got = dict(TT.tree_leaves(tp))
    assert set(got) == set(want)
    for path, t in got.items():
        assert np.array_equal(t.numpy(), np.asarray(want[path])), path
    assert got[("blocks", "b0", "attn", "q", "wp")].shape[0] == tcfg.n_layers // 2


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kv", ["bf16", "int8"])
def test_forward_and_decode_past_the_window(models, kv):
    jcfg, tcfg, jp, tp = models
    jcfg, tcfg = (dataclasses.replace(c, kv_cache_dtype=kv) for c in (jcfg, tcfg))
    toks = _tokens(2, 40, 1)
    want, _, jc = jT.forward(jp, {"tokens": jnp.asarray(toks)}, jcfg, mode="packed",
                             collect_cache=True)
    got, tc = TT.forward(tp, torch.from_numpy(toks).long(), tcfg, kernels=PLAIN,
                         collect_cache=True)
    _close(got.numpy(), want)
    assert got.abs().max() < tcfg.final_logit_softcap
    for path, a in TT.tree_leaves(jax.device_get(jc)):
        assert tuple(TT.tree_get(tc, path).shape) == a.shape, path
    jc, tc = jE.grow_caches(jc, jcfg, 48), TE.grow_caches(tc, tcfg, 48)
    pos = np.array([40, 33], np.int32)  # 24 and 17 rows past the window of 16
    nxt = _tokens(2, 1, 2)
    want, _ = jT.decode_step(jp, {"tokens": jnp.asarray(nxt)}, jc, jnp.asarray(pos), jcfg,
                             mode="packed")
    got, _ = TT.decode_step(tp, torch.from_numpy(nxt).long(), tc, torch.from_numpy(pos), tcfg,
                            kernels=PLAIN)
    _close(got.numpy(), want)


def test_final_softcap_and_window_act(models):
    """The head caps ``30 tanh(z / 30)`` of the uncapped logits, and the
    local layer's window changes what a row past it sees."""
    _, tcfg, _, tp = models
    toks = torch.from_numpy(_tokens(1, 40, 3)).long()
    capped, _ = TT.forward(tp, toks, tcfg, kernels=PLAIN)
    raw, _ = TT.forward(tp, toks, dataclasses.replace(tcfg, final_logit_softcap=0.0),
                        kernels=PLAIN)
    torch.testing.assert_close(capped, 30.0 * torch.tanh(raw / 30.0), atol=1e-6, rtol=0)
    unwindowed, _ = TT.forward(tp, toks, dataclasses.replace(tcfg, sliding_window=0),
                               kernels=PLAIN)
    assert torch.equal(capped[:, :16], unwindowed[:, :16])  # rows the window does not cut
    assert not torch.equal(capped[:, 16:], unwindowed[:, 16:])


def test_generate_streams_equal_jax(models):
    jcfg, tcfg, jp, tp = models
    toks = _tokens(3, 30, 4)
    want = jE.generate(jp, jcfg, jnp.asarray(toks), steps=12, mode="packed")
    got = TE.generate(tp, tcfg, toks, steps=12, kernels=PLAIN, device="cpu")
    assert np.array_equal(got.tokens.numpy(), np.asarray(want.tokens))


def _prompts(seed=3):
    rng = np.random.default_rng(seed)
    return [(rng.integers(0, 256, n).astype(np.int32), m)
            for n, m in ((20, 12), (45, 8), (60, 10), (33, 1), (25, 12))]


def _serve(side, models, prompts, *, kv, layout, speculative, eos_id=-1):
    jcfg, tcfg, jp, tp = models
    fields = dict(ENGINE_FIELDS, kv_cache_dtype=kv, kv_layout=layout)
    kw = dict(prefill="chunked", slots=2, max_len=MAX_LEN, speculative=speculative,
              eos_id=eos_id)
    if side == "jax":
        eng = jE.ServingEngine(jp, dataclasses.replace(jcfg, **fields), mode="packed", **kw)
        Req = jE.Request
    else:
        eng = TE.ServingEngine(tp, dataclasses.replace(tcfg, **fields), kernels=PLAIN,
                               device="cpu", **kw)
        Req = TE.Request
    reqs = [Req(rid=i, prompt=p, max_new=n) for i, (p, n) in enumerate(prompts)]
    for r in reqs:
        eng.submit(r)
    eng.run()
    return [([int(t) for t in r.generated], r.status.name) for r in reqs], eng


@pytest.mark.parametrize("kv,layout,speculative", [
    ("bf16", "contiguous", False), ("int8", "contiguous", False), ("bf16", "paged", False),
    ("bf16", "contiguous", True)])
def test_chunked_engine_streams_equal_jax(models, kv, layout, speculative):
    prompts = _prompts()
    want, _ = _serve("jax", models, prompts, kv=kv, layout=layout, speculative=speculative)
    got, eng = _serve("torch", models, prompts, kv=kv, layout=layout, speculative=speculative)
    assert got == want and all(s == "OK" for _, s in got)
    st = eng.stats()
    assert eng.prefill == "chunked" and st["host_transfers"] == st["ticks"] > 0
    assert st["fused_ticks"] > 0 and (st["spec_ticks"] > 0) == speculative


def test_unfused_is_bit_identical_and_both_kinds_fuse(models):
    """On the plain versions the unfused branch gives the fused branch's
    logits and caches bit for bit; the fused branch is taken by the local
    and the global layer alike: two norm-quant prologues a layer in a
    forward, a decode step and a chunk step, and none with ``fused=False``."""
    _, tcfg, _, tp = models
    calls = []

    def counting(*a, **kw):
        calls.append(1)
        return PLAIN.norm_quant(*a, **kw)

    kset = dataclasses.replace(PLAIN, norm_quant=counting)
    toks = torch.from_numpy(_tokens(2, 21, 5)).long()
    lf, cf = TT.forward(tp, toks, tcfg, kernels=kset, collect_cache=True)
    assert len(calls) == 2 * tcfg.n_layers
    lu, cu = TT.forward(tp, toks, tcfg, kernels=kset, collect_cache=True, fused=False)
    assert len(calls) == 2 * tcfg.n_layers
    assert torch.equal(lf, lu)
    for (p, a), (_, b) in zip(TT.tree_leaves(cf), TT.tree_leaves(cu)):
        assert torch.equal(a, b), p
    cf, cu = TE.grow_caches(cf, tcfg, 32), TE.grow_caches(cu, tcfg, 32)
    pos = torch.tensor([21, 18], dtype=torch.int32)
    df, _ = TT.decode_step(tp, toks[:, :1], cf, pos, tcfg, kernels=kset)
    du, _ = TT.decode_step(tp, toks[:, :1], cu, pos, tcfg, kernels=kset, fused=False)
    assert torch.equal(df, du) and len(calls) == 4 * tcfg.n_layers
    chunk = torch.from_numpy(_tokens(2, 8, 6)).long()
    off = torch.tensor([22, 19], dtype=torch.int32)
    ff, _ = TT.prefill_chunk_step(tp, chunk, cf, off, tcfg, kernels=kset)
    fu, _ = TT.prefill_chunk_step(tp, chunk, cu, off, tcfg, kernels=kset, fused=False)
    assert torch.equal(ff, fu) and len(calls) == 6 * tcfg.n_layers
    for (p, a), (_, b) in zip(TT.tree_leaves(cf), TT.tree_leaves(cu)):
        assert torch.equal(a, b), p
