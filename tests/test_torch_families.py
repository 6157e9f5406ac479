"""PyTorch port, the MoE families: DeepSeek-V2-Lite (``mla_moe``: MLA, a
dense first layer, routed and shared experts) and Arctic (``moe``:
attention, routed experts beside a dense residual MLP), and the dense
configs granite-8b, internlm2-20b, llama3-405b, musicgen-medium and
internvl2-26b (config fields, plans, spec trees and ``generate``) at their
smoke configs, through the JAX package and the port on the same packed weights
(``interop.from_jax_params``), on the same numpy inputs, f32 unless stated.

Bars:
* the block plan, the spec trees, the packed spec shapes and dtypes, the
  packed bytes of the same latents, and the config fields: equal to JAX's;
  the absmean weight scales within 1e-6 (an f32 mean, summed in another
  order);
* ``forward`` logits within 2 % of max |logit| and every row's argmax
  equal; ``decode_step`` logits likewise. Each block agrees with JAX's to
  f32 ulps from the same input (``test_torch_mla.py``,
  ``test_torch_moe.py``), but an ulp in a reduction (``c_kv``'s RMS norm,
  a router sum) can cross a rounding boundary of ``quantize_act`` and move
  one int8 code of a projection's input, which later layers carry (0.9 %
  of max |logit| at these inputs);
* greedy ``generate`` streams of the five dense configs from tokens:
  equal to JAX's ``mode="packed"`` ones token for token;
* greedy streams of ``generate`` and of the legacy ``ServingEngine``
  (ragged prompts, more requests than slots, ``max_new=1``; an EOS on
  Arctic; decode ticks that drop choices, with idle slots ahead of live
  ones):
  equal to JAX's ``mode="packed"`` ones token for token, with the same
  statuses; Arctic also under the int8 KV cache;
* DeepSeek's refusals of the chunked and paged paths (JAX's MLA mixer
  refuses both, ``transformer.py:389-392, 417-421``), Arctic's ``"auto"``
  resolving to the legacy prefill and ``speculative=True`` then staying
  plain decode, as in JAX (Arctic's chunked, paged and speculative engines
  are ``test_torch_moe_engine.py``'s);
* tellme-0.7b smoke: ``fused=False`` equal to ``fused=True`` bit for bit
  (logits, caches and streams) on the plain versions;
* the engine's cache walks on DeepSeek's tree (a prelude, MLA latents with
  the sequence on axis 1 or 2): growing and cropping equal to JAX's
  ``grow_caches``/``fit_caches``, the live view, the slot write of a legacy
  prefill, ``cache_nbytes``; the scale guard does not trip on MLA leaves.
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
from repro_torch import interop
from repro_torch.configs import get_config as t_get_config
from repro_torch.core import params as TP
from repro_torch.kernels import PLAIN
from repro_torch.models import transformer as TT
from repro_torch.serving import engine as TE
from repro_torch.serving import resilience as TR

ARCHS = ("deepseek-v2-lite-16b", "arctic-480b")
# the dense configs of the last slice: GQA groups of 6 and 16, RoPE theta
# 500000, and the two with a frontend (their embeddings path is
# test_torch_frontend.py's; here they run from tokens)
DENSE_ARCHS = ("granite-8b", "internlm2-20b", "llama3-405b", "musicgen-medium",
               "internvl2-26b")
LOGIT_TOL = 2e-2  # of max |logit|
STEPS = 10
MAX_LEN = 64


def _setup(arch, **fields):
    jcfg = dataclasses.replace(get_config(arch, smoke=True), dtype=jnp.float32, **fields)
    tcfg = dataclasses.replace(t_get_config(arch, smoke=True), dtype=torch.float32, **fields)
    specs = jT.param_specs(jcfg)
    latent = P.init_params(specs, jax.random.PRNGKey(0))
    # JAX's pack under one jit: the same bits as eager, a third of the time
    jp = jax.jit(lambda w: jT.pack_tree(w, specs))(latent)
    tp = interop.from_jax_params(jax.device_get(jp), tcfg, device="cpu")
    return jcfg, tcfg, jp, tp, latent


@pytest.fixture(scope="module")
def built():
    return {arch: _setup(arch) for arch in ARCHS}


@pytest.fixture(scope="module")
def models(built):
    """{arch: (JAX config, port config, JAX packed tree, port tree)}."""
    return {arch: b[:4] for arch, b in built.items()}


def _tokens(b, s, seed):
    return np.random.default_rng(seed).integers(0, 256, (b, s)).astype(np.int32)


PREFILL_TOKENS = _tokens(2, 13, 1)


@pytest.fixture(scope="module")
def jax_prefills(models):
    """JAX's forward of PREFILL_TOKENS per arch: (logits, caches), once a file."""
    out = {}
    for arch, (jcfg, _, jp, _) in models.items():
        logits, _, caches = jT.forward(jp, {"tokens": jnp.asarray(PREFILL_TOKENS)}, jcfg,
                                       mode="packed", collect_cache=True)
        out[arch] = (logits, caches)
    return out


def _close(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    err = np.abs(got - want).max() / np.abs(want).max()
    assert err <= LOGIT_TOL, err
    assert (got.argmax(-1) == want.argmax(-1)).all()


def _shapes(tree):
    return {"/".join(p): tuple(t.shape) for p, t in TT.tree_leaves(tree)}


# ---------------------------------------------------------------------------
# configs, plans, specs
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCHS + ("jamba-v0.1-52b",) + DENSE_ARCHS)
def test_config_fields_match_jax(arch):
    for smoke in (False, True):
        tc, jc = t_get_config(arch, smoke=smoke), get_config(arch, smoke=smoke)
        for f in dataclasses.fields(tc):
            if f.name != "dtype":
                assert getattr(tc, f.name) == getattr(jc, f.name), f.name


@pytest.mark.parametrize("arch", ARCHS + ("tellme-0.7b", "rwkv6-3b", "jamba-v0.1-52b")
                         + DENSE_ARCHS)
@pytest.mark.parametrize("smoke", [False, True])
def test_block_plan_and_specs_match_jax(arch, smoke):
    """The plan's kinds and counts, every leaf's path and shape, and the
    packed serving tree's shapes and dtypes."""
    from repro.core.params import _iter_specs

    jc, tc = get_config(arch, smoke=smoke), t_get_config(arch, smoke=smoke)
    jpre, jper, jn = jT.block_plan(jc)
    tpre, tper, tn = TT.block_plan(tc)
    assert [(k.mixer, k.ffn) for k in jpre] == [(k.mixer, k.ffn) for k in tpre]
    assert [(k.mixer, k.ffn) for k in jper] == [(k.mixer, k.ffn) for k in tper]
    assert jn == tn
    want = {p: s.shape for p, s in _iter_specs(jT.param_specs(jc))}
    got = {}
    TP.map_specs(lambda p, s: got.__setitem__(p, s.shape), TT.param_specs(tc))
    assert got == want
    want = {p: (tuple(s.shape), np.dtype(s.dtype).name)
            for p, s in _iter_specs(jT.packed_param_specs(jc))}
    got = {"/" + "/".join(p): (tuple(shape), str(dt).removeprefix("torch."))
           for p, (shape, dt) in _spec_leaves(TT.packed_param_specs(tc))}
    assert got == want


def _spec_leaves(tree, path=()):
    """(path, (shape, dtype)) of a ``packed_param_specs`` tree."""
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _spec_leaves(v, path + (k,))
        else:
            yield path + (k,), v


@pytest.mark.parametrize("arch", ARCHS)
def test_pack_tree_bytes_and_interop(built, arch):
    """The same latents packed by the port give JAX's bytes and scales; the
    bridged tree keeps the f32 router, the 3-D/4-D packed experts and the
    norm scales as they are."""
    jcfg, tcfg, jp, tp, latent = built[arch]
    latent = jax.device_get(latent)
    want = jax.device_get(jp)
    t_latent = jax.tree.map(lambda a: torch.from_numpy(np.array(a)), latent)
    got = TT.pack_tree(t_latent, TT.param_specs(tcfg))
    want_leaves = dict(TT.tree_leaves(want))
    for path, t in TT.tree_leaves(got):  # the absmean scales sum in another order
        if path[-1] == "scale":
            np.testing.assert_allclose(t.numpy(), want_leaves[path], rtol=1e-6, err_msg=path)
        else:
            assert np.array_equal(t.numpy(), np.asarray(want_leaves[path])), path
    assert set(dict(TT.tree_leaves(got))) == set(want_leaves)
    blk = tp["blocks"]["b0"]
    assert blk["ffn"]["moe"]["router"]["w"].dtype == torch.float32
    assert blk["ffn"]["moe"]["gate"]["wp"].dtype == torch.uint8
    assert blk["ffn"]["moe"]["gate"]["wp"].ndim == 4 and blk["ffn"]["moe"]["gate"]["scale"].ndim == 2
    if arch.startswith("deepseek"):
        assert tp["prelude_0"]["attn"]["kv_norm"]["gamma"].shape == (tcfg.kv_lora_rank,)
        assert tp["prelude_0"]["ffn"]["gate"]["wp"].ndim == 2
    for path, t in TT.tree_leaves(tp):
        assert np.array_equal(t.numpy(), np.asarray(want_leaves[path])), path


@pytest.mark.parametrize("arch", ARCHS + ("jamba-v0.1-52b",))
def test_packed_init_equals_pack_of_init(arch):
    tcfg = t_get_config(arch, smoke=True)
    specs = TT.param_specs(tcfg)
    want = TT.pack_tree(TP.init_params(specs, 3, "cpu"), specs, dtype=torch.bfloat16)
    got = TP.init_packed_params(specs, 3, "cpu", dtype=torch.bfloat16,
                                dense_leaves=TT.DENSE_LEAVES)
    want_leaves = dict(TT.tree_leaves(want))
    assert set(dict(TT.tree_leaves(got))) == set(want_leaves)
    for path, t in TT.tree_leaves(got):
        assert t.dtype == want_leaves[path].dtype and torch.equal(t, want_leaves[path]), path
    if arch.startswith("jamba"):  # JAX's "ones" ignores dt_proj.b's -4.6 scale
        b = got["blocks"]["b0"]["mamba"]["dt_proj"]["b"]
        assert torch.equal(b, torch.ones_like(b))


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_and_decode_step(models, jax_prefills, arch):
    jcfg, tcfg, jp, tp = models[arch]
    want, jc = jax_prefills[arch]
    got, tc = TT.forward(tp, torch.from_numpy(PREFILL_TOKENS).long(), tcfg, kernels=PLAIN,
                         collect_cache=True)
    _close(got.numpy(), want)
    assert _shapes(tc) == {"/".join(p): tuple(a.shape) for p, a in TT.tree_leaves(jc)}
    # one decode step at ragged positions on the prefill caches grown to 20
    jc = jE.grow_caches(jc, jcfg, 20)
    tc = TE.grow_caches(tc, tcfg, 20)
    pos = np.array([13, 7], np.int32)
    nxt = _tokens(2, 1, 2)
    want, _ = jT.decode_step(jp, {"tokens": jnp.asarray(nxt)}, jc, jnp.asarray(pos), jcfg,
                             mode="packed")
    got, _ = TT.decode_step(tp, torch.from_numpy(nxt).long(), tc, torch.from_numpy(pos),
                            tcfg, kernels=PLAIN)
    _close(got.numpy(), want)


@pytest.mark.parametrize("arch", ARCHS)
def test_generate_streams_equal_jax(models, arch):
    jcfg, tcfg, jp, tp = models[arch]
    toks = _tokens(3, 13, 3)
    want = jE.generate(jp, jcfg, jnp.asarray(toks), steps=STEPS, mode="packed")
    got = TE.generate(tp, tcfg, toks, steps=STEPS, kernels=PLAIN, device="cpu")
    assert np.array_equal(got.tokens.numpy(), np.asarray(want.tokens))


@pytest.mark.parametrize("arch", DENSE_ARCHS)
def test_dense_generate_streams_equal_jax(arch):
    """Greedy ``generate`` from tokens on each smoke config, exact in f32;
    musicgen-medium and internvl2-26b embed the tokens through the table."""
    jcfg, tcfg, jp, tp, _ = _setup(arch)
    toks = _tokens(2, 11, 6)
    want = jE.generate(jp, jcfg, jnp.asarray(toks), steps=STEPS, mode="packed")
    got = TE.generate(tp, tcfg, toks, steps=STEPS, kernels=PLAIN, device="cpu")
    assert np.array_equal(got.tokens.numpy(), np.asarray(want.tokens))


def _serve(side, cfgs, prompts, slots=2, **kw):
    jcfg, tcfg, jp, tp = cfgs
    if side == "jax":
        eng = jE.ServingEngine(jp, jcfg, mode="packed", prefill="legacy", slots=slots,
                               max_len=MAX_LEN, **kw)
        Req = jE.Request
    else:
        eng = TE.ServingEngine(tp, tcfg, slots=slots, max_len=MAX_LEN, kernels=PLAIN,
                               device="cpu", **kw)
        Req = TE.Request
    reqs = [Req(rid=i, prompt=p, max_new=n) for i, (p, n) in enumerate(prompts)]
    for r in reqs:
        eng.submit(r)
    eng.run()
    return [([int(t) for t in r.generated], r.status.name) for r in reqs], eng


def _prompts(seed=4):
    rng = np.random.default_rng(seed)
    return [(rng.integers(0, 256, n).astype(np.int32), m)
            for n, m in ((5, 8), (17, 1), (9, 8), (30, 6), (3, 8))]


@pytest.mark.parametrize("arch,kv", [(ARCHS[0], "bf16"), (ARCHS[1], "bf16"),
                                     (ARCHS[1], "int8")])
def test_legacy_engine_streams_equal_jax(models, arch, kv):
    jcfg, tcfg, jp, tp = models[arch]
    cfgs = (dataclasses.replace(jcfg, kv_cache_dtype=kv),
            dataclasses.replace(tcfg, kv_cache_dtype=kv), jp, tp)
    prompts = _prompts()
    want, _ = _serve("jax", cfgs, prompts)
    got, eng = _serve("torch", cfgs, prompts)
    assert got == want and all(s == "OK" for _, s in got)
    assert eng.prefill == "legacy"
    assert eng.stats()["host_transfers"] == eng.tick_count > 0
    if (arch, kv) == (ARCHS[1], "bf16"):  # an EOS mid-stream: the first request's third token
        eos = want[0][0][2]
        want, _ = _serve("jax", cfgs, prompts[:2], eos_id=eos)
        got, _ = _serve("torch", cfgs, prompts[:2], eos_id=eos)
        assert got == want


def test_legacy_engine_with_decode_drops():
    """Arctic's smoke config cut to 4 experts at capacity factor 0.25: with
    8 slots a decode tick routes 16 choices into 4 experts of 4 slots, so
    choices drop. The first four requests retire after 2 tokens, and their
    idle slots' rows (their last token at their own position, as JAX feeds
    them) come first in the slots' capacity order; the streams of the four
    live slots after them equal JAX's."""
    cfgs = _setup("arctic-480b", n_experts=4, capacity_factor=0.25)[:4]
    assert TT.moe_mod.group_shape(8, 1024, 2, 0.25, 4) == (1, 8, 4)
    rng = np.random.default_rng(7)
    prompts = [(rng.integers(0, 256, 6).astype(np.int32), 2 if i < 4 else 12)
               for i in range(8)]
    want, _ = _serve("jax", cfgs, prompts, slots=8)
    got, eng = _serve("torch", cfgs, prompts, slots=8)
    assert got == want and all(s == "OK" for _, s in got)
    assert eng.stats()["host_transfers"] == eng.tick_count > 0


@pytest.mark.parametrize("arch", ARCHS)
def test_chunked_and_paged_refused_speculative_stays_plain(models, arch):
    """The MLA family refuses the chunked and paged paths, as JAX's
    ``apply_block`` does; the moe family runs them when asked (its streams
    are held in ``test_torch_moe_engine.py``). Both resolve ``"auto"`` to
    the legacy prefill, where ``speculative=True`` stays plain decode."""
    _, tcfg, _, tp = models[arch]
    caches = TT.cache_zeros(tcfg, 1, MAX_LEN, "cpu")
    chunk = (tp, torch.zeros((1, 64), dtype=torch.long), caches,
             torch.zeros(1, dtype=torch.int32), tcfg)
    if tcfg.family == "mla_moe":
        with pytest.raises(ValueError, match="transformer.py:389-392, 417-421"):
            TE.ServingEngine(tp, tcfg, slots=1, max_len=MAX_LEN, prefill="chunked",
                             device="cpu")
        with pytest.raises(ValueError, match="transformer.py:389-392, 417-421"):
            TE.ServingEngine(tp, dataclasses.replace(tcfg, kv_layout="paged"), slots=1,
                             max_len=MAX_LEN, device="cpu")
        with pytest.raises(NotImplementedError, match="transformer.py:417-421"):
            TT.prefill_chunk_step(*chunk, kernels=PLAIN)
        with pytest.raises(NotImplementedError, match="transformer.py:389-392"):
            TT.cache_specs(tcfg, 1, 64, kv_pages=4)
    else:
        eng = TE.ServingEngine(tp, dataclasses.replace(tcfg, kv_layout="paged"), slots=1,
                               max_len=MAX_LEN, prefill="chunked", kernels=PLAIN, device="cpu")
        assert eng.paged is not None
        logits, _ = TT.prefill_chunk_step(*chunk, kernels=PLAIN)
        assert logits.shape == (1, 64, tcfg.padded_vocab)
        assert TT.cache_specs(tcfg, 1, 64, kv_pages=4)["blocks"]["b0"]["k"][0][1] == 4
    eng = TE.ServingEngine(tp, tcfg, slots=2, max_len=MAX_LEN, kernels=PLAIN, device="cpu",
                           speculative=True)
    assert not eng.speculative and eng.prefill == "legacy"


def test_unfused_dense_block_is_bit_identical():
    """tellme-0.7b smoke on the plain versions: the unfused branch (float
    rows, each projection quantizing its input, residual adds after) gives
    the fused int8-resident branch's logits, caches and streams bit for bit."""
    tcfg = dataclasses.replace(t_get_config("tellme-0.7b", smoke=True), dtype=torch.float32)
    specs = TT.param_specs(tcfg)
    tp = TP.init_packed_params(specs, 0, "cpu", dense_leaves=TT.DENSE_LEAVES)
    toks = torch.from_numpy(_tokens(2, 21, 5)).long()
    lf, cf = TT.forward(tp, toks, tcfg, kernels=PLAIN, collect_cache=True)
    lu, cu = TT.forward(tp, toks, tcfg, kernels=PLAIN, collect_cache=True, fused=False)
    assert torch.equal(lf, lu)
    for (p, a), (_, b) in zip(TT.tree_leaves(cf), TT.tree_leaves(cu)):
        assert torch.equal(a, b), p
    cf, cu = TE.grow_caches(cf, tcfg, 24), TE.grow_caches(cu, tcfg, 24)
    pos = torch.tensor([21, 15], dtype=torch.int32)
    nxt = toks[:, :1]
    df, _ = TT.decode_step(tp, nxt, cf, pos, tcfg, kernels=PLAIN)
    du, _ = TT.decode_step(tp, nxt, cu, pos, tcfg, kernels=PLAIN, fused=False)
    assert torch.equal(df, du)
    for (p, a), (_, b) in zip(TT.tree_leaves(cf), TT.tree_leaves(cu)):
        assert torch.equal(a, b), p
    want = TE.generate(tp, tcfg, toks, steps=6, kernels=PLAIN, device="cpu").tokens
    last, caches = TE.prefill_bucketed(tp, tcfg, toks, kernels=PLAIN)
    caches = TE.fit_caches(caches, tcfg, toks.shape[1] + 6)
    tok, p = last.argmax(-1).to(torch.int32), torch.full((2,), toks.shape[1], dtype=torch.int32)
    got = [tok]
    for _ in range(5):
        logits, caches = TT.decode_step(tp, tok[:, None].long(), caches, p, tcfg,
                                        kernels=PLAIN, fused=False)
        tok, p = logits.argmax(-1).to(torch.int32), p + 1
        got.append(tok)
    assert torch.equal(torch.stack(got, 1), want)


# ---------------------------------------------------------------------------
# the engine's cache walks
# ---------------------------------------------------------------------------


def test_cache_walks_on_a_prelude_tree(models, jax_prefills):
    jcfg, tcfg, jp, tp = models[ARCHS[0]]
    assert TT.cache_layout(tcfg) == {
        ("prelude_0", "c_kv"): (0, 1), ("prelude_0", "k_rope"): (0, 1),
        ("blocks", "b0", "c_kv"): (1, 2), ("blocks", "b0", "k_rope"): (1, 2)}
    toks = PREFILL_TOKENS
    jc = jax_prefills[ARCHS[0]][1]
    tc = jax.tree.map(lambda a: torch.from_numpy(np.array(a)), jax.device_get(jc))
    for fn, jfn, n in ((TE.grow_caches, jE.grow_caches, 19), (TE.fit_caches, jE.fit_caches, 19),
                       (TE.fit_caches, jE.fit_caches, 6)):
        got, want = fn(tc, tcfg, n), jax.device_get(jfn(jc, jcfg, n))
        for path, a in TT.tree_leaves(got):
            assert np.array_equal(a.numpy(), np.asarray(TT.tree_get(want, path))), path
    assert TE.cache_nbytes(tc) == jE.cache_nbytes(jc)
    frontier = torch.tensor([13, 4], dtype=torch.int32)
    live = TE.live_cache_state(tc, tcfg, frontier)
    for path, a in TT.tree_leaves(live):
        full = TT.tree_get(tc, path)
        seq = TT.cache_layout(tcfg)[path][1]
        for b, f in enumerate(frontier.tolist()):
            row = a.select(seq - 1, b)  # the batch axis is just before the sequence axis
            ref = full.select(seq - 1, b)
            assert torch.equal(row.narrow(seq - 1, 0, f), ref.narrow(seq - 1, 0, f))
            assert not row.narrow(seq - 1, f, a.shape[seq] - f).any()
    # a legacy prefill's slot write: the request's rows land in slot 1 only
    eng = TE.ServingEngine(tp, tcfg, slots=3, max_len=MAX_LEN, kernels=PLAIN, device="cpu")
    prompt = toks[1]
    _, alone = TE.prefill_bucketed(tp, tcfg, torch.from_numpy(prompt[None]).long(),
                                   kernels=PLAIN)
    alone = TE.fit_caches(alone, tcfg, eng.cache_len)
    eng._prefill_slot(1, TE.Request(rid=0, prompt=prompt, max_new=2), prompt, 2)
    for path, (batch, _) in TT.cache_layout(tcfg).items():
        leaf = TT.tree_get(eng.caches, path)
        assert torch.equal(leaf.select(batch, 1), TT.tree_get(alone, path).select(batch, 0))
        assert not leaf.select(batch, 0).any() and not leaf.select(batch, 2).any()
    # the scale guard judges attention scales only: poisoned latents do not trip it
    poisoned = jax.tree.map(lambda t: torch.full_like(t, float("nan")), eng.caches)
    rows = torch.zeros((3, 1), dtype=torch.int64)
    assert not TR.scale_guard(poisoned, rows, torch.ones((3, 1), dtype=torch.bool)).any()
