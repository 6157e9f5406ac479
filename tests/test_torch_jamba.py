"""PyTorch port, the hybrid family: Jamba-v0.1 52B's smoke config (a period
of four layers: Mamba + dense, Mamba + MoE, attention + dense, Mamba +
MoE) through the JAX package and the port on the same packed weights
(``interop.from_jax_params``), on the same numpy inputs, f32.

Bars:
* the Mamba layer against ``repro.models.mamba`` (``mode="packed"``): the
  prefill at 1, 2 and 3 tokens (below ``d_conv - 1``, the conv tail
  left-padded), 37 and 300 (JAX's chunks of 4 rows, its carry across 75 of
  them): ``y`` and ``ssm`` within 1e-5 of max |JAX|, ``conv`` within 1e-6
  (it is ``in_proj``'s output); ``mamba_decode`` from JAX's own state: ``y``
  and both leaves within 1e-5; the port's prefill of 16 tokens then 8
  decode steps against its prefill of 24, within 1e-5. The port's scan
  associates in another order than JAX's, so the prefill agrees to f32
  rounding. The scan alone against a float64 recurrence with slow decays
  (a memory of hundreds of rows), in blocks of 16 to 4096 rows, within
  1e-5;
* the zero state and the period of eight kinds; the packed bytes of the
  same latents, the bridged Mamba leaves exactly JAX's f32 (the config
  fields, the block plan, the spec trees and packed init are held in
  ``test_torch_families.py``);
* ``forward`` logits (each prompt's last row, against JAX's one-shot
  prefill) and ``decode_step`` logits (two slots of a bf16 cache at
  frontiers 9 and 2, against JAX's engine decode step) within 2 % of max
  |logit| with every argmax equal (an ulp in a reduction can move one
  int8 code of a projection's input, ``test_torch_families.py``);
* greedy streams: ``generate`` equal to JAX's ``mode="packed"`` one on the
  bf16 cache and on the int8 cache of the attention layers; the legacy
  ``ServingEngine`` (two slots, prompts of 9 and 2 tokens, more requests
  than slots, ``max_new`` 1) on the bf16 cache equal to JAX's engine token
  for token, and on the int8 cache equal to the port's ``generate`` of
  each prompt alone. JAX's compiles dominate the file, so its model runs
  share them: one JAX engine run on the bf16 cache, whose compiled
  prefills and decode step the forward, decode-step and bf16 generate
  checks reuse;
* the chunked and paged paths refused with JAX's reasons
  (``transformer.py:389-392, 417-421``), ``"auto"`` resolving to the legacy
  prefill, ``speculative=True`` staying plain decode, as in JAX;
* the engine's cache walks on the mixed tree: growing and cropping equal
  to JAX's ``grow_caches``/``fit_caches`` (the Mamba leaves pass through),
  the live view, ``cache_nbytes`` and a legacy prefill's slot write, which
  replaces the slot's state leaves whole.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config
from repro.core import params as P
from repro.models import mamba as jM
from repro.models import transformer as jT
from repro.serving import engine as jE
from repro_torch import interop
from repro_torch.configs import get_config as t_get_config
from repro_torch.kernels import PLAIN
from repro_torch.models import mamba as TM
from repro_torch.models import transformer as TT
from repro_torch.serving import engine as TE

ARCH = "jamba-v0.1-52b"
LAYER_TOL = 1e-5  # of max |JAX|
CONV_TOL = 1e-6
LOGIT_TOL = 2e-2  # of max |logit|
STEPS = 10
MAX_LEN = 48
PREFILL_LENGTHS = (1, 2, 3, 37, 300)


def _latents(specs, seed=0):
    """Latent f32 weights with JAX's init distributions (``params.py:73-86``),
    drawn by numpy: JAX's own init compiles for longer than the rest of a
    test takes, and both packages run whatever packed weights these give."""
    rng = np.random.default_rng(seed)

    def one(_, spec):
        if spec.init in ("zeros", "ones"):
            return np.full(spec.shape, float(spec.init == "ones"), np.float32)
        fan_in = spec.shape[-2] if len(spec.shape) >= 2 else spec.shape[-1]
        std = spec.scale if spec.scale is not None else (
            1.0 if spec.init == "embed" else 1.0 / np.sqrt(max(fan_in, 1)))
        return (rng.standard_normal(spec.shape) * std).astype(np.float32)

    return P._map_specs(one, specs)


@pytest.fixture(scope="module")
def built():
    """(JAX config, port config, JAX packed tree, port tree, latents)."""
    jcfg = dataclasses.replace(get_config(ARCH, smoke=True), dtype=jnp.float32)
    tcfg = dataclasses.replace(t_get_config(ARCH, smoke=True), dtype=torch.float32)
    specs = jT.param_specs(jcfg)
    latent = _latents(specs)
    jp = jax.jit(lambda w: jT.pack_tree(w, specs))(latent)
    tp = interop.from_jax_params(jax.device_get(jp), tcfg, device="cpu")
    return jcfg, tcfg, jp, tp, latent


def _mamba_params(built):
    """Layer b0's Mamba params (period 0): JAX's and the port's."""
    _, _, jp, tp, _ = built
    jl = jax.tree.map(lambda a: a[0], jp["blocks"]["b0"]["mamba"])
    return jl, TT.layer_slice(tp["blocks"]["b0"]["mamba"], 0)


def _x(b, s, seed):
    return np.random.default_rng(seed).standard_normal((b, s, 64)).astype(np.float32)


@pytest.fixture(scope="module")
def jax_mamba(built):
    """JAX's jitted Mamba prefill at each of PREFILL_LENGTHS, then one
    decode step from its state: {s: (y, state, x_dec, y_dec, state_dec)}."""
    jcfg = built[0]
    jl, _ = _mamba_params(built)
    prefill = jax.jit(lambda p, x: jM.mamba_prefill(p, x, jcfg, mode="packed"))
    decode = jax.jit(lambda p, x, st: jM.mamba_decode(p, x, jcfg, st, mode="packed"))
    out = {}
    for s in PREFILL_LENGTHS:
        y, st = prefill(jl, jnp.asarray(_x(2, s, s)))
        xd = _x(2, 1, 100 + s)
        yd, std = decode(jl, jnp.asarray(xd), st) if s == 37 else (None, None)
        out[s] = jax.device_get((y, st, xd, yd, std))
    return out


def _rel(got, want):
    got = np.asarray(got.numpy() if isinstance(got, torch.Tensor) else got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape
    return np.abs(got - want).max() / np.abs(want).max()


def _close(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    err = np.abs(got - want).max() / np.abs(want).max()
    assert err <= LOGIT_TOL, err
    assert (got.argmax(-1) == want.argmax(-1)).all()


# ---------------------------------------------------------------------------
# the Mamba layer
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("s", PREFILL_LENGTHS)
def test_mamba_prefill_matches_jax(built, jax_mamba, s):
    _, tl = _mamba_params(built)
    y, st, _, _, _ = jax_mamba[s]
    ty, tst = TM.mamba_prefill(tl, torch.from_numpy(_x(2, s, s)), built[1], kernels=PLAIN)
    assert _rel(ty, y) <= LAYER_TOL
    assert _rel(tst["ssm"], st["ssm"]) <= LAYER_TOL
    assert _rel(tst["conv"], st["conv"]) <= CONV_TOL
    if s < 3:  # the conv tail's left padding
        assert not tst["conv"][:, :3 - s].any()


def test_mamba_decode_matches_jax(built, jax_mamba):
    _, tl = _mamba_params(built)
    _, st, xd, yd, std = jax_mamba[37]
    state = {k: torch.from_numpy(np.array(v)) for k, v in st.items()}
    ty = TM.mamba_decode(tl, torch.from_numpy(xd), built[1], state, kernels=PLAIN)
    assert _rel(ty, yd) <= LAYER_TOL
    for name in ("ssm", "conv"):
        assert _rel(state[name], std[name]) <= LAYER_TOL, name


def test_prefill_then_decode_equals_longer_prefill(built):
    _, tl = _mamba_params(built)
    tcfg = built[1]
    x = torch.from_numpy(_x(2, 24, 5))
    want, want_st = TM.mamba_prefill(tl, x, tcfg, kernels=PLAIN)
    got, state = TM.mamba_prefill(tl, x[:, :16], tcfg, kernels=PLAIN)
    rows = [got]
    for t in range(16, 24):
        rows.append(TM.mamba_decode(tl, x[:, t:t + 1], tcfg, state, kernels=PLAIN))
    assert _rel(torch.cat(rows, 1), want.numpy()) <= LAYER_TOL
    for name in ("ssm", "conv"):
        assert _rel(state[name], want_st[name].numpy()) <= LAYER_TOL, name


def test_selective_scan_against_the_recurrence():
    """Decays of 0.97-0.9997 a row carry the state over hundreds of rows;
    every block size gives the float64 recurrence's outputs and state."""
    gen = torch.Generator().manual_seed(0)
    b, s, di, ds = 2, 700, 8, 4
    dt = torch.rand((b, s, di), generator=gen) * 0.03 + 1e-3
    u = torch.randn((b, s, di), generator=gen)
    bmat, cmat = torch.randn((b, s, ds), generator=gen), torch.randn((b, s, ds), generator=gen)
    a = -torch.rand((di, ds), generator=gen) - 0.01
    h0 = torch.randn((b, di, ds), generator=gen)
    h, ys = h0.double(), []
    for t in range(s):
        h = (h * torch.exp(dt[:, t].double()[..., None] * a.double())
             + (dt[:, t] * u[:, t]).double()[..., None] * bmat[:, t].double()[:, None])
        ys.append(torch.einsum("bdn,bn->bd", h, cmat[:, t].double()))
    want = torch.stack(ys, 1)
    for rows in (16, 48, 256, 4096):
        y, hn = TM.selective_scan(dt, u, bmat, cmat, a, h0, block_rows=rows)
        assert _rel(y, want.numpy()) <= LAYER_TOL, rows
        assert _rel(hn, h.numpy()) <= LAYER_TOL, rows


# ---------------------------------------------------------------------------
# configs, trees and weights
# ---------------------------------------------------------------------------


def test_mamba_init_state_and_period():
    for smoke in (False, True):  # the zero state, as JAX's mamba_init_state builds it
        want = jM.mamba_init_state(get_config(ARCH, smoke=smoke), 2)
        got = TM.mamba_init_state(t_get_config(ARCH, smoke=smoke), 2, device="cpu")
        assert {k: (tuple(v.shape), v.dtype.name) for k, v in want.items()} == {
            k: (tuple(v.shape), str(v.dtype).removeprefix("torch.")) for k, v in got.items()}
        assert not any(v.any() for v in got.values())
    _, period, n = TT.block_plan(t_get_config(ARCH))
    assert n == 4 and [(k.mixer, k.ffn) for k in period] == [
        ("mamba", "dense"), ("mamba", "moe"), ("mamba", "dense"), ("mamba", "moe"),
        ("attn", "dense"), ("mamba", "moe"), ("mamba", "dense"), ("mamba", "moe")]


def test_pack_tree_bytes_and_interop(built):
    """The same latents packed by the port give JAX's bytes and scales; the
    bridged tree keeps every leaf JAX has, the Mamba float leaves in JAX's
    f32 bit for bit."""
    _, tcfg, jp, tp, latent = built
    want = dict(TT.tree_leaves(jax.device_get(jp)))
    t_latent = jax.tree.map(lambda a: torch.from_numpy(np.array(a)), jax.device_get(latent))
    got = dict(TT.tree_leaves(TT.pack_tree(t_latent, TT.param_specs(tcfg))))
    assert set(got) == set(want)
    for path, t in got.items():  # the absmean scales sum in another order
        if path[-1] == "scale":
            np.testing.assert_allclose(t.numpy(), want[path], rtol=1e-6, err_msg=str(path))
        else:
            assert np.array_equal(t.numpy(), np.asarray(want[path])), path
    mamba = tp["blocks"]["b0"]["mamba"]
    for name in ("conv_w", "conv_b", "a_log", "d_skip"):
        assert mamba[name].dtype == torch.float32, name
    assert mamba["dt_proj"]["w"].dtype == mamba["dt_proj"]["b"].dtype == torch.float32
    assert mamba["x_proj"]["wp"].shape == (1, 128 // 4, 8 + 2 * 8)  # dt_rank 8, d_state 8
    assert torch.equal(mamba["dt_proj"]["b"], torch.ones_like(mamba["dt_proj"]["b"]))
    for path, t in TT.tree_leaves(tp):
        assert np.array_equal(t.numpy(), np.asarray(want[path])), path


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------
# JAX's compiles dominate this file, so its model runs share them: one legacy
# engine run on the bf16 cache (two prompt lengths, two slots), whose
# compiled prefills give the forward's caches and the bf16 generate's
# prefill, and whose compiled decode step gives the decode step's logits.

_RNG = np.random.default_rng(4)
LONG, SHORT = (_RNG.integers(0, 256, n).astype(np.int32) for n in (9, 2))
ENGINE_PROMPTS = [(LONG, 7), (SHORT, 5), (LONG[::-1].copy(), 1), (SHORT[::-1].copy(), 6),
                  (LONG, 4)]


def _cfgs(built, kv):
    jcfg, tcfg = built[:2]
    return (dataclasses.replace(jcfg, kv_cache_dtype=kv),
            dataclasses.replace(tcfg, kv_cache_dtype=kv))


def _to_torch(tree):
    return jax.tree.map(lambda a: torch.from_numpy(np.array(a)), jax.device_get(tree))


def _serve(side, cfg, params, prompts, slots=2):
    if side == "jax":
        eng = jE.ServingEngine(params, cfg, mode="packed", prefill="legacy", slots=slots,
                               max_len=MAX_LEN)
        Req = jE.Request
    else:
        eng = TE.ServingEngine(params, cfg, slots=slots, max_len=MAX_LEN, kernels=PLAIN,
                               device="cpu")
        Req = TE.Request
    reqs = [Req(rid=i, prompt=p, max_new=n) for i, (p, n) in enumerate(prompts)]
    for r in reqs:
        eng.submit(r)
    eng.run()
    return [([int(t) for t in r.generated], r.status.name) for r in reqs], eng


@pytest.fixture(scope="module")
def jax_runs(built):
    """JAX's bf16-cache legacy engine over ENGINE_PROMPTS, its prefills of
    LONG and SHORT (the engine's compiled prefills), and its generate of
    LONG on each cache dtype: (streams, prefills, {kv: tokens})."""
    jp = built[2]
    jcfg, _ = _cfgs(built, "bf16")
    streams, _ = _serve("jax", jcfg, jp, ENGINE_PROMPTS)
    prefills = {len(p): jax.device_get(jE.prefill_bucketed(jp, jcfg, jnp.asarray(p[None])))
                for p in (LONG, SHORT)}
    gens = {kv: np.asarray(jE.generate(jp, _cfgs(built, kv)[0], jnp.asarray(LONG[None]),
                                       steps=STEPS, mode="packed").tokens)
            for kv in ("bf16", "int8")}
    return streams, prefills, gens


def test_forward_and_decode_step(built, jax_runs):
    """``forward`` of each prompt against JAX's prefill (its last row's
    logits, every cache leaf's shape); then one ``decode_step`` of a
    two-slot bf16 cache holding both prompts' caches, at their ragged
    frontiers 9 and 2, against JAX's engine decode step on the same cache."""
    jcfg, tcfg = _cfgs(built, "bf16")
    jp, tp = built[2], built[3]
    _, prefills, _ = jax_runs
    slot_caches = []
    for p in (LONG, SHORT):
        want, jc = prefills[len(p)]
        got, tc = TT.forward(tp, torch.from_numpy(p[None]).long(), tcfg, kernels=PLAIN,
                             collect_cache=True)
        _close(got[:, -1].numpy(), want)
        assert ({q: (tuple(a.shape), str(a.dtype).removeprefix("torch."))
                 for q, a in TT.tree_leaves(tc)}
                == {q: (tuple(a.shape), a.dtype.name) for q, a in TT.tree_leaves(jc)})
        slot_caches.append(jE.fit_caches(jc, jcfg, MAX_LEN))
    caches = jax.tree.map(lambda a, b: np.concatenate([a, b], axis=1), *slot_caches)
    pos = np.array([len(LONG), len(SHORT)], np.int32)
    tok = np.stack([prefills[len(p)][0].argmax(-1) for p in (LONG, SHORT)]).astype(np.int32)
    step = jE._serve_step_cached(jcfg, "packed", "auto", None)  # the engine's compiled step
    want, _ = step(jp, {"tokens": jnp.asarray(tok)}, jax.tree.map(jnp.asarray, caches),
                   jnp.asarray(pos))
    got, _ = TT.decode_step(tp, torch.from_numpy(tok).long(), _to_torch(caches),
                            torch.from_numpy(pos), tcfg, kernels=PLAIN)
    _close(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("kv", ["bf16", "int8"])
def test_generate_streams_equal_jax(built, jax_runs, kv):
    _, tcfg = _cfgs(built, kv)
    got = TE.generate(built[3], tcfg, LONG[None], steps=STEPS, kernels=PLAIN, device="cpu")
    assert np.array_equal(got.tokens.numpy(), jax_runs[2][kv])


@pytest.mark.parametrize("kv", ["bf16", "int8"])
def test_legacy_engine_streams_equal_jax(built, jax_runs, kv):
    """Two slots, five requests on prompts of 9 and 2 tokens, one with
    ``max_new`` 1; idle slots step their state and feed their last token
    into the experts, as JAX's do. The bf16 cache's streams equal JAX's
    engine's; the int8 cache's equal the port's ``generate`` of each
    prompt alone (two slots' decode rows never fill an expert's four
    slots, so no choice drops and the rows are independent), the generate
    that ``test_generate_streams_equal_jax`` holds against JAX's on the
    int8 cache."""
    _, tcfg = _cfgs(built, kv)
    got, eng = _serve("torch", tcfg, built[3], ENGINE_PROMPTS)
    assert all(s == "OK" for _, s in got)
    assert [len(t) for t, _ in got] == [n for _, n in ENGINE_PROMPTS]
    assert eng.prefill == "legacy"
    assert eng.stats()["host_transfers"] == eng.tick_count > 0
    if kv == "bf16":
        assert got == jax_runs[0]
        return
    alone = {}  # one row a call: the rows of a batch share the experts' capacity
    for (toks, _), (p, n) in zip(got, ENGINE_PROMPTS):
        key = p.tobytes()
        if key not in alone:
            steps = max(m for q, m in ENGINE_PROMPTS if q.tobytes() == key)
            alone[key] = TE.generate(built[3], tcfg, p[None], steps=steps, kernels=PLAIN,
                                     device="cpu").tokens[0].tolist()
        assert toks == alone[key][:n]


def test_chunked_and_paged_refused_speculative_stays_plain(built):
    _, tcfg, _, tp, _ = built
    with pytest.raises(ValueError, match="transformer.py:389-392, 417-421"):
        TE.ServingEngine(tp, tcfg, slots=1, max_len=MAX_LEN, prefill="chunked", device="cpu")
    with pytest.raises(ValueError, match="transformer.py:389-392, 417-421"):
        TE.ServingEngine(tp, dataclasses.replace(tcfg, kv_layout="paged"), slots=1,
                         max_len=MAX_LEN, device="cpu")
    caches = TT.cache_zeros(tcfg, 1, 64, "cpu")
    with pytest.raises(NotImplementedError, match="Mamba state.*transformer.py:417-421"):
        TT.prefill_chunk_step(tp, torch.zeros((1, 64), dtype=torch.long), caches,
                              torch.zeros(1, dtype=torch.int32), tcfg, kernels=PLAIN)
    with pytest.raises(NotImplementedError, match="Mamba mixer.*transformer.py:389-392"):
        TT.cache_specs(tcfg, 1, 64, kv_pages=4)
    eng = TE.ServingEngine(tp, tcfg, slots=2, max_len=MAX_LEN, kernels=PLAIN, device="cpu",
                           speculative=True)
    assert not eng.speculative and eng.prefill == "legacy"


# ---------------------------------------------------------------------------
# the engine's cache walks
# ---------------------------------------------------------------------------


def test_cache_walks_on_the_mixed_tree(built, jax_runs):
    jcfg, tcfg = _cfgs(built, "bf16")
    tp = built[3]
    layout = TT.cache_layout(tcfg)
    assert layout[("blocks", "b0", "ssm")] == layout[("blocks", "b0", "conv")] == (1, None)
    assert layout[("blocks", "b2", "k")] == layout[("blocks", "b2", "v")] == (1, 3)
    assert TT.cache_layout(_cfgs(built, "int8")[1])[("blocks", "b2", "k_scale")] == (1, 3)
    jc = jax_runs[1][len(LONG)][1]
    tc = _to_torch(jc)
    for fn, jfn, n in ((TE.grow_caches, jE.grow_caches, 19), (TE.fit_caches, jE.fit_caches, 19),
                       (TE.fit_caches, jE.fit_caches, 6)):
        got, want = fn(tc, tcfg, n), jax.device_get(jfn(jc, jcfg, n))
        for path, a in TT.tree_leaves(got):
            assert np.array_equal(a.numpy(), np.asarray(TT.tree_get(want, path))), path
    assert TE.cache_nbytes(tc) == jE.cache_nbytes(jc)
    live = TE.live_cache_state(tc, tcfg, torch.tensor([4], dtype=torch.int32))
    assert torch.equal(live["blocks"]["b1"]["ssm"], tc["blocks"]["b1"]["ssm"])
    assert torch.equal(live["blocks"]["b2"]["k"][..., :4, :], tc["blocks"]["b2"]["k"][..., :4, :])
    assert not live["blocks"]["b2"]["k"][..., 4:, :].any()
    # a legacy prefill's slot write: the request's state and rows in slot 1
    eng = TE.ServingEngine(tp, tcfg, slots=3, max_len=MAX_LEN, kernels=PLAIN, device="cpu")
    for _, leaf in TT.tree_leaves(eng.caches):
        leaf.fill_(7)  # the slot's old state, which the write must replace whole
    prompt = LONG
    _, alone = TE.prefill_bucketed(tp, tcfg, torch.from_numpy(prompt[None]).long(),
                                   kernels=PLAIN)
    alone = TE.fit_caches(alone, tcfg, eng.cache_len)
    eng._prefill_slot(1, TE.Request(rid=0, prompt=prompt, max_new=2), prompt, 2)
    for path, (batch, _) in layout.items():
        leaf = TT.tree_get(eng.caches, path)
        assert torch.equal(leaf.select(batch, 1), TT.tree_get(alone, path).select(batch, 0))
        assert (leaf.select(batch, 0) == 7).all() and (leaf.select(batch, 2) == 7).all()
