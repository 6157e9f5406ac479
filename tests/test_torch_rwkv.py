"""PyTorch port, the RWKV-6 family (``ssm``): the rwkv6-3b smoke config run
through the JAX package and the port on the same packed weights
(``interop.from_jax_params`` carries the tree across), on the same numpy
inputs, f32 unless stated.

Bars:
* ``time_mix``, ``channel_mix`` and the two decode steps: outputs and
  states within 1e-5 of their scale (max |want|). The lerps, the decay
  LoRA and the group norm run in another order and implementation than
  XLA's by f32 ulps, and the WKV's sums as ``test_torch_wkv.py`` says; an
  ulp at a rounding boundary of ``quantize_act`` can move one int8 code of
  a projection's input by one step, which the bar covers at these inputs;
* ``forward`` and ``decode_step`` logits and the collected state
  (``wkv``, ``x_time``, ``x_chan``) within 2e-3 of their scale: through
  two layers those ulps can cross a rounding boundary of ``quantize_act``
  and move one int8 code, as the dense model's tests allow
  (``test_torch_model.py``: logits within 2e-3);
* greedy streams of ``generate`` (B = 3, a 13-token prompt, which is no
  chunk multiple) and of the legacy ``ServingEngine`` equal token for
  token to JAX's, with the same statuses;
* bf16: ``forward`` logits against JAX's blocks run one by one outside
  ``jit``, within 2^-4, one bf16 ulp at the logits' scale (4-8): each op
  rounds to bf16 on both sides (the port spells ``jax.nn.sigmoid`` as XLA
  expands it), so only the WKV's f32 sums, in another order, could move a
  rounding (at these inputs nothing moves); every row's argmax equal.
  Under ``jit`` XLA's fusions keep some bf16 intermediates in f32, so
  JAX's own jitted time mix differs from its eager one, and JAX's jitted
  ``generate`` is no bf16 yardstick.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config
from repro.core import params as P
from repro.models import rwkv as jR
from repro.models import transformer as jT
from repro.serving import engine as jE
from repro_torch import interop
from repro_torch.configs import get_config as t_get_config
from repro_torch.kernels import PLAIN
from repro_torch.models import rwkv as R
from repro_torch.models import transformer as TT
from repro_torch.serving import engine as TE

ARCH = "rwkv6-3b"
PART_TOL = 1e-5
MODEL_TOL = 2e-3
BF16_LOGIT_ATOL = 2.0 ** -4
STEPS = 12


def _setup(dtype):
    jcfg = dataclasses.replace(get_config(ARCH, smoke=True), dtype=getattr(jnp, dtype))
    tcfg = dataclasses.replace(t_get_config(ARCH, smoke=True), dtype=getattr(torch, dtype))
    specs = jT.param_specs(jcfg)
    jp = jT.pack_tree(P.init_params(specs, jax.random.PRNGKey(0)), specs)
    tp = interop.from_jax_params(jax.device_get(jp), tcfg, device="cpu")
    return jcfg, tcfg, jp, tp


@pytest.fixture(scope="module")
def f32():
    return _setup("float32")


def _np(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor) else jnp.asarray(x, jnp.float32),
                      np.float64)


def _close(got, want, tol):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape
    err = np.abs(got - want).max() / np.abs(want).max()
    assert err <= tol, err


def _layer(tree, li=0):
    return jax.tree.map(lambda a: a[li], tree)


def _x(rng, shape):
    return (rng.standard_normal(shape) * 0.5).astype(np.float32)


def _tokens(b, s, seed):
    return np.random.default_rng(seed).integers(0, 256, (b, s)).astype(np.int32)


def test_config_fields_match_jax():
    for smoke in (False, True):
        tc, jc = t_get_config(ARCH, smoke=smoke), get_config(ARCH, smoke=smoke)
        for f in dataclasses.fields(tc):
            if f.name != "dtype":
                assert getattr(tc, f.name) == getattr(jc, f.name), f.name
        assert tc.family == "ssm" and tc.padded_vocab == jc.padded_vocab
    full = t_get_config(ARCH)
    assert (full.n_layers, full.d_model, full.d_ff, full.vocab_size,
            full.d_model // full.rwkv_head_dim) == (32, 2560, 8960, 65536, 40)


def test_param_tree_and_interop_match_jax(f32):
    """The same keys and shapes as the JAX spec tree, and the packed tree
    carried across: f32 mixes, LoRA, bonus and group-norm leaves as they
    are, packed ``W*`` bytes and scales unchanged."""
    from repro.core.params import _iter_specs
    from repro_torch.core import params as PR

    jcfg, tcfg, jp, tp = f32
    want = {p: s.shape for p, s in _iter_specs(jT.param_specs(jcfg))}
    got = {}
    PR.map_specs(lambda p, s: got.__setitem__(p, s.shape), TT.param_specs(tcfg))
    assert got == want
    jt, tt = jp["blocks"]["b0"]["time"], tp["blocks"]["b0"]["time"]
    for name in ("mix_r", "mix_w", "w0", "w1", "w2", "bonus", "ln_w", "ln_b"):
        assert tt[name].dtype == torch.float32
        np.testing.assert_array_equal(tt[name].numpy(), np.asarray(jt[name]))
    for name in ("Wr", "Wo"):
        np.testing.assert_array_equal(tt[name]["wp"].numpy(), np.asarray(jt[name]["wp"]))
        np.testing.assert_array_equal(tt[name]["scale"].numpy(), np.asarray(jt[name]["scale"]))
    assert tp["blocks"]["b0"]["channel"]["Wk"]["wp"].dtype == torch.uint8


def test_time_and_channel_mix_match_jax(f32):
    jcfg, tcfg, jp, tp = f32
    rng = np.random.default_rng(3)
    b, s, d = 2, 70, jcfg.d_model  # two WKV chunk rules apart: 70 runs chunks of 2
    x, xp = _x(rng, (b, s, d)), _x(rng, (b, 1, d))
    jl, tl = _layer(jp["blocks"]["b0"], 1), TT.layer_slice(tp["blocks"]["b0"], 1)
    h = d // jcfg.rwkv_head_dim
    zero = jnp.zeros((b, h, jcfg.rwkv_head_dim, jcfg.rwkv_head_dim), jnp.float32)
    want, want_last, want_s = jR.time_mix(jl["time"], jnp.asarray(x), jnp.asarray(xp), zero,
                                          jcfg, mode="packed")
    got, got_last, got_s = R.time_mix(tl["time"], torch.from_numpy(x), torch.from_numpy(xp),
                                      tcfg, kernels=PLAIN)
    _close(got, want, PART_TOL)
    _close(got_s, want_s, PART_TOL)
    assert torch.equal(got_last, torch.from_numpy(x[:, -1:]))
    want, _ = jR.channel_mix(jl["channel"], jnp.asarray(x), jnp.asarray(xp), mode="packed")
    got, last = R.channel_mix(tl["channel"], torch.from_numpy(x), torch.from_numpy(xp),
                              kernels=PLAIN)
    _close(got, want, PART_TOL)
    assert torch.equal(last, torch.from_numpy(x[:, -1:]))


def test_decode_steps_match_jax(f32):
    """One token against a warm state: ``time_mix_decode`` (the state
    update in plain torch) and ``channel_mix_decode``."""
    jcfg, tcfg, jp, tp = f32
    rng = np.random.default_rng(5)
    b, d, n = 3, jcfg.d_model, jcfg.rwkv_head_dim
    x, xt = _x(rng, (b, 1, d)), _x(rng, (b, 1, d))
    s0 = rng.standard_normal((b, d // n, n, n)).astype(np.float32)
    jl, tl = _layer(jp["blocks"]["b0"]), TT.layer_slice(tp["blocks"]["b0"], 0)
    want, wst = jR.time_mix_decode(jl["time"], jnp.asarray(x),
                                   {"wkv": jnp.asarray(s0), "x_time": jnp.asarray(xt)}, jcfg)
    got, gst = R.time_mix_decode(tl["time"], torch.from_numpy(x),
                                 {"wkv": torch.from_numpy(s0), "x_time": torch.from_numpy(xt)},
                                 tcfg, kernels=PLAIN)
    _close(got, want, PART_TOL)
    _close(gst["wkv"], wst["wkv"], PART_TOL)
    assert torch.equal(gst["x_time"], torch.from_numpy(x))
    want, _ = jR.channel_mix_decode(jl["channel"], jnp.asarray(x), jnp.asarray(xt))
    got, last = R.channel_mix_decode(tl["channel"], torch.from_numpy(x), torch.from_numpy(xt),
                                     kernels=PLAIN)
    _close(got, want, PART_TOL)
    assert torch.equal(last, torch.from_numpy(x))


def test_forward_logits_and_state_match_jax(f32):
    jcfg, tcfg, jp, tp = f32
    tokens = _tokens(2, 37, seed=1)
    want, _, wc = jT.forward(jp, {"tokens": jnp.asarray(tokens)}, jcfg, mode="packed",
                             collect_cache=True)
    got, gc = TT.forward(tp, torch.from_numpy(tokens).long(), tcfg, kernels=PLAIN,
                         collect_cache=True)
    _close(got, want, MODEL_TOL)
    specs = TT.cache_specs(tcfg, 2, 37)["blocks"]["b0"]
    assert set(gc["blocks"]["b0"]) == set(wc["blocks"]["b0"]) == {"wkv", "x_time", "x_chan"}
    for name, leaf in gc["blocks"]["b0"].items():
        assert (tuple(leaf.shape), leaf.dtype) == specs[name]
        _close(leaf, wc["blocks"]["b0"][name], MODEL_TOL)


def test_decode_step_matches_jax(f32):
    """Three decode steps from the collected state, in place on the port's
    side; logits and state within the model bar."""
    jcfg, tcfg, jp, tp = f32
    tokens = _tokens(2, 20, seed=2)
    _, _, jc = jT.forward(jp, {"tokens": jnp.asarray(tokens)}, jcfg, mode="packed",
                          collect_cache=True)
    _, tc = TT.forward(tp, torch.from_numpy(tokens).long(), tcfg, kernels=PLAIN,
                       collect_cache=True)
    tok = _tokens(2, 3, seed=3)
    for i in range(3):
        pos = np.full((2,), 20 + i, np.int32)
        want, jc = jT.decode_step(jp, {"tokens": jnp.asarray(tok[:, i:i + 1])}, jc,
                                  jnp.asarray(pos), jcfg, mode="packed")
        got, tc2 = TT.decode_step(tp, torch.from_numpy(tok[:, i:i + 1]).long(), tc,
                                  torch.from_numpy(pos), tcfg, kernels=PLAIN)
        assert tc2 is tc  # updated in place
        _close(got, want, MODEL_TOL)
    for name, leaf in tc["blocks"]["b0"].items():
        _close(leaf, jc["blocks"]["b0"][name], MODEL_TOL)


def test_generate_streams_equal_jax(f32):
    jcfg, tcfg, jp, tp = f32
    prompts = _tokens(3, 13, seed=11)
    want = jE.generate(jp, jcfg, jnp.asarray(prompts), steps=STEPS, mode="packed")
    got = TE.generate(tp, tcfg, prompts, steps=STEPS, device="cpu")
    np.testing.assert_array_equal(got.tokens.numpy(), np.asarray(want.tokens))
    _close(got.prefill_logits, want.prefill_logits, MODEL_TOL)


def test_bf16_forward_equals_jax_blocks():
    from repro.models import layers as jL

    jcfg, tcfg, jp, tp = _setup("bfloat16")
    tokens = _tokens(3, 13, seed=11)
    x = jL.embed(jp["embed"], jnp.asarray(tokens), dtype=jcfg.dtype)
    pos = jnp.broadcast_to(jnp.arange(13, dtype=jnp.int32)[None], (3, 13))
    kind = jT.block_plan(jcfg)[1][0]
    for li in range(jcfg.n_layers):
        x, _, _ = jT.apply_block(kind, _layer(jp["blocks"]["b0"], li), x, jcfg, None, pos,
                                 mode="packed")
    want = _np(jL.lm_head(jp["lm_head"], jL.rmsnorm(jp["final_norm"], x, eps=jcfg.norm_eps)))
    got, _ = TT.forward(tp, torch.from_numpy(tokens).long(), tcfg, kernels=PLAIN)
    got = _np(got)
    np.testing.assert_allclose(got, want, atol=BF16_LOGIT_ATOL, rtol=0)
    np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))


def _serve(side, f32, prompts, max_new, **kw):
    jcfg, tcfg, jp, tp = f32
    if side == "jax":
        eng, Req = jE.ServingEngine(jp, jcfg, mode="packed", **kw), jE.Request
    else:
        eng, Req = TE.ServingEngine(tp, tcfg, device="cpu", kernels=PLAIN, **kw), TE.Request
    reqs = [Req(rid=i, prompt=p, max_new=n) for i, (p, n) in enumerate(zip(prompts, max_new))]
    for r in reqs:
        eng.submit(r)
    eng.run()
    return [([int(t) for t in r.generated], r.status.name, r.status_detail) for r in reqs], eng


def test_legacy_engine_equals_jax(f32):
    """``prefill="auto"`` resolves to legacy for the ssm family on both
    sides; three requests of ragged lengths on two slots, one admitted
    after a retirement (its slot's state overwritten), with the same
    streams and statuses as JAX's, in the same ticks, and each stream equal
    to the port's own ``generate`` of its prompt alone."""
    rng = np.random.default_rng(9)
    prompts = [rng.integers(0, 256, n).astype(np.int32) for n in (9, 30, 70)]
    max_new = (8, 3, 6)
    want, jeng = _serve("jax", f32, prompts, max_new, slots=2, max_len=128)
    got, eng = _serve("torch", f32, prompts, max_new, slots=2, max_len=128)
    assert got == want
    assert all(s == "OK" for _, s, _ in got)
    assert eng.prefill == jeng.prefill == "legacy" and eng.fused_ticks == 0
    st = eng.stats()
    assert st["host_transfers"] == st["ticks"] == jeng.stats()["ticks"]
    _, tcfg, _, tp = f32
    for (tokens, _, _), p, n in zip(got, prompts, max_new):
        alone = TE.generate(tp, tcfg, p[None], steps=n, device="cpu")
        assert alone.tokens[0].tolist() == tokens


def test_legacy_engine_edges_equal_jax(f32):
    """``max_new=1`` ends on the prefill token; a prompt of ``max_len - 1``
    retires on its prefill token at the cache ceiling; one as long as
    ``max_len`` fails at admission."""
    rng = np.random.default_rng(10)
    prompts = [rng.integers(0, 256, n).astype(np.int32) for n in (12, 64, 63, 20)]
    want, _ = _serve("jax", f32, prompts, (1, 4, 3, 5), slots=2, max_len=64)
    got, _ = _serve("torch", f32, prompts, (1, 4, 3, 5), slots=2, max_len=64)
    assert got == want
    assert got[0][1] == "OK" and len(got[0][0]) == 1
    assert got[1][1:] == ("FAILED", "bad_prompt")
    assert got[2][1] == "CACHE_EXHAUSTED" and len(got[2][0]) == 1


def test_legacy_engine_preemption_equals_jax(f32):
    """A higher-priority arrival evicts the latest low-priority slot; the
    evicted request re-prefills its prompt and emitted tokens into a fresh
    state and finishes its stream, as in JAX."""
    jcfg, tcfg, jp, tp = f32
    rng = np.random.default_rng(12)
    a, b, c = (rng.integers(0, 256, n).astype(np.int32) for n in (60, 90, 30))
    runs = []
    for side in ("jax", "torch"):
        if side == "jax":
            eng, Req = jE.ServingEngine(jp, jcfg, mode="packed", slots=2, max_len=128), jE.Request
        else:
            eng, Req = TE.ServingEngine(tp, tcfg, device="cpu", kernels=PLAIN, slots=2,
                                        max_len=128), TE.Request
        reqs = [Req(rid=0, prompt=a, max_new=12), Req(rid=1, prompt=b, max_new=12),
                Req(rid=2, prompt=c, max_new=4)]
        reqs[2].priority = 3
        eng.submit(reqs[0])
        eng.submit(reqs[1])
        for _ in range(5):
            eng.step()
        eng.submit(reqs[2])
        eng.run()
        runs.append([([int(t) for t in r.generated], r.status.name, r.preemptions)
                     for r in reqs])
    assert runs[0] == runs[1]
    assert [r[2] for r in runs[1]] == [0, 1, 0] and all(r[1] == "OK" for r in runs[1])


def test_fit_caches_passes_the_state_through(f32):
    """No state leaf has a sequence axis: growing, cropping and the
    engine's slot caches leave every leaf as it was (JAX: no act_kv_seq)."""
    _, tcfg, _, tp = f32
    _, caches = TE.prefill_bucketed(tp, tcfg, torch.from_numpy(_tokens(2, 13, 4)).long(),
                                    kernels=PLAIN)
    assert all(seq is None for _, seq in TT.cache_layout(tcfg).values())
    for max_len in (5, 13, 300):
        for fn in (TE.fit_caches, TE.grow_caches):
            out = fn(caches, tcfg, max_len)
            for name, leaf in caches["blocks"]["b0"].items():
                assert out["blocks"]["b0"][name] is leaf
    eng = TE.ServingEngine(tp, tcfg, slots=3, max_len=40, device="cpu", kernels=PLAIN)
    shapes = {n: tuple(t.shape) for n, t in eng.caches["blocks"]["b0"].items()}
    n, d = tcfg.rwkv_head_dim, tcfg.d_model
    assert shapes == {"wkv": (2, 3, d // n, n, n), "x_time": (2, 3, 1, d),
                      "x_chan": (2, 3, 1, d)}
    assert TE.cache_nbytes(eng.caches) == 2 * 3 * (d // n * n * n + 2 * d) * 4


def test_prefill_is_exact_length(f32):
    """Pad tokens would be integrated into the recurrent state, so the ssm
    family prefills the exact prompt: the logits equal those of the
    unpadded forward at its last row."""
    _, tcfg, _, tp = f32
    tokens = torch.from_numpy(_tokens(1, 13, 6)).long()
    last, _ = TE.prefill_bucketed(tp, tcfg, tokens, kernels=PLAIN)
    full, _ = TT.forward(tp, tokens, tcfg, kernels=PLAIN)
    assert torch.equal(last, full[:, -1])


def test_chunked_and_paged_raise_for_the_family(f32):
    _, tcfg, _, tp = f32
    with pytest.raises(ValueError, match="legacy"):
        TE.ServingEngine(tp, tcfg, slots=1, max_len=64, prefill="chunked", device="cpu")
    with pytest.raises(ValueError, match="legacy"):
        TE.ServingEngine(tp, dataclasses.replace(tcfg, kv_layout="paged"), slots=1,
                         max_len=64, device="cpu")
    caches = TT.cache_zeros(tcfg, 1, 64, "cpu")
    with pytest.raises(NotImplementedError, match="zero state"):
        TT.decode_step(tp, torch.zeros((1, 4), dtype=torch.long), caches,
                       torch.zeros(1, dtype=torch.int32), tcfg, kernels=PLAIN)
    with pytest.raises(NotImplementedError, match="legacy"):
        TT.prefill_chunk_step(tp, torch.zeros((1, 64), dtype=torch.long), caches,
                              torch.zeros(1, dtype=torch.int32), tcfg, kernels=PLAIN)
    with pytest.raises(NotImplementedError, match="paged"):
        TT.cache_specs(tcfg, 1, 64, kv_pages=4)
