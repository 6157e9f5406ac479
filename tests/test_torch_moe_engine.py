"""PyTorch port, the chunked, paged and speculative ``ServingEngine`` for the
``moe`` family (Arctic's smoke config: attention, then the routed experts
beside a dense residual MLP), against the JAX package's
``ServingEngine(mode="packed", prefill="chunked")`` on the same packed
weights (``interop.from_jax_params``), on the same numpy inputs, in f32;
and the ``mla_moe`` family's refusals.

Under MoE the rows of a tick share the routed experts' capacity in slot
order, so the rows of idle and trash-diverted slots decide which live
choices drop: zeros at ``trash_base`` in a chunk, a slot's token at
``cache_len - 1`` in a fused tick's decode and at its own position in a
decode-only tick, ``[token, drafts]`` at ``trash_base`` in a verify chunk.
The port feeds JAX's rows, and its diverted chunk rows attend as JAX's XLA
append form has them attend (``serving/engine.py::_prefix_limit``).

Bars: per-request greedy streams and statuses equal to JAX's token for
token (chunks of 32, prompts of 20 to 60 tokens, more requests than
slots, ``max_new=1``), one host transfer a tick, on the contiguous and
the paged layout; the speculative engine under a capacity factor of
0.25, where the chunk and verify steps drop choices (the count is
asserted above zero), likewise.
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

MAX_LEN = 96
ENGINE_FIELDS = dict(prefill_chunk_sizes=(32,), kv_page_size=16)  # one fused-tick compile


def _setup(arch, **fields):
    jcfg = dataclasses.replace(get_config(arch, smoke=True), dtype=jnp.float32, **fields)
    tcfg = dataclasses.replace(t_get_config(arch, smoke=True), dtype=torch.float32, **fields)
    specs = jT.param_specs(jcfg)
    jp = jax.jit(lambda w: jT.pack_tree(w, specs))(P.init_params(specs, jax.random.PRNGKey(0)))
    tp = interop.from_jax_params(jax.device_get(jp), tcfg, device="cpu")
    return jcfg, tcfg, jp, tp


def _init(tcfg):
    return TP.init_packed_params(TT.param_specs(tcfg), 0, "cpu", dense_leaves=TT.DENSE_LEAVES)


@pytest.fixture(scope="module")
def arctic():
    return _setup("arctic-480b", **ENGINE_FIELDS)


def _prompts(seed=3):
    rng = np.random.default_rng(seed)
    return [(rng.integers(0, 256, n).astype(np.int32), m)
            for n, m in ((20, 12), (45, 8), (60, 10), (33, 1), (25, 12))]


def _serve(side, models, prompts, *, slots=2, speculative=False, **fields):
    jcfg, tcfg, jp, tp = models
    kw = dict(prefill="chunked", slots=slots, max_len=MAX_LEN, speculative=speculative)
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


@pytest.mark.parametrize("layout", ["contiguous", "paged"])
def test_moe_chunked_engine_streams_equal_jax(arctic, layout):
    prompts = _prompts()
    want, _ = _serve("jax", arctic, prompts, kv_layout=layout)
    got, eng = _serve("torch", arctic, prompts, kv_layout=layout)
    assert got == want and all(s == "OK" for _, s in got)
    st = eng.stats()
    assert eng.prefill == "chunked" and st["host_transfers"] == st["ticks"] > 0
    assert st["fused_ticks"] > 0 and st["spec_ticks"] == 0


def test_moe_engine_with_drops_equals_jax(arctic, monkeypatch):
    """The speculative engine at capacity factor 0.25: a 2 x 32 chunk step
    routes 128 choices into 8 experts of 4 slots, a 2 x 5 verify step 20
    into 8 of 4, so choices drop, and the diverted rows ahead of a live slot
    take capacity from it. The streams still equal JAX's."""
    jcfg, tcfg, jp, tp = arctic
    models = (dataclasses.replace(jcfg, capacity_factor=0.25),
              dataclasses.replace(tcfg, capacity_factor=0.25), jp, tp)
    assert TT.moe_mod.group_shape(64, 1024, 2, 0.25, tcfg.n_experts) == (1, 64, 4)
    drops = []
    route = TT.moe_mod.route

    def counting(params, xt, *, top_k, cap):
        r = route(params, xt, top_k=top_k, cap=cap)
        if xt.shape[1] > 2:  # a chunk or verify step (a decode step has 2 rows)
            drops.append(int((~r["keep"]).sum()))
        return r

    monkeypatch.setattr(TT.moe_mod, "route", counting)
    prompts = _prompts(seed=8)
    want, _ = _serve("jax", models, prompts, speculative=True)
    got, eng = _serve("torch", models, prompts, speculative=True)
    assert sum(drops) > 0
    assert got == want and all(s == "OK" for _, s in got)
    assert eng.stats()["spec_ticks"] > 0 and eng.stats()["fused_ticks"] > 0


def test_moe_auto_stays_legacy():
    """``"auto"`` resolves to the legacy prefill for the moe family, as in
    JAX, and then ``speculative=True`` stays plain decode."""
    tcfg = t_get_config("arctic-480b", smoke=True)
    tp = _init(tcfg)
    eng = TE.ServingEngine(tp, tcfg, slots=2, max_len=MAX_LEN, kernels=PLAIN, device="cpu",
                           speculative=True)
    assert eng.prefill == "legacy" and not eng.speculative
    eng = TE.ServingEngine(tp, tcfg, slots=2, max_len=MAX_LEN, kernels=PLAIN, device="cpu",
                           prefill="chunked", speculative=True)
    assert eng.prefill == "chunked" and eng.speculative


def test_mla_moe_chunked_and_paged_still_refused():
    """DeepSeek's MLA layers refuse a chunk against the latent cache and a
    page table, citing JAX's own refusals (``transformer.py:389-392,
    417-421``)."""
    tcfg = t_get_config("deepseek-v2-lite-16b", smoke=True)
    tp = _init(tcfg)
    with pytest.raises(ValueError, match="417-421"):
        TE.ServingEngine(tp, tcfg, slots=1, max_len=MAX_LEN, prefill="chunked", device="cpu")
    with pytest.raises(ValueError, match="389-392"):
        TE.ServingEngine(tp, dataclasses.replace(tcfg, kv_layout="paged"), slots=1,
                         max_len=MAX_LEN, prefill="chunked", device="cpu")
    caches = TT.cache_zeros(tcfg, 1, MAX_LEN, "cpu")
    with pytest.raises(NotImplementedError, match="417-421"):
        TT.prefill_chunk_step(tp, torch.zeros((1, 16), dtype=torch.long), caches,
                              torch.zeros(1, dtype=torch.int32), tcfg, kernels=PLAIN)
    with pytest.raises(NotImplementedError, match="389-392"):
        TT.cache_specs(tcfg, 1, 64, kv_pages=4)
