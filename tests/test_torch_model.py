"""PyTorch port, model: the tellme-0.7b smoke config run through the JAX
package and the port on the same packed weights (``interop.from_jax_params``
carries the JAX ``wp`` bytes and scales across).

Bars (f32 unless stated):
* int8 codes at every norm-quant prologue, fed the same input: within 1
  (the f32 row sum and rsqrt run in another order and implementation);
* the residual stream after each attention sub-block: atol 1e-4;
* ``forward`` and ``decode_step`` logits: atol 2e-3 — RoPE's pow/sin/cos,
  the one-block prefill softmax against JAX's online one, and XLA's fused
  multiply-add in the residual epilogue differ by f32 ulps, which can move
  an int8 code by one step;
* bf16: logits within 0.25 (one code step of a bf16 row is ~1/127 of the
  row's absmax, and bf16 rounds at every op), and equal greedy argmax.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config
from repro.core import params as P
from repro.models import layers as jL
from repro.models import transformer as jT
from repro_torch import interop
from repro_torch.configs import get_config as t_get_config
from repro_torch.kernels import KERNELS
from repro_torch.models import layers as L
from repro_torch.models import transformer as TT

LOGIT_ATOL = {"float32": 2e-3, "bfloat16": 0.25}


def _cfgs(dtype):
    jcfg = dataclasses.replace(get_config("tellme-0.7b", smoke=True),
                               dtype=getattr(jnp, dtype))
    tcfg = dataclasses.replace(t_get_config("tellme-0.7b", smoke=True),
                               dtype=getattr(torch, dtype))
    return jcfg, tcfg


@pytest.fixture(scope="module", params=["float32", "bfloat16"])
def model(request):
    jcfg, tcfg = _cfgs(request.param)
    specs = jT.param_specs(jcfg)
    jp = jT.pack_tree(P.init_params(specs, jax.random.PRNGKey(0)), specs)
    tp = interop.from_jax_params(jax.device_get(jp), tcfg, device="cpu")
    return request.param, jcfg, tcfg, jp, tp


def _np(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor) else jnp.asarray(x, jnp.float32))


def _tokens(b, s, vocab, seed=0):
    return np.random.default_rng(seed).integers(0, vocab, (b, s)).astype(np.int32)


def test_forward_logits(model):
    dtype, jcfg, tcfg, jp, tp = model
    toks = _tokens(2, 24, jcfg.vocab_size)
    want, _, _ = jT.forward(jp, {"tokens": jnp.asarray(toks)}, jcfg, mode="packed")
    got, caches = TT.forward(tp, torch.from_numpy(toks).long(), tcfg, kernels=KERNELS)
    np.testing.assert_allclose(_np(got), _np(want), atol=LOGIT_ATOL[dtype], rtol=0)
    assert caches is None
    np.testing.assert_array_equal(_np(got).argmax(-1), _np(want).argmax(-1))


def test_forward_caches(model):
    dtype, jcfg, tcfg, jp, tp = model
    toks = _tokens(2, 16, jcfg.vocab_size, seed=1)
    _, _, want = jT.forward(jp, {"tokens": jnp.asarray(toks)}, jcfg, mode="packed",
                            collect_cache=True)
    _, got = TT.forward(tp, torch.from_numpy(toks).long(), tcfg, kernels=KERNELS,
                        collect_cache=True)
    for name in ("k", "v"):
        g, w = got["blocks"]["b0"][name], want["blocks"]["b0"][name]
        assert tuple(g.shape) == w.shape == (2, 2, 4, 16, 16)
        assert g.dtype == getattr(torch, dtype)
        np.testing.assert_allclose(_np(g), _np(w), atol=LOGIT_ATOL[dtype], rtol=0)


def test_prologue_codes_per_layer():
    """Feed each layer the JAX package's input and compare the int8 codes
    at both norm-quant prologues, and the residual stream between them."""
    jcfg, tcfg = _cfgs("float32")
    specs = jT.param_specs(jcfg)
    jp = jT.pack_tree(P.init_params(specs, jax.random.PRNGKey(0)), specs)
    tp = interop.from_jax_params(jax.device_get(jp), tcfg, device="cpu")
    toks = _tokens(2, 20, jcfg.vocab_size, seed=2)
    x = jT.embed_inputs(jp, {"tokens": jnp.asarray(toks)}, jcfg)
    positions = jnp.broadcast_to(jnp.arange(20, dtype=jnp.int32)[None], (2, 20))
    rope_j = jT.rope_for(jcfg, positions)
    rope_t = TT.rope_for(tcfg, torch.tensor(np.asarray(positions)))["attn"]
    kind_j = jT.block_plan(jcfg)[1][0]
    for layer in range(jcfg.n_layers):
        bj = jax.tree.map(lambda a: a[layer], jp["blocks"]["b0"])
        bt = TT.layer_slice(tp["blocks"]["b0"], layer)
        xt = torch.tensor(np.asarray(x))
        hq_j = jL.norm_quant(bj["ln1"], x)
        hq_t = L.norm_quant(bt["ln1"], xt, kernels=KERNELS)
        assert np.abs(hq_t[0].numpy().astype(int) - np.asarray(hq_j[0]).astype(int)).max() <= 1
        mid_j, _ = jT._apply_attn(bj["attn"], x, jcfg, kind_j, positions, mode="packed",
                                  rope=rope_j["attn"], xq=hq_j, residual=x)
        mid_t, _ = TT._apply_attn(bt["attn"], xt, hq_t, tcfg, rope_t, kernels=KERNELS)
        np.testing.assert_allclose(mid_t.numpy(), np.asarray(mid_j), atol=1e-4, rtol=0)
        h2_j = jL.norm_quant(bj["ln2"], mid_j)
        h2_t = L.norm_quant(bt["ln2"], mid_t, kernels=KERNELS)
        assert np.abs(h2_t[0].numpy().astype(int) - np.asarray(h2_j[0]).astype(int)).max() <= 1
        x, _, _ = jT.apply_block(kind_j, bj, x, jcfg, None, positions, mode="packed",
                                 rope=rope_j)


def test_decode_step_logits(model):
    """One decode step at ragged per-slot positions on the prefill caches."""
    dtype, jcfg, tcfg, jp, tp = model
    toks = _tokens(3, 16, jcfg.vocab_size, seed=3)
    _, _, jc = jT.forward(jp, {"tokens": jnp.asarray(toks)}, jcfg, mode="packed",
                          collect_cache=True)
    _, tc = TT.forward(tp, torch.from_numpy(toks).long(), tcfg, kernels=KERNELS,
                       collect_cache=True)
    jc = jax.tree.map(lambda a: jnp.pad(a, ((0, 0),) * 3 + ((0, 8), (0, 0))), jc)
    tc = {"blocks": {"b0": {n: torch.nn.functional.pad(v, (0, 0, 0, 8))
                            for n, v in tc["blocks"]["b0"].items()}}}
    pos = np.array([16, 9, 12], np.int32)
    nxt = _tokens(3, 1, jcfg.vocab_size, seed=4)
    want, jc2 = jT.decode_step(jp, {"tokens": jnp.asarray(nxt)}, jc, jnp.asarray(pos),
                               jcfg, mode="packed")
    got, tc2 = TT.decode_step(tp, torch.from_numpy(nxt).long(), tc, torch.from_numpy(pos),
                              tcfg, kernels=KERNELS)
    np.testing.assert_allclose(_np(got), _np(want), atol=LOGIT_ATOL[dtype], rtol=0)
    np.testing.assert_array_equal(_np(got).argmax(-1), _np(want).argmax(-1))
    np.testing.assert_allclose(_np(tc2["blocks"]["b0"]["k"]), _np(jc2["blocks"]["b0"]["k"]),
                               atol=LOGIT_ATOL[dtype], rtol=0)


def test_cache_specs_shape():
    _, tcfg = _cfgs("bfloat16")
    specs = TT.cache_specs(tcfg, batch=3, seq=40)
    assert specs["blocks"]["b0"]["k"] == ((2, 3, 4, 40, 16), torch.bfloat16)
    full = t_get_config("tellme-0.7b")
    assert TT.cache_specs(full, 4, 164)["blocks"]["b0"]["v"][0] == (24, 4, 16, 164, 96)
