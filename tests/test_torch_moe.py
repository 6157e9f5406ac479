"""PyTorch port, the token-choice MoE (``models/moe.py``) against the JAX
package's ``moe_ffn`` (``mode="packed"``) on the same packed weights and
the same numpy inputs, f32.

Bars:
* the routing, exact: the chosen experts, each choice's slot in its
  expert's queue, the drop mask and the dispatched rows ``[E, N, cap, d]``
  equal JAX's (its one-hot cumsum and dispatch einsum, transcribed below
  from ``moe.py:111-140``), at the default ``capacity_factor`` 1.25 and at
  0.3, which drops choices (asserted), in one group and in two;
* the expert outputs before combine, exact: JAX's ``_expert_ffn`` on the
  same slot rows;
* ``moe_ffn`` (combine, an f32 sum of at most k gated rows in another
  order than XLA's contraction) within 1e-6 of max |out|, and the aux loss
  within 1e-6;
* the FFN of a ``moe_shared`` (DeepSeek) and a ``moe_dense`` (Arctic)
  layer within 1e-6 of max |out|.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config
from repro.core import params as P
from repro.models import moe as jMoE
from repro.models import transformer as jT
from repro_torch import interop
from repro_torch.configs import get_config as t_get_config
from repro_torch.kernels import PLAIN
from repro_torch.models import moe as MoE
from repro_torch.models import transformer as TT

ARCH = "deepseek-v2-lite-16b"
TOL = 1e-6
TOKENS = (2, 16)


def _packed(spec_tree, tcfg, seed):
    jp = jT.pack_tree(P.init_params(spec_tree, jax.random.PRNGKey(seed)), spec_tree)
    return jp, interop.from_jax_params(jax.device_get(jp), tcfg, device="cpu")


@pytest.fixture(scope="module")
def experts():
    jcfg = dataclasses.replace(get_config(ARCH, smoke=True), dtype=jnp.float32)
    tcfg = dataclasses.replace(t_get_config(ARCH, smoke=True), dtype=torch.float32)
    spec = {"moe": jMoE.moe_spec(jcfg.d_model, jcfg.d_ff, jcfg.n_experts)}
    jp, tp = _packed(spec, tcfg, 0)
    x = np.random.default_rng(1).standard_normal(TOKENS + (jcfg.d_model,)).astype(np.float32)
    return jcfg, jp["moe"], tp["moe"], x


def _jax_routing(params, x, top_k, cf, group_size):
    """``moe.py:103-140`` step by step: (gate_idx, slot, keep, xe)."""
    b, s, dim = x.shape
    e = params["router"]["w"].shape[1]
    tokens = b * s
    g = min(group_size, tokens)
    while tokens % g:
        g //= 2
    n = tokens // g
    cap = max(int(g * top_k * cf / e), 4)
    xt = x.reshape(n, g, dim)
    logits = jnp.einsum("Ngd,de->Nge", xt.astype(jnp.float32),
                        params["router"]["w"].astype(jnp.float32))
    probs = jax.nn.softmax(logits, axis=-1)
    _, gate_idx = jax.lax.top_k(probs, top_k)
    onehot = jax.nn.one_hot(gate_idx, e, dtype=jnp.float32)
    slot = (jnp.cumsum(onehot.reshape(n, g * top_k, e), axis=1) - 1.0).reshape(n, g, top_k, e)
    slot = (slot * onehot).sum(-1)
    keep = slot < cap
    slot_oh = jax.nn.one_hot(slot, cap, dtype=jnp.float32) * keep[..., None]
    dispatch = jnp.einsum("Ngke,Ngkc->Ngec", onehot, slot_oh)
    xe = jnp.einsum("Ngd,Ngec->eNcd", xt.astype(jnp.float32), dispatch)
    return gate_idx, slot, keep, xe, cap


@pytest.mark.parametrize("cf", [1.25, 0.3])
@pytest.mark.parametrize("group_size", [1024, 16])
def test_routing_and_dispatch_exact(experts, cf, group_size):
    jcfg, jp, tp, x = experts
    k = jcfg.experts_per_tok
    gate_idx, slot, keep, xe, cap = _jax_routing(jp, jnp.asarray(x), k, cf, group_size)
    n, g, cap_t = MoE.group_shape(x.shape[0] * x.shape[1], group_size, k, cf, jcfg.n_experts)
    assert (n * g, cap_t) == (x.shape[0] * x.shape[1], cap)
    xt = torch.from_numpy(x).reshape(n, g, -1)
    r = MoE.route(tp, xt, top_k=k, cap=cap)
    assert np.array_equal(r["idx"].numpy(), np.asarray(gate_idx))
    assert np.array_equal(r["slot"].numpy(), np.asarray(slot).astype(np.int64))
    assert np.array_equal(r["keep"].numpy(), np.asarray(keep))
    assert np.array_equal(MoE.dispatch(xt, r, jcfg.n_experts, cap).numpy(), np.asarray(xe))
    if cf < 1:
        assert (~r["keep"]).sum() > 0  # the small factor drops choices


def test_expert_outputs_exact(experts):
    jcfg, jp, tp, x = experts
    *_, xe, cap = _jax_routing(jp, jnp.asarray(x), jcfg.experts_per_tok, 0.3, 1024)
    xe = xe.reshape(jcfg.n_experts, cap, -1)
    want = jMoE._expert_ffn(jp, xe, "packed")
    got = MoE.expert_ffn(tp, torch.from_numpy(np.array(xe)), kernels=PLAIN)
    assert np.array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("cf", [1.25, 0.3])
@pytest.mark.parametrize("group_size", [1024, 16])
def test_moe_ffn_and_aux_loss(experts, cf, group_size):
    jcfg, jp, tp, x = experts
    k = jcfg.experts_per_tok
    want, aux_want = jMoE.moe_ffn(jp, jnp.asarray(x), top_k=k, capacity_factor=cf,
                                  group_size=group_size, mode="packed")
    got, aux = MoE.moe_ffn(tp, torch.from_numpy(x), top_k=k, kernels=PLAIN,
                           capacity_factor=cf, group_size=group_size)
    want = np.asarray(want)
    assert np.abs(got.numpy() - want).max() <= TOL * np.abs(want).max()
    np.testing.assert_allclose(float(aux), float(aux_want), rtol=TOL)


def test_aux_loss_formula(experts):
    """``_aux_loss`` on the same router probabilities."""
    jcfg, jp, tp, x = experts
    probs = np.random.default_rng(2).dirichlet(np.ones(jcfg.n_experts), (4, 8)).astype(np.float32)
    _, idx = jax.lax.top_k(jnp.asarray(probs), jcfg.experts_per_tok)
    want = jMoE._aux_loss(jnp.asarray(probs), jax.nn.one_hot(idx, jcfg.n_experts))
    got = MoE.aux_loss(torch.from_numpy(probs), torch.from_numpy(np.asarray(idx)).long())
    np.testing.assert_allclose(float(got), float(want), rtol=TOL)


@pytest.mark.parametrize("arch", ["deepseek-v2-lite-16b", "arctic-480b"])
def test_layer_ffn_with_shared_or_dense(arch):
    """The period layer's FFN: routed experts plus the shared MLP (DeepSeek)
    or the dense residual MLP (Arctic)."""
    jcfg = dataclasses.replace(get_config(arch, smoke=True), dtype=jnp.float32)
    tcfg = dataclasses.replace(t_get_config(arch, smoke=True), dtype=torch.float32)
    kind_j, kind_t = jT.block_plan(jcfg)[1][0], TT.block_plan(tcfg)[1][0]
    assert kind_t.ffn == {"deepseek-v2-lite-16b": "moe_shared", "arctic-480b": "moe_dense"}[arch]
    jp, tp = _packed(jT._ffn_spec(jcfg, kind_j), tcfg, 3)
    x = np.random.default_rng(4).standard_normal((3, 7, jcfg.d_model)).astype(np.float32)
    want, _ = jT._apply_ffn(jp, jnp.asarray(x), jcfg, kind_j, None, mode="packed")
    got = TT._apply_ffn(tp, torch.from_numpy(x), tcfg, kind_t, kernels=PLAIN)
    want = np.asarray(want)
    assert np.abs(got.numpy() - want).max() <= TOL * np.abs(want).max()
