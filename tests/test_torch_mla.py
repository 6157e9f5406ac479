"""PyTorch port, Multi-head Latent Attention (``models/mla.py``) and the
one-shot attention at a v head dim other than the q/k one, against the JAX
package on the same packed weights and numpy inputs, f32 unless stated.

Bars:
* ``mla_prefill``: the cache rows (``c_kv``, ``k_rope``) within 1e-6 of
  theirs (RoPE and the RMS norm round in another order than XLA's by f32
  ulps), ``quantize_act(c_kv)``'s codes within one step; the output within
  1e-2 of max |out|: an ulp of ``c_kv`` (or of the attention output) can
  cross a rounding boundary of ``quantize_act`` and move one int8 code of
  ``k_up``/``v_up``'s input (of the o projection's), which moves every
  later row by about one code step (0.43 % of max |out| at these inputs,
  rows 3-10 of the first prompt: one ``c_kv`` code of its row 3);
* ``mla_decode`` (JAX ``mode="packed"``, weight-absorbed) at ragged
  positions, one of them past the cache: the output within 1e-5 of max
  |out|, the cache written at each position and nowhere else (a position
  past the cache writes nothing, as JAX's one-hot);
* ``material_weight`` equal to JAX's, bit for bit;
* the plain ``flash_attention`` with Dv != Dqk and an explicit ``scale``
  within 1e-5 of JAX's ``prefill_attention`` (f32, GQA, the smoke's (24,
  16) and DeepSeek's (192, 128)); bf16 within 2^-7 of max |out|, one bf16
  ulp of the probabilities; the wrapper's padded pair choice.
"""

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config
from repro.core import bitlinear as jB
from repro.core import params as P
from repro.core import ternary as jtern
from repro.models import attention as jA
from repro.models import mla as jM
from repro.models import transformer as jT
from repro_torch import interop
from repro_torch.configs import get_config as t_get_config
from repro_torch.core import bitlinear as TB
from repro_torch.core.ternary import quantize_act
from repro_torch.kernels import PLAIN
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.flash_attention import ref as fa_ref
from repro_torch.models import mla as M
from repro_torch.models import transformer as TT

ARCH = "deepseek-v2-lite-16b"
TOL = 1e-5
B, S, M_LEN = 3, 11, 16


@pytest.fixture(scope="module")
def mla():
    jcfg = dataclasses.replace(get_config(ARCH, smoke=True), dtype=jnp.float32)
    tcfg = dataclasses.replace(t_get_config(ARCH, smoke=True), dtype=torch.float32)
    spec = {"attn": jM.mla_spec(jcfg)}
    jp = jT.pack_tree(P.init_params(spec, jax.random.PRNGKey(0)), spec)
    tp = interop.from_jax_params(jax.device_get(jp), tcfg, device="cpu")
    x = np.random.default_rng(1).standard_normal((B, S, jcfg.d_model)).astype(np.float32)
    return jcfg, tcfg, jp["attn"], tp["attn"], x


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    return np.abs(got - want).max() / np.abs(want).max()


def _positions(b, s, offset=0):
    return np.broadcast_to(np.arange(offset, offset + s, dtype=np.int32)[None], (b, s))


def test_mla_prefill(mla):
    jcfg, tcfg, jp, tp, x = mla
    pos = _positions(B, S)
    want, wc = jM.mla_prefill(jp, jnp.asarray(x), jcfg, jnp.asarray(pos), mode="packed")
    rope = TT.rope_for(tcfg, torch.from_numpy(pos.copy()))["mla"]
    got, gc = M.mla_prefill(tp, torch.from_numpy(x), tcfg, rope, kernels=PLAIN)
    assert _rel(got.numpy(), want) <= 1e-2
    for name in ("c_kv", "k_rope"):
        assert _rel(gc[name].numpy(), wc[name]) <= 1e-6, name
    codes = [np.asarray(q[0], np.int32) for q in
             (jtern.quantize_act(wc["c_kv"]), quantize_act(gc["c_kv"]))]
    assert np.abs(codes[0] - codes[1]).max() <= 1


def test_mla_decode(mla):
    jcfg, tcfg, jp, tp, x = mla
    _, wc = jM.mla_prefill(jp, jnp.asarray(x), jcfg, jnp.asarray(_positions(B, S)),
                           mode="packed")
    cache = {n: np.pad(np.asarray(a), ((0, 0), (0, M_LEN - S), (0, 0))) for n, a in wc.items()}
    pos = np.array([S, 4, M_LEN], np.int32)  # the last slot stands past its cache
    x1 = np.random.default_rng(2).standard_normal((B, 1, jcfg.d_model)).astype(np.float32)
    want, wnew = jM.mla_decode(jp, jnp.asarray(x1), jcfg,
                               {n: jnp.asarray(a) for n, a in cache.items()},
                               jnp.asarray(pos), mode="packed")
    tcache = {n: torch.from_numpy(a.copy()) for n, a in cache.items()}
    rope = TT.rope_for(tcfg, torch.from_numpy(pos[:, None].copy()))["mla"]
    got = M.mla_decode(tp, torch.from_numpy(x1), tcfg, tcache, torch.from_numpy(pos), rope,
                       kernels=PLAIN)
    assert _rel(got.numpy(), want) <= TOL
    for name, a in tcache.items():
        w = np.asarray(wnew[name])
        assert _rel(a.numpy(), w) <= 1e-6, name
        for b, p in enumerate(pos):
            others = np.arange(M_LEN) != p
            assert np.array_equal(a.numpy()[b, others], cache[name][b, others]), (name, b)


def test_material_weight(mla):
    _, _, jp, tp, _ = mla
    for name in ("k_up", "v_up"):
        for jdt, tdt in ((jnp.float32, torch.float32), (jnp.bfloat16, torch.bfloat16)):
            want = jB.material_weight(jp[name], mode="packed", dtype=jdt)
            got = TB.material_weight(tp[name], dtype=tdt)
            assert np.array_equal(got.float().numpy(), np.asarray(want.astype(jnp.float32)))


@pytest.mark.parametrize("dqk,dv,h,hk", [(24, 16, 4, 4), (192, 128, 2, 1), (32, 16, 4, 2)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_attention_dv_and_scale(dqk, dv, h, hk, dtype):
    rng = np.random.default_rng(dqk + dv)
    q = rng.standard_normal((2, h, 19, dqk)).astype(np.float32)
    k = rng.standard_normal((2, hk, 19, dqk)).astype(np.float32)
    v = rng.standard_normal((2, hk, 19, dv)).astype(np.float32)
    scale = 1.0 / math.sqrt(dqk + 3)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    want = jA.prefill_attention(*(jnp.asarray(a, jdt) for a in (q, k, v)), scale=scale)
    args = [torch.from_numpy(a).to(tdt) for a in (q, k, v)]
    for fn in (fa_ref.flash_attention, fa_ops.flash_attention, PLAIN.flash_attention):
        got = fn(*args, scale=scale)
        assert got.dtype == tdt and got.shape == (2, h, 19, dv)
        err = _rel(got.float().numpy(), np.asarray(want.astype(jnp.float32)))
        assert err <= (TOL if dtype == "float32" else 2.0 ** -7), err


def test_flash_attention_head_dim_pairs():
    assert fa_ops.head_dims_for(192, 128) == (192, 128)
    assert fa_ops.head_dims_for(24, 16) == (32, 32)
    assert fa_ops.head_dims_for(96, 96) == (96, 96)
    assert fa_ops.head_dims_for(130, 64) == (192, 128)
    with pytest.raises(ValueError, match="head dims"):
        fa_ops.head_dims_for(256, 128)
