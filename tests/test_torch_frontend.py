"""PyTorch port, the ``frontend`` input path: musicgen-medium (precomputed
audio frames, ``FRONTEND_DIMS["audio"]`` = 128) and internvl2-26b (image
patches, 1024) at their smoke configs in f32, through the JAX package and
the port on the same packed weights (``interop.from_jax_params``), on the
same numpy inputs.

Bars:
* ``FRONTEND_DIMS``, the ``frontend`` leaf's spec shape, its packed
  serving dtype (f32: no packing, no cast) and its bridged bytes: equal to
  JAX's; the port's own packed init keeps it f32 beside the bf16 table;
* logits at atol 2e-3, the bar ``test_torch_model.py`` holds f32 logits
  to (RoPE's trig, the softmax order and XLA's fused multiply-adds differ
  by f32 ulps, which can move one int8 code), and every argmax equal:
  ``forward`` on an ``{"embeddings"}`` batch against JAX's
  ``forward(mode="packed")``; ``make_prefill_step`` over S = 16 rows, then
  EXT = 4 ``make_serve_step`` calls of one embedding row each, against
  JAX's steps (``tests/test_serving.py:41-63``) and against the port's
  own full forward; two ``prefill_chunk_step`` calls of 16 embedding rows
  (the second attending the first's cache rows) against JAX's, and the
  cache rows they wrote at atol 1e-5;
* a token batch on a frontend config goes through the embedding table, as
  in JAX: logits at the same bar, the tensor and ``{"tokens"}`` forms
  bit-equal, and a batch that has both keys reads the embeddings.
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

ARCHS = ("musicgen-medium", "internvl2-26b")
LOGIT_ATOL = 2e-3  # f32 logits, as tests/test_torch_model.py
CACHE_ATOL = 1e-5  # f32 cache rows, as tests/test_torch_engine.py
B, S, EXT, CHUNK = 2, 16, 4, 16


@pytest.fixture(scope="module")
def models():
    """{arch: (JAX config, port config, JAX packed tree, port tree)}, one
    JAX init and pack per arch."""
    out = {}
    for arch in ARCHS:
        jcfg = dataclasses.replace(get_config(arch, smoke=True), dtype=jnp.float32)
        tcfg = dataclasses.replace(t_get_config(arch, smoke=True), dtype=torch.float32)
        specs = jT.param_specs(jcfg)
        latent = P.init_params(specs, jax.random.PRNGKey(0))
        jp = jax.jit(lambda w: jT.pack_tree(w, specs))(latent)
        out[arch] = (jcfg, tcfg, jp, interop.from_jax_params(jax.device_get(jp), tcfg,
                                                             device="cpu"))
    return out


def _embeddings(cfg, b, s, seed):
    dfe = TT.FRONTEND_DIMS[cfg.frontend]
    return np.random.default_rng(seed).standard_normal((b, s, dfe)).astype(np.float32)


def _close(got, want, atol=LOGIT_ATOL):
    got, want = np.asarray(got), np.asarray(want)
    np.testing.assert_allclose(got, want, atol=atol, rtol=0)
    np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))


@pytest.mark.parametrize("arch", ARCHS)
def test_frontend_spec_and_bridged_leaf(models, arch):
    jcfg, tcfg, jp, tp = models[arch]
    assert TT.FRONTEND_DIMS == jT.FRONTEND_DIMS
    want = jT.param_specs(jcfg)["frontend"]["w"]
    got = TT.param_specs(tcfg)["frontend"]["w"]
    assert got.shape == want.shape == (jT.FRONTEND_DIMS[jcfg.frontend], jcfg.d_model)
    assert got.quant == want.quant == "none" and got.init == want.init == "normal"
    want_packed = jT.packed_param_specs(jcfg)["frontend"]["w"]
    assert TT.packed_param_specs(tcfg)["frontend"]["w"] == (want.shape, torch.float32)
    assert np.dtype(want_packed.dtype) == np.float32
    jw = np.asarray(jax.device_get(jp)["frontend"]["w"])
    assert jw.dtype == np.float32
    tw = tp["frontend"]["w"]
    assert tw.dtype == torch.float32 and np.array_equal(tw.numpy(), jw)
    bf = dataclasses.replace(tcfg, dtype=torch.bfloat16)
    tree = interop.from_jax_params(jax.device_get(jp), bf, device="cpu")
    assert tree["frontend"]["w"].dtype == torch.float32
    assert tree["embed"]["table"].dtype == torch.bfloat16
    init = TP.init_packed_params(TT.param_specs(bf), 0, "cpu", dtype=torch.bfloat16,
                                 dense_leaves=TT.DENSE_LEAVES)
    assert init["frontend"]["w"].dtype == torch.float32


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_on_embeddings(models, arch):
    jcfg, tcfg, jp, tp = models[arch]
    emb = _embeddings(jcfg, B, 20, seed=1)
    want, _, _ = jT.forward(jp, {"embeddings": jnp.asarray(emb)}, jcfg, mode="packed")
    got, _ = TT.forward(tp, {"embeddings": torch.from_numpy(emb)}, tcfg, kernels=PLAIN)
    assert tuple(got.shape) == (B, 20, tcfg.padded_vocab)
    _close(got.numpy(), want)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_then_serve_steps_on_embeddings(models, arch):
    jcfg, tcfg, jp, tp = models[arch]
    emb = _embeddings(jcfg, B, S + EXT, seed=2)
    rows = lambda lo, hi: emb[:, lo:hi]  # noqa: E731
    j_last, jc = jE.make_prefill_step(jcfg, mode="packed")(
        jp, {"embeddings": jnp.asarray(rows(0, S))})
    t_last, tc = TE.make_prefill_step(tcfg, kernels=PLAIN, device="cpu")(
        tp, {"embeddings": torch.from_numpy(rows(0, S))})
    _close(t_last.numpy(), j_last)
    full, _ = TT.forward(tp, {"embeddings": torch.from_numpy(emb)}, tcfg, kernels=PLAIN)
    _close(t_last.numpy(), full[:, S - 1].numpy())
    jc, tc = jE.grow_caches(jc, jcfg, S + EXT), TE.grow_caches(tc, tcfg, S + EXT)
    j_serve = jE.make_serve_step(jcfg, mode="packed")
    t_serve = TE.make_serve_step(tcfg, kernels=PLAIN, device="cpu")
    for t in range(EXT):
        jl, jc = j_serve(jp, {"embeddings": jnp.asarray(rows(S + t, S + t + 1))}, jc,
                         jnp.int32(S + t))
        tl, tc = t_serve(tp, {"embeddings": torch.from_numpy(rows(S + t, S + t + 1))}, tc,
                         S + t)
        _close(tl.numpy(), jl)
        _close(tl.numpy(), full[:, S + t].numpy())


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_chunk_steps_on_embeddings(models, arch):
    """Two chunks of CHUNK embedding rows from empty caches of 64 rows, at
    offsets 0 and CHUNK in both slots, JAX's XLA chunk form beside the
    port's plain one."""
    jcfg, tcfg, jp, tp = models[arch]
    emb = _embeddings(jcfg, B, 2 * CHUNK, seed=3)
    tc = TE.init_caches(tcfg, B, 64, device="cpu")
    jc = jE.init_caches(jcfg, B, 64, dtype=jcfg.dtype)
    for i in range(2):
        chunk = emb[:, i * CHUNK:(i + 1) * CHUNK]
        off = np.full((B,), i * CHUNK, np.int32)
        jl, jc = jT.prefill_chunk_step(jp, {"embeddings": jnp.asarray(chunk)}, jc,
                                       jnp.asarray(off), jcfg, mode="packed", attn_impl="xla")
        tl, _ = TT.prefill_chunk_step(tp, {"embeddings": torch.from_numpy(chunk)}, tc,
                                      torch.from_numpy(off), tcfg, kernels=PLAIN)
        assert tuple(tl.shape) == (B, CHUNK, tcfg.padded_vocab)
        _close(tl.numpy(), jl)
    for name, leaf in tc["blocks"]["b0"].items():
        np.testing.assert_allclose(leaf.numpy()[..., :2 * CHUNK, :],
                                   np.asarray(jc["blocks"]["b0"][name])[..., :2 * CHUNK, :],
                                   atol=CACHE_ATOL, rtol=0, err_msg=name)


@pytest.mark.parametrize("arch", ARCHS)
def test_token_batch_on_a_frontend_config(models, arch):
    jcfg, tcfg, jp, tp = models[arch]
    toks = np.random.default_rng(4).integers(0, jcfg.vocab_size, (B, 12)).astype(np.int32)
    want, _, _ = jT.forward(jp, {"tokens": jnp.asarray(toks)}, jcfg, mode="packed")
    t = torch.from_numpy(toks).long()
    got, _ = TT.forward(tp, t, tcfg, kernels=PLAIN)
    _close(got.numpy(), want)
    as_dict, _ = TT.forward(tp, {"tokens": t}, tcfg, kernels=PLAIN)
    assert torch.equal(as_dict, got)
    emb = torch.from_numpy(_embeddings(jcfg, B, 12, seed=5))
    both, _ = TT.forward(tp, {"tokens": t, "embeddings": emb}, tcfg, kernels=PLAIN)
    only, _ = TT.forward(tp, {"embeddings": emb}, tcfg, kernels=PLAIN)
    assert torch.equal(both, only)
    if not torch.cuda.is_available():  # the steps run on the card unless asked for the CPU
        with pytest.raises(RuntimeError, match="device='cpu'"):
            TE.make_prefill_step(tcfg)
