"""PyTorch port, serving: greedy ``generate`` on the tellme-0.7b smoke
config against the JAX package's ``generate(mode="packed")`` on the same
packed weights, plus the engine helpers.

Bars: f32 greedy streams equal token for token (B = 3, a 13-token prompt,
which is no bucket size, 12 steps), with and without ``eos_id``; bf16:
first tokens equal and prefill logits within 0.25 (see test_torch_model).
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
from repro_torch.serving import engine as TE

STEPS = 12


def _setup(dtype):
    jcfg = dataclasses.replace(get_config("tellme-0.7b", smoke=True),
                               dtype=getattr(jnp, dtype))
    tcfg = dataclasses.replace(t_get_config("tellme-0.7b", smoke=True),
                               dtype=getattr(torch, dtype))
    specs = jT.param_specs(jcfg)
    jp = jT.pack_tree(P.init_params(specs, jax.random.PRNGKey(0)), specs)
    tp = interop.from_jax_params(jax.device_get(jp), tcfg, device="cpu")
    prompts = np.random.default_rng(11).integers(0, jcfg.vocab_size, (3, 13)).astype(np.int32)
    return jcfg, tcfg, jp, tp, prompts


@pytest.fixture(scope="module")
def f32():
    jcfg, tcfg, jp, tp, prompts = _setup("float32")
    want = jE.generate(jp, jcfg, jnp.asarray(prompts), steps=STEPS, mode="packed")
    return jcfg, tcfg, jp, tp, prompts, np.asarray(want.tokens)


def test_greedy_streams_equal_f32(f32):
    jcfg, tcfg, jp, tp, prompts, want = f32
    got = TE.generate(tp, tcfg, prompts, steps=STEPS, device="cpu")
    assert got.tokens.dtype == torch.int32 and got.tokens.device.type == "cpu"
    np.testing.assert_array_equal(got.tokens.numpy(), want)


def test_greedy_streams_equal_with_eos(f32):
    """``eos_id`` set to a token the greedy path emits mid-stream: finished
    rows emit eos and freeze their position, on both sides alike."""
    jcfg, tcfg, jp, tp, prompts, plain = f32
    eos = int(plain[0, 3])
    want = jE.generate(jp, jcfg, jnp.asarray(prompts), steps=STEPS, mode="packed",
                       eos_id=eos)
    got = TE.generate(tp, tcfg, prompts, steps=STEPS, eos_id=eos, device="cpu")
    np.testing.assert_array_equal(got.tokens.numpy(), np.asarray(want.tokens))
    assert (got.tokens[0, 3:] == eos).all()


def test_greedy_bf16():
    jcfg, tcfg, jp, tp, prompts = _setup("bfloat16")
    want = jE.generate(jp, jcfg, jnp.asarray(prompts), steps=4, mode="packed")
    got = TE.generate(tp, tcfg, prompts, steps=4, device="cpu")
    np.testing.assert_array_equal(got.tokens[:, 0].numpy(), np.asarray(want.tokens)[:, 0])
    np.testing.assert_allclose(got.prefill_logits.float().numpy(),
                               np.asarray(want.prefill_logits, np.float32), atol=0.25, rtol=0)


def test_single_step_is_the_prefill_token(f32):
    jcfg, tcfg, jp, tp, prompts, want = f32
    got = TE.generate(tp, tcfg, prompts, steps=1, device="cpu")
    np.testing.assert_array_equal(got.tokens.numpy(), want[:, :1])


def test_sampling_is_reproducible_from_a_generator(f32):
    """Temperature sampling draws from the caller's ``torch.Generator``
    (not compared with JAX: the two draw different numbers)."""
    _, tcfg, _, tp, prompts, _ = f32
    runs = [TE.generate(tp, tcfg, prompts, steps=5, temperature=0.8, device="cpu",
                        generator=torch.Generator().manual_seed(3)).tokens
            for _ in range(2)]
    assert torch.equal(runs[0], runs[1]) and tuple(runs[0].shape) == (3, 5)
    assert int(runs[0].min()) >= 0 and int(runs[0].max()) < tcfg.padded_vocab


@pytest.mark.parametrize("s", [1, 13, 64, 65, 200, 257, 600])
def test_bucket_length_matches_jax(s):
    assert TE.bucket_length(s) == jE.bucket_length(s)


def test_fit_caches_grows_and_crops():
    _, tcfg, *_ = _setup("float32")
    caches = TE.init_caches(tcfg, 2, 10, device="cpu")
    caches["blocks"]["b0"]["k"].fill_(1.0)
    grown = TE.fit_caches(caches, tcfg, 16)
    k = grown["blocks"]["b0"]["k"]
    assert tuple(k.shape) == (2, 2, 4, 16, 16)
    assert k[:, :, :, :10].eq(1).all() and k[:, :, :, 10:].eq(0).all()
    cropped = TE.fit_caches(caches, tcfg, 4)
    assert tuple(cropped["blocks"]["b0"]["v"].shape) == (2, 2, 4, 4, 16)
