"""PyTorch port, the one-shot prefill's causal attention: the plain version
(which the wrapper runs for CPU tensors) against the JAX Pallas
``flash_attention`` (interpret mode, as the JAX package's own tests run
it), against the JAX oracle ``mha_reference``, and the port's
``prefill_attention`` against the JAX package's XLA ``prefill_attention``,
on the same numpy inputs.

Bars (atol = rtol):
* against the Pallas kernel and the oracle: 2e-3 in f32 and 2e-2 in bf16,
  the JAX package's own bars for its kernel against the oracle
  (``tests/test_kernels.py::TestFlashAttentionKernel``). The kernel rescales
  its online softmax block by block, and the oracle normalizes P before it
  casts P to the input dtype, where the port casts the unnormalized P;
* against the XLA form: 1e-5 in f32 (one softmax over the row against an
  online softmax over four query chunks: rounding only), 2e-2 in bf16 (P is
  rounded to bf16 against another running maximum).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import ops as j_fa_ops
from repro.kernels.flash_attention import ref as j_fa_ref
from repro.models import attention as jA
from repro_torch.kernels import KERNELS, PLAIN, launch_counts, reset_launch_counts
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.flash_attention import ref as fa_ref
from repro_torch.models import attention as TA

TORCH_DT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
JAX_DT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TOL = {"float32": 2e-3, "bfloat16": 2e-2}
XLA_TOL = {"float32": 1e-5, "bfloat16": 2e-2}
HK, D = 2, 32


def _inputs(dtype, g, s, seed, *, b=1):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, HK * g, s, D)).astype(np.float32)
    k = rng.standard_normal((b, HK, s, D)).astype(np.float32)
    v = rng.standard_normal((b, HK, s, D)).astype(np.float32)
    # both sides get the same dtype-rounded values
    ts = [torch.from_numpy(a).to(TORCH_DT[dtype]) for a in (q, k, v)]
    js = [jnp.asarray(t.float().numpy()).astype(JAX_DT[dtype]) for t in ts]
    return ts, js


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x.astype(jnp.float32))


# (G, S, causal_skip): G = H / HK; S = 200 is ragged; causal_skip=False is
# the dense schedule
CASES = [(1, 128, True), (2, 128, True), (4, 128, True), (1, 200, True), (2, 200, True),
         (1, 128, False), (2, 200, False)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("g,s,causal_skip", CASES)
def test_plain_matches_jax_kernel_and_oracle(dtype, g, s, causal_skip):
    (q, k, v), (jq, jk, jv) = _inputs(dtype, g, s, seed=s + 10 * g)
    got = fa_ops.flash_attention(q, k, v, causal_skip=causal_skip)
    assert got.dtype == q.dtype and tuple(got.shape) == tuple(q.shape)
    want_kernel = j_fa_ops.flash_attention(jq, jk, jv, causal_skip=causal_skip)
    f32 = [a.astype(jnp.float32) for a in (jq, jk, jv)]
    want_oracle = j_fa_ref.mha_reference(*f32)
    tol = TOL[dtype]
    np.testing.assert_allclose(_np(got), _np(want_kernel), atol=tol, rtol=tol)
    np.testing.assert_allclose(_np(got), _np(want_oracle), atol=tol, rtol=tol)


@pytest.mark.parametrize("dtype,g,s", [("float32", 2, 200), ("bfloat16", 1, 128)])
def test_prefill_attention_matches_jax_xla(dtype, g, s):
    """The model's one-shot prefill attention (through the plain kernel set)
    against the JAX package's XLA form, which the JAX model runs there."""
    (q, k, v), (jq, jk, jv) = _inputs(dtype, g, s, seed=7 * s + g, b=2)
    got = TA.prefill_attention(q, k, v, kernels=PLAIN)
    want = jA.prefill_attention(jq, jk, jv)
    tol = XLA_TOL[dtype]
    np.testing.assert_allclose(_np(got), _np(want), atol=tol, rtol=tol)


def test_wrapper_runs_the_plain_version_on_cpu():
    """A CPU tensor takes the plain version (bit for bit, both schedules)
    and counts no launch."""
    (q, k, v), _ = _inputs("bfloat16", 2, 96, seed=3)
    reset_launch_counts()
    for kw in ({}, {"causal_skip": False}):
        assert torch.equal(KERNELS.flash_attention(q, k, v, **kw),
                           fa_ref.flash_attention(q, k, v, **kw))
    assert launch_counts()["flash_attention"] == 0
    assert TA.prefill_attention(q, k, v, kernels=KERNELS).shape == q.shape
