"""PyTorch port, the RWKV-6 WKV recurrence (B15): the plain ``wkv`` against
the JAX package's ``wkv/ref.py::wkv`` (``_wkv_chunked``, from a zero state),
against its Pallas kernel in interpret mode (``wkv/ops.py::wkv``, run as
``tests/test_kernels.py`` runs it), and against the sequential recurrence
that ``time_mix_decode`` steps, on the same numpy inputs.

Inputs: r, k, v standard normal, u normal x 0.5, and a log-decay drawn
log-uniform across the model's whole clip range [-10, -1e-4] on half the
channels and in the slow band [-1e-3, -1e-4] on the other half, so that
the state carries across every chunk boundary (with random weights the
model's own decays sit near -1, which would hide errors in that carry).

Bar: 1e-5 of the output's scale (max |want| over each head's y or state),
against JAX's chunked form and its kernel, which use the same chunk (the
port keeps JAX's rule) and differ only in the order of f32 sums and in
exp's last bit, and against the sequential recurrence in f64, which sees
the f32 rounding of the chunked form itself. The fast channels'
cumulative log-decay reaches -640 in a chunk, where one f32 ulp is 6e-5,
so a decay ratio near 1 can be off by that much relatively; sums of such
terms keep the output within a few 1e-6 of its scale.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.wkv import ops as jwkv_ops
from repro.kernels.wkv import ref as jwkv_ref
from repro_torch.kernels import PLAIN
from repro_torch.kernels.wkv import ops as wkv_ops
from repro_torch.kernels.wkv import ref as wkv_ref

B, H, N = 2, 3, 16
TOL = 1e-5


def wkv_inputs(rng, b, h, s, n):
    """r, k, v [b, h, s, n], logw [b, h, s, n] and u [h, n], f32 numpy."""
    r, k, v = (rng.standard_normal((b, h, s, n)).astype(np.float32) for _ in range(3))
    fast = -(10.0 ** rng.uniform(-4.0, 1.0, (b, h, s, n)))
    slow = -(10.0 ** rng.uniform(-4.0, -3.0, (b, h, s, n)))
    logw = np.where(np.arange(n) % 2 == 0, slow, fast).astype(np.float32)
    u = (rng.standard_normal((h, n)) * 0.5).astype(np.float32)
    return r, k, v, logw, u


def sequential(r, k, v, logw, u):
    """The decode step's recurrence in f64 (repro/models/rwkv.py:214-218):
    y_t = r_t (S + diag(u) k_t v_t^T), S <- diag(exp(logw_t)) S + k_t v_t^T."""
    r, k, v, logw, u = (np.asarray(a, np.float64) for a in (r, k, v, logw, u))
    b, h, s, n = r.shape
    state = np.zeros((b, h, n, n))
    ys = np.zeros((b, h, s, n))
    for t in range(s):
        kv = k[:, :, t, :, None] * v[:, :, t, None, :]
        ys[:, :, t] = np.einsum("bhn,bhnm->bhm", r[:, :, t], state + u[None, :, :, None] * kv)
        state = np.exp(logw[:, :, t])[..., None] * state + kv
    return ys, state


def rel_err(got, want):
    """max |got - want| over each head, relative to that head's max |want|."""
    got, want = (np.asarray(a, np.float64) for a in (got, want))
    axes = tuple(range(2, want.ndim))
    scale = np.abs(want).max(axis=axes)
    return float((np.abs(got - want).max(axis=axes) / scale).max())


def _port(inputs):
    y, s_n = wkv_ref.wkv(*(torch.from_numpy(a) for a in inputs))
    assert y.dtype == s_n.dtype == torch.float32
    return y.numpy(), s_n.numpy()


@pytest.mark.parametrize("s", [64, 128, 200])
def test_plain_wkv_equals_jax_chunked_and_kernel(s):
    inputs = wkv_inputs(np.random.default_rng(s), B, H, s, N)
    y, s_n = _port(inputs)
    assert y.shape == (B, H, s, N) and s_n.shape == (B, H, N, N)
    j = [jnp.asarray(a) for a in inputs]
    y_ref, s_ref = jwkv_ref.wkv(*j, jnp.zeros((B, H, N, N), jnp.float32))
    y_pal, s_pal = jwkv_ops.wkv(*j)  # Pallas, interpret mode on the CPU
    for want_y, want_s in ((y_ref, s_ref), (y_pal, s_pal)):
        assert rel_err(y, want_y) <= TOL
        assert rel_err(s_n, want_s) <= TOL


@pytest.mark.parametrize("s", [64, 128, 200])
def test_plain_wkv_equals_sequential_recurrence(s):
    inputs = wkv_inputs(np.random.default_rng(100 + s), B, H, s, N)
    y, s_n = _port(inputs)
    want_y, want_s = sequential(*inputs)
    assert rel_err(y, want_y) <= TOL
    assert rel_err(s_n, want_s) <= TOL


def test_slow_decay_carries_across_chunks():
    """The slow channels keep most of the state across every chunk
    boundary: the final state of a 200-token run still holds the first
    chunk's contribution (the carry the bar above checks)."""
    inputs = wkv_inputs(np.random.default_rng(7), 1, 1, 200, N)
    _, full = _port(inputs)
    cut = [a.copy() for a in inputs]
    for a in cut[:3]:
        a[:, :, :64] = 0  # drop the first chunk's r, k, v
    _, late = _port(cut)
    slow = np.arange(N) % 2 == 0
    assert np.abs(full - late)[0, 0, slow].max() > 0.1 * np.abs(full).max()


def test_chunk_rule_and_dispatch():
    """The chunk is JAX's: min(64, S), halved until it divides S; any S
    runs (13: one chunk of 13; 100: 25 of 4). The kernel set's ``wkv`` is
    the dispatching wrapper, which runs the plain version on CPU tensors
    without counting a launch."""
    for s in (13, 100):
        inputs = wkv_inputs(np.random.default_rng(s), 1, 2, s, N)
        y, s_n = _port(inputs)
        want_y, want_s = sequential(*inputs)
        assert rel_err(y, want_y) <= TOL
        assert rel_err(s_n, want_s) <= TOL
    assert PLAIN.wkv is wkv_ref.wkv
    before = wkv_ops.wkv.launches
    t = [torch.from_numpy(a) for a in wkv_inputs(np.random.default_rng(1), 1, 2, 13, N)]
    y, s_n = wkv_ops.wkv(*t)
    want = wkv_ref.wkv(*t)
    assert torch.equal(y, want[0]) and torch.equal(s_n, want[1])
    assert wkv_ops.wkv.launches == before
