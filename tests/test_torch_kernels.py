"""PyTorch port, kernels: each plain version against the JAX Pallas kernel
it stands beside (interpret mode, as the JAX package's own tests run it)
and against the JAX plain form; the CPU dispatch of every wrapper; and, on
a CUDA device only, each CUDA kernel against its plain version.

Bars:
* ternary GEMV/matmul: exact (int32 accumulation, same f32 epilogue order),
  except where XLA's CPU compiler fuses the f32 residual add into a
  multiply-add (see test_ternary_projection_plain_exact);
* norm-quant and SwiGLU: int8 codes within 1 and scales within rtol 5e-7
  (f32) or one bf16 ulp (4.1e-3) — the row sums, rsqrt and sigmoid run in
  another order or implementation, as in tests/test_fusion.py;
* decode attention: atol = rtol = 1e-5 in f32 (the kernel rescales its
  online softmax block by block); 4e-3 in bf16, two bf16 ulps at
  |out| <= 0.5 (probabilities are rounded to bf16 against a different
  running maximum).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import packing as jPK
from repro.core import ternary as jT
from repro.kernels.decode_attention import ops as j_da_ops
from repro.kernels.fused_norm_quant import ops as j_nq_ops
from repro.kernels.fused_norm_quant import ref as j_nq_ref
from repro.kernels.ternary_matmul import ops as j_tm_ops
from repro.models import attention as jA
from repro_torch.core import packing as PK
from repro_torch.kernels import KERNELS, PLAIN, launch_counts, reset_launch_counts
from repro_torch.kernels.decode_attention import ops as da_ops
from repro_torch.kernels.decode_attention import ref as da_ref
from repro_torch.kernels.fused_norm_quant import ops as nq_ops
from repro_torch.kernels.fused_norm_quant import ref as nq_ref
from repro_torch.kernels.ternary_matmul import ops as tm_ops
from repro_torch.kernels.ternary_matmul import ref as tm_ref

TORCH_DT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
QUANT_RTOL = {"float32": 5e-7, "bfloat16": 4.1e-3}
ATTN_TOL = {"float32": 1e-5, "bfloat16": 4e-3}


def _t(a, dtype=None):
    t = torch.from_numpy(np.array(a))  # a writable copy
    return t if dtype is None else t.to(dtype)


def _np(t):
    return t.float().numpy() if t.dtype == torch.bfloat16 else t.numpy()


def _assert_quant_close(got, want, rtol):
    (qg, sg), (qw, sw) = got, want
    np.testing.assert_allclose(np.asarray(sg), np.asarray(sw), rtol=rtol)
    assert (np.abs(np.asarray(qg, np.int32) - np.asarray(qw, np.int32)) <= 1).all()


# ---------------------------------------------------------------------------
# norm-quant
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shape", [(4, 96), (3, 5, 200), (17, 64)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_norm_quant_plain_vs_jax(shape, dtype):
    rng = np.random.default_rng(10)
    x = (rng.standard_normal(shape) * 3).astype(np.float32)
    g = rng.standard_normal(shape[-1]).astype(np.float32)
    xj = jnp.asarray(x).astype(getattr(jnp, dtype))
    want_k = j_nq_ops.norm_quant(xj, jnp.asarray(g), impl="kernel", interpret=True)
    want_x = j_nq_ref.norm_quant(xj, jnp.asarray(g))
    for fn in (nq_ref.norm_quant, nq_ops.norm_quant):
        got = fn(_t(x, TORCH_DT[dtype]), _t(g))
        got = (got[0].numpy(), got[1].numpy())
        _assert_quant_close(got, want_k, QUANT_RTOL[dtype])
        _assert_quant_close(got, want_x, QUANT_RTOL[dtype])


# ---------------------------------------------------------------------------
# ternary GEMV / matmul
# ---------------------------------------------------------------------------


def _projection_inputs(m, n, k, seed):
    rng = np.random.default_rng(seed)
    w = rng.integers(-1, 2, (n, k)).astype(np.int8)
    x = rng.integers(-127, 128, (m, n)).astype(np.int8)
    xs = rng.uniform(0.01, 0.2, (m, 1)).astype(np.float32)
    r = rng.standard_normal((m, k)).astype(np.float32)
    return w, x, xs, np.float32(0.61), r


@pytest.mark.parametrize("m", [1, 5, 16, 40])
@pytest.mark.parametrize("with_residual", [False, True])
def test_ternary_projection_plain_exact(m, with_residual):
    """N = 72 and K = 44 are multiples of no JAX block size.

    Exact against JAX's plain form (``ternary_matmul_ref`` then ``+ r``,
    run op by op) and, without a residual, against the Pallas kernels in
    interpret mode. With a residual and f32 output, XLA's CPU compiler
    contracts the kernel's ``(acc·xs)·ws + r`` into one fused multiply-add
    (a single rounding), which the port does not do: there the bar is the
    rounding step of that multiply, half an f32 ulp of ``(acc·xs)·ws``
    plus one of the sum."""
    w, x, xs, ws, r = _projection_inputs(m, 72, 44, seed=m)
    wp = np.asarray(jPK.pack2(jnp.asarray(w)))
    res_j = jnp.asarray(r) if with_residual else None
    res_t = _t(r) if with_residual else None
    plain = jT.ternary_matmul_ref(jnp.asarray(x), jnp.asarray(xs), jPK.unpack2(jnp.asarray(wp)),
                                  jnp.asarray(ws))
    want = np.asarray(plain if res_j is None else plain + res_j)
    want_k = j_tm_ops.ternary_gemv(jnp.asarray(x), jnp.asarray(xs), jnp.asarray(wp),
                                   jnp.asarray(ws), residual=res_j, interpret=True)
    want_m = j_tm_ops.ternary_matmul(jnp.asarray(x), jnp.asarray(xs), jnp.asarray(wp),
                                     jnp.asarray(ws), residual=res_j, interpret=True)
    np.testing.assert_array_equal(np.asarray(want_k), np.asarray(want_m))
    fma_atol = (np.spacing(np.abs(np.asarray(plain)).max())
                + np.spacing(np.abs(want).max())) if with_residual else 0.0
    for fn in (tm_ref.ternary_gemv, tm_ref.ternary_matmul, tm_ops.ternary_gemv,
               tm_ops.ternary_matmul):
        got = fn(_t(x), _t(xs), _t(wp), torch.tensor(ws), residual=res_t).numpy()
        np.testing.assert_array_equal(got, want)
        np.testing.assert_allclose(got, np.asarray(want_k), rtol=0, atol=fma_atol)


def test_ternary_projection_bf16_out_exact():
    w, x, xs, ws, r = _projection_inputs(6, 64, 24, seed=7)
    wp = np.asarray(jPK.pack2(jnp.asarray(w)))
    rj = jnp.asarray(r).astype(jnp.bfloat16)
    want = j_tm_ops.ternary_gemv(jnp.asarray(x), jnp.asarray(xs), jnp.asarray(wp),
                                 jnp.asarray(ws), out_dtype=jnp.bfloat16, residual=rj,
                                 interpret=True)
    got = tm_ops.ternary_gemv(_t(x), _t(xs), _t(wp), torch.tensor(ws),
                              out_dtype=torch.bfloat16,
                              residual=_t(r).to(torch.bfloat16))
    np.testing.assert_array_equal(_np(got), np.asarray(want.astype(jnp.float32)))


# ---------------------------------------------------------------------------
# SwiGLU
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("m", [3, 21])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ternary_swiglu_plain_vs_jax(m, dtype):
    rng = np.random.default_rng(20 + m)
    n, k = 48, 40
    wg = np.asarray(jPK.pack2(jnp.asarray(rng.integers(-1, 2, (n, k)).astype(np.int8))))
    wu = np.asarray(jPK.pack2(jnp.asarray(rng.integers(-1, 2, (n, k)).astype(np.int8))))
    x = rng.integers(-127, 128, (m, n)).astype(np.int8)
    xs = rng.uniform(0.01, 0.05, (m, 1)).astype(np.float32)
    sg, su = np.float32(0.8), np.float32(1.3)
    jargs = [jnp.asarray(a) for a in (x, xs, wg, sg, wu, su)]
    want = j_tm_ops.ternary_swiglu(*jargs, act_dtype=getattr(jnp, dtype), interpret=True)
    for fn in (tm_ref.ternary_swiglu, tm_ops.ternary_swiglu):
        q, s = fn(_t(x), _t(xs), _t(wg), torch.tensor(sg), _t(wu), torch.tensor(su),
                  act_dtype=TORCH_DT[dtype])
        _assert_quant_close((q.numpy(), s.numpy()), want, QUANT_RTOL[dtype])


# ---------------------------------------------------------------------------
# decode attention
# ---------------------------------------------------------------------------


def _attn_inputs(b, h, hk, m, d, seed, dtype):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, h, d)).astype(np.float32)
    k = rng.standard_normal((b, hk, m, d)).astype(np.float32)
    v = rng.standard_normal((b, hk, m, d)).astype(np.float32)
    pos = rng.integers(0, m, (b,)).astype(np.int32)
    pos[0] = m - 1  # one slot at the last row, the rest ragged
    jd = getattr(jnp, dtype)
    return ([jnp.asarray(a).astype(jd) for a in (q, k, v)] + [jnp.asarray(pos)],
            [_t(a, TORCH_DT[dtype]) for a in (q, k, v)] + [_t(pos)])


@pytest.mark.parametrize("g", [1, 2])
@pytest.mark.parametrize("window,softcap", [(0, 0.0), (37, 0.0), (0, 5.0), (50, 3.0)])
def test_decode_attention_plain_vs_jax(g, window, softcap):
    jargs, targs = _attn_inputs(3, 4 * g, 4, 200, 24, seed=g, dtype="float32")
    want_k = j_da_ops.decode_attention(*jargs, window=window, softcap=softcap,
                                       bkv=64, interpret=True)
    want_x = jA.decode_attention(*jargs, window=window, softcap=softcap, impl="xla")
    for fn in (da_ref.decode_attention, da_ops.decode_attention):
        got = fn(*targs, window=window, softcap=softcap).numpy()
        tol = ATTN_TOL["float32"]
        np.testing.assert_allclose(got, np.asarray(want_k), atol=tol, rtol=tol)
        np.testing.assert_allclose(got, np.asarray(want_x), atol=tol, rtol=tol)


def test_decode_attention_plain_vs_jax_bf16():
    jargs, targs = _attn_inputs(2, 8, 4, 130, 16, seed=5, dtype="bfloat16")
    want = j_da_ops.decode_attention(*jargs, bkv=64, interpret=True)
    got = da_ref.decode_attention(*targs)
    tol = ATTN_TOL["bfloat16"]
    np.testing.assert_allclose(_np(got), np.asarray(want.astype(jnp.float32)),
                               atol=tol, rtol=tol)


# ---------------------------------------------------------------------------
# dispatch and counters
# ---------------------------------------------------------------------------


def test_cpu_dispatch_runs_plain_and_counts_nothing():
    """A CPU tensor takes the plain version; no kernel launch is counted."""
    reset_launch_counts()
    w, x, xs, ws, _ = _projection_inputs(2, 16, 8, seed=3)
    wp = PK.pack2(_t(w))
    KERNELS.ternary_gemv(_t(x), _t(xs), wp, torch.tensor(ws))
    KERNELS.norm_quant(torch.ones(2, 8), torch.ones(8))
    assert set(launch_counts()) == {"norm_quant", "ternary_gemv", "ternary_matmul",
                                    "ternary_swiglu", "decode_attention",
                                    "decode_attention_quant", "prefill_append",
                                    "prefill_append_quant", "decode_attention_paged",
                                    "decode_attention_paged_quant", "prefill_append_paged",
                                    "prefill_append_paged_quant", "norm_quant_tables",
                                    "tl_gemv", "tl_matmul", "tl_swiglu", "flash_attention",
                                    "wkv"}
    assert sum(launch_counts().values()) == 0
    assert PLAIN.ternary_gemv is tm_ref.ternary_gemv
