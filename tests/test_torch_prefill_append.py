"""PyTorch port, chunked prefill-append and the int8 KV cache: each plain
version against the JAX Pallas kernel it stands beside (interpret mode, as
the JAX package's own tests run it) and against the JAX oracle.

Bars:
* cache rows written by the append: exact against the JAX oracle (bf16 or
  f32 copies; int8 codes and f32 scales of ``quantize_kv``). Against the
  kernel run in interpret mode the codes are exact at these inputs, and the
  scales within one ulp of their dtype: XLA compiles ``amax / 127`` in the
  jitted kernel to a multiplication by the reciprocal, where the oracle, the
  port and its CUDA kernel divide;
* attention outputs: atol = rtol = 1e-5 in f32 (the kernel rescales its
  online softmax block by block); 1e-2 in bf16, under three bf16 ulps at
  |out| <= 3.1 (probabilities are rounded to bf16 against another running
  maximum, normalized in the oracle and not in the kernel);
* output rows of write-only slots (offset >= prefix_limit) are garbage by
  contract and left out of every comparison with JAX.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import ternary as jT
from repro.kernels.decode_attention import ops as j_da_ops
from repro.kernels.decode_attention import ref as j_da_ref
from repro.kernels.prefill_append import ops as j_pa_ops
from repro.kernels.prefill_append import ref as j_pa_ref
from repro.models import attention as jA
from repro_torch.core import ternary as TT
from repro_torch.kernels import KERNELS, launch_counts, reset_launch_counts
from repro_torch.kernels.decode_attention import ops as da_ops
from repro_torch.kernels.decode_attention import ref as da_ref
from repro_torch.kernels.prefill_append import ops as pa_ops
from repro_torch.kernels.prefill_append import ref as pa_ref
from repro_torch.models import attention as TA

TORCH_DT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
OUT_TOL = {"float32": 1e-5, "bfloat16": 1e-2}
SCALE_ULP = {"float32": 2.0 ** -23, "bfloat16": 2.0 ** -7}  # relative, one ulp

B, HK, C, M, D = 4, 2, 64, 256, 32
OFFSETS = np.array([0, C, 2 * C, 3 * C], np.int32)  # 0, C, 2C, and a write-only slot
PREFIX_LIMIT = 3 * C
LIVE = slice(0, 3)  # the slots whose outputs are compared with JAX


def _t(a, dtype=None):
    t = torch.from_numpy(np.array(a))  # a writable copy
    return t if dtype is None else t.to(dtype)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy() if x.dtype == torch.bfloat16 else x.numpy()
    return np.asarray(x.astype(jnp.float32) if x.dtype == jnp.bfloat16 else x)


def _inputs(dtype, quant, g, seed):
    """(jax operands, torch operands) for one chunk: q, k_new, v_new, the
    caches (and int8 scales), offsets."""
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, HK * g, C, D)).astype(np.float32)
    kn = rng.standard_normal((B, HK, C, D)).astype(np.float32)
    vn = rng.standard_normal((B, HK, C, D)).astype(np.float32)
    jd, td = getattr(jnp, dtype), TORCH_DT[dtype]
    jx = [jnp.asarray(a).astype(jd) for a in (q, kn, vn)]
    tx = [_t(a, td) for a in (q, kn, vn)]
    if quant:
        caches = [rng.integers(-127, 128, (B, HK, M, D)).astype(np.int8) for _ in range(2)]
        scales = [rng.uniform(1e-3, 2e-2, (B, HK, M)).astype(np.float32) for _ in range(2)]
        jc = [jnp.asarray(a) for a in caches + scales]
        tc = [_t(a) for a in caches + scales]
    else:
        caches = [rng.standard_normal((B, HK, M, D)).astype(np.float32) for _ in range(2)]
        jc = [jnp.asarray(a).astype(jd) for a in caches]
        tc = [_t(a, td) for a in caches]
    return jx + jc, tx + tc


CASES = [  # (g, window, softcap)
    (1, 0, 0.0),
    (2, 40, 0.0),
    (1, 0, 5.0),
]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("quant", [False, True], ids=["dense", "int8"])
@pytest.mark.parametrize("g,window,softcap", CASES)
def test_prefill_append_plain_vs_jax(dtype, quant, g, window, softcap):
    jargs, targs = _inputs(dtype, quant, g, seed=10 * g + window)
    off = jnp.asarray(OFFSETS)
    kw = dict(window=window, softcap=softcap)
    if quant:
        jq, jkn, jvn, jk, jv, jks, jvs = jargs
        want_k = j_pa_ops.prefill_append(jq, jkn, jvn, jk, jv, off, k_scale=jks, v_scale=jvs,
                                         prefix_limit=PREFIX_LIMIT, interpret=True, **kw)
        want_r = j_pa_ref.prefill_append_quant_reference(jq, jkn, jvn, jk, jv, jks, jvs, off,
                                                         **kw)
        tq, tkn, tvn, tk, tv, tks, tvs = targs
        got = pa_ref.prefill_append(tq, tkn, tvn, tk, tv, _t(OFFSETS), k_scale=tks,
                                    v_scale=tvs, prefix_limit=PREFIX_LIMIT, **kw)
        written = (tk, tv, tks, tvs)
    else:
        jq, jkn, jvn, jk, jv = jargs
        want_k = j_pa_ops.prefill_append(jq, jkn, jvn, jk, jv, off,
                                         prefix_limit=PREFIX_LIMIT, interpret=True, **kw)
        want_r = j_pa_ref.prefill_append_reference(jq, jkn, jvn, jk, jv, off, **kw)
        tq, tkn, tvn, tk, tv = targs
        got = pa_ref.prefill_append(tq, tkn, tvn, tk, tv, _t(OFFSETS),
                                    prefix_limit=PREFIX_LIMIT, **kw)
        written = (tk, tv)
    # the caches, written in place, equal the oracle's exactly
    for mine, ref_ in zip(written, want_r[1:]):
        np.testing.assert_array_equal(_np(mine), _np(ref_))
    # against the jitted kernel: codes and copies exact, scales within an ulp
    for mine, kern in zip(written[:2], want_k[1:3]):
        np.testing.assert_array_equal(_np(mine), _np(kern))
    for mine, kern in zip(written[2:], want_k[3:]):
        np.testing.assert_allclose(_np(mine), _np(kern), rtol=SCALE_ULP[dtype], atol=0)
    tol = OUT_TOL[dtype]
    for want in (want_k[0], want_r[0]):
        np.testing.assert_allclose(_np(got)[LIVE], _np(want)[LIVE], atol=tol, rtol=tol)


def test_write_only_slot_outputs_zeros():
    """A slot at offset >= prefix_limit only writes its chunk into the cache;
    its output rows, garbage by contract, are zero."""
    _, (q, kn, vn, k, v) = _inputs("float32", False, 1, seed=4)
    out = pa_ref.prefill_append(q, kn, vn, k, v, _t(OFFSETS), prefix_limit=PREFIX_LIMIT)
    assert out[3].eq(0).all() and out[:3].ne(0).any(dim=-1).all()
    assert torch.equal(k[3, :, 3 * C:], kn[3])


def test_append_leaves_other_rows_alone():
    _, (q, kn, vn, k, v, ks, vs) = _inputs("bfloat16", True, 1, seed=6)
    before = [t.clone() for t in (k, v, ks, vs)]
    pa_ref.prefill_append(q, kn, vn, k, v, _t(OFFSETS), k_scale=ks, v_scale=vs)
    for s, o in enumerate(OFFSETS):
        mask = np.ones(M, bool)
        mask[o:o + C] = False
        for new, old in zip((k, v, ks, vs), before):
            assert torch.equal(new[s][:, mask], old[s][:, mask])
    assert not torch.equal(k, before[0])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_append_and_update_quant_exact_vs_jax(dtype):
    """The XLA-form appends of the JAX package (run op by op) and the
    port's in-place ones write the same bytes and scales."""
    jargs, targs = _inputs(dtype, True, 1, seed=8)
    _, jkn, jvn, jk, jv, jks, jvs = jargs
    _, tkn, tvn, tk, tv, tks, tvs = targs
    off = jnp.asarray(OFFSETS)
    want = jA.append_kv_cache_quant(jk, jv, jks, jvs, jkn, jvn, off)
    TA.append_kv_cache_quant(tk, tv, tks, tvs, tkn, tvn, _t(OFFSETS))
    for mine, ref_ in zip((tk, tv, tks, tvs), want):
        np.testing.assert_array_equal(_np(mine), _np(ref_))
    pos = np.array([5, 70, 255, 0], np.int32)
    want = jA.update_kv_cache_quant(*want, jkn[:, :, 0], jvn[:, :, 0], jnp.asarray(pos))
    TA.update_kv_cache_quant(tk, tv, tks, tvs, tkn[:, :, 0], tvn[:, :, 0], _t(pos))
    for mine, ref_ in zip((tk, tv, tks, tvs), want):
        np.testing.assert_array_equal(_np(mine), _np(ref_))


def test_append_dense_exact_vs_jax():
    jargs, targs = _inputs("bfloat16", False, 1, seed=9)
    want = jA.append_kv_cache(jargs[3], jargs[4], jargs[1], jargs[2], jnp.asarray(OFFSETS))
    TA.append_kv_cache(targs[3], targs[4], targs[1], targs[2], _t(OFFSETS))
    for mine, ref_ in zip(targs[3:5], want):
        np.testing.assert_array_equal(_np(mine), _np(ref_))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_kv_exact_vs_jax(dtype):
    rng = np.random.default_rng(12)
    x = rng.standard_normal((3, 5, 24)).astype(np.float32) * 4
    x[1, 2] = 0.0  # an all-zero row takes the 1e-8 floor
    jx = jnp.asarray(x).astype(getattr(jnp, dtype))
    tx = _t(x, TORCH_DT[dtype])
    (jq, js), (tq, ts) = jT.quantize_kv(jx), TT.quantize_kv(tx)
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    assert tuple(ts.shape) == (3, 5)
    for out_dtype in (jnp.float32, jnp.bfloat16):
        want = jT.dequantize_kv(jq, js, out_dtype)
        got = TT.dequantize_kv(tq, ts, TORCH_DT[jnp.dtype(out_dtype).name])
        np.testing.assert_array_equal(_np(got), _np(want))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("g,window,softcap", [(1, 0, 0.0), (2, 37, 5.0)])
def test_decode_attention_int8_plain_vs_jax(dtype, g, window, softcap):
    rng = np.random.default_rng(20 + g)
    b, hk, m, d = 3, 4, 200, 24
    q = rng.standard_normal((b, hk * g, d)).astype(np.float32)
    k8, v8 = (rng.integers(-127, 128, (b, hk, m, d)).astype(np.int8) for _ in range(2))
    ks, vs = (rng.uniform(1e-3, 2e-2, (b, hk, m)).astype(np.float32) for _ in range(2))
    pos = np.array([m - 1, 17, 130], np.int32)
    jq = jnp.asarray(q).astype(getattr(jnp, dtype))
    jargs = (jq, jnp.asarray(k8), jnp.asarray(v8), jnp.asarray(pos))
    kw = dict(window=window, softcap=softcap)
    want_k = j_da_ops.decode_attention(*jargs, k_scale=jnp.asarray(ks), v_scale=jnp.asarray(vs),
                                       bkv=64, interpret=True, **kw)
    want_r = j_da_ref.decode_attention_quant_reference(
        jq, jnp.asarray(k8), jnp.asarray(v8), jnp.asarray(ks), jnp.asarray(vs),
        jnp.asarray(pos), **kw)
    targs = (_t(q, TORCH_DT[dtype]), _t(k8), _t(v8), _t(pos))
    for fn in (da_ref.decode_attention, da_ops.decode_attention):
        got = fn(*targs, k_scale=_t(ks), v_scale=_t(vs), **kw)
        for want in (want_k, want_r):
            tol = OUT_TOL[dtype]
            np.testing.assert_allclose(_np(got), _np(want), atol=tol, rtol=tol)
    got = da_ops.decode_attention_quant(*targs[:3], _t(ks), _t(vs), targs[3], **kw)
    np.testing.assert_allclose(_np(got), _np(want_k), atol=OUT_TOL[dtype], rtol=OUT_TOL[dtype])


def test_cpu_wrappers_run_plain_and_count_nothing():
    """CPU tensors take the plain versions through every new wrapper and
    through the kernel set; no launch is counted."""
    _, (q, kn, vn, k, v, ks, vs) = _inputs("float32", True, 1, seed=2)
    reset_launch_counts()
    out = KERNELS.prefill_append(q, kn, vn, k.clone(), v.clone(), _t(OFFSETS),
                                 k_scale=ks.clone(), v_scale=vs.clone())
    want = pa_ref.prefill_append(q, kn, vn, k.clone(), v.clone(), _t(OFFSETS),
                                 k_scale=ks.clone(), v_scale=vs.clone())
    assert torch.equal(out, want)
    out = pa_ops.prefill_append_quant(q, kn, vn, k.clone(), v.clone(), ks.clone(),
                                      vs.clone(), _t(OFFSETS))
    assert torch.equal(out, want)
    assert sum(launch_counts().values()) == 0


@pytest.mark.parametrize("quant", [False, True], ids=["dense", "int8"])
def test_unaligned_append_plain_vs_jax_xla(quant):
    """A chunk at offsets that are no multiple of C (speculative verify's
    decode frontiers), through the model-level form with the kernel set:
    the caches equal JAX's XLA form (``aligned=False``) exactly, the live
    outputs within the f32 bar."""
    jargs, targs = _inputs("float32", quant, 1, seed=1)
    offsets = np.array([5, 61, 130, 3 * C], np.int32)  # the last one write-only
    jkw = dict(k_scale=jargs[5], v_scale=jargs[6]) if quant else {}
    want = jA.prefill_append_attention(*jargs[:5], jnp.asarray(offsets), impl="xla",
                                       aligned=False, prefix_limit=PREFIX_LIMIT, **jkw)
    tkw = dict(k_scale=targs[5], v_scale=targs[6]) if quant else {}
    got = TA.prefill_append_attention(*targs[:5], _t(offsets), kernels=KERNELS,
                                      prefix_limit=PREFIX_LIMIT, **tkw)
    for mine, ref_ in zip(targs[3:], want[1:]):
        np.testing.assert_array_equal(_np(mine), _np(ref_))
    tol = OUT_TOL["float32"]
    np.testing.assert_allclose(_np(got)[LIVE], _np(want[0])[LIVE], atol=tol, rtol=tol)


def test_new_wrappers_refuse_non_cuda_devices():
    """A tensor on neither the CPU nor a CUDA device is refused, never run
    through the plain version."""
    def meta(*shape, dtype=torch.float32):
        return torch.ones(shape, dtype=dtype, device="meta")

    with pytest.raises(ValueError, match="CUDA"):
        pa_ops.prefill_append(meta(1, 2, C, D), meta(1, 2, C, D), meta(1, 2, C, D),
                              meta(1, 2, M, D), meta(1, 2, M, D),
                              meta(1, dtype=torch.int32))
    with pytest.raises(ValueError, match="CUDA"):
        da_ops.decode_attention_quant(meta(1, 2, D), meta(1, 2, M, D, dtype=torch.int8),
                                      meta(1, 2, M, D, dtype=torch.int8), meta(1, 2, M),
                                      meta(1, 2, M), meta(1, dtype=torch.int32))
