"""PyTorch port, the table-lookup (TL) matmul engine (``matmul_engine="tl"``):
each piece against the JAX package on the same numpy inputs, and the TL
path against the port's own packed path.

Bars:
* exact: ``tl_indices`` (uint8 here, int32 in JAX; ragged N included),
  ``build_tables``, ``tl_matmul_int``; the plain ``tl_matmul`` from int8
  rows and from tables against the JAX oracle and the JAX Pallas kernel
  in interpret mode, except with a residual in f32, where XLA's CPU
  compiler fuses ``(acc·xs)·ws + r`` into one multiply-add: there one
  rounding of that multiply (as test_torch_kernels.py::
  test_ternary_projection_plain_exact); ``tl_gemv`` (scalar and
  per-channel scales); ``tl_swiglu``'s codes and scales against the port's
  packed ``ternary_swiglu`` plain version (against JAX: codes within 1,
  scales within rtol 5e-7, f32's SwiGLU bar in test_torch_kernels.py);
  ``norm_quant_tables``: codes and scales those of ``norm_quant``, tables
  ``build_tables`` of the codes;
* exact: ``resolve_engine`` forced, pinned, and ``"auto"`` with and without
  a record (after tests/test_tl_engine.py::TestEngineDispatch), on a
  private store file, restored in the fixture's teardown;
* model level, f32 smoke config: ``forward`` logits under TL bit-equal to
  packed; greedy ``generate`` streams equal to the JAX TL streams; the
  ``ServingEngine`` under TL gives the port's packed streams and statuses
  on both layouts and both cache dtypes. The int8 smoke model is chaotic
  at the ulp level (ROADMAP C1), so int8 TL is held to the port's own
  packed engine, which runs the same ops, and not to JAX.
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config
from repro.core import bitlinear as jBL
from repro.core import packing as jPK
from repro.core import params as P
from repro.core import tl_matmul as jTL
from repro.kernels.fused_norm_quant import ops as j_nq_ops
from repro.kernels.tl_gemv import ops as j_tl_ops
from repro.kernels.tl_gemv import ref as j_tl_ref
from repro.models import transformer as jT
from repro.serving import engine as jE
from repro_torch import interop
from repro_torch.configs import get_config as t_get_config
from repro_torch.core import bitlinear as BL
from repro_torch.core import packing as PK
from repro_torch.core import tl_matmul as TL
from repro_torch.kernels import KERNELS, PLAIN, autotune
from repro_torch.kernels.fused_norm_quant import ops as nq_ops
from repro_torch.kernels.fused_norm_quant import ref as nq_ref
from repro_torch.kernels.ternary_matmul import ref as tm_ref
from repro_torch.kernels.tl_gemv import ops as tl_ops
from repro_torch.kernels.tl_gemv import ref as tl_ref
from repro_torch.models import transformer as TT
from repro_torch.serving import engine as TE

TORCH_DT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@pytest.fixture
def store(tmp_path):
    """A private, empty autotune store; the default is restored after."""
    autotune.set_cache_path(tmp_path / "autotune.json")
    yield tmp_path / "autotune.json"
    autotune.set_cache_path(None)


def _t(a, dtype=None):
    t = torch.from_numpy(np.array(a))
    return t if dtype is None else t.to(dtype)


def _np(t):
    return t.float().numpy() if t.dtype == torch.bfloat16 else t.numpy()


def _weights(n, k, seed):
    """Ternary [n, k] with n % 4 == 0, its pack2 bytes, and its group indices
    as int32 numpy (the JAX side's dtype) and as the port's uint8. The port's
    indices stand in for JAX's: test_tl_indices_match_jax holds them equal."""
    w = np.random.default_rng(seed).integers(-1, 2, (n, k)).astype(np.int8)
    wp = PK.pack2(_t(w))
    idx = TL.tl_indices(wp)
    return w, wp.numpy(), idx.numpy().astype(np.int32), idx


def _acts(m, n, seed):
    rng = np.random.default_rng(seed)
    x = rng.integers(-127, 128, (m, n)).astype(np.int8)
    return x, rng.uniform(0.01, 0.2, (m, 1)).astype(np.float32)


# ---------------------------------------------------------------------------
# core: indices, tables, the integer product
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n,k", [(64, 40), (72, 44), (128, 64), (4, 3)])
def test_tl_indices_match_jax(n, k):
    """N = 64 and 128 leave a last group of one trit, 4 of one: the zero-trit
    pad; 72 fills its groups."""
    w, wp, _, idx = _weights(n, k, seed=n + k)
    np.testing.assert_array_equal(wp, np.asarray(jPK.pack2(jnp.asarray(w))))
    j_idx = np.asarray(jTL.tl_indices(jnp.asarray(wp)))
    assert idx.dtype == torch.uint8 and idx.shape == j_idx.shape == (-(-n // 3), k)
    np.testing.assert_array_equal(idx.numpy().astype(np.int32), j_idx)
    dec = PK.decode_groups(idx, 3)
    np.testing.assert_array_equal(dec[:n].numpy(), w)
    assert not dec[n:].any()


def test_tl_indices_stacked_and_packing_helpers():
    wp = np.stack([_weights(24, 8, seed=s)[1] for s in (1, 2, 3)])
    np.testing.assert_array_equal(TL.tl_indices(_t(wp)).numpy().astype(np.int32),
                                  np.asarray(jTL.tl_indices(jnp.asarray(wp))))
    w = np.random.default_rng(4).integers(-1, 2, (12, 5)).astype(np.int8)
    np.testing.assert_array_equal(PK.encode_groups(_t(w), 3).numpy().astype(np.int32),
                                  np.asarray(jPK.encode_groups(jnp.asarray(w), 3)))
    np.testing.assert_array_equal(
        TL.preprocess_weights(_t(w)).numpy().astype(np.int32),
        np.asarray(jTL.preprocess_weights(jnp.asarray(w))))
    np.testing.assert_array_equal(PK.combo_matrix(3).numpy(), jPK.combo_matrix_np(3))
    assert int(PK.encode_groups(torch.zeros((3, 1), dtype=torch.int8), 3)) == 13


@pytest.mark.parametrize("shape,n", [((5, 64), 64), ((2, 3, 72), 72), ((4, 130), 130)])
def test_build_tables_and_int_product_match_jax(shape, n):
    x = np.random.default_rng(n).integers(-127, 128, shape).astype(np.int8)
    t = -(-n // 3)
    got = TL.build_tables(_t(x), t=t)
    want = np.asarray(jTL.build_tables(jnp.asarray(x), t=t))
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)
    assert np.abs(want).max() <= 381
    x2 = x.reshape(-1, n)
    pad = t * 3 - n
    xp = np.pad(x2, ((0, 0), (0, pad)))
    w, _, j_idx, idx = _weights(4 * -(-n // 4), 24, seed=n + 1)
    idx, j_idx = idx[:t], j_idx[:t]  # the groups of the first n (+ pad) rows
    acc = TL.tl_matmul_int(_t(xp), idx)
    np.testing.assert_array_equal(acc.numpy(), np.asarray(jTL.tl_matmul_int(
        jnp.asarray(xp), jnp.asarray(j_idx))))
    np.testing.assert_array_equal(acc.numpy(), xp.astype(np.int32) @ PK.decode_groups(
        idx, 3).numpy().astype(np.int32))


@pytest.mark.parametrize("chunk", [1, 6 * 30, 6 * 30 * 5])
def test_lookup_sum_chunks_exactly(chunk):
    """Chunking the group axis changes nothing (one group a chunk, one, five)."""
    x, _ = _acts(6, 72, seed=5)
    _, _, _, idx = _weights(72, 30, seed=6)
    tables = TL.build_tables(_t(x), t=24)
    want = x.astype(np.int32) @ PK.decode_groups(idx, 3).numpy().astype(np.int32)
    np.testing.assert_array_equal(TL.lookup_sum(tables, idx, chunk=chunk).numpy(), want)


# ---------------------------------------------------------------------------
# kernels' plain versions and wrappers (the CPU dispatch) against JAX
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("m,n,k", [(1, 64, 44), (40, 72, 130)])
@pytest.mark.parametrize("residual", [False, True])
def test_tl_matmul_plain_exact(m, n, k, residual):
    x, xs = _acts(m, n, seed=m + n)
    r = np.random.default_rng(k).standard_normal((m, k)).astype(np.float32)
    _, wp, j_idx, idx = _weights(n, k, seed=n + k)
    ws = np.float32(0.61)
    res_j, res_t = (jnp.asarray(r), _t(r)) if residual else (None, None)
    t = j_idx.shape[0]
    plain = jTL.tl_matmul(jnp.asarray(np.pad(x, ((0, 0), (0, 3 * t - n)))), jnp.asarray(xs),
                          jnp.asarray(j_idx), jnp.asarray(ws))
    want = np.asarray(plain if res_j is None else plain + res_j)
    oracle = np.asarray(j_tl_ref.tl_matmul(jnp.asarray(x), jnp.asarray(xs), jnp.asarray(j_idx),
                                           jnp.asarray(ws), residual=res_j))
    kern = np.asarray(j_tl_ops.tl_matmul(jnp.asarray(x), jnp.asarray(xs), jnp.asarray(j_idx),
                                         jnp.asarray(ws), residual=res_j, impl="kernel",
                                         interpret=True))
    fma = (np.spacing(np.abs(np.asarray(plain)).max()) + np.spacing(np.abs(want).max())
           if residual else 0.0)
    tables = TL.build_tables(_t(x), t=t)
    packed = tm_ref.ternary_matmul(_t(x), _t(xs), _t(wp), torch.tensor(ws), residual=res_t)
    for tab in (None, tables):
        for fn in (tl_ref.tl_matmul, tl_ops.tl_matmul):
            got = fn(_t(x), _t(xs), idx, torch.tensor(ws), tables=tab, residual=res_t)
            assert torch.equal(got, packed)
            np.testing.assert_array_equal(got.numpy(), want)
            np.testing.assert_array_equal(got.numpy(), oracle)
            np.testing.assert_allclose(got.numpy(), kern, atol=fma, rtol=0)
    # from tables alone, x_i8 absent
    got = tl_ops.tl_matmul(None, _t(xs), idx, torch.tensor(ws), tables=tables, residual=res_t)
    assert torch.equal(got, packed)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_tl_matmul_out_dtype_and_lead_dims(dtype):
    x, xs = _acts(6, 64, seed=7)
    _, wp, j_idx, idx = _weights(64, 20, seed=8)
    r = np.random.default_rng(9).standard_normal((2, 3, 20)).astype(np.float32)
    ws = np.float32(0.3)
    dt = TORCH_DT[dtype]
    got = tl_ops.tl_matmul(_t(x).reshape(2, 3, 64), _t(xs).reshape(2, 3, 1), idx,
                           torch.tensor(ws), residual=_t(r, dt), out_dtype=dt)
    want = tm_ref.ternary_matmul(_t(x).reshape(2, 3, 64), _t(xs).reshape(2, 3, 1), _t(wp),
                                 torch.tensor(ws), residual=_t(r, dt), out_dtype=dt)
    assert got.dtype == dt and got.shape == (2, 3, 20) and torch.equal(got, want)
    j = j_tl_ref.tl_matmul(jnp.asarray(x), jnp.asarray(xs), jnp.asarray(j_idx), jnp.asarray(ws),
                           out_dtype=getattr(jnp, dtype))
    g2 = tl_ops.tl_matmul(_t(x), _t(xs), idx, torch.tensor(ws), out_dtype=dt)
    np.testing.assert_array_equal(_np(g2), np.asarray(j, np.float32))


@pytest.mark.parametrize("m,per_channel", [(1, False), (16, True)])
def test_tl_gemv_plain_exact(m, per_channel):
    n, k = 64, 128  # the JAX kernel's blocks are 128 columns
    x, xs = _acts(m, n, seed=20 + m)
    _, _, j_idx, idx = _weights(n, k, seed=21)
    ws = (np.random.default_rng(22).uniform(0.1, 1.0, k).astype(np.float32) if per_channel
          else np.float32(0.4))
    xj = jnp.asarray(np.pad(x, ((0, 0), (0, 3 * j_idx.shape[0] - n))))
    kern = j_tl_ops.tl_gemv(xj, jnp.asarray(xs), jnp.asarray(j_idx), jnp.asarray(ws),
                            interpret=True)
    oracle = j_tl_ref.tl_gemv(xj, jnp.asarray(xs), jnp.asarray(j_idx), jnp.asarray(ws))
    for fn in (tl_ref.tl_gemv, tl_ops.tl_gemv):
        got = fn(_t(x), _t(xs), idx, _t(ws))
        assert got.dtype == torch.float32
        np.testing.assert_array_equal(got.numpy(), np.asarray(kern))
        np.testing.assert_array_equal(got.numpy(), np.asarray(oracle))


@pytest.mark.parametrize("m", [1, 6])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_tl_swiglu_plain(m, dtype):
    n, k = 64, 128
    x, xs = _acts(m, n, seed=30 + m)
    _, wg, jg, ig = _weights(n, k, seed=31)
    _, wu, ju, iu = _weights(n, k, seed=32)
    sg, su = np.float32(0.05), np.float32(0.04)
    dt = TORCH_DT[dtype]
    packed = tm_ref.ternary_swiglu(_t(x), _t(xs), _t(wg), torch.tensor(sg), _t(wu),
                                   torch.tensor(su), act_dtype=dt)
    jdt = getattr(jnp, dtype)
    jargs = (jnp.asarray(x), jnp.asarray(xs), jnp.asarray(jg), jnp.asarray(sg),
             jnp.asarray(ju), jnp.asarray(su))
    wants = [j_tl_ops.tl_swiglu(*jargs, act_dtype=jdt, impl="kernel", interpret=True),
             j_tl_ref.tl_swiglu(*jargs, act_dtype=jdt)]
    for tab in (None, TL.build_tables(_t(x), t=ig.shape[0])):
        for fn in (tl_ref.tl_swiglu, tl_ops.tl_swiglu):
            q, s = fn(_t(x), _t(xs), ig, torch.tensor(sg), iu, torch.tensor(su), tables=tab,
                      act_dtype=dt)
            assert torch.equal(q, packed[0]) and torch.equal(s, packed[1])
            for wq, ws_ in wants:
                np.testing.assert_allclose(s.numpy(), np.asarray(ws_),
                                           rtol=5e-7 if dtype == "float32" else 4.1e-3)
                assert (np.abs(q.numpy().astype(np.int32) - np.asarray(wq, np.int32)) <= 1).all()


@pytest.mark.parametrize("shape", [(4, 64), (2, 3, 200)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_norm_quant_tables_plain(shape, dtype):
    rng = np.random.default_rng(40)
    x = (rng.standard_normal(shape) * 3).astype(np.float32)
    g = rng.standard_normal(shape[-1]).astype(np.float32)
    xt = _t(x, TORCH_DT[dtype])
    for fn in (nq_ref.norm_quant_tables, nq_ops.norm_quant_tables):
        q, s, tab = fn(xt, _t(g))
        q0, s0 = nq_ops.norm_quant(xt, _t(g))
        assert torch.equal(q, q0) and torch.equal(s, s0)
        t = -(-shape[-1] // 3)
        assert tab.shape == (*shape[:-1], t * 27)
        assert torch.equal(tab, TL.build_tables(q, t=t))
    jq, js, jtab = j_nq_ops.norm_quant_tables(jnp.asarray(x).astype(getattr(jnp, dtype)),
                                              jnp.asarray(g), impl="kernel", interpret=True)
    np.testing.assert_allclose(s.numpy(), np.asarray(js),
                               rtol=5e-7 if dtype == "float32" else 4.1e-3)
    assert (np.abs(q.numpy().astype(np.int32) - np.asarray(jq, np.int32)) <= 1).all()
    same = (q.numpy() == np.asarray(jq)).all(axis=-1)  # rows whose codes agree
    np.testing.assert_array_equal(tab.numpy()[same], np.asarray(jtab)[same])


def test_cpu_dispatch_counts_nothing():
    """CPU tensors take the plain versions: no launch is counted, and the
    kernel sets hold the TL entries (the wrappers, and the plain versions)."""
    from repro_torch.kernels import launch_counts, reset_launch_counts

    x, xs = _acts(2, 64, seed=52)
    _, _, _, idx = _weights(64, 8, seed=53)
    ws = torch.tensor(0.5)
    reset_launch_counts()
    KERNELS.tl_matmul(_t(x), _t(xs), idx, ws)
    KERNELS.tl_swiglu(_t(x), _t(xs), idx, ws, idx, ws)
    KERNELS.norm_quant_tables(torch.ones(2, 64), torch.ones(64))
    tl_ops.tl_gemv(_t(x), _t(xs), idx, ws)
    assert sum(launch_counts().values()) == 0
    assert PLAIN.tl_matmul is tl_ref.tl_matmul and PLAIN.tl_swiglu is tl_ref.tl_swiglu
    assert PLAIN.norm_quant_tables is nq_ref.norm_quant_tables


def test_tl_wrappers_reject_bad_operands():
    x, xs = _acts(2, 64, seed=50)
    _, _, _, idx = _weights(64, 8, seed=51)
    ws = torch.tensor(0.5)
    with pytest.raises(ValueError):
        tl_ref.tl_matmul(_t(x)[:, :30], _t(xs), idx, ws)
    with pytest.raises(ValueError):
        tl_ref.tl_matmul(None, _t(xs), idx, ws, tables=torch.zeros((2, 27)))


# ---------------------------------------------------------------------------
# dispatch, the store, interop
# ---------------------------------------------------------------------------


def _node(n=64, k=32, seed=51, with_idx=True):
    _, wp, _, _ = _weights(n, k, seed)
    node = {"wp": _t(wp), "scale": torch.tensor(0.1)}
    return BL.with_tl_indices(node) if with_idx else node


def test_resolve_engine_forced_and_pinned(store):
    node = _node()
    assert BL.resolve_engine(node, 4, engine="tl") == "tl"
    assert BL.resolve_engine(node, 4, engine="packed") == "packed"
    with pytest.raises(ValueError):
        BL.resolve_engine(node, 4, engine="fast")


def test_resolve_engine_auto_needs_record_and_indices(store):
    node, plain = _node(), _node(with_idx=False)
    assert BL.resolve_engine(node, 4, engine="auto") == "packed"  # nothing on record
    assert autotune.record_engine(4, 64, 32, {"tl": 1.0, "packed": 2.0}) == "tl"
    assert BL.resolve_engine(node, 4, engine="auto") == "tl"
    assert BL.resolve_engine(node, 5, engine="auto") == "packed"  # another shape
    assert BL.resolve_engine(plain, 4, engine="auto") == "packed"  # no w_idx
    autotune.record_engine(4, 64, 32, {"tl": 3.0, "packed": 2.0})
    assert BL.resolve_engine(node, 4, engine="auto") == "packed"


def test_autotune_store_persists_and_rejects_bad_files(store):
    autotune.record("engine", autotune.shape_key(m=1, n=2, k=3), {"engine": "tl"}, 5.0,
                    losers={"packed": 6.0})
    raw = json.loads(store.read_text())
    assert raw["version"] == 1 and raw["kernels"]["engine"]["k3-m1-n2"]["losers"] == {
        "packed": 6.0}
    autotune.set_cache_path(store)  # drop the loaded store, read the file anew
    assert autotune.choose_engine(1, 2, 3) == "tl"
    assert autotune.best("engine", "k3-m1-n2", {"engine": "packed", "x": 1}) == {
        "engine": "tl", "x": 1}
    for bad in ("{not json", json.dumps({"version": 99, "kernels": {}}),
                json.dumps({"version": 1, "kernels": {"engine": {"k": {"us": 1}}}})):
        store.write_text(bad)
        autotune.set_cache_path(store)
        assert autotune.choose_engine(1, 2, 3) is None
    assert autotune.cache_path() == store
    autotune.set_cache_path(None)
    assert autotune.cache_path().name.startswith("autotune-")


def test_from_jax_params_carries_indices(models):
    jcfg, tcfg, jp, _ = models
    jtl = jBL.with_tl_tree(jp)
    tp = interop.from_jax_params(jax.device_get(jtl), tcfg, device="cpu")
    got = tp["blocks"]["b0"]["ffn"]["down"]["w_idx"]
    want = np.asarray(jtl["blocks"]["b0"]["ffn"]["down"]["w_idx"])
    assert got.dtype == torch.uint8 and got.shape == want.shape == (2, 43, 64)
    np.testing.assert_array_equal(got.numpy(), want)
    assert torch.equal(BL.with_tl_tree(tp)["blocks"]["b0"]["attn"]["q"]["w_idx"],
                       tp["blocks"]["b0"]["attn"]["q"]["w_idx"])
    bad = jax.device_get(jtl)
    bad["blocks"]["b0"]["attn"]["q"]["w_idx"] = np.full((2, 22, 64), 27, np.int32)
    with pytest.raises(ValueError, match="outside"):
        interop.from_jax_params(bad, tcfg, device="cpu")


# ---------------------------------------------------------------------------
# the model and the serving paths, f32 smoke config
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def models():
    jcfg = dataclasses.replace(get_config("tellme-0.7b", smoke=True), dtype=jnp.float32)
    tcfg = dataclasses.replace(t_get_config("tellme-0.7b", smoke=True), dtype=torch.float32)
    specs = jT.param_specs(jcfg)
    jp = jT.pack_tree(P.init_params(specs, jax.random.PRNGKey(0)), specs)
    tp = interop.from_jax_params(jax.device_get(jp), tcfg, device="cpu")
    return jcfg, tcfg, jp, tp


def test_forward_tl_bit_equal_to_packed(store, models):
    _, tcfg, _, tp = models
    toks = torch.from_numpy(np.random.default_rng(60).integers(0, 256, (2, 24))).long()
    packed, _ = TT.forward(tp, toks, tcfg, kernels=KERNELS)
    tl_cfg = dataclasses.replace(tcfg, matmul_engine="tl")
    got, _ = TT.forward(TE.engine_params(tp, tl_cfg), toks, tl_cfg, kernels=KERNELS)
    assert torch.equal(got, packed)
    # without precomputed indices the TL path derives them, same logits
    got2, _ = TT.forward(tp, toks, tl_cfg, kernels=PLAIN)
    assert torch.equal(got2, packed)


def test_block_engines(store, models):
    """Forced TL is every projection's; "auto" stays packed with nothing on
    record, and follows the record shape by shape."""
    _, tcfg, _, tp = models
    bp = TT.layer_slice(TE.engine_params(tp, dataclasses.replace(tcfg, matmul_engine="tl"))
                        ["blocks"]["b0"], 0)
    assert set(TT.block_engines(bp, 4, "tl").values()) == {"tl"}
    assert set(TT.block_engines(bp, 4, "auto").values()) == {"packed"}
    autotune.record_engine(4, 64, 64, {"tl": 1.0, "packed": 2.0})  # q, k, v, o
    eng = TT.block_engines(bp, 4, "auto")
    assert eng == {"q": "tl", "k": "tl", "v": "tl", "o": "tl", "gate": "packed",
                   "down": "packed"}


def test_generate_tl_streams_equal_jax(store, models):
    jcfg, tcfg, jp, tp = models
    prompts = np.random.default_rng(11).integers(0, jcfg.vocab_size, (3, 13)).astype(np.int32)
    want = jE.generate(jp, dataclasses.replace(jcfg, matmul_engine="tl"), jnp.asarray(prompts),
                       steps=10, mode="packed")
    got = TE.generate(tp, dataclasses.replace(tcfg, matmul_engine="tl"), prompts, steps=10,
                      device="cpu")
    np.testing.assert_array_equal(got.tokens.numpy(), np.asarray(want.tokens))
    packed = TE.generate(tp, tcfg, prompts, steps=10, device="cpu")
    assert torch.equal(got.tokens, packed.tokens)


@pytest.mark.parametrize("layout", ["contiguous", "paged"])
@pytest.mark.parametrize("kv", ["bf16", "int8"])
def test_engine_tl_equals_packed(store, models, layout, kv):
    _, tcfg, _, tp = models
    cfg = dataclasses.replace(tcfg, kv_cache_dtype=kv, kv_layout=layout)
    rng = np.random.default_rng(70)
    prefix = rng.integers(0, cfg.vocab_size, 128)
    prompts = [rng.integers(0, cfg.vocab_size, n) for n in (9, 70, 130)]
    prompts.append(np.concatenate([prefix, rng.integers(0, cfg.vocab_size, 20)]))
    prompts.append(np.concatenate([prefix, rng.integers(0, cfg.vocab_size, 7)]))

    def serve(c):
        eng = TE.ServingEngine(tp, c, slots=2, max_len=256, kernels=PLAIN, device="cpu")
        reqs = [TE.Request(rid=i, prompt=p, max_new=5) for i, p in enumerate(prompts)]
        for r in reqs:
            eng.submit(r)
        eng.run()
        st = eng.stats()
        return [(r.generated, r.status, r.status_detail) for r in reqs], st["ticks"], st["paged"]

    got = serve(dataclasses.replace(cfg, matmul_engine="tl"))
    want = serve(cfg)
    assert got == want
    assert all(status.name == "OK" for _, status, _ in got[0])
