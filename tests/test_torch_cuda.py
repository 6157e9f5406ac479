"""PyTorch port on a CUDA device: each CUDA kernel against its plain
PyTorch version, and the smoke model through the kernels against the plain
versions. Every test here needs the card (marker ``gpu``) and skips
without one; the file imports neither JAX nor the JAX package, so it runs
on the card's machine:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_cuda.py

Bars as in test_torch_kernels.py: ternary projections exact; norm-quant and
SwiGLU codes within 1 and scales within one ulp of the activation dtype;
decode attention (bf16 and int8 caches) and prefill-append within 1e-5
(f32) or 4e-3 (bf16, atol = rtol: two bf16 ulps at |out| <= 0.5; the
prefill inputs' V is scaled so that |out| stays near that). The rows the
prefill-append kernel writes into the cache equal the plain version's
exactly (bf16 copies, or int8 codes and f32 scales), and every other cache
row is left as it was.
"""

import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.core import packing as PK
from repro_torch.core import params as PR
from repro_torch.kernels import KERNELS, PLAIN, launch_counts, reset_launch_counts
from repro_torch.kernels.decode_attention import ops as da_ops
from repro_torch.kernels.decode_attention import ref as da_ref
from repro_torch.kernels.fused_norm_quant import ops as nq_ops
from repro_torch.kernels.fused_norm_quant import ref as nq_ref
from repro_torch.kernels.prefill_append import ops as pa_ops
from repro_torch.kernels.prefill_append import ref as pa_ref
from repro_torch.kernels.ternary_matmul import ops as tm_ops
from repro_torch.kernels.ternary_matmul import ref as tm_ref
from repro_torch.models import transformer as TT
from repro_torch.serving import engine as TE

pytestmark = pytest.mark.gpu

TORCH_DT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
QUANT_RTOL = {"float32": 5e-7, "bfloat16": 4.1e-3}
ATTN_TOL = {"float32": 1e-5, "bfloat16": 4e-3}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc (the kernels have no CPU mode)")
    return torch.device("cuda")


def _t(a, dev, dtype=None):
    t = torch.from_numpy(np.array(a)).to(dev)
    return t if dtype is None else t.to(dtype)


def _assert_quant_close(got, want, rtol):
    (qg, sg), (qw, sw) = [[t.cpu() for t in pair] for pair in (got, want)]
    torch.testing.assert_close(sg, sw, rtol=rtol, atol=0)
    assert (qg.to(torch.int32) - qw.to(torch.int32)).abs().max().item() <= 1


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("m", [1, 7, 512])
def test_norm_quant(cuda, dtype, m):
    rng = np.random.default_rng(30 + m)
    x = _t(rng.standard_normal((m, 1536)).astype(np.float32) * 3, cuda, TORCH_DT[dtype])
    g = _t(rng.standard_normal(1536).astype(np.float32), cuda)
    _assert_quant_close(nq_ops.norm_quant(x, g), nq_ref.norm_quant(x, g), QUANT_RTOL[dtype])


@pytest.mark.parametrize("m", [1, 4, 16, 40, 130])
@pytest.mark.parametrize("n,k", [(1536, 1536), (4096, 1536), (72, 44)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ternary_projection(cuda, m, n, k, dtype):
    rng = np.random.default_rng(m + n + k)
    wp = PK.pack2(_t(rng.integers(-1, 2, (n, k)).astype(np.int8), cuda))
    x = _t(rng.integers(-127, 128, (m, n)).astype(np.int8), cuda)
    xs = _t(rng.uniform(1e-4, 1e-2, (m, 1)).astype(np.float32), cuda)
    ws = torch.tensor(0.61, device=cuda)
    res = _t(rng.standard_normal((m, k)).astype(np.float32), cuda, TORCH_DT[dtype])
    for residual in (None, res):
        for fn in (tm_ops.ternary_gemv, tm_ops.ternary_matmul):
            got = fn(x, xs, wp, ws, out_dtype=TORCH_DT[dtype], residual=residual)
            want = tm_ref.ternary_matmul(x, xs, wp, ws, out_dtype=TORCH_DT[dtype],
                                         residual=residual)
            assert torch.equal(got, want)


@pytest.mark.parametrize("m", [1, 4, 64])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ternary_swiglu(cuda, m, dtype):
    rng = np.random.default_rng(40 + m)
    wg = PK.pack2(_t(rng.integers(-1, 2, (1536, 4096)).astype(np.int8), cuda))
    wu = PK.pack2(_t(rng.integers(-1, 2, (1536, 4096)).astype(np.int8), cuda))
    x = _t(rng.integers(-127, 128, (m, 1536)).astype(np.int8), cuda)
    xs = _t(rng.uniform(0.001, 0.01, (m, 1)).astype(np.float32), cuda)
    s = torch.tensor(0.05, device=cuda)
    got = tm_ops.ternary_swiglu(x, xs, wg, s, wu, s, act_dtype=TORCH_DT[dtype])
    want = tm_ref.ternary_swiglu(x, xs, wg, s, wu, s, act_dtype=TORCH_DT[dtype])
    _assert_quant_close(got, want, QUANT_RTOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("g,window,softcap", [(1, 0, 0.0), (2, 100, 30.0), (4, 0, 5.0)])
def test_decode_attention(cuda, dtype, g, window, softcap):
    rng = np.random.default_rng(9 + g)
    b, hk, m, d = 4, 8, 300, 96
    q = _t(rng.standard_normal((b, hk * g, d)).astype(np.float32), cuda, TORCH_DT[dtype])
    k = _t(rng.standard_normal((b, hk, m, d)).astype(np.float32), cuda, TORCH_DT[dtype])
    v = _t(rng.standard_normal((b, hk, m, d)).astype(np.float32), cuda, TORCH_DT[dtype])
    pos = torch.tensor([299, 0, 63, 150], dtype=torch.int32, device=cuda)
    got = da_ops.decode_attention(q, k, v, pos, window=window, softcap=softcap)
    want = da_ref.decode_attention(q, k, v, pos, window=window, softcap=softcap)
    tol = ATTN_TOL[dtype]
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("g,window,softcap", [(1, 0, 0.0), (2, 100, 30.0)])
def test_decode_attention_int8(cuda, dtype, g, window, softcap):
    rng = np.random.default_rng(19 + g)
    b, hk, m, d = 4, 8, 300, 96
    q = _t(rng.standard_normal((b, hk * g, d)).astype(np.float32), cuda, TORCH_DT[dtype])
    k, v = (_t(rng.integers(-127, 128, (b, hk, m, d)).astype(np.int8), cuda) for _ in range(2))
    ks, vs = (_t(rng.uniform(1e-3, 2e-2, (b, hk, m)).astype(np.float32), cuda)
              for _ in range(2))
    pos = torch.tensor([299, 0, 63, 150], dtype=torch.int32, device=cuda)
    kw = dict(k_scale=ks, v_scale=vs, window=window, softcap=softcap)
    got = da_ops.decode_attention(q, k, v, pos, **kw)
    want = da_ref.decode_attention(q, k, v, pos, **kw)
    tol = ATTN_TOL[dtype]
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("quant", [False, True], ids=["dense", "int8"])
@pytest.mark.parametrize("c,d,g,window,softcap", [(256, 96, 1, 0, 0.0), (64, 96, 2, 100, 30.0),
                                                  (128, 16, 1, 0, 5.0), (64, 32, 4, 0, 0.0)])
def test_prefill_append(cuda, dtype, quant, c, d, g, window, softcap):
    """Offsets 0, C and 4C with one write-only slot past prefix_limit."""
    rng = np.random.default_rng(c + d + g)
    b, hk = 4, 4
    m = 6 * c
    td = TORCH_DT[dtype]
    q = _t(rng.standard_normal((b, hk * g, c, d)).astype(np.float32), cuda, td)
    kn = _t(rng.standard_normal((b, hk, c, d)).astype(np.float32), cuda, td)
    vn = _t(rng.standard_normal((b, hk, c, d)).astype(np.float32) * 0.25, cuda, td)
    off = torch.tensor([0, c, 4 * c, 5 * c], dtype=torch.int32, device=cuda)
    if quant:
        caches = [_t(rng.integers(-127, 128, (b, hk, m, d)).astype(np.int8), cuda)
                  for _ in range(2)]
        caches += [_t(rng.uniform(1e-3, 2e-2, (b, hk, m)).astype(np.float32), cuda)
                   for _ in range(2)]
    else:
        caches = [_t(rng.standard_normal((b, hk, m, d)).astype(np.float32) * s, cuda, td)
                  for s in (1.0, 0.25)]
    mine, plain = [t.clone() for t in caches], [t.clone() for t in caches]

    def call(fn, cs):
        kw = dict(k_scale=cs[2], v_scale=cs[3]) if quant else {}
        return fn(q, kn, vn, cs[0], cs[1], off, window=window, softcap=softcap,
                  prefix_limit=5 * c, **kw)

    got, want = call(pa_ops.prefill_append, mine), call(pa_ref.prefill_append, plain)
    torch.cuda.synchronize()
    tol = ATTN_TOL[dtype]
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)
    for a, w, before in zip(mine, plain, caches):
        assert torch.equal(a, w)  # appended rows bit-equal, the rest untouched
        written = torch.zeros(a.shape[:3], dtype=torch.bool, device=cuda)
        for s, o in enumerate(off.tolist()):
            written[s, :, o:o + c] = True
        assert torch.equal(a[~written], before[~written])


def test_prefill_append_counts_its_launches(cuda):
    q = torch.zeros((1, 2, 64, 32), device=cuda)
    k = torch.zeros((1, 2, 128, 32), device=cuda)
    off = torch.zeros((1,), dtype=torch.int32, device=cuda)
    reset_launch_counts()
    pa_ops.prefill_append(q, q, q, k, k.clone(), off)
    k8 = torch.zeros((1, 2, 128, 32), dtype=torch.int8, device=cuda)
    s = torch.ones((1, 2, 128), device=cuda)
    KERNELS.prefill_append(q, q, q, k8, k8.clone(), off, k_scale=s, v_scale=s.clone())
    counts = launch_counts()
    assert counts["prefill_append"] == 1 and counts["prefill_append_quant"] == 1
    with pytest.raises(ValueError, match="head_dim"):
        pa_ops.prefill_append(q[..., :24].contiguous(), q[..., :24].contiguous(),
                              q[..., :24].contiguous(), k[..., :24].contiguous(),
                              k[..., :24].contiguous(), off)


def test_wrappers_validate_inputs(cuda):
    x = torch.zeros((2, 8), dtype=torch.int8, device=cuda)
    with pytest.raises(TypeError):
        tm_ops.ternary_gemv(x, torch.ones((2, 1), device=cuda),
                            torch.zeros((2, 4), dtype=torch.int8, device=cuda),
                            torch.tensor(1.0, device=cuda))
    with pytest.raises(ValueError):
        nq_ops.norm_quant(torch.ones((8, 2), device=cuda).t(), torch.ones(8, device=cuda))


def test_smoke_generate_kernels_vs_plain(cuda):
    """The smoke config in f32 through the kernels: same greedy stream as
    the plain versions, and every kernel of generate's path launched."""
    cfg = dataclasses.replace(get_config("tellme-0.7b", smoke=True), dtype=torch.float32)
    specs = TT.param_specs(cfg)
    params = TT.pack_tree(PR.init_params(specs, seed=0, device=cuda), specs, dtype=cfg.dtype)
    prompts = torch.randint(0, cfg.vocab_size, (3, 13), generator=torch.Generator().manual_seed(1))
    reset_launch_counts()
    got = TE.generate(params, cfg, prompts, steps=12, kernels=KERNELS)
    counts = launch_counts()
    want = TE.generate(params, cfg, prompts, steps=12, kernels=PLAIN)
    assert torch.equal(got.tokens, want.tokens)
    path = ("norm_quant", "ternary_gemv", "ternary_matmul", "ternary_swiglu",
            "decode_attention")
    assert all(counts[n] > 0 for n in path), counts


@pytest.mark.parametrize("kv", ["bf16", "int8"])
def test_smoke_engine_kernels_vs_plain(cuda, kv):
    """The f32 smoke config in the chunked engine: through the kernels on
    the card, the same streams and statuses as through the plain versions
    on the CPU, one host transfer per tick, and the attention kernels of
    its cache dtype launched 2 (layers) times per tick that runs them."""
    cfg = dataclasses.replace(get_config("tellme-0.7b", smoke=True), dtype=torch.float32,
                              kv_cache_dtype=kv)
    specs = TT.param_specs(cfg)
    cpu_params = TT.pack_tree(PR.init_params(specs, seed=0, device="cpu"), specs,
                              dtype=cfg.dtype)
    rng = np.random.default_rng(2)
    prompts = [rng.integers(0, cfg.vocab_size, n) for n in (9, 30, 70, 130, 200)]

    def serve(params, kernels, device):
        eng = TE.ServingEngine(params, cfg, slots=2, max_len=256, kernels=kernels,
                               device=device)
        reqs = [TE.Request(rid=i, prompt=p, max_new=8) for i, p in enumerate(prompts)]
        for r in reqs:
            eng.submit(r)
        eng.run()
        return [(r.generated, r.status) for r in reqs], eng

    reset_launch_counts()
    got, eng = serve(_to(cpu_params, cuda), KERNELS, None)
    counts = launch_counts()
    want, _ = serve(cpu_params, PLAIN, "cpu")
    assert got == want
    st = eng.stats()
    assert st["host_transfers"] == st["ticks"]
    sfx = "_quant" if kv == "int8" else ""
    assert counts["decode_attention" + sfx] == cfg.n_layers * st["ticks"]
    assert counts["prefill_append" + sfx] == cfg.n_layers * st["fused_ticks"] > 0


def _to(tree, dev):
    return ({k: _to(v, dev) for k, v in tree.items()} if isinstance(tree, dict)
            else tree.to(dev))
