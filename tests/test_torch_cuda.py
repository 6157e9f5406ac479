"""PyTorch port on a CUDA device: each CUDA kernel against its plain
PyTorch version, and the smoke model through the kernels against the plain
versions. Every test here needs the card (marker ``gpu``) and skips
without one; the file imports neither JAX nor the JAX package, so it runs
on the card's machine:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_cuda.py

Bars as in test_torch_kernels.py: ternary projections exact; norm-quant and
SwiGLU codes within 1 and scales within one ulp of the activation dtype;
decode attention within 1e-5 (f32) or 4e-3 (bf16, atol = rtol: two bf16
ulps at |out| <= 0.5).
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
    the plain versions, and every kernel launched."""
    cfg = dataclasses.replace(get_config("tellme-0.7b", smoke=True), dtype=torch.float32)
    specs = TT.param_specs(cfg)
    params = TT.pack_tree(PR.init_params(specs, seed=0, device=cuda), specs, dtype=cfg.dtype)
    prompts = torch.randint(0, cfg.vocab_size, (3, 13), generator=torch.Generator().manual_seed(1))
    reset_launch_counts()
    got = TE.generate(params, cfg, prompts, steps=12, kernels=KERNELS)
    counts = launch_counts()
    want = TE.generate(params, cfg, prompts, steps=12, kernels=PLAIN)
    assert torch.equal(got.tokens, want.tokens)
    assert all(c > 0 for c in counts.values()), counts
