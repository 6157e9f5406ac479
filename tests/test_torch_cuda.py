"""PyTorch port on a CUDA device: each CUDA kernel against its plain
PyTorch version, and the smoke model through the kernels against the plain
versions. Every test here needs the card (marker ``gpu``) and skips
without one; the file imports neither JAX nor the JAX package, so it runs
on the card's machine:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_cuda.py

Bars as in test_torch_kernels.py: ternary projections exact; norm-quant and
SwiGLU codes within 1 and scales within one ulp of the activation dtype;
decode attention (bf16 and int8 caches; query groups of 1 to 16, the
groups of 6 and 16 internlm2-20b's and llama3-405b's) and prefill-append
(groups of 1 to 6) within 1e-5 (f32) or 4e-3 (bf16, atol = rtol: two bf16 ulps at |out| <= 0.5; the
prefill inputs' V is scaled so that |out| stays near that). The rows the
prefill-append kernel writes into the cache equal the plain version's
exactly (bf16 copies, or int8 codes and f32 scales), and every other cache
row is left as it was.

The paged kernels run on a page table that is a seeded permutation of the
pool, with pages shared between two slots and garbage-page entries past
each frontier; the garbage page and every unmapped page hold NaN (int8:
NaN scales). Their output is finite and bit for bit the contiguous
kernel's on the gathered view (``gather_kv_pages``); it is within the bars
above of the plain version, which runs on the same pools with the poison
replaced by zeros (the plain version multiplies masked probabilities, exact
zeros, by V, so its unread rows must be finite, as the contract of
``serving/paging.py`` keeps them). The pools after the append equal the
plain version's byte for byte, garbage page excepted, and every other row
is left as it was. Decode attention, split over blocks of ``SPLIT_ROWS``
cache rows, is also held at a 1280-row cache with frontiers at 0, on a
split boundary and one either side of it, at m - 1, and with window feet
inside a split; prefill-append (bf16 on the tensor cores, 64-row query
tiles) with two query heads a kv head at C = 256 and at C = 96, where a
tile holds the end of one head and the start of the next, paged at
ps = 32 and 64. Each kernel on the clean gathered view gives the paged
kernel's output on the poisoned pools bit for bit, so no unread row
reaches it. The speculative verify chunk (C = 1, 5, 9, and G = 4 at C =
5) is held the same way at decode frontiers that are no multiple of C or
of a tile, chunks straddling page boundaries; the smoke config through
``ServingEngine(speculative=True)`` gives the CPU's streams, statuses and
drafted/accepted counts, and the plain engine's streams.

The table-lookup (TL) kernels are bit-equal to their plain versions and to
their packed twins (the same int32 sums through the same epilogues), at
decode and prefill shapes, with and without a residual, from the
prologue's tables and from int8 rows, at a ragged contraction (N = 4096
and 64 fill their last group of 3 with one trit); the TL SwiGLU's codes
equal the packed kernel's and lie within the SwiGLU bar of its plain
version. ``norm_quant_tables`` gives ``norm_quant``'s codes and scales bit
for bit, and its tables equal ``build_tables`` of those codes.

The flash-attention kernel (the one-shot prefill) is within 1e-5 (f32,
atol = rtol) of its plain version at the shapes of ``chip_smoke.py`` (the
4096-token one in f32 too), the smoke config's D = 16, with GQA and a
ragged S; in bf16 (the tensor-core kernel) also at every D it takes, with
S = 1, 63, 65 and 129 around its 64-row tiles, and with GQA (H = 8, HK =
2), in groups of 16 (llama3-405b's) and at musicgen-medium's D = 64. In
bf16 each element is within 2e-2 of (|want| + the RMS of its output
row): P is rounded to bf16 against the kernel's running maximum and the
plain version's row maximum, which moves an output by a small share of
its row's scale, and the output's own rounding can differ by one bf16 ulp
(2^-7 of |want| at most). The dense schedule gives the causal-skip
schedule's output bit for bit; with v of another head dim and an
explicit scale (DeepSeek's (192, 128), the smoke's (24, 16) zero-padded to
(32, 32)) at the same bars; with gemma2's sliding window and softcap
(windows off the tiles, G = 1 and 2, gemma2-27b's 4352-token local
layer) at the same bars, the dense schedule bit for bit, and the
kernel without them unchanged; gemma2 smoke's local block through the
kernels within 1e-4 of the plain versions. One period block of each MoE family's smoke
config (MLA or attention, routed experts, the shared or dense MLP) through
the kernels is within 1e-4 of the plain versions, prefill and decode; of
jamba's smoke config the Mamba blocks (dense MLP, routed experts) bit for
bit, its attention block within 1e-4. The GEMV (M <= 16, the cluster-split
kernel) and the tiled matmul (the tensor-core kernel) are held bit for bit
at M = 1 to 2048, at rwkv6-3b's projections and jamba's Mamba projections
(x_proj's ragged 288 and 24 outputs), and with x and the packed
weights off their 16-byte alignment. The SwiGLU (the GEMV's pass 1 at
M <= 16, the tensor-core pass above, then the row requant) is held at
M = 1 to 2048, also at a ragged 72 x 44, within its bar and bit for bit
against ``tl_swiglu``. A CUDA graph of the GEMV at two shapes and the
decode SwiGLU, replayed three times, gives the eager outputs bit for bit.

The WKV kernel (RWKV-6's prefill recurrence) gives y and the final state
within 1e-4 of each head's max |plain| at odd and even S, n = 16, 32 and
64, f32 and bf16 r/k/v, with the log-decay slow on half the channels and
across the clip range [-10, -1e-4] on the others: both run in f32 and
differ in the order of their sums and in the chunk (the kernel's 64 with a
masked tail, the plain version's JAX rule), which moves a decay ratio by a
few ulps of the cumulative log-decay; the per-head error stays near 1e-6.
The kernels (chunk states, a state scan, outputs with the decay factored
at 16-row sub-chunk boundaries) are also held at S on either side of
those boundaries (1 to 129), over 4000 tokens, and with every decay at
-10 or -1e-4. Strided inputs (the [B, S, H, n] views ``time_mix``
passes) give the contiguous inputs' outputs bit for bit; so do a second
call, and each head of a B = 4 call run alone. The rwkv smoke config in f32
through the kernels gives the plain versions' streams on the CPU, through
``generate`` and the legacy engine.

Threads share one card: two engines over one params tree, stepped at the
same time on two threads (each on the device's default stream, so decode
attention's one ticket buffer is used by one launch at a time), give each
engine's streams and cache bytes alone, bit for bit, with a bf16 and with
an int8 cache. The f32 smoke replica pool (two replicas, the default
warmup, a ``replica_crash`` on replica 0) gives the CPU pool's streams, one
terminal event each.
"""

import dataclasses
import threading
import time

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.core import packing as PK
from repro_torch.core import params as PR
from repro_torch.core import tl_matmul as TL
from repro_torch.core.ternary import gather_kv_pages
from repro_torch.kernels import KERNELS, PLAIN, launch_counts, reset_launch_counts
from repro_torch.kernels.decode_attention import ops as da_ops
from repro_torch.kernels.decode_attention import ref as da_ref
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.flash_attention import ref as fa_ref
from repro_torch.kernels.fused_norm_quant import ops as nq_ops
from repro_torch.kernels.fused_norm_quant import ref as nq_ref
from repro_torch.kernels.prefill_append import ops as pa_ops
from repro_torch.kernels.prefill_append import ref as pa_ref
from repro_torch.kernels.ternary_matmul import ops as tm_ops
from repro_torch.kernels.ternary_matmul import ref as tm_ref
from repro_torch.kernels.tl_gemv import ops as tl_ops
from repro_torch.kernels.tl_gemv import ref as tl_ref
from repro_torch.models import attention as TA
from repro_torch.models import transformer as TT
from repro_torch.serving import engine as TE
from repro_torch.serving import resilience as TR
from repro_torch.serving.pool import ReplicaPool

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


# (M, N): rwkv6-3b's d_model (ten elements a thread), a ragged row (one
# element a thread, byte stores), the 4096-token prefill's rows, the widest
# register tile (4096) and a row past it (the loop form)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("m,n", [(4, 2560), (7, 44), (4096, 1536), (3, 4096), (2, 5000)])
def test_norm_quant_widths(cuda, dtype, m, n):
    rng = np.random.default_rng(40 + m + n)
    x = _t(rng.standard_normal((m, n)).astype(np.float32) * 3, cuda, TORCH_DT[dtype])
    g = _t(rng.standard_normal(n).astype(np.float32), cuda)
    _assert_quant_close(nq_ops.norm_quant(x, g), nq_ref.norm_quant(x, g), QUANT_RTOL[dtype])
    q, s, tab = nq_ops.norm_quant_tables(x, g)
    q0, s0 = nq_ops.norm_quant(x, g)
    assert torch.equal(q, q0) and torch.equal(s, s0)
    assert torch.equal(tab, TL.build_tables(q, t=-(-n // 3)))


# (M, N, K): tellme-0.7b's q/k/v and down and a ragged shape (N/4 = 18, K =
# 44: the staging by plain loads) at decode rows (1, 4 and the engine's 8:
# the GEMV's MB = 8 instance; 16: MB = 16), around the
# tensor-core tiles (17, 64, 130 rows), at 512 (a prefill) and 2048 (the
# chunk step's 8 x 256); then rwkv6-3b's d -> d, d -> d_ff and d_ff -> d
# at generate's 400 prefill rows (N/4 = 640 and 2240); then jamba's Mamba
# projections: x_proj's ragged output (dt_rank + 2 d_state = 288; 24 at
# smoke) at a decode, the engine's 8 rows and a prefill, in_proj and
# out_proj at a decode
PROJECTION_CASES = [(m, n, k) for m in (1, 4, 8, 16, 17, 40, 64, 130, 512, 2048)
                    for n, k in ((1536, 1536), (4096, 1536), (72, 44))]
PROJECTION_CASES += [(400, 2560, 2560), (400, 2560, 8960), (400, 8960, 2560)]
PROJECTION_CASES += [(4, 8192, 288), (8, 8192, 288), (512, 8192, 288), (26, 128, 24),
                     (4, 4096, 16384), (4, 8192, 4096)]


@pytest.mark.parametrize("m,n,k", PROJECTION_CASES)
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


SWIGLU_ROWS = (1, 4, 8, 16, 17, 64, 130, 512, 2048)


@pytest.mark.parametrize("m", SWIGLU_ROWS)
@pytest.mark.parametrize("n,k", [(1536, 4096), (72, 44)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ternary_swiglu(cuda, m, n, k, dtype):
    rng = np.random.default_rng(40 + m + n)
    wg = PK.pack2(_t(rng.integers(-1, 2, (n, k)).astype(np.int8), cuda))
    wu = PK.pack2(_t(rng.integers(-1, 2, (n, k)).astype(np.int8), cuda))
    x = _t(rng.integers(-127, 128, (m, n)).astype(np.int8), cuda)
    xs = _t(rng.uniform(0.001, 0.01, (m, 1)).astype(np.float32), cuda)
    s = torch.tensor(0.05, device=cuda)
    act = TORCH_DT[dtype]
    got = tm_ops.ternary_swiglu(x, xs, wg, s, wu, s, act_dtype=act)
    want = tm_ref.ternary_swiglu(x, xs, wg, s, wu, s, act_dtype=act)
    _assert_quant_close(got, want, QUANT_RTOL[dtype])
    tl = tl_ops.tl_swiglu(x, xs, TL.tl_indices(wg), s, TL.tl_indices(wu), s, act_dtype=act)
    assert torch.equal(got[0], tl[0]) and torch.equal(got[1], tl[1])


def _unaligned(t, offset):
    """``t``'s values in a contiguous tensor that starts ``offset`` bytes
    past an aligned allocation."""
    flat = torch.empty(t.numel() * t.element_size() + offset, dtype=torch.uint8,
                       device=t.device)
    view = flat[offset:].view(t.dtype).view(t.shape)
    view.copy_(t)
    return view


@pytest.mark.parametrize("m", [3, 8, 16, 40])
@pytest.mark.parametrize("offset", [1, 4])
def test_ternary_unaligned_operands(cuda, m, offset):
    """x and the packed weights off their 16-byte alignment take the GEMV's
    and the tiled matmul's masked loads: the same outputs bit for bit."""
    rng = np.random.default_rng(60 + m + offset)
    n, k = 1536, 1536
    wp = PK.pack2(_t(rng.integers(-1, 2, (n, k)).astype(np.int8), cuda))
    wu = PK.pack2(_t(rng.integers(-1, 2, (n, k)).astype(np.int8), cuda))
    x = _t(rng.integers(-127, 128, (m, n)).astype(np.int8), cuda)
    xs = _t(rng.uniform(1e-4, 1e-2, (m, 1)).astype(np.float32), cuda)
    ws = torch.tensor(0.61, device=cuda)
    xo, wpo, wuo = (_unaligned(t, offset) for t in (x, wp, wu))
    for fn in (tm_ops.ternary_gemv, tm_ops.ternary_matmul):
        want = fn(x, xs, wp, ws, out_dtype=torch.bfloat16)
        assert torch.equal(fn(xo, xs, wpo, ws, out_dtype=torch.bfloat16), want)
        assert torch.equal(fn(xo, xs, wp, ws, out_dtype=torch.bfloat16), want)
    want = tm_ops.ternary_swiglu(x, xs, wp, ws, wu, ws)
    for got in (tm_ops.ternary_swiglu(xo, xs, wpo, ws, wuo, ws),
                tm_ops.ternary_swiglu(x, xs, wp, ws, wuo, ws)):
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def test_ternary_graph_replay(cuda):
    """The GEMV at two shapes (cluster launches) and the decode SwiGLU
    captured in one CUDA graph: three replays each give the eager calls'
    outputs bit for bit."""
    rng = np.random.default_rng(77)
    bf16 = torch.bfloat16

    def operands(m, n, k):
        wp = PK.pack2(_t(rng.integers(-1, 2, (n, k)).astype(np.int8), cuda))
        x = _t(rng.integers(-127, 128, (m, n)).astype(np.int8), cuda)
        xs = _t(rng.uniform(1e-4, 1e-2, (m, 1)).astype(np.float32), cuda)
        return x, xs, wp, torch.tensor(0.02, device=cuda)

    qkv, down = operands(4, 1536, 1536), operands(4, 4096, 1536)
    res = _t(rng.standard_normal((4, 1536)).astype(np.float32), cuda, bf16)
    x, xs, wg, sg = operands(4, 1536, 4096)
    wu = PK.pack2(_t(rng.integers(-1, 2, (1536, 4096)).astype(np.int8), cuda))

    def calls():
        return (tm_ops.ternary_gemv(*qkv, out_dtype=bf16),
                tm_ops.ternary_gemv(*down, out_dtype=bf16, residual=res),
                *tm_ops.ternary_swiglu(x, xs, wg, sg, wu, sg, act_dtype=bf16))

    eager = calls()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        calls()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = calls()
    for _ in range(3):
        for t in captured:
            t.zero_()
        graph.replay()
        torch.cuda.synchronize()
        for got, want in zip(captured, eager):
            assert torch.equal(got, want)
    assert all(torch.equal(a, b) for a, b in zip(calls(), eager))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("g,window,softcap", [(1, 0, 0.0), (2, 100, 30.0), (4, 0, 5.0),
                                              (6, 0, 0.0), (16, 0, 0.0)])
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
                                                  (128, 16, 1, 0, 5.0), (64, 32, 4, 0, 0.0),
                                                  (64, 128, 6, 0, 0.0), (96, 64, 6, 0, 0.0)])
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


def _bits(t):
    """The raw bits of a tensor: equality of these is NaN-safe."""
    return t.view({torch.bfloat16: torch.int16, torch.float32: torch.int32}.get(t.dtype, t.dtype))


def _paged_pools(rng, dev, pages, hk, ps, d, dtype, quant, table):
    """(poisoned, clean) pools: random, with the garbage page 0 and every
    page the table does not map set to NaN (int8: NaN scales, codes -128) in
    ``poisoned`` and to zeros in ``clean``."""
    dead = torch.ones(pages, dtype=torch.bool)
    dead[torch.from_numpy(table.reshape(-1)).long()] = False
    dead[0] = True
    if quant:
        base = [_t(rng.integers(-127, 128, (pages, hk, ps, d)).astype(np.int8), dev)
                for _ in range(2)]
        base += [_t(rng.uniform(1e-3, 2e-2, (pages, hk, ps)).astype(np.float32), dev)
                 for _ in range(2)]
    else:
        base = [_t(rng.standard_normal((pages, hk, ps, d)).astype(np.float32) * s, dev, dtype)
                for s in (1.0, 0.25)]
    poisoned, clean = [t.clone() for t in base], [t.clone() for t in base]
    dead = dead.to(dev)
    for p, c in zip(poisoned, clean):
        p[dead] = -128 if p.dtype == torch.int8 else float("nan")
        c[dead] = 0
    return poisoned, clean


def _paged_table(rng, b, nb, pages, mapped, share):
    """Pages 1..pages-1 in a seeded random order: slot s maps its first
    ``mapped[s]`` blocks, garbage (0) past them; slot dst's first n blocks
    are slot src's pages (``share = (dst, src, n)``)."""
    perm = list(rng.permutation(np.arange(1, pages)))
    table = np.zeros((b, nb), np.int32)
    dst, src, n = share
    for s in range(b):
        for blk in range(mapped[s]):
            table[s, blk] = table[src, blk] if s == dst and blk < n else perm.pop()
    return table


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("quant", [False, True], ids=["dense", "int8"])
@pytest.mark.parametrize("g,window,softcap", [(1, 0, 0.0), (2, 100, 30.0)])
def test_decode_attention_paged(cuda, dtype, quant, g, window, softcap):
    rng = np.random.default_rng(50 + g + 2 * quant)
    b, hk, d, ps, nb = 4, 8, 96, 64, 5
    pos_np = np.array([nb * ps - 1, 0, 63, 150], np.int32)
    pages = b * nb + 4
    table = _paged_table(rng, b, nb, pages, [p // ps + 1 for p in pos_np], share=(3, 0, 2))
    poisoned, clean = _paged_pools(rng, cuda, pages, hk, ps, d, TORCH_DT[dtype], quant, table)
    q = _t(rng.standard_normal((b, hk * g, d)).astype(np.float32), cuda, TORCH_DT[dtype])
    pos, pt = _t(pos_np, cuda), _t(table, cuda)
    kw = dict(window=window, softcap=softcap)

    def scales(pools):
        return dict(k_scale=pools[2], v_scale=pools[3]) if quant else {}

    got = da_ops.decode_attention_paged(q, poisoned[0], poisoned[1], pt, pos,
                                        **scales(poisoned), **kw)
    views = [gather_kv_pages(t, pt) for t in poisoned]
    contiguous = da_ops.decode_attention(q, views[0], views[1], pos, **scales(views), **kw)
    want = da_ref.decode_attention_paged(q, clean[0], clean[1], pt, pos, **scales(clean), **kw)
    torch.cuda.synchronize()
    assert torch.isfinite(got).all()
    assert torch.equal(_bits(got), _bits(contiguous))
    tol = ATTN_TOL[dtype]
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("quant", [False, True], ids=["dense", "int8"])
@pytest.mark.parametrize("c,g,window,softcap", [(256, 1, 0, 0.0), (64, 2, 100, 30.0),
                                                (128, 1, 0, 5.0)])
def test_prefill_append_paged(cuda, dtype, quant, c, g, window, softcap):
    """Offsets 0, C and 4C, and a write-only slot at 5C = prefix_limit whose
    window maps the garbage page; slot 2 reads slot 1's prefix pages."""
    rng = np.random.default_rng(60 + c + g + quant)
    b, hk, d, ps = 4, 4, 96, 64
    nb = 6 * c // ps
    off_np = np.array([0, c, 4 * c, 5 * c], np.int32)
    pages = b * nb + 3
    table = _paged_table(rng, b, nb, pages, [(o + c) // ps for o in off_np[:3]] + [0],
                         share=(2, 1, c // ps))
    poisoned, clean = _paged_pools(rng, cuda, pages, hk, ps, d, TORCH_DT[dtype], quant, table)
    td = TORCH_DT[dtype]
    q = _t(rng.standard_normal((b, hk * g, c, d)).astype(np.float32), cuda, td)
    kn = _t(rng.standard_normal((b, hk, c, d)).astype(np.float32), cuda, td)
    vn = _t(rng.standard_normal((b, hk, c, d)).astype(np.float32) * 0.25, cuda, td)
    off, pt = _t(off_np, cuda), _t(table, cuda)
    kw = dict(window=window, softcap=softcap, prefix_limit=5 * c)

    def scales(pools):
        return dict(k_scale=pools[2], v_scale=pools[3]) if quant else {}

    mine, plain = [t.clone() for t in poisoned], [t.clone() for t in clean]
    views = [gather_kv_pages(t, pt) for t in poisoned]
    got = pa_ops.prefill_append_paged(q, kn, vn, mine[0], mine[1], pt, off, **scales(mine),
                                      **kw)
    contiguous = pa_ops.prefill_append(q, kn, vn, views[0], views[1], off, **scales(views),
                                       **kw)
    want = pa_ref.prefill_append_paged(q, kn, vn, plain[0], plain[1], pt, off,
                                       **scales(plain), **kw)
    torch.cuda.synchronize()
    assert torch.isfinite(got).all()
    assert torch.equal(_bits(got), _bits(contiguous))
    tol = ATTN_TOL[dtype]
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)
    written = torch.zeros((pages, ps), dtype=torch.bool)  # (page, row) the chunks write
    for s, o in enumerate(off_np[:3]):
        for blk in range(o // ps, (o + c) // ps):
            written[table[s, blk]] = True
    mapped = torch.zeros(pages, dtype=torch.bool)
    mapped[torch.from_numpy(table.reshape(-1)).long()] = True
    mapped[0] = False  # the garbage page: written by the write-only slot
    written, mapped = written.to(cuda), mapped.to(cuda)
    not_garbage = torch.ones(pages, dtype=torch.bool, device=cuda)
    not_garbage[0] = False
    for a, p, before, view in zip(mine, plain, poisoned, views):
        assert torch.equal(_bits(a[mapped]), _bits(p[mapped]))  # the plain version's bytes
        kept = ~written[:, None, :].expand(a.shape[:3]) & not_garbage[:, None, None]
        assert torch.equal(_bits(a[kept]), _bits(before[kept]))  # the rest untouched
        # the contiguous kernel's cache, scattered back, on the written rows
        for s, o in enumerate(off_np[:3]):
            for blk in range(o // ps, (o + c) // ps):
                assert torch.equal(_bits(a[table[s, blk]]),
                                   _bits(view[s, :, blk * ps:(blk + 1) * ps]))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("quant", [False, True], ids=["dense", "int8"])
@pytest.mark.parametrize("g,window", [(1, 0), (2, 300)])
def test_decode_attention_splits(cuda, dtype, quant, g, window):
    """A 1280-row cache cut into ``SPLIT_ROWS`` splits: frontiers at 0, one
    below a split boundary, on it and one past it, at m - 1 and at 700
    (with the window, both feet inside a split). Contiguous on the clean
    gathered view within the bars of the plain version; paged on NaN pools
    finite and bit for bit the contiguous kernel on both views."""
    rng = np.random.default_rng(70 + g + 2 * quant)
    b, hk, d, ps, m = 6, 4, 96, 64, 1280
    nb, split = m // ps, da_ops.SPLIT_ROWS
    assert split < m
    pos_np = np.array([0, split - 1, split, split + 1, m - 1, 700], np.int32)
    pages = b * nb + 2
    table = _paged_table(rng, b, nb, pages, [p // ps + 1 for p in pos_np], share=(5, 4, 3))
    poisoned, clean = _paged_pools(rng, cuda, pages, hk, ps, d, TORCH_DT[dtype], quant, table)
    q = _t(rng.standard_normal((b, hk * g, d)).astype(np.float32), cuda, TORCH_DT[dtype])
    pos, pt = _t(pos_np, cuda), _t(table, cuda)

    def scales(pools):
        return dict(k_scale=pools[2], v_scale=pools[3]) if quant else {}

    dense = [gather_kv_pages(t, pt) for t in clean]
    views = [gather_kv_pages(t, pt) for t in poisoned]
    got = da_ops.decode_attention(q, dense[0], dense[1], pos, window=window, **scales(dense))
    want = da_ref.decode_attention(q, dense[0], dense[1], pos, window=window, **scales(dense))
    paged = da_ops.decode_attention_paged(q, poisoned[0], poisoned[1], pt, pos, window=window,
                                          **scales(poisoned))
    twin = da_ops.decode_attention(q, views[0], views[1], pos, window=window, **scales(views))
    torch.cuda.synchronize()
    tol = ATTN_TOL[dtype]
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)
    assert torch.isfinite(paged).all()
    assert torch.equal(_bits(paged), _bits(twin)) and torch.equal(_bits(paged), _bits(got))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("quant", [False, True], ids=["dense", "int8"])
@pytest.mark.parametrize("c,g,window,ps", [(256, 2, 0, 64), (256, 2, 0, 32), (96, 2, 100, 32)])
def test_prefill_append_grouped_tiles(cuda, dtype, quant, c, g, window, ps):
    """Two query heads a kv head, at C = 256 and at C = 96, where a 64-row
    query tile holds the end of one head and the start of the next;
    offsets 0, C and 4C and a write-only slot at 5C; paged at ps = 32 and
    64. Contiguous on the clean gathered view within the bars of the plain
    version, its cache equal to the plain version's bytes and unchanged
    outside the append; paged on NaN pools finite, bit for bit the
    contiguous kernel on both views, its written pages that kernel's cache
    scattered back."""
    rng = np.random.default_rng(80 + c + g + ps + quant)
    b, hk, d = 4, 4, 96
    m = 6 * c
    nb = m // ps
    off_np = np.array([0, c, 4 * c, 5 * c], np.int32)
    pages = b * nb + 3
    table = _paged_table(rng, b, nb, pages, [(o + c) // ps for o in off_np[:3]] + [0],
                         share=(2, 1, c // ps))
    poisoned, clean = _paged_pools(rng, cuda, pages, hk, ps, d, TORCH_DT[dtype], quant, table)
    td = TORCH_DT[dtype]
    q = _t(rng.standard_normal((b, hk * g, c, d)).astype(np.float32), cuda, td)
    kn = _t(rng.standard_normal((b, hk, c, d)).astype(np.float32), cuda, td)
    vn = _t(rng.standard_normal((b, hk, c, d)).astype(np.float32) * 0.25, cuda, td)
    off, pt = _t(off_np, cuda), _t(table, cuda)
    kw = dict(window=window, prefix_limit=5 * c)

    def scales(pools):
        return dict(k_scale=pools[2], v_scale=pools[3]) if quant else {}

    dense = [gather_kv_pages(t, pt) for t in clean]
    mine, plain = [t.clone() for t in dense], [t.clone() for t in dense]
    got = pa_ops.prefill_append(q, kn, vn, mine[0], mine[1], off, **scales(mine), **kw)
    want = pa_ref.prefill_append(q, kn, vn, plain[0], plain[1], off, **scales(plain), **kw)
    pools = [t.clone() for t in poisoned]
    views = [gather_kv_pages(t, pt) for t in poisoned]
    paged = pa_ops.prefill_append_paged(q, kn, vn, pools[0], pools[1], pt, off,
                                        **scales(pools), **kw)
    twin = pa_ops.prefill_append(q, kn, vn, views[0], views[1], off, **scales(views), **kw)
    torch.cuda.synchronize()
    tol = ATTN_TOL[dtype]
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)
    written = torch.zeros(dense[0].shape[:3], dtype=torch.bool, device=cuda)
    for s, o in enumerate(off_np.tolist()):
        written[s, :, o:o + c] = True
    for a, w, before in zip(mine, plain, dense):
        assert torch.equal(_bits(a), _bits(w))
        assert torch.equal(_bits(a[~written]), _bits(before[~written]))
    assert torch.isfinite(paged).all()
    assert torch.equal(_bits(paged), _bits(twin)) and torch.equal(_bits(paged), _bits(got))
    for a, view in zip(pools, views):
        for s, o in enumerate(off_np[:3]):
            for blk in range(o // ps, (o + c) // ps):
                assert torch.equal(_bits(a[table[s, blk]]),
                                   _bits(view[s, :, blk * ps:(blk + 1) * ps]))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("quant", [False, True], ids=["dense", "int8"])
@pytest.mark.parametrize("c,g", [(1, 1), (5, 1), (9, 1), (5, 4)])
def test_prefill_append_verify_frontiers(cuda, dtype, quant, c, g):
    """Speculative verify chunks (C = gamma + 1) at decode frontiers that
    are no multiple of C or of a tile: a partial last prefix tile, chunks
    that straddle a page boundary (paged, ps = 64: 62 and 125), a 64-row
    query tile holding the rows of G query heads, and a write-only slot.
    Contiguous on the clean gathered view within the bars of the plain
    version, its cache equal to the plain version's bytes and unchanged
    outside the append; paged on NaN pools finite, bit for bit the
    contiguous kernel on both views, its pools equal to the plain
    version's bytes (the mapped pages), its written rows that kernel's
    cache scattered back."""
    rng = np.random.default_rng(90 + c + g + quant)
    b, hk, d, ps, m = 6, 2, 96, 64, 640
    nb = m // ps
    off_np = np.array([163, 62, 517, 125, 0, 576], np.int32)  # the last one write-only
    limit = 576
    pages = b * nb + 2
    mapped = [-(-(o + c) // ps) for o in off_np[:5]] + [0]
    table = _paged_table(rng, b, nb, pages, mapped, share=(2, 0, 2))
    poisoned, clean = _paged_pools(rng, cuda, pages, hk, ps, d, TORCH_DT[dtype], quant, table)
    td = TORCH_DT[dtype]
    q = _t(rng.standard_normal((b, hk * g, c, d)).astype(np.float32), cuda, td)
    kn = _t(rng.standard_normal((b, hk, c, d)).astype(np.float32), cuda, td)
    vn = _t(rng.standard_normal((b, hk, c, d)).astype(np.float32) * 0.25, cuda, td)
    off, pt = _t(off_np, cuda), _t(table, cuda)

    def scales(pools):
        return dict(k_scale=pools[2], v_scale=pools[3]) if quant else {}

    dense = [gather_kv_pages(t, pt) for t in clean]
    mine, plain = [t.clone() for t in dense], [t.clone() for t in dense]
    got = pa_ops.prefill_append(q, kn, vn, mine[0], mine[1], off, prefix_limit=limit,
                                **scales(mine))
    want = pa_ref.prefill_append(q, kn, vn, plain[0], plain[1], off, prefix_limit=limit,
                                 **scales(plain))
    pools, ref_pools = [t.clone() for t in poisoned], [t.clone() for t in clean]
    views = [gather_kv_pages(t, pt) for t in poisoned]
    paged = pa_ops.prefill_append_paged(q, kn, vn, pools[0], pools[1], pt, off,
                                        prefix_limit=limit, **scales(pools))
    twin = pa_ops.prefill_append(q, kn, vn, views[0], views[1], off, prefix_limit=limit,
                                 **scales(views))
    pa_ref.prefill_append_paged(q, kn, vn, ref_pools[0], ref_pools[1], pt, off,
                                prefix_limit=limit, **scales(ref_pools))
    torch.cuda.synchronize()
    tol = ATTN_TOL[dtype]
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)
    written = torch.zeros(dense[0].shape[:3], dtype=torch.bool, device=cuda)
    for s, o in enumerate(off_np.tolist()):
        written[s, :, o:o + c] = True
    for a, w, before in zip(mine, plain, dense):
        assert torch.equal(_bits(a), _bits(w))
        assert torch.equal(_bits(a[~written]), _bits(before[~written]))
    assert torch.isfinite(paged).all()
    assert torch.equal(_bits(paged), _bits(twin)) and torch.equal(_bits(paged), _bits(got))
    live = torch.zeros(pages, dtype=torch.bool)
    live[torch.from_numpy(table.reshape(-1)).long()] = True
    live[0] = False  # the garbage page: written by the write-only slot
    live = live.to(cuda)
    for a, r, view in zip(pools, ref_pools, views):
        assert torch.equal(_bits(a[live]), _bits(r[live]))
        for s, o in enumerate(off_np[:5]):
            for blk in range(o // ps, (o + c - 1) // ps + 1):
                assert torch.equal(_bits(a[table[s, blk]]),
                                   _bits(view[s, :, blk * ps:(blk + 1) * ps]))


def test_paged_wrappers_count_and_check(cuda):
    pool = torch.zeros((3, 2, 64, 32), device=cuda)
    pt = torch.ones((1, 2), dtype=torch.int32, device=cuda)
    pos = torch.zeros((1,), dtype=torch.int32, device=cuda)
    q = torch.zeros((1, 2, 32), device=cuda)
    reset_launch_counts()
    KERNELS.decode_attention_paged(q, pool, pool.clone(), pt, pos)
    qc = torch.zeros((1, 2, 64, 32), device=cuda)
    KERNELS.prefill_append_paged(qc, qc, qc, pool, pool.clone(), pt, pos)
    counts = launch_counts()
    assert counts["decode_attention_paged"] == counts["prefill_append_paged"] == 1
    # a chunk shorter than a page, at an unaligned offset, is taken; a page
    # size that is no multiple of 32 rows (one kv tile) is not
    q5 = torch.zeros((1, 2, 5, 32), device=cuda)
    KERNELS.prefill_append_paged(q5, q5, q5, pool, pool.clone(), pt, pos + 3)
    assert launch_counts()["prefill_append_paged"] == 2
    pool48 = torch.zeros((3, 2, 48, 32), device=cuda)
    with pytest.raises(ValueError, match="page size"):
        pa_ops.prefill_append_paged(q5, q5, q5, pool48, pool48.clone(), pt, pos)
    with pytest.raises(TypeError, match="page_table"):
        da_ops.decode_attention_paged(q, pool, pool.clone(), pt.long(), pos)


@pytest.mark.parametrize("kv", ["bf16", "int8"])
def test_smoke_paged_engine_kernels_vs_plain(cuda, kv):
    """The f32 smoke config in the paged engine, a shared prompt prefix
    included: through the kernels on the card, the same streams, statuses
    and page statistics as through the plain versions on the CPU, and the
    same streams as the contiguous engine through the kernels; one host
    transfer per tick, and the paged attention kernels of the cache dtype
    launched 2 (layers) times per tick that runs them."""
    cfg = dataclasses.replace(get_config("tellme-0.7b", smoke=True), dtype=torch.float32,
                              kv_cache_dtype=kv, kv_layout="paged")
    specs = TT.param_specs(cfg)
    cpu_params = TT.pack_tree(PR.init_params(specs, seed=0, device="cpu"), specs,
                              dtype=cfg.dtype)
    rng = np.random.default_rng(2)
    prefix = rng.integers(0, cfg.vocab_size, 320)
    prompts = [rng.integers(0, cfg.vocab_size, n) for n in (9, 30, 70, 130, 200)]
    prompts += [np.concatenate([prefix, rng.integers(0, cfg.vocab_size, n)]) for n in (32, 17)]

    def serve(params, kernels, device, layout="paged"):
        eng = TE.ServingEngine(params, dataclasses.replace(cfg, kv_layout=layout), slots=2,
                               max_len=512, kernels=kernels, device=device)
        reqs = [TE.Request(rid=i, prompt=p, max_new=8) for i, p in enumerate(prompts)]
        for r in reqs[:-1]:
            eng.submit(r)
        eng.run()
        eng.submit(reqs[-1])  # after its twin's prefix was interned
        eng.run()
        return [(r.generated, r.status) for r in reqs], eng

    cuda_params = _to(cpu_params, cuda)
    reset_launch_counts()
    got, eng = serve(cuda_params, KERNELS, None)
    counts = launch_counts()
    want, ref_eng = serve(cpu_params, PLAIN, "cpu")
    assert got == want
    assert serve(cuda_params, KERNELS, None, layout="contiguous")[0] == got
    st = eng.stats()
    assert st["paged"] == ref_eng.stats()["paged"] and st["paged"]["prefix_hits"] >= 1
    assert st["host_transfers"] == st["ticks"]
    sfx = "_quant" if kv == "int8" else ""
    assert counts["decode_attention_paged" + sfx] == cfg.n_layers * st["ticks"]
    assert counts["prefill_append_paged" + sfx] == cfg.n_layers * st["fused_ticks"] > 0
    assert counts["decode_attention" + sfx] == counts["prefill_append" + sfx] == 0


@pytest.mark.parametrize("layout", ["contiguous", "paged"])
@pytest.mark.parametrize("kv", ["bf16", "int8"])
def test_smoke_spec_engine_kernels_vs_plain(cuda, kv, layout):
    """The f32 smoke config in ServingEngine(speculative=True), a tiled
    phrase among ragged prompts: through the kernels on the card, the same
    streams, statuses and per-request drafted and accepted counts as
    through the plain versions on the CPU, and the same streams as the
    plain engine on the card; one host transfer per tick; the verify runs
    through the prefill-append kernel of the layout and cache dtype, 2
    (layers) launches a spec tick plus 2 a tick with a prompt chunk, and
    decode attention only in the ticks that are not speculative."""
    cfg = dataclasses.replace(get_config("tellme-0.7b", smoke=True), dtype=torch.float32,
                              kv_cache_dtype=kv, kv_layout=layout)
    specs = TT.param_specs(cfg)
    cpu_params = TT.pack_tree(PR.init_params(specs, seed=0, device="cpu"), specs,
                              dtype=cfg.dtype)
    rng = np.random.default_rng(5)
    prompts = [rng.integers(0, cfg.vocab_size, n) for n in (9, 30, 70, 130)]
    prompts.append(np.tile(rng.integers(0, cfg.vocab_size, 7), 9))

    def serve(params, kernels, device, speculative=True):
        eng = TE.ServingEngine(params, cfg, slots=2, max_len=256, kernels=kernels,
                               device=device, speculative=speculative)
        reqs = [TE.Request(rid=i, prompt=p, max_new=16) for i, p in enumerate(prompts)]
        for r in reqs:
            eng.submit(r)
        eng.run()
        return [(r.generated, r.status, r.spec_drafted, r.spec_accepted) for r in reqs], eng

    cuda_params = _to(cpu_params, cuda)
    reset_launch_counts()
    got, eng = serve(cuda_params, KERNELS, None)
    counts = launch_counts()
    want, _ = serve(cpu_params, PLAIN, "cpu")
    assert got == want
    plain, _ = serve(cuda_params, KERNELS, None, speculative=False)
    assert [g[:2] for g in got] == [p[:2] for p in plain]
    st = eng.stats()
    assert st["host_transfers"] == st["ticks"] and st["spec_ticks"] > 0
    assert got[-1][3] > 0.2 * got[-1][2]
    sfx = ("_paged" if layout == "paged" else "") + ("_quant" if kv == "int8" else "")
    assert counts["prefill_append" + sfx] == cfg.n_layers * (st["spec_ticks"] + st["fused_ticks"])
    assert counts["decode_attention" + sfx] == cfg.n_layers * (st["ticks"] - st["spec_ticks"])
    assert sum(counts.values()) == sum(counts[n] for n in (
        "norm_quant", "ternary_gemv", "ternary_matmul", "ternary_swiglu",
        "prefill_append" + sfx, "decode_attention" + sfx))


def _to(tree, dev):
    return ({k: _to(v, dev) for k, v in tree.items()} if isinstance(tree, dict)
            else tree.to(dev))


# ---------------------------------------------------------------------------
# the table-lookup engine
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("m", [1, 7, 512])
@pytest.mark.parametrize("n", [1536, 64])
def test_norm_quant_tables(cuda, dtype, m, n):
    rng = np.random.default_rng(60 + m + n)
    x = _t(rng.standard_normal((m, n)).astype(np.float32) * 3, cuda, TORCH_DT[dtype])
    g = _t(rng.standard_normal(n).astype(np.float32), cuda)
    q, s, tab = nq_ops.norm_quant_tables(x, g)
    q0, s0 = nq_ops.norm_quant(x, g)
    assert torch.equal(q, q0) and torch.equal(s, s0)
    assert tab.shape == (m, -(-n // 3) * 27)
    assert torch.equal(tab, TL.build_tables(q, t=-(-n // 3)))
    _assert_quant_close((q, s), nq_ref.norm_quant(x, g), QUANT_RTOL[dtype])


def _tl_operands(rng, m, n, k, dev):
    w = _t(rng.integers(-1, 2, (n, k)).astype(np.int8), dev)
    wp = PK.pack2(w)
    x = _t(rng.integers(-127, 128, (m, n)).astype(np.int8), dev)
    xs = _t(rng.uniform(1e-4, 1e-2, (m, 1)).astype(np.float32), dev)
    return wp, TL.tl_indices(wp), x, xs


@pytest.mark.parametrize("m", [1, 4, 16, 40, 130])
@pytest.mark.parametrize("n,k", [(1536, 1536), (4096, 1536), (64, 44)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_tl_matmul(cuda, m, n, k, dtype):
    rng = np.random.default_rng(70 + m + n + k)
    wp, w_idx, x, xs = _tl_operands(rng, m, n, k, cuda)
    ws = torch.tensor(0.61, device=cuda)
    res = _t(rng.standard_normal((m, k)).astype(np.float32), cuda, TORCH_DT[dtype])
    tables = TL.build_tables(x, t=w_idx.shape[0])
    out = TORCH_DT[dtype]
    for residual in (None, res):
        twin = tm_ops.ternary_matmul(x, xs, wp, ws, out_dtype=out, residual=residual)
        for tab in (None, tables):
            got = tl_ops.tl_matmul(x, xs, w_idx, ws, tables=tab, residual=residual,
                                   out_dtype=out)
            want = tl_ref.tl_matmul(x, xs, w_idx, ws, tables=tab, residual=residual,
                                    out_dtype=out)
            assert torch.equal(got, want) and torch.equal(got, twin)


# Group counts that are no multiple of the chunk or of the cluster's share
# (N = 1000: 334 groups, 996: 332), K past 4-byte index words (45: the
# byte-by-byte staging), rows just past the decode configurations (17, 33)
# and past a prefill tile, the prologue's tables as given, 4 bytes off a
# 16-byte boundary (float by float) and not at all
@pytest.mark.parametrize("m", [3, 5, 16, 17, 33, 70])
@pytest.mark.parametrize("n,k", [(1000, 200), (996, 1536), (4096, 1536), (996, 45)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_tl_matmul_edges(cuda, m, n, k, dtype):
    rng = np.random.default_rng(170 + m + n + k)
    wp, w_idx, x, xs = _tl_operands(rng, m, n, k, cuda)
    ws = torch.tensor(0.37, device=cuda)
    res = _t(rng.standard_normal((m, k)).astype(np.float32), cuda, TORCH_DT[dtype])
    tables = TL.build_tables(x, t=w_idx.shape[0])
    out = TORCH_DT[dtype]
    for residual in (None, res):
        twin = tm_ops.ternary_matmul(x, xs, wp, ws, out_dtype=out, residual=residual)
        for tab in (None, tables, _unaligned(tables, 4)):
            got = tl_ops.tl_matmul(x, xs, w_idx, ws, tables=tab, residual=residual,
                                   out_dtype=out)
            want = tl_ref.tl_matmul(x, xs, w_idx, ws, tables=tab, residual=residual,
                                    out_dtype=out)
            assert torch.equal(got, want) and torch.equal(got, twin)


@pytest.mark.parametrize("m", [5, 17, 33])
@pytest.mark.parametrize("n,k", [(1000, 200), (996, 4096)])
def test_tl_swiglu_edges(cuda, m, n, k):
    rng = np.random.default_rng(190 + m + n)
    wg, wg_idx, x, xs = _tl_operands(rng, m, n, k, cuda)
    wu = PK.pack2(_t(rng.integers(-1, 2, (n, k)).astype(np.int8), cuda))
    wu_idx = TL.tl_indices(wu)
    sg, su = torch.tensor(0.05, device=cuda), torch.tensor(0.04, device=cuda)
    twin = tm_ops.ternary_swiglu(x, xs, wg, sg, wu, su, act_dtype=torch.bfloat16)
    tables = TL.build_tables(x, t=wg_idx.shape[0])
    for tab in (None, tables, _unaligned(tables, 4)):
        got = tl_ops.tl_swiglu(x, xs, wg_idx, sg, wu_idx, su, tables=tab,
                               act_dtype=torch.bfloat16)
        assert torch.equal(got[0], twin[0]) and torch.equal(got[1], twin[1])


@pytest.mark.parametrize("m", [1, 4, 16, 40])
@pytest.mark.parametrize("n,k", [(1536, 1536), (4096, 1536), (64, 44)])
def test_tl_gemv(cuda, m, n, k):
    rng = np.random.default_rng(80 + m + n + k)
    wp, w_idx, x, xs = _tl_operands(rng, m, n, k, cuda)
    scalar = torch.tensor(0.61, device=cuda)
    per_channel = _t(rng.uniform(0.1, 1.0, k).astype(np.float32), cuda)
    for ws in (scalar, per_channel):
        got = tl_ops.tl_gemv(x, xs, w_idx, ws)
        assert got.dtype == torch.float32
        assert torch.equal(got, tl_ref.tl_gemv(x, xs, w_idx, ws))
    assert torch.equal(tl_ops.tl_gemv(x, xs, w_idx, scalar),
                       tm_ops.ternary_gemv(x, xs, wp, scalar))


@pytest.mark.parametrize("m", [1, 4, 64])
@pytest.mark.parametrize("n,k", [(1536, 4096), (64, 128)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_tl_swiglu(cuda, m, n, k, dtype):
    rng = np.random.default_rng(90 + m + n)
    wg, wg_idx, x, xs = _tl_operands(rng, m, n, k, cuda)
    wu = PK.pack2(_t(rng.integers(-1, 2, (n, k)).astype(np.int8), cuda))
    wu_idx = TL.tl_indices(wu)
    sg, su = torch.tensor(0.05, device=cuda), torch.tensor(0.04, device=cuda)
    act = TORCH_DT[dtype]
    twin = tm_ops.ternary_swiglu(x, xs, wg, sg, wu, su, act_dtype=act)
    for tab in (None, TL.build_tables(x, t=wg_idx.shape[0])):
        got = tl_ops.tl_swiglu(x, xs, wg_idx, sg, wu_idx, su, tables=tab, act_dtype=act)
        assert torch.equal(got[0], twin[0]) and torch.equal(got[1], twin[1])
        want = tl_ref.tl_swiglu(x, xs, wg_idx, sg, wu_idx, su, tables=tab, act_dtype=act)
        _assert_quant_close(got, want, QUANT_RTOL[dtype])


def test_tl_wrappers_count_and_validate(cuda):
    rng = np.random.default_rng(99)
    wp, w_idx, x, xs = _tl_operands(rng, 4, 64, 32, cuda)
    ws = torch.tensor(0.5, device=cuda)
    reset_launch_counts()
    tl_ops.tl_gemv(x, xs, w_idx, ws)
    tl_ops.tl_matmul(x, xs, w_idx, ws)
    tl_ops.tl_swiglu(x, xs, w_idx, ws, w_idx, ws)
    nq_ops.norm_quant_tables(torch.ones((4, 64), device=cuda), torch.ones(64, device=cuda))
    counts = launch_counts()
    assert all(counts[n] == 1 for n in ("tl_gemv", "tl_matmul", "tl_swiglu",
                                        "norm_quant_tables")), counts
    with pytest.raises(TypeError):
        tl_ops.tl_matmul(x, xs, w_idx.to(torch.int32), ws)
    with pytest.raises(ValueError):
        tl_ops.tl_matmul(x[:, :30].contiguous(), xs, w_idx, ws)
    with pytest.raises(ValueError):
        tl_ops.tl_matmul(None, xs, w_idx, ws, tables=torch.zeros((4, 27), device=cuda))


@pytest.mark.parametrize("layout", ["contiguous", "paged"])
def test_smoke_tl_engine_vs_packed(cuda, layout):
    """The f32 smoke config with matmul_engine="tl" through the kernels:
    generate and the engine give the packed kernels' streams, and only the
    TL kernels run the projections."""
    cfg = dataclasses.replace(get_config("tellme-0.7b", smoke=True), dtype=torch.float32,
                              kv_layout=layout)
    tl_cfg = dataclasses.replace(cfg, matmul_engine="tl")
    specs = TT.param_specs(cfg)
    params = TT.pack_tree(PR.init_params(specs, seed=0, device=cuda), specs, dtype=cfg.dtype)
    prompts = torch.randint(0, cfg.vocab_size, (3, 13), generator=torch.Generator().manual_seed(1))
    rng = np.random.default_rng(3)
    reqs = [rng.integers(0, cfg.vocab_size, n) for n in (9, 30, 70, 130, 200)]

    def run(c):
        reset_launch_counts()
        gen = TE.generate(params, c, prompts, steps=8, kernels=KERNELS)
        eng = TE.ServingEngine(params, c, slots=2, max_len=256, kernels=KERNELS)
        rs = [TE.Request(rid=i, prompt=p, max_new=6) for i, p in enumerate(reqs)]
        for r in rs:
            eng.submit(r)
        eng.run()
        return gen.tokens, [(r.generated, r.status) for r in rs], launch_counts()

    g_tl, e_tl, counts = run(tl_cfg)
    g_pk, e_pk, _ = run(cfg)
    assert torch.equal(g_tl, g_pk) and e_tl == e_pk
    assert all(counts[n] > 0 for n in ("norm_quant_tables", "tl_matmul", "tl_swiglu")), counts
    assert all(counts[n] == 0 for n in ("ternary_gemv", "ternary_matmul", "ternary_swiglu"))


FLASH_TOL_F32 = 1e-5
FLASH_TOL_BF16 = 2e-2  # of |want| + the RMS of want's row


# (B, H, HK, S, D, dtype): chip_smoke.py's shapes (generate's bucket, 1024
# and 4096 tokens in bf16, 4096 in f32, GQA at a ragged S), then the smoke
# config's D = 16 and the JAX tests' D = 32, ragged; then the tensor-core
# kernel (bf16) at every D with S around its 64-row tiles, and with GQA
FLASH_CASES = [
    (4, 16, 16, 128, 96, "bfloat16"), (1, 16, 16, 1024, 96, "bfloat16"),
    (1, 16, 16, 4096, 96, "bfloat16"), (1, 16, 16, 4096, 96, "float32"),
    (1, 8, 2, 200, 64, "float32"), (3, 4, 4, 64, 16, "float32"),
    (2, 4, 2, 77, 32, "bfloat16"), (1, 4, 4, 200, 96, "float32")]
FLASH_CASES += [(2, 4, 4, s, d, "bfloat16") for s in (1, 63, 65, 129)
                for d in (16, 32, 64, 96, 128)]
FLASH_CASES += [(1, 8, 2, 200, 64, "bfloat16"), (2, 8, 2, 129, 96, "bfloat16")]
# groups of 16 (llama3-405b: 128 heads on 8) and musicgen-medium's D = 64
# without GQA, narrowed
FLASH_CASES += [(1, 16, 1, 200, 128, "bfloat16"), (1, 16, 1, 129, 128, "float32"),
                (2, 6, 6, 100, 64, "bfloat16")]


@pytest.mark.parametrize("b,h,hk,s,d,dtype", FLASH_CASES)
def test_flash_attention(cuda, b, h, hk, s, d, dtype):
    rng = np.random.default_rng(s + d + h)
    td = TORCH_DT[dtype]
    q = _t(rng.standard_normal((b, h, s, d)).astype(np.float32), cuda, td)
    k = _t(rng.standard_normal((b, hk, s, d)).astype(np.float32), cuda, td)
    v = _t(rng.standard_normal((b, hk, s, d)).astype(np.float32), cuda, td)
    got = fa_ops.flash_attention(q, k, v)
    dense = fa_ops.flash_attention(q, k, v, causal_skip=False)
    want = fa_ref.flash_attention(q, k, v).float()
    torch.cuda.synchronize()
    assert got.dtype == td and got.shape == q.shape
    if td is torch.float32:
        torch.testing.assert_close(got, want, atol=FLASH_TOL_F32, rtol=FLASH_TOL_F32)
    else:
        rms = want.pow(2).mean(dim=-1, keepdim=True).sqrt()
        err = (got.float() - want).abs()
        worst = (err / (want.abs() + rms)).max().item()
        assert worst <= FLASH_TOL_BF16, worst
    assert torch.equal(dense, got)  # masked tiles add exact zeros


# (B, H, HK, S, Dqk, Dv, dtype): DeepSeek-V2-Lite's MLA prefill (192, 128),
# instantiated, and the smoke config's (24, 16), zero-padded to (32, 32)
FLASH_DV_CASES = [(4, 16, 16, 100, 192, 128, "bfloat16"), (1, 16, 16, 1000, 192, 128, "bfloat16"),
                  (2, 4, 4, 129, 192, 128, "float32"), (3, 4, 4, 13, 24, 16, "float32"),
                  (2, 4, 4, 65, 24, 16, "bfloat16"), (1, 4, 2, 77, 192, 128, "bfloat16")]


@pytest.mark.parametrize("b,h,hk,s,d,dv,dtype", FLASH_DV_CASES)
def test_flash_attention_dv_and_scale(cuda, b, h, hk, s, d, dv, dtype):
    """v of another head dim than q and k, and an explicit scale (MLA's
    1/sqrt(Dqk)), against the plain version at the same bars."""
    rng = np.random.default_rng(s + d + dv)
    td = TORCH_DT[dtype]
    q = _t(rng.standard_normal((b, h, s, d)).astype(np.float32), cuda, td)
    k = _t(rng.standard_normal((b, hk, s, d)).astype(np.float32), cuda, td)
    v = _t(rng.standard_normal((b, hk, s, dv)).astype(np.float32), cuda, td)
    scale = 1.0 / np.sqrt(d + 5)
    got = fa_ops.flash_attention(q, k, v, scale=scale)
    dense = fa_ops.flash_attention(q, k, v, scale=scale, causal_skip=False)
    want = fa_ref.flash_attention(q, k, v, scale=scale).float()
    torch.cuda.synchronize()
    assert got.dtype == td and got.shape == (b, h, s, dv)
    if td is torch.float32:
        torch.testing.assert_close(got, want, atol=FLASH_TOL_F32, rtol=FLASH_TOL_F32)
    else:
        rms = want.pow(2).mean(dim=-1, keepdim=True).sqrt()
        worst = ((got.float() - want).abs() / (want.abs() + rms)).max().item()
        assert worst <= FLASH_TOL_BF16, worst
    assert torch.equal(dense, got)


# (B, H, HK, S, Dqk, Dv, window, softcap, dtype): gemma2's sliding window
# and attention softcap, G = 1 and 2, windows shorter than S and off the
# 64-row tiles (and the f32 kernel's 32), a window of 1, one wider than S,
# the smoke's padded (24, 16) pair, and gemma2-27b's local layer at 4352
# tokens past its 4096 window
FLASH_WINDOW_CASES = [
    (2, 4, 4, 200, 32, 32, 37, 50.0, "bfloat16"), (2, 4, 4, 200, 32, 32, 37, 50.0, "float32"),
    (1, 8, 4, 300, 128, 128, 100, 50.0, "bfloat16"), (1, 8, 4, 300, 128, 128, 100, 50.0, "float32"),
    (2, 4, 2, 129, 16, 16, 16, 50.0, "bfloat16"), (2, 4, 2, 129, 16, 16, 16, 0.0, "float32"),
    (1, 4, 2, 65, 64, 64, 1, 30.0, "bfloat16"), (1, 4, 2, 65, 64, 64, 500, 5.0, "float32"),
    (1, 4, 4, 77, 24, 16, 20, 50.0, "bfloat16"), (1, 4, 4, 77, 24, 16, 20, 50.0, "float32"),
    (1, 4, 2, 256, 128, 128, 0, 50.0, "bfloat16"),
    (1, 32, 16, 4352, 128, 128, 4096, 50.0, "bfloat16")]


@pytest.mark.parametrize("b,h,hk,s,d,dv,window,softcap,dtype", FLASH_WINDOW_CASES)
def test_flash_attention_window_softcap(cuda, b, h, hk, s, d, dv, window, softcap, dtype):
    """The sliding window and the softcap (gemma2's local and global
    layers) against the plain version at the bars above; the dense schedule
    (every tile visited and masked) gives the windowed walk's output bit
    for bit, and with neither option the kernel's output is unchanged."""
    rng = np.random.default_rng(s + d + window)
    td = TORCH_DT[dtype]
    q = _t(4 * rng.standard_normal((b, h, s, d)).astype(np.float32), cuda, td)
    k = _t(rng.standard_normal((b, hk, s, d)).astype(np.float32), cuda, td)
    v = _t(rng.standard_normal((b, hk, s, dv)).astype(np.float32), cuda, td)
    got = fa_ops.flash_attention(q, k, v, window=window, softcap=softcap)
    dense = fa_ops.flash_attention(q, k, v, window=window, softcap=softcap, causal_skip=False)
    want = fa_ref.flash_attention(q, k, v, window=window, softcap=softcap).float()
    plain_kernel = fa_ops.flash_attention(q, k, v)
    torch.cuda.synchronize()
    assert got.dtype == td and got.shape == (b, h, s, dv)
    if td is torch.float32:
        torch.testing.assert_close(got, want, atol=FLASH_TOL_F32, rtol=FLASH_TOL_F32)
    else:
        rms = want.pow(2).mean(dim=-1, keepdim=True).sqrt()
        worst = ((got.float() - want).abs() / (want.abs() + rms)).max().item()
        assert worst <= FLASH_TOL_BF16, worst
    assert torch.equal(dense, got)
    assert torch.equal(plain_kernel, fa_ops.flash_attention(q, k, v, window=0, softcap=0.0))
    if 0 < window < s:  # the window acts: it is not the causal output
        assert not torch.equal(got, fa_ops.flash_attention(q, k, v, softcap=softcap))


def test_gemma2_local_block_kernels_vs_plain(cuda):
    """gemma2-27b smoke's local block (window 16, softcaps) in f32 through
    the kernels on the card and the plain versions on the same weights: a
    40-token prefill and one decode step at positions past the window,
    within 1e-4 of max |plain|, through the fused branch (two norm-quant
    launches)."""
    cfg = dataclasses.replace(get_config("gemma2-27b", smoke=True), dtype=torch.float32)
    params = PR.init_packed_params(TT.param_specs(cfg), 0, cuda, dense_leaves=TT.DENSE_LEAVES)
    kind, bp, _ = list(TT._layers(cfg, params))[0]
    assert kind.local and cfg.sliding_window == 16
    x = torch.randn((2, 40, cfg.d_model), generator=torch.Generator(device=cuda).manual_seed(1),
                    device=cuda)
    rope = TT.rope_for(cfg, torch.arange(40, device=cuda)[None].expand(2, 40))
    reset_launch_counts()
    yk, rows = TT.apply_block(kind, bp, x, cfg, rope, kernels=KERNELS)
    counts = launch_counts()
    yp, _ = TT.apply_block(kind, bp, x, cfg, rope, kernels=PLAIN)
    assert (yk - yp).abs().max() <= 1e-4 * yp.abs().max()
    assert counts["norm_quant"] == 2 and counts["flash_attention"] == 1
    pos = torch.tensor([40, 29], dtype=torch.int32, device=cuda)
    cache = {n: torch.nn.functional.pad(r, (0, 0, 0, 3)) for n, r in rows.items()}  # S + 3
    drope = TT.rope_for(cfg, pos[:, None])
    x1 = x[:, :1].clone()
    dk, _ = TT.apply_block(kind, bp, x1, cfg, drope, kernels=KERNELS, pos=pos,
                           cache={n: c.clone() for n, c in cache.items()})
    dp, _ = TT.apply_block(kind, bp, x1, cfg, drope, kernels=PLAIN, pos=pos,
                           cache={n: c.clone() for n, c in cache.items()})
    assert (dk - dp).abs().max() <= 1e-4 * dp.abs().max()


@pytest.mark.parametrize("arch", ["deepseek-v2-lite-16b", "arctic-480b"])
def test_moe_block_kernels_vs_plain(cuda, arch):
    """One period block of each MoE family's smoke config in f32 (MLA or
    attention, routed experts with the shared or the dense MLP): through
    the kernels on the card and the plain versions on the same weights,
    prefill and one decode step, within 1e-4 of max |plain| (the projections
    are exact; attention rounds in another order); every expert projection
    a launch of its own."""
    cfg = dataclasses.replace(get_config(arch, smoke=True), dtype=torch.float32)
    params = PR.init_packed_params(TT.param_specs(cfg), 0, cuda, dense_leaves=TT.DENSE_LEAVES)
    kind, bp, _ = list(TT._layers(cfg, params))[-1]
    x = torch.randn((2, 13, cfg.d_model), generator=torch.Generator(device=cuda).manual_seed(1),
                    device=cuda)
    rope = TT.rope_for(cfg, torch.arange(13, device=cuda)[None].expand(2, 13))
    reset_launch_counts()
    yk, rows = TT.apply_block(kind, bp, x, cfg, rope, kernels=KERNELS)
    counts = launch_counts()
    yp, _ = TT.apply_block(kind, bp, x, cfg, rope, kernels=PLAIN)
    assert (yk - yp).abs().max() <= 1e-4 * yp.abs().max()
    projections = counts["ternary_gemv"] + counts["ternary_matmul"]
    assert projections >= 3 * cfg.n_experts and counts["flash_attention"] == 1
    pos = torch.tensor([13, 5], dtype=torch.int32, device=cuda)
    x1 = x[:, :1].clone()
    cache = {n: torch.nn.functional.pad(r, (0, 0, 0, 3)) for n, r in rows.items()}  # S + 3
    drope = TT.rope_for(cfg, pos[:, None])
    dk, _ = TT.apply_block(kind, bp, x1, cfg, drope, kernels=KERNELS, pos=pos,
                           cache={n: c.clone() for n, c in cache.items()})
    dp, _ = TT.apply_block(kind, bp, x1, cfg, drope, kernels=PLAIN, pos=pos,
                           cache={n: c.clone() for n, c in cache.items()})
    assert (dk - dp).abs().max() <= 1e-4 * dp.abs().max()


@pytest.mark.parametrize("block", ["b0", "b1", "b2"])
def test_jamba_block_kernels_vs_plain(cuda, block):
    """One block of each jamba smoke kind in f32 (b0 Mamba + dense MLP, b1
    Mamba + routed experts, b2 attention + dense MLP on the fused branch),
    through the kernels on the card and the plain versions on the same
    weights: a 2 x 13 prefill, then one decode step from its state or
    cache. The Mamba kinds are bit-equal (their projections are exact
    int32 sums through the same epilogues, and everything else is the same
    torch code); the attention kind within 1e-4 of max |plain|."""
    cfg = dataclasses.replace(get_config("jamba-v0.1-52b", smoke=True), dtype=torch.float32)
    params = PR.init_packed_params(TT.param_specs(cfg), 0, cuda, dense_leaves=TT.DENSE_LEAVES)
    kind, bp, _ = list(TT._layers(cfg, params))[int(block[1])]
    x = torch.randn((2, 13, cfg.d_model), generator=torch.Generator(device=cuda).manual_seed(1),
                    device=cuda)
    rope = TT.rope_for(cfg, torch.arange(13, device=cuda)[None].expand(2, 13))
    reset_launch_counts()
    yk, rows_k = TT.apply_block(kind, bp, x, cfg, rope, kernels=KERNELS)
    counts = launch_counts()
    yp, rows = TT.apply_block(kind, bp, x, cfg, rope, kernels=PLAIN)
    pos = torch.tensor([13, 5], dtype=torch.int32, device=cuda)
    x1 = x[:, :1].clone()
    if kind.mixer == "mamba":
        assert torch.equal(yk, yp)
        for n in rows:
            assert torch.equal(rows_k[n], rows[n]), n
        cache = rows
    else:
        assert (yk - yp).abs().max() <= 1e-4 * yp.abs().max()
        assert counts["norm_quant"] == 2 and counts["flash_attention"] == 1
        cache = {n: torch.nn.functional.pad(r, (0, 0, 0, 3)) for n, r in rows.items()}
    assert counts["ternary_gemv"] + counts["ternary_matmul"] >= (
        3 * cfg.n_experts if kind.ffn == "moe" else 4)
    drope = TT.rope_for(cfg, pos[:, None])
    ck, cp = ({n: c.clone() for n, c in cache.items()} for _ in range(2))
    dk, _ = TT.apply_block(kind, bp, x1, cfg, drope, kernels=KERNELS, pos=pos, cache=ck)
    dp, _ = TT.apply_block(kind, bp, x1, cfg, drope, kernels=PLAIN, pos=pos, cache=cp)
    if kind.mixer == "mamba":
        assert torch.equal(dk, dp)
        for n in ck:
            assert torch.equal(ck[n], cp[n]), n
    else:
        assert (dk - dp).abs().max() <= 1e-4 * dp.abs().max()


def test_flash_attention_counts_and_checks(cuda):
    """A CUDA tensor launches the kernel (the count goes up, through the
    kernel set too) and never takes the plain version; bad inputs raise."""
    q = torch.randn((1, 4, 64, 32), device=cuda)
    k = torch.randn((1, 2, 64, 32), device=cuda)
    reset_launch_counts()
    fa_ops.flash_attention(q, k, k.clone())
    KERNELS.flash_attention(q, k, k.clone(), causal_skip=False)
    TA.prefill_attention(q, k, k.clone(), kernels=KERNELS)
    assert launch_counts()["flash_attention"] == 3
    with pytest.raises(ValueError, match="head dims"):  # no instantiated pair holds 256
        fa_ops.flash_attention(torch.randn((1, 4, 64, 256), device=cuda),
                               torch.randn((1, 2, 64, 256), device=cuda), k.clone())
    with pytest.raises(TypeError):
        fa_ops.flash_attention(q, k.to(torch.bfloat16), k.to(torch.bfloat16))
    with pytest.raises(ValueError):
        fa_ops.flash_attention(q, k[:, :, :32].contiguous(), k[:, :, :32].contiguous())
    with pytest.raises(ValueError):
        fa_ops.flash_attention(q, torch.randn((1, 3, 64, 32), device=cuda),
                               torch.randn((1, 3, 64, 32), device=cuda))
    qb = torch.randn(q.numel() + 1, device=cuda).to(torch.bfloat16)[1:].view(q.shape)
    with pytest.raises(ValueError, match="aligned"):  # the bf16 kernel copies q by 16 bytes
        fa_ops.flash_attention(qb, k.to(torch.bfloat16), k.to(torch.bfloat16))
    assert launch_counts()["flash_attention"] == 3


@pytest.mark.parametrize("kv", ["bf16", "int8"])
def test_smoke_legacy_engine_kernels_vs_plain(cuda, kv):
    """The f32 smoke config in the engine with prefill="legacy": through the
    kernels on the card, the streams and statuses of the plain versions on
    the CPU and of the chunked engine on the card; one flash-attention
    launch per layer and admission, no prefill-append launch."""
    cfg = dataclasses.replace(get_config("tellme-0.7b", smoke=True), dtype=torch.float32,
                              kv_cache_dtype=kv)
    specs = TT.param_specs(cfg)
    cpu_params = TT.pack_tree(PR.init_params(specs, seed=0, device="cpu"), specs,
                              dtype=cfg.dtype)
    rng = np.random.default_rng(4)
    prompts = [rng.integers(0, cfg.vocab_size, n) for n in (9, 30, 70, 130, 200, 255)]

    def serve(params, kernels, device, prefill):
        eng = TE.ServingEngine(params, cfg, slots=2, max_len=256, kernels=kernels,
                               device=device, prefill=prefill)
        reqs = [TE.Request(rid=i, prompt=p, max_new=8) for i, p in enumerate(prompts)]
        for r in reqs:
            eng.submit(r)
        eng.run()
        return [(r.generated, r.status) for r in reqs], eng

    cuda_params = _to(cpu_params, cuda)
    reset_launch_counts()
    got, eng = serve(cuda_params, KERNELS, None, "legacy")
    counts = launch_counts()
    want, _ = serve(cpu_params, PLAIN, "cpu", "legacy")
    chunked, _ = serve(cuda_params, KERNELS, None, "chunked")
    assert got == want == chunked
    st = eng.stats()
    assert st["host_transfers"] == st["ticks"] and st["fused_ticks"] == 0
    sfx = "_quant" if kv == "int8" else ""
    assert counts["flash_attention"] == cfg.n_layers * len(prompts)
    assert counts["decode_attention" + sfx] == cfg.n_layers * st["ticks"]
    assert counts["prefill_append" + sfx] == 0


WKV_TOL = 1e-4  # of each head's max |plain|


def _wkv_inputs(rng, b, h, s, n, dtype, dev):
    r, k, v = (_t(rng.standard_normal((b, h, s, n)).astype(np.float32), dev, dtype)
               for _ in range(3))
    fast = -(10.0 ** rng.uniform(-4.0, 1.0, (b, h, s, n)))
    slow = -(10.0 ** rng.uniform(-4.0, -3.0, (b, h, s, n)))
    logw = _t(np.where(np.arange(n) % 2 == 0, slow, fast).astype(np.float32), dev)
    u = _t((rng.standard_normal((h, n)) * 0.5).astype(np.float32), dev)
    return r, k, v, logw, u


def _head_rel_err(got, want):
    diff = (got - want).abs().flatten(2).amax(-1)
    return (diff / want.abs().flatten(2).amax(-1)).max().item()


def _wkv_check(args):
    """The kernels against the plain version on ``args``: y and the final
    state f32, of their shapes, within WKV_TOL of each head's scale (NaN
    fails too)."""
    from repro_torch.kernels.wkv import ops as wkv_ops
    from repro_torch.kernels.wkv import ref as wkv_ref

    b, h, s, n = args[0].shape
    y, s_n = wkv_ops.wkv(*args)
    want_y, want_s = wkv_ref.wkv(*args)
    torch.cuda.synchronize()
    assert y.dtype == s_n.dtype == torch.float32
    assert y.shape == (b, h, s, n) and s_n.shape == (b, h, n, n)
    assert _head_rel_err(y, want_y) <= WKV_TOL
    assert _head_rel_err(s_n, want_s) <= WKV_TOL
    return y, s_n


# S on either side of the kernels' 64-row chunks and 16-row sub-chunks
# (1 to 129), and 4000 tokens (63 chunks), where the slow channels carry
# the state through every step of the state scan
@pytest.mark.parametrize("b,h,s,n,dtype", [
    (3, 4, 77, 16, "float32"), (2, 3, 1, 32, "float32"), (2, 3, 130, 32, "bfloat16"),
    (1, 2, 64, 64, "float32"), (4, 40, 100, 64, "bfloat16"), (1, 4, 200, 64, "float32"),
    (1, 8, 1000, 64, "bfloat16"), *((2, 3, s, 64, "float32") for s in (1, 16, 17, 63, 64, 65, 129)),
    (1, 4, 4000, 64, "bfloat16")])
def test_wkv(cuda, b, h, s, n, dtype):
    from repro_torch.kernels.wkv import ops as wkv_ops

    args = _wkv_inputs(np.random.default_rng(s + n), b, h, s, n, TORCH_DT[dtype], cuda)
    y, s_n = _wkv_check(args)
    # the layout time_mix hands over: [B, S, H, n] tensors seen as [B, H, S, n]
    strided = [t.transpose(1, 2).contiguous().transpose(1, 2) for t in args[:4]]
    y2, s2 = wkv_ops.wkv(*strided, args[4])
    assert torch.equal(y2, y) and torch.equal(s2, s_n)


@pytest.mark.parametrize("logw", [-10.0, -1e-4])
def test_wkv_uniform_decay(cuda, logw):
    """Every decay at the model's clip: -10 a row, where e_t - lc_s spans
    +-630 within a chunk and the factored exponents must stay <= 0, and
    -1e-4, where the state keeps nearly all of every row."""
    r, k, v, w, u = _wkv_inputs(np.random.default_rng(7), 2, 3, 200, 64, torch.float32, cuda)
    _wkv_check((r, k, v, torch.full_like(w, logw), u))


def test_wkv_deterministic_and_batch_invariant(cuda):
    """Two calls on the same inputs are bit-equal, and each head of a
    B = 4 call is bit-equal to the same inputs run alone at B = 1: no
    atomics, so a head's result depends on its own inputs only."""
    from repro_torch.kernels.wkv import ops as wkv_ops

    args = _wkv_inputs(np.random.default_rng(11), 4, 5, 300, 64, torch.bfloat16, cuda)
    y, s_n = wkv_ops.wkv(*args)
    y2, s_n2 = wkv_ops.wkv(*args)
    assert torch.equal(y, y2) and torch.equal(s_n, s_n2)
    for i in range(4):
        ya, sa = wkv_ops.wkv(*(t[i:i + 1] for t in args[:4]), args[4])
        assert torch.equal(ya, y[i:i + 1]) and torch.equal(sa, s_n[i:i + 1])


def test_wkv_counts_and_checks(cuda):
    """A CUDA tensor launches the kernel (counted, through the kernel set
    too) and never takes the plain version; bad inputs raise."""
    from repro_torch.kernels.wkv import ops as wkv_ops

    r, k, v, logw, u = _wkv_inputs(np.random.default_rng(0), 1, 2, 70, 16, torch.float32,
                                   cuda)
    reset_launch_counts()
    wkv_ops.wkv(r, k, v, logw, u)
    KERNELS.wkv(r, k, v, logw, u)
    assert launch_counts()["wkv"] == 2
    with pytest.raises(ValueError, match="head size"):
        wkv_ops.wkv(*(t[..., :8].contiguous() for t in (r, k, v, logw)), u[:, :8].contiguous())
    with pytest.raises(TypeError):
        wkv_ops.wkv(r, k.to(torch.bfloat16), v, logw, u)
    with pytest.raises(TypeError):
        wkv_ops.wkv(r, k, v, logw.to(torch.bfloat16), u)
    with pytest.raises(ValueError):
        wkv_ops.wkv(r, k, v, logw, u[:1].contiguous())
    with pytest.raises(ValueError):
        wkv_ops.wkv(r, k[:, :, :64].contiguous(), v, logw, u)
    with pytest.raises(ValueError, match="strides"):  # one input in another layout
        wkv_ops.wkv(r, k.transpose(1, 2).contiguous().transpose(1, 2), v, logw, u)
    with pytest.raises(ValueError, match="strides"):  # no unit last stride
        wkv_ops.wkv(*(t.transpose(-1, -2).contiguous().transpose(-1, -2)
                      for t in (r, k, v, logw)), u)
    assert launch_counts()["wkv"] == 2


@pytest.mark.parametrize("bh,s,n", [(1, 0, 64), (3, 1, 16), (40, 64, 64), (40, 65, 64),
                                    (4, 4000, 32)])
def test_wkv_buffer_floats(cuda, bh, s, n):
    """The buffer the wrapper allocates for y and the kernels' scratch, as
    the library reports it: y's floats alone up to one chunk of 64 rows,
    then each chunk's state increment [n, n] and decay [n] after y."""
    from repro_torch.kernels import _build as KB

    nc = -(-s // 64)
    scratch = bh * nc * (n * n + n) if nc > 1 else 0
    assert KB.library().tm_wkv_buffer_floats(bh, s, n) == bh * s * n + scratch


def test_smoke_rwkv_kernels_vs_plain(cuda):
    """The f32 rwkv smoke config through the kernels on the card gives the
    plain versions' greedy streams on the CPU, through generate (one wkv
    launch per layer) and the legacy engine (statuses too)."""
    cfg = dataclasses.replace(get_config("rwkv6-3b", smoke=True), dtype=torch.float32)
    specs = TT.param_specs(cfg)
    cpu_params = TT.pack_tree(PR.init_params(specs, seed=0, device="cpu"), specs,
                              dtype=cfg.dtype)
    cuda_params = _to(cpu_params, cuda)
    prompts = np.random.default_rng(8).integers(0, cfg.vocab_size, (3, 13))
    reset_launch_counts()
    got = TE.generate(cuda_params, cfg, prompts, steps=10, kernels=KERNELS)
    assert launch_counts()["wkv"] == cfg.n_layers
    want = TE.generate(cpu_params, cfg, prompts, steps=10, kernels=PLAIN, device="cpu")
    assert torch.equal(got.tokens, want.tokens)

    rng = np.random.default_rng(9)
    eng_prompts = [rng.integers(0, cfg.vocab_size, n) for n in (9, 30, 70, 130)]

    def serve(params, kernels, device):
        eng = TE.ServingEngine(params, cfg, slots=2, max_len=256, kernels=kernels,
                               device=device)
        reqs = [TE.Request(rid=i, prompt=p, max_new=6) for i, p in enumerate(eng_prompts)]
        for r in reqs:
            eng.submit(r)
        eng.run()
        return [(r.generated, r.status) for r in reqs], eng

    reset_launch_counts()
    served, eng = serve(cuda_params, KERNELS, None)
    assert launch_counts()["wkv"] == cfg.n_layers * len(eng_prompts)
    assert served == serve(cpu_params, PLAIN, "cpu")[0]
    assert eng.prefill == "legacy" and eng.stats()["host_transfers"] == eng.stats()["ticks"]


@pytest.mark.parametrize("kv", ["bf16", "int8"])
def test_two_engines_on_two_threads_equal_each_alone(cuda, kv):
    """Two engines over one params tree, stepped at the same time on two
    threads: each gives its streams and cache bytes run alone, bit for bit."""
    cfg = dataclasses.replace(get_config("tellme-0.7b", smoke=True), kv_cache_dtype=kv)
    specs = TT.param_specs(cfg)
    params = TT.pack_tree(PR.init_params(specs, seed=0, device=cuda), specs, dtype=cfg.dtype)
    rng = np.random.default_rng(11)
    workloads = [[rng.integers(0, cfg.vocab_size, n) for n in lens]
                 for lens in ((9, 70, 200, 30, 130), (150, 12, 64, 90))]

    def engine(prompts):
        eng = TE.ServingEngine(params, cfg, slots=2, max_len=256, kernels=KERNELS)
        reqs = [TE.Request(rid=i, prompt=p, max_new=12) for i, p in enumerate(prompts)]
        for r in reqs:
            eng.submit(r)
        return eng, reqs

    def result(eng, reqs):
        torch.cuda.synchronize()
        caches = {b: {n: t.cpu() for n, t in leaves.items()}
                  for b, leaves in eng.caches["blocks"].items()}
        return [(r.generated, r.status) for r in reqs], caches

    alone = []
    for prompts in workloads:
        eng, reqs = engine(prompts)
        eng.run()
        alone.append(result(eng, reqs))
    pairs = [engine(p) for p in workloads]
    barrier, errors = threading.Barrier(2), []

    def run(eng):
        try:
            barrier.wait(timeout=60)
            eng.run()
        except BaseException as exc:  # noqa: BLE001 -- reported below
            errors.append(exc)

    threads = [threading.Thread(target=run, args=(eng,)) for eng, _ in pairs]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    assert not errors and not any(t.is_alive() for t in threads)
    for (eng, reqs), (streams, caches) in zip(pairs, alone):
        got_streams, got_caches = result(eng, reqs)
        assert got_streams == streams
        assert all(r.status.name == "OK" for r in reqs)
        for b, leaves in caches.items():
            for n, t in leaves.items():
                assert torch.equal(got_caches[b][n], t), (b, n)


class _Sink:
    def __init__(self):
        self.items = []

    def push(self, item):
        self.items.append(item)


def test_smoke_pool_replica_crash_equals_cpu(cuda):
    """The f32 smoke pool of two replicas (default warmup: the library
    loaded, one request through the kernels) under a replica_crash on
    replica 0: on the card, the CPU pool's streams and terminal events."""
    cfg = dataclasses.replace(get_config("tellme-0.7b", smoke=True), dtype=torch.float32,
                              pool_backoff_s=0.1, pool_hang_timeout_s=300.0)
    specs = TT.param_specs(cfg)
    cpu_params = TT.pack_tree(PR.init_params(specs, seed=0, device="cpu"), specs,
                              dtype=cfg.dtype)
    rng = np.random.default_rng(12)
    prompts = [[int(t) for t in rng.integers(0, cfg.vocab_size, n)]
               for n in (40, 70, 30, 17, 25, 55)]
    plan = TR.FaultPlan(faults=(TR.Fault("replica_crash", tick=5, replica=0),))

    def serve(params, kernels, device):
        pool = ReplicaPool(
            lambda idx: TE.ServingEngine(params, cfg, slots=2, max_len=192, kernels=kernels,
                                         device=device),
            cfg, replicas=2, fault_plan=plan)
        sinks = [_Sink() for _ in prompts]
        pool.start(supervise=False)
        try:
            t0 = time.monotonic()
            while sum(r.state == "ready" for r in pool.replicas) < 2:
                assert time.monotonic() - t0 < 300, pool.stats()
                pool.poll()
                time.sleep(0.005)
            for p, s in zip(prompts, sinks):
                pool.submit(p, max_new=10, sink=s)
            while not pool.idle():
                assert time.monotonic() - t0 < 300, pool.stats()
                pool.poll()
                time.sleep(0.005)
            return [s.items for s in sinks], pool.stats()
        finally:
            pool.stop()

    got, st = serve(_to(cpu_params, cuda), KERNELS, None)
    want, _ = serve(cpu_params, PLAIN, "cpu")
    assert st["migrated_total"] >= 1 and st["statuses"] == {"OK": len(prompts)}

    def tokens(items):
        return [t for it in items if it[0] == "tokens" for t in it[1]]

    assert [tokens(i) for i in got] == [tokens(i) for i in want]
    assert [[it for it in i if it[0] == "final"] for i in got] == [
        [("final", "OK", None, 10)]] * len(prompts)
