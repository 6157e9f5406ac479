"""On-card check of the PyTorch/CUDA port: builds the CUDA kernels, holds
each against its plain PyTorch version at tellme-0.7b's real shapes, times
them, then drives greedy ``generate`` and the chunked continuous-batching
``ServingEngine`` for tellme-0.7b at full width.

    python3 chip_smoke.py                # one CUDA device
    python3 chip_smoke.py --out report.json   # also the full report as JSON

Phases (each prints one JSON line; any failed bar exits non-zero):
  build     nvcc builds the five kernel sources (timed).
  kernels   the eight kernel entry points vs their plain versions: the
            generate path's at the decode (B = 4) and prefill (B*bucket =
            512 rows) shapes; int8 decode attention at the engine's decode
            shape (8 slots, cache 1280 rows); prefill-append, bf16 and int8
            cache, at the engine's tick shape (8 slots, C = 256, live slots
            at offsets 0 and 512, six write-only slots) and at one slot with
            C = 128 at offset 768. Kernel, plain, library and bound times.
  smoke     the smoke config in f32 on the card (kernels) against the same
            weights on the CPU (plain versions): equal greedy streams.
  engine_smoke  the same for the ServingEngine, both cache dtypes: equal
            per-request streams and statuses.
  generate  full-width tellme-0.7b (24 layers, random weights from seed 0),
            B = 4, prompt 100 (bucket 128), 64 greedy steps, once through
            the kernels (launch counters reset just before, read just after)
            and once through the plain versions on the card; then eight
            decode steps from shared caches both ways (logits held to a
            bar at each, argmax equal at the first), the per-layer drift
            between the two prefills, and torch.profiler over three
            decode steps (device time by kernel, busy share).
  engine    full-width ServingEngine, slots = 8, max_len = 1024, 16 requests
            (prompts of 16-900 tokens, 32 new tokens each), for each cache
            dtype through the kernels (counters reset just before, read just
            after) and through the plain versions: every request OK with 32
            tokens, one host transfer per tick, 24 attention launches per
            tick that runs them; tick times, tokens/s, time to first token,
            cache bytes, stream agreement with the plain run.
  chunk_step  one full-width prefill_chunk_step per cache dtype from shared
            caches (4 slots, chunk 128 at offset 256 after a 256-chunk):
            last-row logits of kernels vs plain versions to a bar, and the
            kernels' argmax a plain argmax (equal, or one of two exactly
            tied plain logits).
Then the ``kernels`` line, the card's name and power limit, and the last
line ``{"ok": true, "device": {...}}``. Without CUDA it exits non-zero and
prints no result.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))

HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA data sheet
PEAK_OPS = {"int8": 1979e12, "bf16": 989e12, "f32": 67e12}  # dense, 700 W

# Bars (see PERF.md and CHANGES.md for why each is not exact)
QUANT_SCALE_RTOL = 4.1e-3  # one bf16 ulp of the row scale
ATTN_TOL_BF16 = 4e-3  # atol = rtol: two bf16 ulps at |out| <= 0.5
ATTN_TOL_F32 = 1e-5  # atol = rtol, the same inputs in f32
LOGIT_REL_TOL = 5e-2  # full-width prefill and decode-step logits, relative to max |logit|
SMOKE_LOGIT_TOL = 1e-3  # f32 smoke prefill logits, card vs CPU

STEPS = 64  # greedy steps of the full-width run
DECODE_CHECK_STEPS = 8  # decode steps held against the plain versions from shared caches

# The kernels that generate runs (bf16 cache)
GENERATE_PATH = ("norm_quant", "ternary_gemv", "ternary_matmul", "ternary_swiglu",
                 "decode_attention")

# The full-width engine run (and the kernel shapes taken from its ticks)
ENGINE_SLOTS, ENGINE_MAX_LEN, ENGINE_REQUESTS, ENGINE_NEW = 8, 1024, 16, 32
ENGINE_PROMPT_RANGE = (16, 900)  # prompt lengths, uniform, numpy default_rng(0)


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    if out.returncode:
        fail(f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


# ---------------------------------------------------------------------------
# timing
# ---------------------------------------------------------------------------


def time_ms(torch, fn, arg_sets, iters=100) -> float:
    """Device time per call, in ms: ``iters`` calls, cycling through
    ``arg_sets`` (copies of the streamed operand, so that it comes from
    device memory and not from L2), captured in one CUDA graph; the replay
    is timed with CUDA events. The graph removes the host's launch cost, so
    this is the time the card spends, gaps between kernels included."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # warm-up off the capture, as CUDA graphs ask
        for i in range(3):
            fn(*arg_sets[i % len(arg_sets)])
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for i in range(iters):
            fn(*arg_sets[i % len(arg_sets)])
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(5):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    del graph
    return start.elapsed_time(end) / (5 * iters)


def eager_ms(torch, fn, arg_sets, iters=200) -> float:
    """Time per call launched from Python one after another (CUDA events):
    the host's per-call cost shows here when it exceeds the kernel's."""
    for i in range(10):
        fn(*arg_sets[i % len(arg_sets)])
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(iters):
        fn(*arg_sets[i % len(arg_sets)])
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def copies_for(nbytes: int, limit: int = 64) -> int:
    """Enough copies of an operand to exceed twice the 50 MB L2."""
    return max(1, min(limit, math.ceil(100e6 / max(nbytes, 1))))


def bound_ms(nbytes: float, ops: float, kind: str) -> tuple[float, str]:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS[kind] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ---------------------------------------------------------------------------
# phase: kernels
# ---------------------------------------------------------------------------


def _nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts if t is not None)


def kernel_phase(torch, cfg, report: dict) -> list[dict]:
    from repro_torch.core import packing as PK
    from repro_torch.kernels.decode_attention import ops as da_ops
    from repro_torch.kernels.decode_attention import ref as da_ref
    from repro_torch.kernels.fused_norm_quant import ops as nq_ops
    from repro_torch.kernels.fused_norm_quant import ref as nq_ref
    from repro_torch.kernels.ternary_matmul import ops as tm_ops
    from repro_torch.kernels.ternary_matmul import ref as tm_ref

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(1234)
    bf16 = torch.bfloat16
    d, ff, b = cfg.d_model, cfg.d_ff, 4
    decode_m, prefill_m = b, b * 128

    def randn(*shape, dtype=torch.float32):
        return torch.randn(shape, generator=gen, device=dev).to(dtype)

    def int8(*shape):
        return torch.randint(-127, 128, shape, generator=gen, device=dev, dtype=torch.int8)

    def packed(n, k):
        w = torch.randint(-1, 2, (n, k), generator=gen, device=dev, dtype=torch.int8)
        return PK.pack2(w)

    def unpacked_bf16(wp, scale):
        return (PK.unpack2(wp).to(torch.float32) * scale).to(bf16)

    def quant_close(name, got, want):
        (qg, sg), (qw, sw) = got, want
        code_err = (qg.to(torch.int32) - qw.to(torch.int32)).abs().max().item()
        scale_err = ((sg - sw).abs() / sw.abs()).max().item()
        if code_err > 1 or scale_err > QUANT_SCALE_RTOL:
            fail(f"{name}: codes off by {code_err}, scale rel err {scale_err}")
        return float(code_err)

    rows = []
    checks = []

    # --- norm_quant: decode and prefill rows -----------------------------
    gamma = randn(d)
    for tag, m in (("decode", decode_m), ("prefill", prefill_m)):
        x = randn(m, d, dtype=bf16)
        err = quant_close(f"norm_quant[{tag}]", nq_ops.norm_quant(x, gamma),
                          nq_ref.norm_quant(x, gamma))
        checks.append({"kernel": "norm_quant", "shape": tag, "max_abs_err": err})
        if tag == "decode":
            nq_args = [(x, gamma)]
            nq_err = err
    x, _ = nq_args[0]
    nb = _nbytes(x, gamma) + x.numel() + x.shape[0] * 4
    bms, bby = bound_ms(nb, 5 * x.numel(), "f32")
    rows.append({"name": "norm_quant", "route": "cuda",
                 "source": "src/repro_torch/kernels/fused_norm_quant/csrc/norm_quant.cu",
                 "replaces": "src/repro/kernels/fused_norm_quant/kernel.py:74",
                 "shape": f"x[{decode_m},{d}] bf16", "max_abs_err": nq_err,
                 "ms": time_ms(torch, nq_ops.norm_quant, nq_args),
                 "eager_ms": eager_ms(torch, nq_ops.norm_quant, nq_args),
                 "plain_ms": time_ms(torch, nq_ref.norm_quant, nq_args),
                 "bound_ms": bms, "bound_by": bby, "library_ms": None})

    # --- ternary projections: GEMV (decode) and tiled matmul (prefill) ----
    def projection_row(name, fn, ref_fn, m, n, k, residual: bool, replaces, shape_tag):
        wp = packed(n, k)
        ws = torch.tensor(0.02, device=dev)
        x, xs = int8(m, n), randn(m, 1).abs() * 1e-3 + 1e-4
        res = randn(m, k, dtype=bf16) if residual else None
        got = fn(x, xs, wp, ws, out_dtype=bf16, residual=res)
        want = ref_fn(x, xs, wp, ws, out_dtype=bf16, residual=res)
        err = (got.float() - want.float()).abs().max().item()
        if err != 0.0:
            fail(f"{name}[{shape_tag}]: max |kernel - plain| = {err}, bar is exact")
        checks.append({"kernel": name, "shape": shape_tag, "max_abs_err": err})
        n_copies = copies_for(wp.numel())
        sets = [(x, xs, wp.clone(), ws) for _ in range(n_copies)]
        kw = {"out_dtype": bf16, "residual": res}
        lib_n = copies_for(n * k * 2, limit=32)
        wbf = unpacked_bf16(wp, ws)
        xb = (x.to(torch.float32) * xs).to(bf16)
        lib_sets = [(xb, wbf.clone()) for _ in range(lib_n)]
        nb = _nbytes(x, xs, wp, ws, res) + m * k * 2
        bms, bby = bound_ms(nb, 2 * m * n * k, "int8")
        return {"name": name, "route": "cuda",
                "source": "src/repro_torch/kernels/ternary_matmul/csrc/ternary_matmul.cu",
                "replaces": replaces,
                "shape": f"x[{m},{n}] x wp[{n // 4},{k}]" + (" +res" if residual else ""),
                "max_abs_err": err,
                "ms": time_ms(torch, lambda *a: fn(*a, **kw), sets),
                "eager_ms": eager_ms(torch, lambda *a: fn(*a, **kw), sets),
                "plain_ms": time_ms(torch, lambda *a: ref_fn(*a, **kw), sets),
                "bound_ms": bms, "bound_by": bby,
                "library_ms": time_ms(torch, torch.matmul, lib_sets)}

    gemv_rows = [
        projection_row("ternary_gemv", tm_ops.ternary_gemv, tm_ref.ternary_gemv,
                       decode_m, d, d, False, "src/repro/kernels/ternary_matmul/kernel.py:109",
                       "decode q/k/v"),
        projection_row("ternary_gemv", tm_ops.ternary_gemv, tm_ref.ternary_gemv,
                       decode_m, ff, d, True, "src/repro/kernels/ternary_matmul/kernel.py:109",
                       "decode down+res"),
    ]
    mm_rows = [
        projection_row("ternary_matmul", tm_ops.ternary_matmul, tm_ref.ternary_matmul,
                       prefill_m, d, d, False, "src/repro/kernels/ternary_matmul/kernel.py:147",
                       "prefill q/k/v"),
        projection_row("ternary_matmul", tm_ops.ternary_matmul, tm_ref.ternary_matmul,
                       prefill_m, ff, d, True, "src/repro/kernels/ternary_matmul/kernel.py:147",
                       "prefill down+res"),
    ]
    rows.append(gemv_rows[0])
    rows.append(mm_rows[0])
    report["projection_shapes"] = gemv_rows + mm_rows

    # --- SwiGLU ------------------------------------------------------------
    wg, wu = packed(d, ff), packed(d, ff)
    sg, su = torch.tensor(0.03, device=dev), torch.tensor(0.025, device=dev)
    sw_rows = []
    for tag, m in (("decode", decode_m), ("prefill", prefill_m)):
        x, xs = int8(m, d), randn(m, 1).abs() * 1e-3 + 1e-4
        got = tm_ops.ternary_swiglu(x, xs, wg, sg, wu, su, act_dtype=bf16)
        want = tm_ref.ternary_swiglu(x, xs, wg, sg, wu, su, act_dtype=bf16)
        err = quant_close(f"ternary_swiglu[{tag}]", got, want)
        checks.append({"kernel": "ternary_swiglu", "shape": tag, "max_abs_err": err})
        sets = [(x, xs, wg.clone(), sg, wu.clone(), su)
                for _ in range(copies_for(2 * wg.numel()))]
        kw = {"act_dtype": bf16}
        nb = _nbytes(x, xs, wg, wu, sg, su) + m * ff + m * 4
        bms, bby = bound_ms(nb, 4 * m * d * ff, "int8")
        sw_rows.append({"name": "ternary_swiglu", "route": "cuda",
                        "source": "src/repro_torch/kernels/ternary_matmul/csrc/ternary_swiglu.cu",
                        "replaces": "src/repro/kernels/ternary_matmul/kernel.py:177",
                        "shape": f"x[{m},{d}] x 2 wp[{d // 4},{ff}]", "max_abs_err": err,
                        "ms": time_ms(torch, lambda *a: tm_ops.ternary_swiglu(*a, **kw), sets),
                        "eager_ms": eager_ms(torch,
                                             lambda *a: tm_ops.ternary_swiglu(*a, **kw), sets),
                        "plain_ms": time_ms(torch,
                                            lambda *a: tm_ref.ternary_swiglu(*a, **kw), sets),
                        "bound_ms": bms, "bound_by": bby, "library_ms": None})
    rows.append(sw_rows[0])
    report["swiglu_shapes"] = sw_rows

    # --- decode attention: B = 4 slots at ragged frontiers, cache 164 rows -
    h, hk, hd, cache_len = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, 164
    q = randn(b, h, hd, dtype=bf16)
    k = randn(b, hk, cache_len, hd, dtype=bf16)
    v = randn(b, hk, cache_len, hd, dtype=bf16)
    pos = torch.tensor([163, 120, 100, 140], dtype=torch.int32, device=dev)
    for dtype, tol in ((bf16, ATTN_TOL_BF16), (torch.float32, ATTN_TOL_F32)):
        args = (q.to(dtype), k.to(dtype), v.to(dtype), pos)
        got = da_ops.decode_attention(*args).float()
        want = da_ref.decode_attention(*args).float()
        dt_err = (got - want).abs().max().item()
        checks.append({"kernel": "decode_attention", "shape": f"decode {str(dtype)[6:]}",
                       "max_abs_err": dt_err, "max_abs_out": want.abs().max().item(),
                       "tol": tol})
        if not torch.allclose(got, want, atol=tol, rtol=tol):
            fail(f"decode_attention[{dtype}]: max |kernel - plain| = {dt_err}, bar {tol}")
        if dtype is bf16:
            err = dt_err
    sets = [(q, k.clone(), v.clone(), pos) for _ in range(copies_for(2 * _nbytes(k)))]
    live = int((pos.to(torch.int64) + 1).sum().item()) * hk  # rows read
    nb = _nbytes(q, pos) * 2 + 2 * live * hd * 2
    bms, bby = bound_ms(nb, 4 * live * (h // hk) * hd, "bf16")
    mask = (torch.arange(cache_len, device=dev)[None, :] <= pos[:, None].to(torch.int64))
    mask = mask[:, None, None, :]
    sdpa = torch.nn.functional.scaled_dot_product_attention
    lib_sets = [(q[:, :, None], kk, vv, mask) for (_, kk, vv, _) in sets]
    rows.append({"name": "decode_attention", "route": "cuda",
                 "source": "src/repro_torch/kernels/decode_attention/csrc/decode_attention.cu",
                 "replaces": "src/repro/kernels/decode_attention/kernel.py:305",
                 "shape": f"q[{b},{h},{hd}] cache[{b},{hk},{cache_len},{hd}] bf16",
                 "max_abs_err": err,
                 "ms": time_ms(torch, da_ops.decode_attention, sets),
                 "eager_ms": eager_ms(torch, da_ops.decode_attention, sets),
                 "plain_ms": time_ms(torch, da_ref.decode_attention, sets),
                 "bound_ms": bms, "bound_by": bby,
                 "library_ms": time_ms(torch, lambda qq, kk, vv, mm: sdpa(qq, kk, vv, attn_mask=mm),
                                       lib_sets)})
    rows.append(decode_int8_row(torch, cfg, randn, int8, checks))
    pa_rows = prefill_append_rows(torch, cfg, randn, int8, checks)
    rows += [r for r in pa_rows if r["shape_tag"] == "tick"]
    report["prefill_append_shapes"] = pa_rows
    report["kernel_checks"] = checks
    emit({"phase": "kernels", "checks": checks})
    return rows


def _sdpa_masked(torch, q, k, v, mask):
    return torch.nn.functional.scaled_dot_product_attention(q, k, v, attn_mask=mask)


def decode_int8_row(torch, cfg, randn, int8, checks) -> dict:
    """Decode attention over an int8 cache at the engine's decode shape: 8
    slots against cache_len = 1024 + 256 rows, two of them diverted to the
    last row as in a fused tick."""
    from repro_torch.core.ternary import dequantize_kv
    from repro_torch.kernels.decode_attention import ops as da_ops
    from repro_torch.kernels.decode_attention import ref as da_ref

    dev = torch.device("cuda")
    b, h, hk, hd = ENGINE_SLOTS, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    m = ENGINE_MAX_LEN + 256
    q = randn(b, h, hd, dtype=torch.bfloat16)
    k, v = int8(b, hk, m, hd), int8(b, hk, m, hd)
    ks, vs = (randn(b, hk, m).abs() * 4e-3 + 1e-3 for _ in range(2))
    pos = torch.tensor([m - 1, 700, 512, 900, 300, m - 1, 1000, 100], dtype=torch.int32,
                       device=dev)
    err = None
    for dtype, tol in ((torch.bfloat16, ATTN_TOL_BF16), (torch.float32, ATTN_TOL_F32)):
        args = (q.to(dtype), k, v, pos)
        got = da_ops.decode_attention(*args, k_scale=ks, v_scale=vs).float()
        want = da_ref.decode_attention(*args, k_scale=ks, v_scale=vs).float()
        dt_err = (got - want).abs().max().item()
        checks.append({"kernel": "decode_attention_quant", "shape": f"engine decode {dtype}",
                       "max_abs_err": dt_err, "max_abs_out": want.abs().max().item(),
                       "tol": tol})
        if not torch.allclose(got, want, atol=tol, rtol=tol):
            fail(f"decode_attention_quant[{dtype}]: max |kernel - plain| = {dt_err}, bar {tol}")
        err = dt_err if err is None else err
    n = copies_for(2 * _nbytes(k))
    sets = [(q, k.clone(), v.clone(), ks.clone(), vs.clone(), pos) for _ in range(n)]
    live = int((pos.to(torch.int64) + 1).sum().item()) * hk  # rows read
    nb = 2 * _nbytes(q) + _nbytes(pos) + live * (2 * hd + 2 * 4)
    bms, bby = bound_ms(nb, 4 * live * (h // hk) * hd, "bf16")
    mask = (torch.arange(m, device=dev)[None, :] <= pos[:, None].to(torch.int64))[:, None, None]
    kd, vd = dequantize_kv(k, ks, torch.bfloat16), dequantize_kv(v, vs, torch.bfloat16)
    lib_sets = [(q[:, :, None], kd.clone(), vd.clone(), mask) for _ in range(n)]

    # the bf16 kernel at the same shape, for the cost of the dequant
    dense_ms = time_ms(torch, da_ops.decode_attention,
                       [(q, kd.clone(), vd.clone(), pos) for _ in range(n)])

    def plain_call(qq, kk, vv, kks, vvs, pp):
        return da_ref.decode_attention(qq, kk, vv, pp, k_scale=kks, v_scale=vvs)

    return {"name": "decode_attention_quant", "route": "cuda",
            "source": "src/repro_torch/kernels/decode_attention/csrc/decode_attention.cu",
            "replaces": "src/repro/kernels/decode_attention/kernel.py:324",
            "shape": f"q[{b},{h},{hd}] int8 cache[{b},{hk},{m},{hd}] + scales, "
                     f"pos {pos.tolist()}",
            "max_abs_err": err,
            "ms": time_ms(torch, da_ops.decode_attention_quant, sets),
            "eager_ms": eager_ms(torch, da_ops.decode_attention_quant, sets),
            "plain_ms": time_ms(torch, plain_call, sets),
            "bound_ms": bms, "bound_by": bby,
            "library_ms": time_ms(torch, lambda *a: _sdpa_masked(torch, *a), lib_sets),
            "library_note": "SDPA over the cache dequantized to bf16 (dequant not timed)",
            "bf16_kernel_same_shape_ms": dense_ms}


def prefill_append_rows(torch, cfg, randn, int8, checks) -> list[dict]:
    """Prefill-append, bf16 and int8 caches, at two shapes: ``tick`` (the
    engine's fused tick: 8 slots, C = 256, live slots at offsets 0 and 512,
    six write-only slots at trash_base 1024) and ``one`` (1 slot, C = 128 at
    offset 768). Outputs against the plain version in bf16 and f32; the
    cache after the call equal to the plain version's byte for byte, and
    unchanged outside the appended rows."""
    from repro_torch.core.ternary import dequantize_kv
    from repro_torch.kernels.prefill_append import ops as pa_ops
    from repro_torch.kernels.prefill_append import ref as pa_ref

    dev = torch.device("cuda")
    h, hk, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    m = ENGINE_MAX_LEN + 256
    limit = ENGINE_MAX_LEN  # the engine's trash_base
    shapes = {"tick": (256, [0, 512] + [limit] * 6), "one": (128, [768])}
    out_rows = []
    for tag, (c, offs) in shapes.items():
        b = len(offs)
        off = torch.tensor(offs, dtype=torch.int32, device=dev)
        q = randn(b, h, c, hd)
        kn, vn = randn(b, hk, c, hd), randn(b, hk, c, hd) * 0.25
        dense = [randn(b, hk, m, hd), randn(b, hk, m, hd) * 0.25]
        quant = [int8(b, hk, m, hd), int8(b, hk, m, hd),
                 randn(b, hk, m).abs() * 4e-3 + 1e-3, randn(b, hk, m).abs() * 1e-3 + 2e-4]
        written = torch.zeros((b, hk, m), dtype=torch.bool, device=dev)
        for i, o in enumerate(offs):
            written[i, :, o:o + c] = True
        live = [i for i, o in enumerate(offs) if o < limit]  # the others only write
        live_rows = sum(offs[i] for i in live)  # prefix rows read, per kv head
        pairs = sum(offs[i] * c for i in live) + len(live) * c * (c + 1) // 2
        for name, is_quant in (("prefill_append", False), ("prefill_append_quant", True)):
            err = None
            for dtype, tol in ((torch.bfloat16, ATTN_TOL_BF16), (torch.float32, ATTN_TOL_F32)):
                cast = [t.to(dtype) for t in (q, kn, vn)]
                base = quant if is_quant else [t.to(dtype) for t in dense]
                mine, plain = [t.clone() for t in base], [t.clone() for t in base]

                def call(fn, cs, cast=cast, is_quant=is_quant):
                    kw = dict(k_scale=cs[2], v_scale=cs[3]) if is_quant else {}
                    return fn(*cast, cs[0], cs[1], off, prefix_limit=limit, **kw)

                got = call(pa_ops.prefill_append, mine).float()
                want = call(pa_ref.prefill_append, plain).float()
                torch.cuda.synchronize()
                dt_err = (got - want).abs().max().item()
                same = all(torch.equal(a, w) for a, w in zip(mine, plain))
                kept = all(torch.equal(a[~written], t[~written]) for a, t in zip(mine, base))
                checks.append({"kernel": name, "shape": f"{tag} {dtype}", "max_abs_err": dt_err,
                               "max_abs_out": want.abs().max().item(), "tol": tol,
                               "cache_equal": same, "other_rows_unchanged": kept})
                if not torch.allclose(got, want, atol=tol, rtol=tol):
                    fail(f"{name}[{tag}, {dtype}]: max |kernel - plain| = {dt_err}, bar {tol}")
                if not (same and kept):
                    fail(f"{name}[{tag}, {dtype}]: cache equal to plain {same}, "
                         f"rows outside the append unchanged {kept}")
                err = dt_err if err is None else err
            bf16 = torch.bfloat16
            qb, knb, vnb = q.to(bf16), kn.to(bf16), vn.to(bf16)  # the engine's dtype
            base = quant if is_quant else [t.to(bf16) for t in dense]
            n = copies_for(_nbytes(*base))
            sets = [(qb, knb, vnb, *[t.clone() for t in base]) for _ in range(n)]

            def kern(qq, kk, vv, *cs, is_quant=is_quant):
                kw = dict(k_scale=cs[2], v_scale=cs[3]) if is_quant else {}
                return pa_ops.prefill_append(qq, kk, vv, cs[0], cs[1], off,
                                             prefix_limit=limit, **kw)

            def plain_fn(qq, kk, vv, *cs, is_quant=is_quant):
                kw = dict(k_scale=cs[2], v_scale=cs[3]) if is_quant else {}
                return pa_ref.prefill_append(qq, kk, vv, cs[0], cs[1], off,
                                             prefix_limit=limit, **kw)

            # bytes: the live slots' q, every slot's out, k_new and v_new
            # once each; the live prefix rows read and the chunk rows written
            # (K and V, + int8 scales)
            row_b = 2 * hd * (1 if is_quant else 2) + (2 * 4 if is_quant else 0)
            nb = (_nbytes(qb) * len(live) // b + _nbytes(qb) + 2 * _nbytes(knb)
                  + live_rows * hk * row_b + b * c * hk * row_b + _nbytes(off))
            bms, bby = bound_ms(nb, 4 * hd * h * pairs, "bf16")
            # the library call: SDPA for the live slots over their cache rows
            # up to the last chunk row, with the offset-causal mask
            end = max(offs[i] for i in live) + c
            kpos = torch.arange(end, device=dev)[None, None, :]
            qpos = off[live, None, None].to(torch.int64) + torch.arange(c, device=dev)[None, :, None]
            mask = kpos <= qpos
            if is_quant:
                kd, vd = (dequantize_kv(base[0], base[2], bf16),
                          dequantize_kv(base[1], base[3], bf16))
            else:
                kd, vd = base[0].clone(), base[1].clone()
            for i, o in enumerate(offs):  # the chunk's rows, as appended
                kd[i, :, o:o + c], vd[i, :, o:o + c] = knb[i], vnb[i]
            lib_sets = [(qb[live].contiguous(), kd[live, :, :end].contiguous(),
                         vd[live, :, :end].contiguous(), mask[:, None])]
            out_rows.append({
                "name": name, "route": "cuda", "shape_tag": tag,
                "source": "src/repro_torch/kernels/prefill_append/csrc/prefill_append.cu",
                "replaces": ("src/repro/kernels/prefill_append/kernel.py:556" if is_quant
                             else "src/repro/kernels/prefill_append/kernel.py:532"),
                "shape": (f"q[{b},{h},{c},{hd}] offsets {offs} prefix_limit {limit} cache "
                          f"[{b},{hk},{m},{hd}] " + ("int8 + scales" if is_quant else "bf16")),
                "max_abs_err": err,
                "ms": time_ms(torch, kern, sets, iters=20),
                "eager_ms": eager_ms(torch, kern, sets, iters=20),
                "plain_ms": time_ms(torch, plain_fn, sets, iters=5),
                "bound_ms": bms, "bound_by": bby,
                "library_ms": time_ms(torch, lambda *a: _sdpa_masked(torch, *a), lib_sets,
                                      iters=20),
                "library_note": "SDPA of the live slots with the offset-causal mask over "
                                "their bf16 cache rows up to the chunk's end"
                                + (", dequantized" if is_quant else "")
                                + "; the append and the dequant are not timed"})
    return out_rows


# ---------------------------------------------------------------------------
# phase: smoke (small input, card vs CPU reference)
# ---------------------------------------------------------------------------


def smoke_phase(torch, report: dict) -> None:
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.core import params as PR
    from repro_torch.kernels import KERNELS, PLAIN
    from repro_torch.models import transformer as Tr
    from repro_torch.serving import engine as E

    cfg = dataclasses.replace(get_config("tellme-0.7b", smoke=True), dtype=torch.float32)
    specs = Tr.param_specs(cfg)
    cpu_params = Tr.pack_tree(PR.init_params(specs, seed=0, device="cpu"), specs,
                              dtype=cfg.dtype)

    def to_cuda(node):
        return ({k: to_cuda(v) for k, v in node.items()} if isinstance(node, dict)
                else node.to("cuda"))

    cuda_params = to_cuda(cpu_params)
    gen = torch.Generator().manual_seed(7)
    prompts = torch.randint(0, cfg.vocab_size, (3, 13), generator=gen)
    on_card = E.generate(cuda_params, cfg, prompts, steps=12, kernels=KERNELS)
    on_cpu = E.generate(cpu_params, cfg, prompts, steps=12, kernels=PLAIN, device="cpu")
    err = (on_card.prefill_logits.cpu() - on_cpu.prefill_logits).abs().max().item()
    same = torch.equal(on_card.tokens, on_cpu.tokens)
    out = {"phase": "smoke", "streams_equal": same, "prefill_logit_max_abs_err": err}
    report["smoke"] = out
    emit(out)
    if not same or not err <= SMOKE_LOGIT_TOL:
        fail(f"smoke config: card vs CPU streams equal={same}, logit err {err}")


# ---------------------------------------------------------------------------
# phase: generate (full width)
# ---------------------------------------------------------------------------


def layer_drift(torch, params, cfg, tokens) -> list[dict]:
    """Per layer of the full-width prefill: int8 codes of the first
    norm-quant that differ between kernel and plain version on the same
    input, the block's output difference on the same input, and the
    difference of the two runs' own residual streams (relative to max |x|)."""
    from repro_torch.kernels import KERNELS, PLAIN
    from repro_torch.models import layers as L
    from repro_torch.models import transformer as Tr

    b, s = tokens.shape
    x_k = L.embed(params["embed"], tokens, dtype=cfg.dtype)
    x_p = x_k.clone()
    pos = torch.arange(s, dtype=torch.int32, device=tokens.device)[None].expand(b, s)
    rope = Tr.rope_for(cfg, pos)["attn"]
    out = []
    with torch.inference_mode():
        for li in range(cfg.n_layers):
            bp = Tr.layer_slice(params["blocks"]["b0"], li)
            qk = KERNELS.norm_quant(x_p, bp["ln1"]["gamma"], eps=cfg.norm_eps)[0]
            qp = PLAIN.norm_quant(x_p, bp["ln1"]["gamma"], eps=cfg.norm_eps)[0]
            same_k, _ = Tr.apply_block(bp, x_p, cfg, rope, kernels=KERNELS)
            x_k, _ = Tr.apply_block(bp, x_k, cfg, rope, kernels=KERNELS)
            x_p, _ = Tr.apply_block(bp, x_p, cfg, rope, kernels=PLAIN)
            scale = x_p.float().abs().max().item()
            out.append({
                "layer": li, "prologue_codes_differing": int((qk != qp).sum().item()),
                "same_input_rel": (same_k.float() - x_p.float()).abs().max().item() / scale,
                "trajectory_rel": (x_k.float() - x_p.float()).abs().max().item() / scale})
    return out


def profile_decode(torch, params, cfg, caches, tok, pos) -> dict:
    """torch.profiler over three decode steps: device time by kernel (kernel
    events only; an op's own entry repeats its kernels' time), the device's
    busy share of the wall time, and the host ops that take the most time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.kernels import KERNELS
    from repro_torch.models import transformer as Tr

    steps = 3
    with torch.inference_mode():
        for _ in range(2):
            Tr.decode_step(params, tok, caches, pos, cfg, kernels=KERNELS)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t = time.perf_counter()
            for _ in range(steps):
                Tr.decode_step(params, tok, caches, pos, cfg, kernels=KERNELS)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t) * 1e3
    events = prof.key_averages()
    kernels = sorted(((e.self_device_time_total, e.key, e.count) for e in events
                      if e.device_type == DeviceType.CUDA), reverse=True)
    host = sorted(((e.self_cpu_time_total, e.key, e.count) for e in events
                   if e.device_type == DeviceType.CPU), reverse=True)
    device_ms = sum(k[0] for k in kernels) / 1e3

    def table(rows):
        return [{"name": k[:90], "ms_per_step": us / 1e3 / steps, "calls_per_step": c / steps}
                for us, k, c in rows[:12]]

    return {"steps": steps, "wall_ms_per_step": wall_ms / steps,
            "device_ms_per_step": device_ms / steps,
            "device_busy_share": device_ms / wall_ms,
            "kernel_launches_per_step": sum(k[2] for k in kernels) / steps,
            "top_device": table(kernels), "top_host": table(host)}


def full_params(torch, cfg):
    """Full-width packed weights, random from seed 0, on the card."""
    from repro_torch.core import params as PR
    from repro_torch.models import transformer as Tr

    specs = Tr.param_specs(cfg)
    params = Tr.pack_tree(PR.init_params(specs, seed=0, device=torch.device("cuda")), specs,
                          dtype=cfg.dtype)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    return params


def generate_phase(torch, cfg, params, steps: int, report: dict) -> dict:
    from repro_torch import kernels as K
    from repro_torch.models import transformer as Tr
    from repro_torch.serving import engine as E

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    b, s = 4, 100
    prompts = torch.randint(0, cfg.vocab_size, (b, s), generator=gen, device=dev)

    def run(kset):
        # prefill alone, for its time; then the whole generate
        with torch.inference_mode():
            E.prefill_bucketed(params, cfg, prompts, kernels=kset)  # warm-up
            torch.cuda.synchronize()
            t = time.perf_counter()
            E.prefill_bucketed(params, cfg, prompts, kernels=kset)
            torch.cuda.synchronize()
        prefill_ms = (time.perf_counter() - t) * 1e3
        torch.cuda.reset_peak_memory_stats()
        if kset is K.KERNELS:
            K.reset_launch_counts()
        torch.cuda.synchronize()
        t = time.perf_counter()
        res = E.generate(params, cfg, prompts, steps=steps, kernels=kset)
        torch.cuda.synchronize()
        total_ms = (time.perf_counter() - t) * 1e3
        counts = K.launch_counts() if kset is K.KERNELS else None
        decode_ms = (total_ms - prefill_ms) / (steps - 1)
        return res, counts, {"prefill_ms": prefill_ms, "generate_ms": total_ms,
                             "decode_ms_per_step": decode_ms,
                             "decode_tokens_per_s": b * 1e3 / decode_ms,
                             "max_memory_allocated": torch.cuda.max_memory_allocated()}

    res_k, counts, times_k = run(K.KERNELS)
    res_p, _, times_p = run(K.PLAIN)
    toks_k, toks_p = res_k.tokens, res_p.tokens
    if tuple(toks_k.shape) != (b, steps) or not torch.isfinite(res_k.prefill_logits).all():
        fail("generate: wrong token shape or non-finite logits")
    diff = (toks_k != toks_p).any(dim=0).nonzero()
    first_div = int(diff[0].item()) if len(diff) else None
    lk, lp = res_k.prefill_logits.float(), res_p.prefill_logits.float()
    logit_err = (lk - lp).abs().max().item()
    logit_scale = lp.abs().max().item()

    # decode steps from shared caches, kernels vs plain versions: each step
    # starts both from the plain run's caches, and the plain argmax is fed on
    with torch.inference_mode():
        _, caches = E.prefill_bucketed(params, cfg, prompts, kernels=K.PLAIN)
        caches = E.fit_caches(caches, cfg, s + steps)
        tok = toks_p[:, :1].to(dev).long()
        pos = torch.full((b,), s, dtype=torch.int32, device=dev)
        step_checks = []
        for _ in range(DECODE_CHECK_STEPS):
            copy = {"blocks": {n: {k: v.clone() for k, v in c.items()}
                               for n, c in caches["blocks"].items()}}
            dk, _ = Tr.decode_step(params, tok, copy, pos, cfg, kernels=K.KERNELS)
            dp, _ = Tr.decode_step(params, tok, caches, pos, cfg, kernels=K.PLAIN)
            top2 = dp.topk(2, dim=-1).values
            step_checks.append({
                "logit_max_abs_err": (dk - dp).abs().max().item(),
                "logit_max_abs": dp.abs().max().item(),
                "argmax_equal": bool(torch.equal(dk.argmax(-1), dp.argmax(-1))),
                "min_top2_gap": (top2[:, 0] - top2[:, 1]).min().item()})
            tok = dp.argmax(-1, keepdim=True)
            pos = pos + 1
    padded = torch.nn.functional.pad(prompts, (0, E.bucket_length(s, cfg.prefill_chunk_sizes) - s))
    out = {"phase": "generate", "model": cfg.name, "batch": b, "prompt": s,
           "bucket": E.bucket_length(s, cfg.prefill_chunk_sizes), "steps": steps,
           "kernels": times_k, "plain": times_p,
           "launch_counts": counts,
           "first_tokens_equal": bool(torch.equal(toks_k[:, 0], toks_p[:, 0])),
           "first_divergence_step": first_div,
           "stream_agreement": (toks_k == toks_p).float().mean().item(),
           "prefill_logit_max_abs_err": logit_err, "prefill_logit_max_abs": logit_scale,
           "decode_step_checks": step_checks,
           "layer_drift": layer_drift(torch, params, cfg, padded)}
    out["decode_profile"] = profile_decode(torch, params, cfg, caches, tok, pos)
    report["generate"] = out
    emit(out)
    if not out["first_tokens_equal"]:
        fail("generate: first tokens differ between kernels and plain versions")
    if logit_err > LOGIT_REL_TOL * logit_scale:
        fail(f"generate: prefill logits differ by {logit_err} (max |logit| {logit_scale})")
    for i, c in enumerate(step_checks):
        if c["logit_max_abs_err"] > LOGIT_REL_TOL * c["logit_max_abs"]:
            fail(f"generate: decode step {i} logits differ by {c['logit_max_abs_err']} "
                 f"(max |logit| {c['logit_max_abs']})")
    if not step_checks[0]["argmax_equal"]:
        fail("generate: first decode step from shared caches picks other tokens")
    missing = [n for n in GENERATE_PATH if counts[n] <= 0]
    if missing:
        fail(f"generate: kernels never launched on the main path: {missing}")
    return counts


# ---------------------------------------------------------------------------
# phases: the ServingEngine
# ---------------------------------------------------------------------------


def _to_cuda(node):
    return ({k: _to_cuda(v) for k, v in node.items()} if isinstance(node, dict)
            else node.to("cuda"))


def engine_smoke_phase(torch, report: dict) -> None:
    """The f32 smoke config in the ServingEngine, each cache dtype: through
    the kernels on the card, the same streams and statuses as through the
    plain versions on the CPU."""
    import dataclasses

    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.core import params as PR
    from repro_torch.kernels import KERNELS, PLAIN
    from repro_torch.models import transformer as Tr
    from repro_torch.serving import engine as E

    base = dataclasses.replace(get_config("tellme-0.7b", smoke=True), dtype=torch.float32)
    specs = Tr.param_specs(base)
    cpu_params = Tr.pack_tree(PR.init_params(specs, seed=0, device="cpu"), specs,
                              dtype=base.dtype)
    cuda_params = _to_cuda(cpu_params)
    rng = np.random.default_rng(7)
    prompts = [rng.integers(0, base.vocab_size, n) for n in (9, 30, 70, 130, 200)]
    out = {"phase": "engine_smoke"}
    for kv in ("bf16", "int8"):
        cfg = dataclasses.replace(base, kv_cache_dtype=kv)
        runs = []
        for params, kset, device in ((cuda_params, KERNELS, None), (cpu_params, PLAIN, "cpu")):
            eng = E.ServingEngine(params, cfg, slots=2, max_len=256, kernels=kset,
                                  device=device)
            reqs = [E.Request(rid=i, prompt=p, max_new=8) for i, p in enumerate(prompts)]
            for r in reqs:
                eng.submit(r)
            eng.run()
            runs.append(([(r.generated, r.status.name) for r in reqs], eng.stats()))
        (got, st), (want, _) = runs
        out[kv] = {"streams_equal": got == want, "ticks": st["ticks"],
                   "host_transfers": st["host_transfers"]}
        if got != want or st["host_transfers"] != st["ticks"]:
            emit(out)
            fail(f"engine_smoke[{kv}]: card vs CPU streams equal {got == want}, "
                 f"transfers {st['host_transfers']} for {st['ticks']} ticks")
    report["engine_smoke"] = out
    emit(out)


def _engine_prompts(cfg):
    import numpy as np

    rng = np.random.default_rng(0)
    lo, hi = ENGINE_PROMPT_RANGE
    lengths = rng.integers(lo, hi + 1, ENGINE_REQUESTS)
    return [rng.integers(0, cfg.vocab_size, int(n)) for n in lengths]


def engine_run(torch, cfg, params, kset, prompts) -> tuple[dict, list]:
    """Serve ``prompts`` to the end; returns (measurements, requests). The
    launch counters are reset just before the first tick and read just
    after the last."""
    from repro_torch import kernels as K
    from repro_torch.serving import engine as E

    eng = E.ServingEngine(params, cfg, slots=ENGINE_SLOTS, max_len=ENGINE_MAX_LEN,
                          kernels=kset, eos_id=-1)
    reqs = [E.Request(rid=i, prompt=p, max_new=ENGINE_NEW) for i, p in enumerate(prompts)]
    first = {}
    eng.on_emit = lambda req, toks: first.setdefault(
        req.rid, (eng.tick_count, time.perf_counter()))
    for r in reqs:
        eng.submit(r)
    torch.cuda.synchronize()
    K.reset_launch_counts()
    fused_ms, decode_ms = [], []
    t0 = time.perf_counter()
    while eng.queue or any(r is not None for r in eng.live):
        f0, t = eng.fused_ticks, time.perf_counter()
        if not eng.step():
            break
        (fused_ms if eng.fused_ticks > f0 else decode_ms).append(
            (time.perf_counter() - t) * 1e3)
    wall = time.perf_counter() - t0
    counts = K.launch_counts()
    st = eng.stats()
    tokens = sum(len(r.generated) for r in reqs)

    def mean(xs):
        return sum(xs) / len(xs) if xs else None

    return {"ticks": st["ticks"], "fused_ticks": st["fused_ticks"],
            "host_transfers": st["host_transfers"], "statuses": st["statuses"],
            "wall_s": wall, "tokens": tokens, "tokens_per_s": tokens / wall,
            "fused_tick_ms_mean": mean(fused_ms), "decode_tick_ms_mean": mean(decode_ms),
            "fused_tick_ms": fused_ms, "decode_tick_ms": decode_ms,
            "first_token_ticks": [first[r.rid][0] for r in reqs if r.rid in first],
            "first_token_ms": [(first[r.rid][1] - t0) * 1e3 for r in reqs if r.rid in first],
            "cache_bytes": E.cache_nbytes(eng.caches), "launch_counts": counts}, reqs


def engine_phase(torch, cfg, params, report: dict) -> dict:
    """The full-width ServingEngine for each cache dtype, through the kernels
    and through the plain versions; returns the kernels' launch counts of
    each run by cache dtype."""
    import dataclasses

    from repro_torch import kernels as K

    prompts = _engine_prompts(cfg)
    out = {"phase": "engine", "model": cfg.name, "slots": ENGINE_SLOTS,
           "max_len": ENGINE_MAX_LEN, "requests": ENGINE_REQUESTS, "max_new": ENGINE_NEW,
           "prompt_lengths": [len(p) for p in prompts]}
    counts_by_kv = {}
    with torch.inference_mode():
        for kv in ("bf16", "int8"):
            c = dataclasses.replace(cfg, kv_cache_dtype=kv)
            got, reqs = engine_run(torch, c, params, K.KERNELS, prompts)
            plain, preqs = engine_run(torch, c, params, K.PLAIN, prompts)
            agree = [sum(a == b for a, b in zip(r.generated, p.generated)) / ENGINE_NEW
                     for r, p in zip(reqs, preqs)]
            got["plain"] = {k: plain[k] for k in ("wall_s", "tokens_per_s",
                                                   "fused_tick_ms_mean", "decode_tick_ms_mean")}
            got["token_agreement_with_plain"] = sum(agree) / len(agree)
            got["streams_equal_to_plain"] = sum(a == 1.0 for a in agree)
            out[kv] = got
            counts_by_kv[kv] = got["launch_counts"]
            sfx = "_quant" if kv == "int8" else ""
            bad = [r.rid for r in reqs
                   if r.status.name != "OK" or len(r.generated) != ENGINE_NEW]
            counts = got["launch_counts"]
            path = ("norm_quant", "ternary_gemv", "ternary_matmul", "ternary_swiglu",
                    "decode_attention" + sfx, "prefill_append" + sfx)
            problems = []
            if bad:
                problems.append(f"requests not OK with {ENGINE_NEW} tokens: {bad}")
            if got["host_transfers"] != got["ticks"]:
                problems.append(f"{got['host_transfers']} transfers for {got['ticks']} ticks")
            if counts["decode_attention" + sfx] != cfg.n_layers * got["ticks"]:
                problems.append(f"decode_attention{sfx} launched {counts['decode_attention' + sfx]}"
                                f" times in {got['ticks']} ticks")
            if counts["prefill_append" + sfx] != cfg.n_layers * got["fused_ticks"]:
                problems.append(f"prefill_append{sfx} launched {counts['prefill_append' + sfx]}"
                                f" times in {got['fused_ticks']} fused ticks")
            missing = [n for n in path if counts[n] <= 0]
            if missing:
                problems.append(f"kernels never launched on the engine path: {missing}")
            if problems:
                emit(out)
                fail(f"engine[{kv}]: " + "; ".join(problems))
    report["engine"] = out
    emit(out)
    return counts_by_kv


def chunk_step_phase(torch, cfg, params, report: dict) -> None:
    """One full-width prefill_chunk_step per cache dtype from shared caches:
    4 slots, chunk 128 at offset 256 after a 256-chunk written by the plain
    versions; last-row logits of kernels vs plain versions."""
    import dataclasses

    from repro_torch.kernels import KERNELS, PLAIN
    from repro_torch.models import transformer as Tr
    from repro_torch.serving import engine as E

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(3)
    b = 4
    t1 = torch.randint(0, cfg.vocab_size, (b, 256), generator=gen, device=dev)
    t2 = torch.randint(0, cfg.vocab_size, (b, 128), generator=gen, device=dev)
    out = {"phase": "chunk_step"}
    with torch.inference_mode():
        for kv in ("bf16", "int8"):
            c = dataclasses.replace(cfg, kv_cache_dtype=kv)
            caches = E.init_caches(c, b, 512)
            Tr.prefill_chunk_step(params, t1, caches, torch.zeros(b, dtype=torch.int32,
                                                                  device=dev), c, kernels=PLAIN)
            copy = {"blocks": {n: {k: v.clone() for k, v in leaves.items()}
                               for n, leaves in caches["blocks"].items()}}
            off = torch.full((b,), 256, dtype=torch.int32, device=dev)
            last = torch.full((b,), 127, dtype=torch.int32, device=dev)
            lk, _ = Tr.prefill_chunk_step(params, t2, copy, off, c, kernels=KERNELS,
                                          last_row=last)
            lp, _ = Tr.prefill_chunk_step(params, t2, caches, off, c, kernels=PLAIN,
                                          last_row=last)
            top2 = lp.topk(2, dim=-1).values
            # the kernels' argmax must be a plain argmax: the bf16 LM head
            # ties logits exactly, and then either tied token is the argmax
            picked = lp.gather(1, lk.argmax(-1, keepdim=True))[:, 0]
            res = {"logit_max_abs_err": (lk - lp).abs().max().item(),
                   "logit_max_abs": lp.abs().max().item(),
                   "argmax_equal": bool(torch.equal(lk.argmax(-1), lp.argmax(-1))),
                   "argmax_is_plain_argmax": bool(torch.equal(picked, top2[:, 0])),
                   "min_top2_gap": (top2[:, 0] - top2[:, 1]).min().item()}
            out[kv] = res
            if (res["logit_max_abs_err"] > LOGIT_REL_TOL * res["logit_max_abs"]
                    or not res["argmax_is_plain_argmax"]):
                emit(out)
                fail(f"chunk_step[{kv}]: logits differ by {res['logit_max_abs_err']} "
                     f"(max |logit| {res['logit_max_abs']}), kernels' argmax a plain "
                     f"argmax {res['argmax_is_plain_argmax']}")
    report["chunk_step"] = out
    emit(out)


# ---------------------------------------------------------------------------


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=None, help="also write the full report as JSON here")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this check runs only on the card",
              file=sys.stderr)
        return 1
    src = os.path.join(ROOT, "src")
    if src not in sys.path:
        sys.path.insert(0, src)
    from repro_torch.configs import get_config
    from repro_torch.kernels import _build

    report: dict = {"torch": torch.__version__, "cuda": torch.version.cuda,
                    "tf32_matmul": torch.backends.cuda.matmul.allow_tf32}
    smi = nvidia_smi_line()
    report["nvidia_smi"] = smi
    emit({"phase": "device", "nvidia_smi": smi})
    t0 = time.perf_counter()
    lib_path = _build.build()
    _build.library()
    build = {"phase": "build", "seconds": time.perf_counter() - t0, "library": str(lib_path)}
    report["build"] = build
    report["build_log"] = (lib_path.parent / "build.log").read_text()
    emit(build)

    cfg = get_config("tellme-0.7b")
    rows = kernel_phase(torch, cfg, report)
    smoke_phase(torch, report)
    engine_smoke_phase(torch, report)
    params = full_params(torch, cfg)
    gen_counts = generate_phase(torch, cfg, params, STEPS, report)
    eng_counts = engine_phase(torch, cfg, params, report)
    chunk_step_phase(torch, cfg, params, report)
    for row in rows:  # launches on the main path that runs each kernel
        name = row["name"]
        if name.endswith("_quant"):
            row["launches"] = eng_counts["int8"][name]
        elif name == "prefill_append":
            row["launches"] = eng_counts["bf16"][name]
        else:
            row["launches"] = gen_counts[name]
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err", "ms",
            "plain_ms", "bound_ms", "bound_by", "library_ms", "shape", "eager_ms")
    kernels_line = {"kernels": [{k: r[k] for k in keys} for r in rows]}
    report["kernels"] = kernels_line["kernels"]
    report["kernel_rows"] = rows  # with each row's notes
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(report, f, indent=1)
    emit(kernels_line)
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
