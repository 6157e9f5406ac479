"""On-card check of the PyTorch/CUDA port: builds the CUDA kernels, holds
each against its plain PyTorch version at the real shapes of the path that
runs it, times them, then drives greedy ``generate``, the one-shot prefill,
and the continuous-batching ``ServingEngine`` for tellme-0.7b at full
width, on the contiguous and on the paged KV layout, with the packed matmul
engine and with the table-lookup one, with chunked and with per-request
prefill, with speculative decoding, under injected faults, in a replica
pool and behind the HTTP/SSE front door; then RWKV-6 3B (rwkv6-3b, the ssm
family) at full width and depth through ``generate``, the one-shot prefill
and the per-request engine.

    python3 chip_smoke.py                # one CUDA device
    python3 chip_smoke.py --out report.json   # also the full report as JSON

Phases (each prints one JSON line; any failed bar exits non-zero):
  build     nvcc builds the eight kernel sources (timed); the line carries
            ptxas's registers, static shared memory and spills of the three
            tensor-core kernels (flash attention and prefill-append in bf16,
            the packed matmul), of the packed GEMV and of the three WKV
            kernels (chunk states, state scan, outputs).
  kernels   the eighteen kernel entry points vs their plain versions: the
            generate path's at the decode (B = 4) and prefill (B*bucket =
            512 rows) shapes (norm_quant also at the 4096-token prefill's
            rows and rwkv6-3b's d_model, the GEMV and its library call also
            at the engine's 8 slots); decode attention, bf16 and int8 cache, at
            the engine's decode shape (8 slots, cache 1280 rows);
            prefill-append, bf16 and int8 cache, at the engine's tick
            shape (8 slots, C = 256, live slots
            at offsets 0 and 512, six write-only slots) and at one slot with
            C = 128 at offset 768; the four paged variants at the same
            shapes over a pool of 161 pages of 64 rows, on a permuted table
            with shared pages and NaN in the garbage and unmapped pages
            (output finite and bit-equal to the contiguous kernel on the
            gathered view; pools byte-equal to the plain version's); the
            four prefill-append variants also at the speculative verify
            shape (8 slots, C = 5 at frontiers 163, 700, 517, 900, 301,
            1000, 99 and 62, the last straddling a page) and at G = 4
            (q[2,8,5,64], bf16 and f32). Kernel,
            plain, contiguous-twin, library and bound times, and the kernel's
            over the library's (over_library), every shape of these eight
            entry points in one attention_rows line. The four
            table-lookup entry points at the shapes of the packed ones
            (decode q/k/v [4,1536]x[1536,1536] and down [4,4096]x[4096,1536],
            prefill [512,1536] from tables and from int8 and down+res, SwiGLU
            [4,1536] and [512,1536] from tables, held also at 2048 rows, the
            prologue with tables at 4 and 512 rows): exact against the plain versions (SwiGLU and
            the prologue's codes within the SwiGLU and norm-quant bars), bit
            for bit against their packed twins (the prologue: norm_quant's
            codes and scale, tables build_tables of them), timed beside them.
            Flash attention (the one-shot prefill) at generate's bucket
            q[4,16,128,96], at 1024 and 4096 tokens in bf16, at 4096 in f32
            and with GQA in f32 at a ragged S (q[1,8,200,64], k/v 2 heads):
            kernel, plain, bound and SDPA times (and the kernel's over
            SDPA's, over_library), and at 4096 the dense schedule
            (causal_skip=False, bit-equal) beside the causal skip. The tiled
            matmul also at the chunk step's 2048 rows (8 slots x 256), each
            projection row with its time over torch.matmul's. The SwiGLU at
            4, 512, 2048 (the chunk step) and 4096 rows (the long
            prefill's bucket), within its bar, timed beside twin_ms, two
            ternary_matmul calls of the same shapes; with the projections'
            shapes and each shape's launches in the ternary_rows line.
            WKV (rwkv6-3b's prefill recurrence) at generate's exact-length
            prefill [4,40,100,64], at 1000, 875 (the rwkv engine's longest
            admission) and 4000 tokens with bf16 r/k/v, at 4000 all f32,
            and at the smoke config's n = 16 with S = 77; log-decays across
            the clip range [-10, -1e-4], half the channels slow; y and the
            final state within 1e-4 of each head's scale, a second call bit
            for bit equal to the first, and each head of a B > 1 call bit
            for bit equal to its inputs run alone; kernel, plain and bound
            times (no library call computes WKV). The GEMV and the tiled matmul also at rwkv6-3b's
            projections (d -> d, d -> d_ff, d_ff -> d at M = 4, 400 and
            4000), bit for bit, their launches from the rwkv generate run
            (printed as the rwkv_projections line).
  smoke     the smoke config in f32 on the card (kernels) against the same
            weights on the CPU (plain versions): equal greedy streams.
  engine_smoke  the same for the ServingEngine, both cache dtypes: equal
            per-request streams and statuses.
  paged_engine_smoke  the same for the paged engine, a shared prompt prefix
            included: equal streams, statuses and page statistics.
  spec_engine_smoke  the same for ServingEngine(speculative=True), each
            cache dtype and layout, with a tiled phrase among the prompts:
            equal streams, statuses and per-request drafted and accepted
            counts; streams equal to the engine without speculation; the
            tiled phrase accepted above 0.2; the verify's launches.
  fault_engine_smoke  the smoke engine under a FaultPlan (NaN on one slot,
            cache_growth on the other, a raising tick, a 0.05 s slow tick),
            each cache dtype, plain and speculative with garbage drafts on
            every tick: card (kernels) vs CPU (plain versions), equal
            streams, statuses, details and event kinds (straggler events
            dropped); step() never raised; every fault left its event.
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
  paged_engine  the full-width engine with kv_layout="paged" (pool of 161
            pages of 64 rows), through the kernels, each cache dtype:
            (a) the engine phase's workload: every request OK, streams equal
            to the engine phase's contiguous kernel streams (16 of 16), one
            host transfer per tick, 24 paged attention launches per tick
            that runs them (counters reset just before, read just after),
            the pool's bytes, and the contiguous engine run again right
            after for its tick times; (b) 16 requests sharing a 576-token prefix,
            the first served alone: 15 prefix hits of 512 tokens, at least
            15 copy-on-write forks, streams against the contiguous engine on
            the same requests, tokens/s of both.
  tl        matmul_engine="tl" at full width (w_idx made once on the card):
            generate, the engine phase's workload (contiguous, bf16 cache)
            and the shared-prefix workload (paged, bf16 cache), through the
            kernels; every stream equal to the packed kernels' stream of the
            same workload above (16 of 16), TL kernels launched and the packed
            projections and the plain prologue not (counters reset just
            before each run, read just after); decode ms per step, tokens/s
            and tick times beside the packed runs'. Then the f32 smoke
            config with an int8 cache, each layout, TL against packed.
  prefill   prefill_bucketed at full width through the kernels and through
            the plain versions: B = 4 x 100 tokens (bucket 128), 1 x 1000
            (1024) and 1 x 4000 (4096); last-token logits to the bar, ms per
            prefill of each, the peak memory it adds to what was resident,
            24 flash-attention launches per prefill (counters reset just
            before, read just after); torch.profiler over the 1 x 4000
            prefill (device time by kernel, busy share).
  legacy_engine  the engine phase's workload with prefill="legacy" (each
            request prefilled whole at admission), each cache dtype,
            through the kernels: every request OK, each stream equal to the
            port's own generate of that prompt alone (B = 1), one host
            transfer per tick, 24 flash-attention launches per request and
            no prefill-append launch (counters reset just before, read just
            after); agreement with the chunked engine's streams, and where
            one parts, the logit gap of the two tokens.
  spec_engine  full-width ServingEngine(speculative=True), gamma = 4: (a)
            the engine phase's workload, each cache dtype, contiguous and
            paged, through the kernels: every request OK with 32 tokens,
            one host transfer per tick, 24 prefill-append launches a spec
            tick (48 with a prompt chunk) and no decode attention in it,
            0 <= accepted <= drafted, paged streams equal to contiguous;
            tokens/s, ticks by kind, ms per tick, acceptance, tokens per
            spec tick, time to first token beside the engine and
            paged_engine phases' figures, agreement with their streams (a
            parting reported with its logit gap); (b) 8 phrases of 6-12
            tokens tiled to 100-400, 64 new tokens, with and without
            speculation; (c) one verify_chunk_step at the eight verify
            frontiers from shared caches: kernel logits vs plain and vs
            teacher-forced kernel decode steps within the logits bar, each
            layer's cache the plain append of the verify's K/V rows.
            Then the verify_rows line: the verify-shape rows of the kernels
            phase with their launches in the spec engine run.
  fault_engine  the engine phase's workload under faults, through the
            kernels: (a) contiguous bf16 under FAULT_PLAN: the NaN slot
            QUARANTINED (guard_flag=1), the raising tick's live requests
            (8) FAILED, every stream a prefix of the engine phase's and every OK
            one equal to it (the requests queued at the raising tick among
            them), consecutive_tick_failures back to 0, the slow tick's
            straggler event, one host transfer per tick that ran; the ms
            the containment took to rebuild the cache; (b) the same on the
            paged int8 layout, the rebuilt pool's statistics a fresh
            pool's; (c) speculative bf16 with garbage drafts on every tick:
            one spec_disabled event, every request OK with 32 tokens,
            agreement with the plain streams reported; (d) a plan that
            never fires between two runs without one: the engine phase's
            streams, the same launches, tokens/s of each.
  pool_smoke  the f32 smoke config in a ReplicaPool of two replicas (each
            warmed up by its default request) under a replica_crash on
            replica 0, on the card (kernels) and on the CPU (plain
            versions): equal streams and terminal events, every request OK,
            at least one migrated.
  pool      full-width ReplicaPool of 2 engines (8 slots, max_len 1024,
            bf16 contiguous cache) over one params tree, driven by poll()
            on this thread, on the engine phase's workload: (a) fault-free:
            every request OK, streams equal to the engine phase's, every
            path kernel launched (the threads share the counters, so > 0);
            tokens/s beside the engine phase's, straggler events, drains;
            (b) a replica_crash on replica 0 at its tick 10 (the straggler
            gate off): every request OK, at least one migrated, delivery
            exactly once (each sink's tokens its request's final stream),
            unmigrated streams equal to the engine phase's, a migrated one's
            parting reported with its logit gap; then, on a clock moved past
            a 30 s backoff, the restart from the factory and the probe bring
            replica 0 back to ready: its ms and its peak allocation beyond
            what was resident; (c) a 2.5 s replica_hang on replica 1: the
            failover on the stale heartbeat, every request OK, exactly once
            after the replica wakes; the stall-to-failover ms.
  server    a ServingServer on 127.0.0.1 over one full-width engine (the
            engine phase's), 16 concurrent SSE clients: streams equal to
            the engine phase's, time to first token p50/p99, tokens/s; again
            with the longest prompt's client leaving after its first token:
            CANCELLED, the other 15 unchanged. Then ``python -m
            repro_torch.launch.server --port 0 --replicas 2`` as a process:
            ready, four requests OK, SIGTERM, exit code 0.
  rwkv_smoke  the rwkv smoke config in f32 on the card (kernels) against
            the same weights on the CPU (plain versions), through generate
            and the engine (prefill="auto", which is legacy): equal streams
            and statuses.
  rwkv_generate  full-width rwkv6-3b (32 layers, random weights from seed
            0), B = 4, a 100-token prompt, 64 greedy steps, kernels and
            plain versions: 32 wkv launches per prefill and no attention or
            norm-quant launch (counters reset just before, read just
            after); the prefill held block by block, each block and the
            last-token logits from the same input within the logits bar
            (the random-weight model amplifies an ulp over 32 blocks, so
            the end-to-end logits and streams are reported, not held; the
            plain versions against themselves with the embedding nudged by
            one ulp are reported beside them as the witness);
            eight decode steps from shared state within the bar; ms per
            decode step against its weight-stream bound; torch.profiler's
            busy share.
  rwkv_prefill  prefill_bucketed (exact length) at 1 x 1000 and 1 x 4000,
            kernels and plain versions: ms, added peak memory, 32 wkv
            launches a prefill, the blocks and logits held as above; each
            prefill's device time by kernel and busy share (torch.profiler).
  rwkv_engine  ServingEngine(prefill="auto") on the engine phase's ragged
            workload: every request OK, one host transfer per tick, 32 wkv
            launches per admitted request; tokens/s, tick times, time to
            first token, state bytes. The workload again with every step
            held bit for bit on the same inputs: each admitted slot's state
            equal to prefill_bucketed of its prompt alone, the other slots
            untouched; each tick's logits and all eight slots' new state
            equal to decode_step from a copy taken just before. Each stream
            beside generate of that prompt alone, a parting reported with
            the gap of its two tokens in the engine's own logits; the first
            two requests through a one-slot engine, streams equal to
            generate's; one decode step batched against one by one.
Then the ``kernels`` line, the card's name and power limit, and the last
line ``{"ok": true, "device": {...}}``. Without CUDA it exits non-zero and
prints no result.
"""

from __future__ import annotations

import argparse
import gc
import json
import math
import os
import re
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
FLASH_TOL_BF16 = 2e-2  # of |want| + the RMS of want's row (flash_attention_rows)
LOGIT_REL_TOL = 5e-2  # full-width prefill and decode-step logits, relative to max |logit|
SMOKE_LOGIT_TOL = 1e-3  # f32 smoke prefill logits, card vs CPU
WKV_TOL = 1e-4  # wkv's y and state, f32, of each head's max |plain| (wkv_rows)

STEPS = 64  # greedy steps of the full-width run
DECODE_CHECK_STEPS = 8  # decode steps held against the plain versions from shared caches

# The kernels that generate runs (bf16 cache)
GENERATE_PATH = ("norm_quant", "ternary_gemv", "ternary_matmul", "ternary_swiglu",
                 "decode_attention", "flash_attention")
# Under matmul_engine="tl" these take the place of the packed projections
# and of the plain prologue, which must then not launch
TL_PATH = ("norm_quant_tables", "tl_matmul", "tl_swiglu")
TL_REPLACED = ("norm_quant", "ternary_gemv", "ternary_matmul", "ternary_swiglu")

# The full-width engine run (and the kernel shapes taken from its ticks)
ENGINE_SLOTS, ENGINE_MAX_LEN, ENGINE_REQUESTS, ENGINE_NEW = 8, 1024, 16, 32
ENGINE_PROMPT_RANGE = (16, 900)  # prompt lengths, uniform, numpy default_rng(0)
CHUNK_ROWS = 256  # the engine's largest prefill chunk: its chunk step has 8 x 256 rows
PAGE_SIZE = 64  # kv_page_size of the paged layout (the config's default)
# The shared-prefix workload: a 576-token system prompt (9 pages) and
# distinct tails; followers prefill from 512 (the match floored to the
# largest chunk), so their first chunk rewrites the shared page 8 (a fork)
PREFIX_LEN, PREFIX_TAILS = 576, (16, 128)
PAGED_POOL_BYTES = {"bf16": 1_519_386_624, "int8": 791_347_200}  # 161 pages of 64 rows
# The speculative verify chunk (C = gamma + 1 at the default spec_gamma = 4)
# at decode frontiers: none a multiple of C or of a kv tile, the one at 62
# straddling the page boundary at 64
VERIFY_C, VERIFY_FRONTIERS = 5, (163, 700, 517, 900, 301, 1000, 99, 62)
PREFILL_SHAPES = ((4, 100), (1, 1000), (1, 4000))  # (batch, prompt): buckets 128, 1024, 4096
RWKV_PREFILL_SHAPES = ((1, 1000), (1, 4000))  # (batch, prompt), exact length
ONE_SLOT_REQUESTS = 2  # the rwkv engine's requests also served through one slot
REPEAT_REQUESTS, REPEAT_NEW = 8, 64  # the speculative engine's repetitive workload
# the fault phases' plans: ticks and slots where the engine phase's schedule
# (and the smoke engine's) has the targeted slots live
FAULT_PLAN = [dict(kind="nan", tick=10, slot=2), dict(kind="cache_growth", tick=14, slot=5),
              dict(kind="tick_exception", tick=20),
              dict(kind="slow_tick", tick=30, duration_s=0.25)]
FAULT_SMOKE_PLAN = [dict(kind="nan", tick=3, slot=0), dict(kind="cache_growth", tick=5, slot=1),
                    dict(kind="tick_exception", tick=9),
                    dict(kind="slow_tick", tick=12, duration_s=0.05)]
# the pool phases: replicas of the full-width engine, and the replica faults
# (a replica's engine ticks count its warmup's two)
POOL_REPLICAS = 2
POOL_SMOKE_CRASH = dict(kind="replica_crash", tick=5, replica=0)
POOL_CRASH = dict(kind="replica_crash", tick=10, replica=0)
POOL_HANG = dict(kind="replica_hang", tick=10, replica=1, duration_s=2.5)


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


# The tensor-core kernels and the packed GEMV in ptxas's log, by the
# mangled name's template arguments: flash attention in bf16 (D), the
# packed matmul (weights, tile, dtype), the GEMV (weights, row instance,
# dtype), prefill-append in bf16 (cache dtype, D, int8 cache, paged)
_EPI = r"NS_(?:10DequantEpi|9SwigluEpi)I(f|13__nv_bfloat16)E"
_TC_KERNELS = (("flash_attention_tc", re.compile(r"flash_attention_tc_kernelILi(\d+)E")),
               ("ternary_mma", re.compile(r"17mma_matmul_kernelILi(\d+)ELi(\d+)ELi(\d+)"
                                          r"ELi(\d+)E" + _EPI)),
               ("ternary_gemv", re.compile(r"11gemv_kernelILi(\d+)ELi(\d+)E" + _EPI)),
               ("prefill_append_tc", re.compile(r"prefill_append_tc_kernelI(a|13__nv_bfloat16)"
                                                r"Li(\d+)ELb([01])ELb([01])E")))
_MANGLED_DTYPE = {"f": "f32", "13__nv_bfloat16": "bf16", "a": "int8"}
# The WKV kernels (B15), by dtype and head size (the scan by head size)
_WKV_KERNELS = (("wkv_chunk_state", re.compile(r"wkv_chunk_state_kernelI(f|13__nv_bfloat16)"
                                               r"Li(\d+)E")),
                ("wkv_state_scan", re.compile(r"wkv_state_scan_kernelILi(\d+)E")),
                ("wkv_output", re.compile(r"wkv_output_kernelI(f|13__nv_bfloat16)Li(\d+)E")))


def ptxas_usage(log: str, kernels=_TC_KERNELS) -> list[dict]:
    """Registers, static shared memory and spills that ``nvcc -Xptxas -v``
    reports for each instantiation of ``kernels`` (default: the three
    tensor-core kernels and the packed GEMV). Their dynamic shared memory
    is the launcher's (``tc_smem_bytes``, ``MmaTile::kSmem``,
    ``launch_gemv_mb``, ``output_smem_bytes``) and does not show here."""
    rows, cur = [], None
    for line in log.splitlines():
        m = re.search(r"Function properties for (\S+)", line)
        if m:
            cur = None
            for name, pat in kernels:
                hit = pat.search(m.group(1))
                if hit:
                    cur = {"kernel": name, "template": [
                        int(a) if a.isdigit() else _MANGLED_DTYPE[a] for a in hit.groups()]}
                    rows.append(cur)
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m:
            cur["spill_stores"], cur["spill_loads"] = int(m.group(1)), int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            cur["registers"] = int(m.group(1))
            sm = re.search(r"(\d+) bytes smem", line)
            cur["static_smem"] = int(sm.group(1)) if sm else 0
            cur = None
    return rows


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

    # --- norm_quant: decode, prefill and the 4096-token prefill's rows, and
    # rwkv6-3b's d_model; each held and timed, the decode row on the line --
    nq_rows = []
    for tag, m, width in (("decode", decode_m, d), ("prefill", prefill_m, d),
                          ("prefill 4096", 4096, d), ("d_model 2560", decode_m, 2560)):
        gamma = randn(width)
        x = randn(m, width, dtype=bf16)
        err = quant_close(f"norm_quant[{tag}]", nq_ops.norm_quant(x, gamma),
                          nq_ref.norm_quant(x, gamma))
        checks.append({"kernel": "norm_quant", "shape": tag, "max_abs_err": err})
        nq_args = [(x, gamma)]
        nb = _nbytes(x, gamma) + x.numel() + x.shape[0] * 4
        bms, bby = bound_ms(nb, 5 * x.numel(), "f32")
        nq_rows.append({"name": "norm_quant", "route": "cuda", "shape_tag": tag,
                        "source": "src/repro_torch/kernels/fused_norm_quant/csrc/norm_quant.cu",
                        "replaces": "src/repro/kernels/fused_norm_quant/kernel.py:74",
                        "shape": f"x[{m},{width}] bf16", "max_abs_err": err,
                        "ms": time_ms(torch, nq_ops.norm_quant, nq_args),
                        "eager_ms": eager_ms(torch, nq_ops.norm_quant, nq_args),
                        "plain_ms": time_ms(torch, nq_ref.norm_quant, nq_args,
                                            iters=100 if m <= prefill_m else 20),
                        "bound_ms": bms, "bound_by": bby, "library_ms": None})
    rows.append(nq_rows[0])
    report["norm_quant_shapes"] = nq_rows

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
        row = {"name": name, "route": "cuda", "shape_tag": shape_tag,
               "source": "src/repro_torch/kernels/ternary_matmul/csrc/ternary_matmul.cu",
               "replaces": replaces,
               "shape": f"x[{m},{n}] x wp[{n // 4},{k}]" + (" +res" if residual else ""),
               "max_abs_err": err,
               "ms": time_ms(torch, lambda *a: fn(*a, **kw), sets),
               "eager_ms": eager_ms(torch, lambda *a: fn(*a, **kw), sets),
               "plain_ms": time_ms(torch, lambda *a: ref_fn(*a, **kw), sets),
               "bound_ms": bms, "bound_by": bby,
               "library_ms": time_ms(torch, torch.matmul, lib_sets)}
        row["over_library"] = row["ms"] / row["library_ms"]
        return row

    gemv_rows = [
        projection_row("ternary_gemv", tm_ops.ternary_gemv, tm_ref.ternary_gemv,
                       decode_m, d, d, False, "src/repro/kernels/ternary_matmul/kernel.py:109",
                       "decode q/k/v"),
        projection_row("ternary_gemv", tm_ops.ternary_gemv, tm_ref.ternary_gemv,
                       decode_m, ff, d, True, "src/repro/kernels/ternary_matmul/kernel.py:109",
                       "decode down+res"),
        projection_row("ternary_gemv", tm_ops.ternary_gemv, tm_ref.ternary_gemv,
                       ENGINE_SLOTS, d, d, False,
                       "src/repro/kernels/ternary_matmul/kernel.py:109", "engine q/k/v"),
        projection_row("ternary_gemv", tm_ops.ternary_gemv, tm_ref.ternary_gemv,
                       ENGINE_SLOTS, ff, d, True,
                       "src/repro/kernels/ternary_matmul/kernel.py:109", "engine down+res"),
    ]
    mm_rows = [
        projection_row("ternary_matmul", tm_ops.ternary_matmul, tm_ref.ternary_matmul,
                       prefill_m, d, d, False, "src/repro/kernels/ternary_matmul/kernel.py:147",
                       "prefill q/k/v"),
        projection_row("ternary_matmul", tm_ops.ternary_matmul, tm_ref.ternary_matmul,
                       prefill_m, ff, d, True, "src/repro/kernels/ternary_matmul/kernel.py:147",
                       "prefill down+res"),
        projection_row("ternary_matmul", tm_ops.ternary_matmul, tm_ref.ternary_matmul,
                       ENGINE_SLOTS * CHUNK_ROWS, d, d, False,
                       "src/repro/kernels/ternary_matmul/kernel.py:147", "chunk step q/k/v"),
    ]
    rows.append(gemv_rows[0])
    rows.append(mm_rows[0])
    report["projection_shapes"] = gemv_rows + mm_rows
    report["rwkv_projection_shapes"] = rwkv_projection_rows(projection_row)

    # --- SwiGLU: generate's decode, a 4 x 128 prefill, the chunk step's
    # 8 x 256 rows and the 4096-token prefill's bucket; twin_ms is two
    # ternary_matmul calls of the same shapes (pass 1's yardstick, no
    # library call computes the SwiGLU) -----------------------------------
    wg, wu = packed(d, ff), packed(d, ff)
    sg, su = torch.tensor(0.03, device=dev), torch.tensor(0.025, device=dev)
    sw_rows = []

    def swiglu_twin(x, xs, wg, sg, wu, su, act_dtype):
        return (tm_ops.ternary_matmul(x, xs, wg, sg, out_dtype=act_dtype),
                tm_ops.ternary_matmul(x, xs, wu, su, out_dtype=act_dtype))

    for tag, m in (("decode", decode_m), ("prefill", prefill_m),
                   ("chunk step", ENGINE_SLOTS * CHUNK_ROWS), ("prefill 4096", 4096)):
        x, xs = int8(m, d), randn(m, 1).abs() * 1e-3 + 1e-4
        got = tm_ops.ternary_swiglu(x, xs, wg, sg, wu, su, act_dtype=bf16)
        want = tm_ref.ternary_swiglu(x, xs, wg, sg, wu, su, act_dtype=bf16)
        err = quant_close(f"ternary_swiglu[{tag}]", got, want)
        checks.append({"kernel": "ternary_swiglu", "shape": tag, "max_abs_err": err})
        sets = [(x, xs, wg.clone(), sg, wu.clone(), su)
                for _ in range(copies_for(2 * wg.numel()))]
        kw = {"act_dtype": bf16}
        iters = 100 if m <= prefill_m else 20
        nb = _nbytes(x, xs, wg, wu, sg, su) + m * ff + m * 4
        bms, bby = bound_ms(nb, 4 * m * d * ff, "int8")
        sw_rows.append({"name": "ternary_swiglu", "route": "cuda", "shape_tag": tag,
                        "source": "src/repro_torch/kernels/ternary_matmul/csrc/ternary_swiglu.cu",
                        "replaces": "src/repro/kernels/ternary_matmul/kernel.py:177",
                        "shape": f"x[{m},{d}] x 2 wp[{d // 4},{ff}]", "max_abs_err": err,
                        "ms": time_ms(torch, lambda *a: tm_ops.ternary_swiglu(*a, **kw), sets,
                                      iters=iters),
                        "eager_ms": eager_ms(torch,
                                             lambda *a: tm_ops.ternary_swiglu(*a, **kw), sets,
                                             iters=10 * iters),
                        "plain_ms": time_ms(torch,
                                            lambda *a: tm_ref.ternary_swiglu(*a, **kw), sets,
                                            iters=iters if m <= prefill_m else 5),
                        "twin_ms": time_ms(torch, lambda *a: swiglu_twin(*a, **kw), sets,
                                           iters=iters),
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
    gen_row = {"name": "decode_attention", "route": "cuda", "shape_tag": "generate",
               "source": "src/repro_torch/kernels/decode_attention/csrc/decode_attention.cu",
               "replaces": "src/repro/kernels/decode_attention/kernel.py:305",
               "shape": f"q[{b},{h},{hd}] cache[{b},{hk},{cache_len},{hd}] bf16",
               "max_abs_err": err,
               "ms": time_ms(torch, da_ops.decode_attention, sets),
               "eager_ms": eager_ms(torch, da_ops.decode_attention, sets),
               "plain_ms": time_ms(torch, da_ref.decode_attention, sets),
               "bound_ms": bms, "bound_by": bby,
               "library_ms": time_ms(torch, lambda qq, kk, vv, mm: sdpa(qq, kk, vv, attn_mask=mm),
                                     lib_sets)}
    gen_row["over_library"] = gen_row["ms"] / gen_row["library_ms"]
    rows.append(gen_row)
    engine_dense, engine_int8 = decode_engine_rows(torch, cfg, randn, int8, checks)
    rows.append(engine_int8)
    report["decode_attention_shapes"] = [gen_row, engine_dense]
    pa_rows = prefill_append_rows(torch, cfg, randn, int8, checks)
    rows += [r for r in pa_rows if r["shape_tag"] == "tick"]
    report["prefill_append_shapes"] = pa_rows
    paged_decode = paged_decode_rows(torch, cfg, randn, int8, checks)
    rows += paged_decode
    paged_rows = paged_prefill_rows(torch, cfg, randn, int8, checks)
    rows += [r for r in paged_rows if r["shape_tag"] == "tick"]
    report["prefill_append_paged_shapes"] = paged_rows
    ver_rows = [r for r in pa_rows + paged_rows if r["shape_tag"] == "verify"]
    ver_rows.append(grouped_verify_row(torch, randn, checks))
    report["prefill_append_verify_shapes"] = ver_rows
    attn_keys = ("name", "shape_tag", "shape", "max_abs_err", "ms", "plain_ms", "bound_ms",
                 "bound_by", "library_ms", "over_library", "contiguous_twin_ms")
    emit({"phase": "attention_rows",
          "rows": [{k: r[k] for k in attn_keys if k in r}
                   for r in [gen_row, engine_dense, engine_int8, *pa_rows, *paged_decode,
                             *paged_rows, ver_rows[-1]]]})
    tl_rows = tl_kernel_rows(torch, cfg, randn, int8, packed, unpacked_bf16, quant_close,
                             checks)
    rows += [r for r in tl_rows if r.get("main_row")]
    report["tl_shapes"] = tl_rows
    fa_rows = flash_attention_rows(torch, cfg, randn, checks)
    rows += [r for r in fa_rows if r["shape_tag"] == "generate"]
    report["flash_attention_shapes"] = fa_rows
    wkv = wkv_rows(torch, checks)
    rows += [r for r in wkv if r["shape_tag"] == "generate"]
    report["wkv_shapes"] = wkv
    report["kernel_checks"] = checks
    emit({"phase": "kernels", "checks": checks})
    return rows


def rwkv_projection_rows(projection_row) -> list[dict]:
    """The GEMV and the tiled matmul at rwkv6-3b's projections, which
    tellme-0.7b never gives them: d -> d (time mix r/k/v/g/o, channel mix
    r), d -> d_ff (channel mix k) and d_ff -> d (channel mix v), no
    residual (the RWKV block adds it after the projection); the GEMV at
    generate's decode rows (M = 4), the matmul at generate's prefill
    (4 x 100 = 400 rows) and at the 4000-token prefill. Each bit for bit
    against its plain version (``projection_row`` fails otherwise), timed
    like the tellme rows; their launches come from the rwkv generate run."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.ternary_matmul import ops as tm_ops
    from repro_torch.kernels.ternary_matmul import ref as tm_ref

    rc = get_config("rwkv6-3b")
    d, ff = rc.d_model, rc.d_ff
    rows = []
    for name, line, ms in (("ternary_gemv", 109, (4,)), ("ternary_matmul", 147, (400, 4000))):
        fn, ref_fn = getattr(tm_ops, name), getattr(tm_ref, name)
        for m in ms:
            for n_in, n_out, tag in ((d, d, "time r/k/v/g/o, channel r"), (d, ff, "channel k"),
                                     (ff, d, "channel v")):
                row = projection_row(name, fn, ref_fn, m, n_in, n_out, False,
                                     f"src/repro/kernels/ternary_matmul/kernel.py:{line}",
                                     f"rwkv6-3b {tag} M={m}")
                row["shape_tag"] = f"rwkv6-3b {tag}"
                rows.append(row)
    return rows


def _sdpa_masked(torch, q, k, v, mask):
    return torch.nn.functional.scaled_dot_product_attention(q, k, v, attn_mask=mask)


def decode_engine_rows(torch, cfg, randn, int8, checks) -> tuple[dict, dict]:
    """Decode attention at the engine's decode shape: 8 slots against
    cache_len = 1024 + 256 rows, two of them at the last row as in a fused
    tick. The int8 cache, and the bf16 cache it dequantizes to; each held
    against the plain version in bf16 and f32, timed beside SDPA over the
    same bf16 rows. Returns (bf16 row, int8 row)."""
    from repro_torch.core.ternary import dequantize_kv
    from repro_torch.kernels.decode_attention import ops as da_ops
    from repro_torch.kernels.decode_attention import ref as da_ref

    dev = torch.device("cuda")
    b, h, hk, hd = ENGINE_SLOTS, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    m = ENGINE_MAX_LEN + 256
    q = randn(b, h, hd, dtype=torch.bfloat16)
    k, v = int8(b, hk, m, hd), int8(b, hk, m, hd)
    ks, vs = (randn(b, hk, m).abs() * 4e-3 + 1e-3 for _ in range(2))
    kd, vd = dequantize_kv(k, ks, torch.bfloat16), dequantize_kv(v, vs, torch.bfloat16)
    pos = torch.tensor([m - 1, 700, 512, 900, 300, m - 1, 1000, 100], dtype=torch.int32,
                       device=dev)
    live = int((pos.to(torch.int64) + 1).sum().item()) * hk  # rows read
    mask = (torch.arange(m, device=dev)[None, :] <= pos[:, None].to(torch.int64))[:, None, None]
    n = copies_for(2 * _nbytes(k))
    lib_sets = [(q[:, :, None], kd.clone(), vd.clone(), mask) for _ in range(n)]
    library_ms = time_ms(torch, lambda *a: _sdpa_masked(torch, *a), lib_sets)
    out = []
    for name, quant in (("decode_attention", False), ("decode_attention_quant", True)):
        cache = (k, v, ks, vs) if quant else (kd, vd)
        err = None
        for dtype, tol in ((torch.bfloat16, ATTN_TOL_BF16), (torch.float32, ATTN_TOL_F32)):
            kk, vv = cache[:2] if quant else (kd.to(dtype), vd.to(dtype))
            args = (q.to(dtype), kk, vv, pos)
            got = da_ops.decode_attention(*args, **_scales(cache)).float()
            want = da_ref.decode_attention(*args, **_scales(cache)).float()
            dt_err = (got - want).abs().max().item()
            checks.append({"kernel": name, "shape": f"engine decode {dtype}",
                           "max_abs_err": dt_err, "max_abs_out": want.abs().max().item(),
                           "tol": tol})
            if not torch.allclose(got, want, atol=tol, rtol=tol):
                fail(f"{name}[{dtype}]: max |kernel - plain| = {dt_err}, bar {tol}")
            err = dt_err if err is None else err
        sets = [(q, *[t.clone() for t in cache], pos) for _ in range(n)]
        kern = da_ops.decode_attention_quant if quant else da_ops.decode_attention

        def plain_call(qq, *rest):
            *cs, pp = rest
            return da_ref.decode_attention(qq, cs[0], cs[1], pp, **_scales(cs))

        row_b = 2 * hd * (1 if quant else 2) + (2 * 4 if quant else 0)
        bms, bby = bound_ms(2 * _nbytes(q) + _nbytes(pos) + live * row_b,
                            4 * live * (h // hk) * hd, "bf16")
        row = {"name": name, "route": "cuda", "shape_tag": "engine",
               "source": "src/repro_torch/kernels/decode_attention/csrc/decode_attention.cu",
               "replaces": "src/repro/kernels/decode_attention/kernel.py:"
                           + ("324" if quant else "305"),
               "shape": f"q[{b},{h},{hd}] " + ("int8 cache" if quant else "bf16 cache")
                        + f"[{b},{hk},{m},{hd}]" + (" + scales" if quant else "")
                        + f", pos {pos.tolist()}",
               "max_abs_err": err,
               "ms": time_ms(torch, kern, sets),
               "eager_ms": eager_ms(torch, kern, sets),
               "plain_ms": time_ms(torch, plain_call, sets),
               "bound_ms": bms, "bound_by": bby, "library_ms": library_ms,
               "library_note": "SDPA over the bf16 rows" + (" dequantized (dequant not timed)"
                                                           if quant else "")}
        row["over_library"] = row["ms"] / library_ms
        out.append(row)
    return out[0], out[1]


def prefill_append_rows(torch, cfg, randn, int8, checks) -> list[dict]:
    """Prefill-append, bf16 and int8 caches, at three shapes: ``tick`` (the
    engine's fused tick: 8 slots, C = 256, live slots at offsets 0 and 512,
    six write-only slots at trash_base 1024), ``one`` (1 slot, C = 128 at
    offset 768) and ``verify`` (8 slots, the speculative verify chunk C = 5
    at ``VERIFY_FRONTIERS``). Outputs against the plain version in bf16 and f32; the
    cache after the call equal to the plain version's byte for byte, and
    unchanged outside the appended rows."""
    from repro_torch.core.ternary import dequantize_kv
    from repro_torch.kernels.prefill_append import ops as pa_ops
    from repro_torch.kernels.prefill_append import ref as pa_ref

    dev = torch.device("cuda")
    h, hk, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    m = ENGINE_MAX_LEN + 256
    limit = ENGINE_MAX_LEN  # the engine's trash_base
    shapes = {"tick": (256, [0, 512] + [limit] * 6), "one": (128, [768]),
              "verify": (VERIFY_C, list(VERIFY_FRONTIERS))}
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
            out_rows[-1]["over_library"] = out_rows[-1]["ms"] / out_rows[-1]["library_ms"]
    return out_rows

def flash_attention_rows(torch, cfg, randn, checks) -> list[dict]:
    """Flash attention, the one-shot prefill's attention, at generate's
    bucket, at 1024 and 4096 tokens in bf16, at 4096 in f32 and with GQA in
    f32 at a ragged S: each against its plain version, timed beside its
    bound, the plain version and SDPA; at 4096 also the dense schedule
    (causal_skip=False), which must give the same bits, and its time over
    the causal skip's (the paper's Table II saving, on this card).

    f32 is held at ATTN_TOL_F32 (atol = rtol). In bf16 each element is held
    within FLASH_TOL_BF16 of |want| + the RMS of its output row: P is
    rounded to bf16 against the kernel's running maximum and the plain
    version's row maximum, which moves an output by a small share of its
    row's scale (about sqrt(e / n) over n live keys with unit-normal inputs),
    and the output's own rounding can differ by one ulp (2^-7 of |want|)."""
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.flash_attention import ref as fa_ref

    h, hk, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    bf16, f32 = torch.bfloat16, torch.float32
    sdpa = torch.nn.functional.scaled_dot_product_attention
    shapes = (  # tag, (B, H, HK, S, D), dtype
        ("generate", (4, h, hk, 128, hd), bf16),
        ("1024", (1, h, hk, 1024, hd), bf16),
        ("4096", (1, h, hk, 4096, hd), bf16),
        ("4096_f32", (1, h, hk, 4096, hd), f32),
        ("gqa", (1, 8, 2, 200, 64), f32))
    rows = []
    for tag, (b, nh, nk, s, d), dtype in shapes:
        q, k, v = (randn(b, n, s, d, dtype=dtype) for n in (nh, nk, nk))
        got = fa_ops.flash_attention(q, k, v)
        want = fa_ref.flash_attention(q, k, v).float()
        torch.cuda.synchronize()
        diff = (got.float() - want).abs()
        rms_row = want.pow(2).mean(dim=-1, keepdim=True).sqrt()
        scaled = (diff / (want.abs() + rms_row).clamp_min(1e-30)).max().item()
        err = diff.max().item()
        check = {"kernel": "flash_attention", "shape": tag, "max_abs_err": err,
                 "max_abs_out": want.abs().max().item(),
                 "rms_out": want.pow(2).mean().sqrt().item(),
                 "max_err_over_abs_plus_row_rms": scaled}
        if dtype is bf16:
            check["tol_of_abs_plus_row_rms"] = FLASH_TOL_BF16
            ok = scaled <= FLASH_TOL_BF16
        else:
            check["tol"] = ATTN_TOL_F32
            ok = torch.allclose(got, want, atol=ATTN_TOL_F32, rtol=ATTN_TOL_F32)
        checks.append(check)
        if not ok:
            fail(f"flash_attention[{tag}]: {check}")
        n = copies_for(_nbytes(q, k, v))
        sets = [(q, k.clone(), v.clone()) for _ in range(n)]
        iters = 100 if s <= 256 else 20
        # live (query, key) pairs: causal
        pairs = b * nh * s * (s + 1) // 2
        nb = 2 * _nbytes(q) + _nbytes(k, v)
        bms, bby = bound_ms(nb, 4 * d * pairs, "bf16" if dtype is bf16 else "f32")
        # the yardstick: SDPA on the same tensors (k/v repeated to H heads
        # for GQA, outside the timing)
        kl, vl = k.repeat_interleave(nh // nk, dim=1), v.repeat_interleave(nh // nk, dim=1)
        lib_ms = time_ms(torch, lambda qq, kk, vv: sdpa(qq, kk, vv, is_causal=True),
                         [(q, kl, vl)], iters=iters)
        lib_note = "SDPA, is_causal=True" + (", k/v repeated to H heads" if nh != nk else "")

        row = {"name": "flash_attention", "route": "cuda", "shape_tag": tag,
               "source": "src/repro_torch/kernels/flash_attention/csrc/flash_attention.cu",
               "replaces": "src/repro/kernels/flash_attention/kernel.py:101",
               "shape": f"q[{b},{nh},{s},{d}] k/v[{b},{nk},{s},{d}] {str(dtype)[6:]}",
               "max_abs_err": err,
               "ms": time_ms(torch, fa_ops.flash_attention, sets, iters=iters),
               "eager_ms": eager_ms(torch, fa_ops.flash_attention, sets, iters=2 * iters),
               "plain_ms": time_ms(torch, fa_ref.flash_attention, sets[:1],
                                   iters=min(iters, 5)),
               "bound_ms": bms, "bound_by": bby, "library_ms": lib_ms,
               "library_note": lib_note, "live_pairs": pairs}
        row["over_library"] = row["ms"] / lib_ms
        if tag == "4096":  # the dense schedule: every kv tile visited and masked
            dense = fa_ops.flash_attention(q, k, v, causal_skip=False)
            same = bool(torch.equal(dense, got))
            checks.append({"kernel": "flash_attention", "shape": "4096 dense schedule",
                           "equal_to_causal_skip": same})
            if not same:
                fail("flash_attention[4096]: the dense schedule's output differs from the "
                     "causal skip's")
            row["dense_ms"] = time_ms(torch, lambda *a: fa_ops.flash_attention(
                *a, causal_skip=False), sets, iters=iters)
            row["dense_over_skip"] = row["dense_ms"] / row["ms"]
        rows.append(row)
    return rows


def wkv_inputs(torch, gen, b, h, s, n, dtype):
    """r, k, v [b, h, s, n] normal in ``dtype``; the log-decay f32, slow on
    the even channels ([-1e-3, -1e-4], so the state carries across
    thousands of tokens and every chunk boundary) and log-uniform across
    the model's whole clip range [-10, -1e-4] on the odd ones; u [h, n]."""
    dev = torch.device("cuda")
    r, k, v = (torch.randn((b, h, s, n), generator=gen, device=dev).to(dtype) for _ in range(3))
    fast = -(10.0 ** (torch.rand((b, h, s, n), generator=gen, device=dev) * 5.0 - 4.0))
    slow = -(10.0 ** (torch.rand((b, h, s, n), generator=gen, device=dev) - 4.0))
    logw = torch.where(torch.arange(n, device=dev) % 2 == 0, slow, fast)
    u = torch.randn((h, n), generator=gen, device=dev) * 0.5
    return r, k, v, logw, u


def wkv_rel_err(got, want) -> float:
    """max |got - want| over each head, relative to that head's max |want|."""
    diff = (got - want).abs().flatten(2).amax(-1)
    return (diff / want.abs().flatten(2).amax(-1).clamp_min(1e-30)).max().item()


def _wkv_chunk_ops(m: int, n: int, sub: int, first: bool) -> int:
    """f32 operations of one chunk of m rows of the chunked WKV, an exp
    counted as one, with A's decay factored at ``sub``-row sub-chunk
    boundaries (sub >= m: not factored). The cumulative log-decay (an add
    a row and channel); d = sum r u k and d v (five a row and channel); the
    state's factors k exp(last - lc) (three) and its increment k^T v (a
    multiply-add a pair of channels a row); A's causal pairs inside a
    sub-chunk at five a channel (a subtract, an exp, two multiplies, an
    add), the other pairs at a multiply-add a channel and their factors at
    three a channel for each key row with a later sub-chunk and each
    (query row, earlier key sub-chunk); A.v at a multiply-add a pair and
    value column. Past the first chunk (which enters with the zero state)
    also r exp(e) (two), r.S (a multiply-add a pair of channels a row) and
    S = g S + dS with g = exp(last)."""
    pairs = m * (m - 1) // 2
    sizes = [min(sub, m - j) for j in range(0, m, sub)]
    diag = sum(q * (q - 1) // 2 for q in sizes)
    factors = sum(sizes[:-1]) + sum(j * q for j, q in enumerate(sizes))
    a = 5 * diag * n + 2 * (pairs - diag) * n + 3 * factors * n
    ops = 9 * m * n + 2 * m * n * n + a + 2 * pairs * n + n
    if not first:
        ops += 2 * m * n + 2 * m * n * n + 2 * n * n
    return ops


def wkv_ops_count(bh: int, s: int, n: int) -> int:
    """The least f32 operations (an exp counted as one) that compute WKV at
    these inputs, over the forms that compute it: the sequential recurrence
    (a row takes exp(w), d = sum r u k and d v, r.S at a multiply-add a
    pair of channels, S = w S + k v^T at three a pair: 5 n^2 + 6 n; the
    first row no r.S and S = k v^T), and the chunked form
    (``_wkv_chunk_ops``) at every chunk size from 1 to 64 rows, with A's
    decay factored at sub-chunks of 1, 2, 4, ..., 64 rows. At n = 64 the
    least is chunks of 7-10 rows and sub-chunks of 4, about 19,400 a row
    (the recurrence 20,860; the kernels' 64-row chunks with 16-row
    sub-chunks about 27,000); at n = 16 and 77 rows the recurrence."""
    forms = [s * (5 * n * n + 6 * n) - 3 * n * n]
    for chunk in range(1, 65):
        full, tail = divmod(s, chunk)
        for sub in (1, 2, 4, 8, 16, 32, 64):
            if sub > chunk:
                break
            ops = _wkv_chunk_ops(min(chunk, s), n, sub, True)
            if full > 1:
                ops += (full - 1) * _wkv_chunk_ops(chunk, n, sub, False)
            if tail and full:
                ops += _wkv_chunk_ops(tail, n, sub, False)
            forms.append(ops)
    return bh * min(forms)


def wkv_shapes(torch) -> tuple:
    """(tag, (B, H, S, n), r/k/v dtype) of the WKV rows: generate's
    exact-length prefill, 1000 tokens, the rwkv engine's longest B = 1
    admission (875), 4000 in bf16 and in f32, and the smoke config's
    n = 16 with an odd S."""
    bf16, f32 = torch.bfloat16, torch.float32
    return (("generate", (4, 40, 100, 64), bf16), ("1000", (1, 40, 1000, 64), bf16),
            ("engine_875", (1, 40, 875, 64), bf16), ("4000", (1, 40, 4000, 64), bf16),
            ("4000_f32", (1, 40, 4000, 64), f32), ("smoke", (3, 4, 77, 16), f32))


def wkv_shape_name(args) -> str:
    b, h, s, n = args[0].shape
    return f"r/k/v/logw[{b},{h},{s},{n}] {str(args[0].dtype)[6:]}"


def wkv_timing(torch, wkv, args, outs) -> tuple[dict, list]:
    """One WKV shape's times on the card (``wkv`` on ``args``, whose
    outputs ``outs`` count in the bytes): ms (a CUDA graph's replay),
    eager_ms, the bound; and the input copies timed, which exceed the L2."""
    b, h, s, n = args[0].shape
    nb = _nbytes(*args) + _nbytes(*outs)
    bms, bby = bound_ms(nb, wkv_ops_count(b * h, s, n), "f32")
    sets = [tuple(t.clone() for t in args) for _ in range(copies_for(nb))]
    iters = 100 if s <= 128 else 10
    return {"ms": time_ms(torch, wkv, sets, iters=iters),
            "eager_ms": eager_ms(torch, wkv, sets, iters=2 * iters),
            "bound_ms": bms, "bound_by": bby}, sets


def wkv_rows(torch, checks) -> list[dict]:
    """The WKV kernels (B15) against their plain version on the card, at
    ``wkv_shapes``. y and the final state are held within WKV_TOL of each
    head's scale: both run in f32 from the same inputs and differ in the
    order of their sums, in the chunk (the kernels' 64 with a masked tail,
    the plain version's JAX rule) and in the kernels' decay factored at
    16-row sub-chunk boundaries, which moves a decay ratio by a few ulps of
    the cumulative log-decay (up to 640: 6e-5); the per-head error stays
    near 1e-6. Each shape's second call is held bit for bit against its
    first, and at B > 1 each head of the batch bit for bit against the same
    inputs run alone at B = 1 (no atomics: a head's result depends on its
    own inputs only). No single PyTorch call computes WKV, so no library
    time."""
    from repro_torch.kernels.wkv import ops as wkv_ops
    from repro_torch.kernels.wkv import ref as wkv_ref

    gen = torch.Generator(device="cuda").manual_seed(19)
    rows = []
    for tag, (b, h, s, n), dtype in wkv_shapes(torch):
        args = wkv_inputs(torch, gen, b, h, s, n, dtype)
        y, s_n = wkv_ops.wkv(*args)
        y2, s_n2 = wkv_ops.wkv(*args)
        alone = [wkv_ops.wkv(*(t[i:i + 1] for t in args[:4]), args[4]) for i in range(b)]
        torch.cuda.synchronize()
        want_y, want_s = wkv_ref.wkv(*args)
        err_y, err_s = wkv_rel_err(y, want_y), wkv_rel_err(s_n, want_s)
        repeat_equal = torch.equal(y, y2) and torch.equal(s_n, s_n2)
        batch_equal = all(torch.equal(y[i:i + 1], ya) and torch.equal(s_n[i:i + 1], sa)
                          for i, (ya, sa) in enumerate(alone))
        check = {"kernel": "wkv", "shape": tag, "y_err_of_head_scale": err_y,
                 "state_err_of_head_scale": err_s, "tol": WKV_TOL,
                 "max_abs_y": want_y.abs().max().item(),
                 "max_abs_state": want_s.abs().max().item(),
                 "repeat_bit_equal": repeat_equal, "batch_invariant": batch_equal}
        checks.append(check)
        if not (err_y <= WKV_TOL and err_s <= WKV_TOL and repeat_equal and batch_equal):
            fail(f"wkv[{tag}]: {check}")  # NaN fails too
        timing, sets = wkv_timing(torch, wkv_ops.wkv, args, (y, s_n))
        rows.append({"name": "wkv", "route": "cuda", "shape_tag": tag,
                     "source": "src/repro_torch/kernels/wkv/csrc/wkv.cu",
                     "replaces": "src/repro/kernels/wkv/kernel.py:75",
                     "shape": wkv_shape_name(args),
                     "max_abs_err": max((y - want_y).abs().max().item(),
                                        (s_n - want_s).abs().max().item()),
                     **timing,
                     "plain_ms": time_ms(torch, wkv_ref.wkv, sets[:1], iters=3),
                     "library_ms": None})
    return rows


# ---------------------------------------------------------------------------
# the paged kernels (phase kernels)
# ---------------------------------------------------------------------------


def _bits(torch, t):
    """The raw bits of a tensor: comparing these is NaN-safe."""
    return t.view({torch.bfloat16: torch.int16, torch.float32: torch.int32}.get(t.dtype, t.dtype))


def _paged_table(rng, b, nb, pages, mapped, share):
    """A page table over pages 1..pages-1 in a seeded random order: slot s
    maps its first ``mapped[s]`` blocks and holds the garbage page 0 past
    them; slot dst's first n blocks are slot src's pages (``share = (dst,
    src, n)``, read-only)."""
    import numpy as np

    perm = list(rng.permutation(np.arange(1, pages)))
    table = np.zeros((b, nb), np.int32)
    dst, src, n = share
    for s in range(b):
        for blk in range(mapped[s]):
            table[s, blk] = table[src, blk] if s == dst and blk < n else perm.pop()
    return table


def _poison(torch, pools, table):
    """(poisoned, clean) copies of ``pools``: the garbage page and every page
    the table does not map hold NaN (int8 codes -128, NaN scales) in the
    first, zeros in the second. The kernels never read them; the plain
    versions multiply masked probabilities (exact zeros) by V, so they need
    finite values there, as the contract of serving/paging.py keeps them."""
    dead = torch.ones(pools[0].shape[0], dtype=torch.bool)
    dead[torch.from_numpy(table.reshape(-1)).long()] = False
    dead[0] = True
    dead = dead.to(pools[0].device)
    poisoned, clean = [t.clone() for t in pools], [t.clone() for t in pools]
    for p, c in zip(poisoned, clean):
        p[dead] = -128 if p.dtype == torch.int8 else float("nan")
        c[dead] = 0
    return poisoned, clean


def _scales(pools):
    return dict(k_scale=pools[2], v_scale=pools[3]) if len(pools) == 4 else {}


def paged_decode_rows(torch, cfg, randn, int8, checks) -> list[dict]:
    """Paged decode attention, bf16 and int8 pools, at the engine's decode
    shape (8 slots, 1280 logical rows = 20 pages of 64, the auto pool of
    161 pages): a permuted table with slot 2's first 8 pages shared with
    slot 1, garbage past each frontier, NaN in the garbage and the unmapped
    pages. Output finite, bit-equal to the contiguous kernel on the gathered
    view, within the bars of the plain version."""
    import numpy as np

    from repro_torch.core.ternary import dequantize_kv, gather_kv_pages
    from repro_torch.kernels.decode_attention import ops as da_ops
    from repro_torch.kernels.decode_attention import ref as da_ref

    dev = torch.device("cuda")
    b, h, hk, hd, ps = ENGINE_SLOTS, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, PAGE_SIZE
    m = ENGINE_MAX_LEN + 256
    nb, pages = m // ps, ENGINE_SLOTS * (m // ps) + 1
    pos_l = [m - 1, 700, 512, 900, 300, m - 1, 1000, 100]
    table = _paged_table(np.random.default_rng(15), b, nb, pages, [p // ps + 1 for p in pos_l],
                         share=(2, 1, 8))
    pt = torch.from_numpy(table).to(dev)
    pos = torch.tensor(pos_l, dtype=torch.int32, device=dev)
    q = randn(b, h, hd, dtype=torch.bfloat16)
    live = sum(p + 1 for p in pos_l) * hk  # rows read
    entries = sum(p // ps + 1 for p in pos_l)  # table entries read
    out_rows = []
    for quant in (False, True):
        name = "decode_attention_paged" + ("_quant" if quant else "")
        if quant:
            base = [int8(pages, hk, ps, hd), int8(pages, hk, ps, hd),
                    randn(pages, hk, ps).abs() * 4e-3 + 1e-3, randn(pages, hk, ps).abs() * 4e-3 + 1e-3]
        else:
            base = [randn(pages, hk, ps, hd), randn(pages, hk, ps, hd)]
        err = None
        for dtype, tol in ((torch.bfloat16, ATTN_TOL_BF16), (torch.float32, ATTN_TOL_F32)):
            cast = base if quant else [t.to(dtype) for t in base]
            poisoned, clean = _poison(torch, cast, table)
            qq = q.to(dtype)
            got = da_ops.decode_attention_paged(qq, poisoned[0], poisoned[1], pt, pos,
                                                **_scales(poisoned))
            views = [gather_kv_pages(t, pt) for t in poisoned]
            twin = da_ops.decode_attention(qq, views[0], views[1], pos, **_scales(views))
            want = da_ref.decode_attention_paged(qq, clean[0], clean[1], pt, pos, **_scales(clean))
            torch.cuda.synchronize()
            finite = bool(torch.isfinite(got).all())
            bit_equal = bool(torch.equal(_bits(torch, got), _bits(torch, twin)))
            dt_err = (got.float() - want.float()).abs().max().item()
            checks.append({"kernel": name, "shape": f"engine decode {str(dtype)[6:]}",
                           "max_abs_err": dt_err, "max_abs_out": want.abs().max().item(),
                           "tol": tol, "finite_on_nan_pools": finite,
                           "bit_equal_contiguous_on_gathered_view": bit_equal})
            if not (finite and bit_equal and torch.allclose(got.float(), want.float(), atol=tol,
                                                            rtol=tol)):
                fail(f"{name}[{dtype}]: finite {finite}, bit-equal to the contiguous kernel "
                     f"{bit_equal}, max |kernel - plain| = {dt_err} (bar {tol})")
            err = dt_err if err is None else err
        poisoned, clean = _poison(torch, base if quant else [t.to(torch.bfloat16) for t in base],
                                  table)
        n = copies_for(2 * _nbytes(poisoned[0]))
        sets = [(q, *[t.clone() for t in poisoned], pt, pos) for _ in range(n)]
        clean_sets = [(q, *[t.clone() for t in clean], pt, pos) for _ in range(n)]
        kern = da_ops.decode_attention_paged_quant if quant else da_ops.decode_attention_paged

        def plain_fn(qq, *a):
            *pools, ptt, pp = a
            return da_ref.decode_attention_paged(qq, pools[0], pools[1], ptt, pp,
                                                 **_scales(pools))

        views = [[gather_kv_pages(t, pt) for t in st[1:-2]] for st in sets]
        twin_fn = da_ops.decode_attention_quant if quant else da_ops.decode_attention
        twin_sets = [(q, *v, pos) for v in views]
        kd = [dequantize_kv(v[0], v[2], torch.bfloat16) for v in views] if quant else None
        vd = [dequantize_kv(v[1], v[3], torch.bfloat16) for v in views] if quant else None
        mask = (torch.arange(m, device=dev)[None, :] <= pos[:, None].to(torch.int64))
        lib_sets = [(q[:, :, None], kd[i] if quant else v[0], vd[i] if quant else v[1],
                     mask[:, None, None]) for i, v in enumerate(views)]
        row_b = 2 * hd * (1 if quant else 2) + (2 * 4 if quant else 0)
        nbytes = 2 * _nbytes(q) + _nbytes(pos) + live * row_b + entries * 4
        bms, bby = bound_ms(nbytes, 4 * live * (h // hk) * hd, "bf16")
        out_rows.append({
            "name": name, "route": "cuda",
            "source": "src/repro_torch/kernels/decode_attention/csrc/decode_attention.cu",
            "replaces": ("src/repro/kernels/decode_attention/kernel.py:281" if quant
                         else "src/repro/kernels/decode_attention/kernel.py:261"),
            "shape": f"q[{b},{h},{hd}] pools[{pages},{hk},{ps},{hd}] "
                     + ("int8 + scales" if quant else "bf16")
                     + f", table[{b},{nb}], pos {pos_l}",
            "max_abs_err": err,
            "ms": time_ms(torch, kern, sets),
            "eager_ms": eager_ms(torch, kern, sets),
            "plain_ms": time_ms(torch, plain_fn, clean_sets),
            "contiguous_twin_ms": time_ms(torch, twin_fn, twin_sets),
            "bound_ms": bms, "bound_by": bby,
            "library_ms": time_ms(torch, lambda *a: _sdpa_masked(torch, *a), lib_sets),
            "library_note": "SDPA over the gathered view" + (" dequantized to bf16" if quant
                                                             else "")
                            + " (gather and dequant not timed)"})
        out_rows[-1]["over_library"] = out_rows[-1]["ms"] / out_rows[-1]["library_ms"]
    return out_rows


def paged_prefill_rows(torch, cfg, randn, int8, checks) -> list[dict]:
    """Paged prefill-append, bf16 and int8 pools (161 pages of 64 rows), at
    three shapes: ``tick`` (8 slots, C = 256, live slots at offsets 0 and 512,
    six write-only slots at trash_base 1024, whose windows map the garbage
    page; slot 2 shares slot 1's first 8 pages), ``one`` (1 slot, C = 128
    at offset 768) and ``verify`` (8 slots, C = 5 at ``VERIFY_FRONTIERS``,
    the chunk at 62 straddling a page; slot 2 reads slot 1's first 4 pages). NaN in the garbage and unmapped pages. Output finite and
    bit-equal to the contiguous kernel on the gathered view, within the bars
    of the plain version; the pools after the append equal the plain
    version's byte for byte and the contiguous kernel's cache scattered back,
    and are unchanged outside the written windows (garbage page excepted)."""
    import numpy as np

    from repro_torch.core.ternary import dequantize_kv, gather_kv_pages
    from repro_torch.kernels.prefill_append import ops as pa_ops
    from repro_torch.kernels.prefill_append import ref as pa_ref

    dev = torch.device("cuda")
    h, hk, hd, ps = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, PAGE_SIZE
    m = ENGINE_MAX_LEN + 256
    nb, pages = m // ps, ENGINE_SLOTS * (m // ps) + 1
    limit = ENGINE_MAX_LEN  # the engine's trash_base
    rng = np.random.default_rng(16)
    shapes = {"tick": (256, [0, 512] + [limit] * 6, [4, 12, 11, 15, 5, 16, 16, 2], (2, 1, 8)),
              "one": (128, [768], [14], (0, 0, 0)),
              "verify": (VERIFY_C, list(VERIFY_FRONTIERS),
                         [-(-(o + VERIFY_C) // ps) for o in VERIFY_FRONTIERS], (2, 1, 4))}
    out_rows = []
    for tag, (c, offs, mapped, share) in shapes.items():
        b = len(offs)
        table = _paged_table(rng, b, nb, pages, mapped, share)
        pt = torch.from_numpy(table).to(dev)
        off = torch.tensor(offs, dtype=torch.int32, device=dev)
        q = randn(b, h, c, hd)
        kn, vn = randn(b, hk, c, hd), randn(b, hk, c, hd) * 0.25
        live = [i for i, o in enumerate(offs) if o < limit]
        # (page, row) the live chunks write; the write-only ones write page 0
        written = torch.zeros((pages, ps), dtype=torch.bool)
        for i in live:
            for r in range(offs[i], offs[i] + c):
                written[table[i, r // ps], r % ps] = True
        written = written.to(dev)
        mapped_pages = torch.zeros(pages, dtype=torch.bool)
        mapped_pages[torch.from_numpy(table.reshape(-1)).long()] = True
        mapped_pages[0] = False
        mapped_pages = mapped_pages.to(dev)
        not_garbage = torch.ones(pages, dtype=torch.bool, device=dev)
        not_garbage[0] = False
        live_rows = sum(offs[i] for i in live)  # prefix rows read, per kv head
        pairs = sum(offs[i] * c for i in live) + len(live) * c * (c + 1) // 2
        # table entries read: a live slot's prefix and chunk pages, a
        # write-only slot's chunk pages
        entries = sum((o + c - 1) // ps + 1 - (0 if o < limit else o // ps) for o in offs)
        for quant in (False, True):
            name = "prefill_append_paged" + ("_quant" if quant else "")
            if quant:
                base = [int8(pages, hk, ps, hd), int8(pages, hk, ps, hd),
                        randn(pages, hk, ps).abs() * 4e-3 + 1e-3,
                        randn(pages, hk, ps).abs() * 1e-3 + 2e-4]
            else:
                base = [randn(pages, hk, ps, hd), randn(pages, hk, ps, hd) * 0.25]
            err = None
            for dtype, tol in ((torch.bfloat16, ATTN_TOL_BF16), (torch.float32, ATTN_TOL_F32)):
                cast = [t.to(dtype) for t in (q, kn, vn)]
                poisoned, clean = _poison(torch, base if quant else [t.to(dtype) for t in base],
                                          table)
                mine = [t.clone() for t in poisoned]
                views = [gather_kv_pages(t, pt) for t in poisoned]
                got = pa_ops.prefill_append_paged(*cast, mine[0], mine[1], pt, off,
                                                  prefix_limit=limit, **_scales(mine))
                twin = pa_ops.prefill_append(*cast, views[0], views[1], off, prefix_limit=limit,
                                             **_scales(views))
                want = pa_ref.prefill_append_paged(*cast, clean[0], clean[1], pt, off,
                                                   prefix_limit=limit, **_scales(clean))
                torch.cuda.synchronize()
                finite = bool(torch.isfinite(got).all())
                bit_equal = bool(torch.equal(_bits(torch, got), _bits(torch, twin)))
                dt_err = (got.float() - want.float()).abs().max().item()
                same = kept = scattered = True
                for a, p, before, view in zip(mine, clean, poisoned, views):
                    same &= torch.equal(_bits(torch, a[mapped_pages]), _bits(torch, p[mapped_pages]))
                    keep = ~written[:, None, :].expand(a.shape[:3]) & not_garbage[:, None, None]
                    kept &= torch.equal(_bits(torch, a[keep]), _bits(torch, before[keep]))
                    for i in live:
                        for blk in range(offs[i] // ps, (offs[i] + c - 1) // ps + 1):
                            scattered &= torch.equal(
                                _bits(torch, a[table[i, blk]]),
                                _bits(torch, view[i, :, blk * ps:(blk + 1) * ps]))
                checks.append({"kernel": name, "shape": f"{tag} {str(dtype)[6:]}",
                               "max_abs_err": dt_err, "max_abs_out": want.abs().max().item(),
                               "tol": tol, "finite_on_nan_pools": finite,
                               "bit_equal_contiguous_on_gathered_view": bit_equal,
                               "pools_equal_plain": same, "other_rows_unchanged": kept,
                               "pools_equal_contiguous_scattered": scattered})
                if not (finite and bit_equal and same and kept and scattered
                        and torch.allclose(got.float(), want.float(), atol=tol, rtol=tol)):
                    fail(f"{name}[{tag}, {dtype}]: finite {finite}, bit-equal to the contiguous "
                         f"kernel {bit_equal}, max |kernel - plain| = {dt_err} (bar {tol}), "
                         f"pools equal plain {same}, other rows unchanged {kept}, equal the "
                         f"contiguous cache scattered {scattered}")
                err = dt_err if err is None else err
            bf16 = torch.bfloat16
            qb, knb, vnb = q.to(bf16), kn.to(bf16), vn.to(bf16)  # the engine's dtype
            poisoned, clean = _poison(torch, base if quant else [t.to(bf16) for t in base], table)
            n = copies_for(_nbytes(*poisoned))
            sets = [(qb, knb, vnb, *[t.clone() for t in poisoned], pt) for _ in range(n)]
            clean_sets = [(qb, knb, vnb, *[t.clone() for t in clean], pt) for _ in range(n)]
            twin_sets = [(qb, knb, vnb, *[gather_kv_pages(t, pt) for t in st[3:-1]])
                         for st in sets]

            def kern(qq, kk, vv, *a):
                *pools, ptt = a
                return pa_ops.prefill_append_paged(qq, kk, vv, pools[0], pools[1], ptt, off,
                                                   prefix_limit=limit, **_scales(pools))

            def plain_fn(qq, kk, vv, *a):
                *pools, ptt = a
                return pa_ref.prefill_append_paged(qq, kk, vv, pools[0], pools[1], ptt, off,
                                                   prefix_limit=limit, **_scales(pools))

            def twin_fn(qq, kk, vv, *cs):
                return pa_ops.prefill_append(qq, kk, vv, cs[0], cs[1], off, prefix_limit=limit,
                                             **_scales(list(cs)))

            row_b = 2 * hd * (1 if quant else 2) + (2 * 4 if quant else 0)
            nbytes = (_nbytes(qb) * len(live) // b + _nbytes(qb) + 2 * _nbytes(knb)
                      + live_rows * hk * row_b + b * c * hk * row_b + _nbytes(off) + entries * 4)
            bms, bby = bound_ms(nbytes, 4 * hd * h * pairs, "bf16")
            # the library call: SDPA for the live slots over their gathered
            # rows up to the chunk's end, with the offset-causal mask
            end = max(offs[i] for i in live) + c
            kpos = torch.arange(end, device=dev)[None, None, :]
            qpos = off[live, None, None].to(torch.int64) + torch.arange(c, device=dev)[None, :, None]
            views = [gather_kv_pages(t, pt) for t in clean]
            if quant:
                kd, vd = (dequantize_kv(views[0], views[2], bf16),
                          dequantize_kv(views[1], views[3], bf16))
            else:
                kd, vd = views[0], views[1]
            for i, o in enumerate(offs):  # the chunk's rows, as appended
                kd[i, :, o:o + c], vd[i, :, o:o + c] = knb[i], vnb[i]
            lib_sets = [(qb[live].contiguous(), kd[live, :, :end].contiguous(),
                         vd[live, :, :end].contiguous(), (kpos <= qpos)[:, None])]
            out_rows.append({
                "name": name, "route": "cuda", "shape_tag": tag,
                "source": "src/repro_torch/kernels/prefill_append/csrc/prefill_append.cu",
                "replaces": ("src/repro/kernels/prefill_append/kernel.py:503" if quant
                             else "src/repro/kernels/prefill_append/kernel.py:477"),
                "shape": (f"q[{b},{h},{c},{hd}] offsets {offs} prefix_limit {limit} pools "
                          f"[{pages},{hk},{ps},{hd}] " + ("int8 + scales" if quant else "bf16")
                          + f", table[{b},{nb}]"),
                "max_abs_err": err,
                "ms": time_ms(torch, kern, sets, iters=20),
                "eager_ms": eager_ms(torch, kern, sets, iters=20),
                "plain_ms": time_ms(torch, plain_fn, clean_sets, iters=5),
                "contiguous_twin_ms": time_ms(torch, twin_fn, twin_sets, iters=20),
                "bound_ms": bms, "bound_by": bby,
                "library_ms": time_ms(torch, lambda *a: _sdpa_masked(torch, *a), lib_sets,
                                      iters=20),
                "library_note": "SDPA of the live slots with the offset-causal mask over "
                                "their gathered bf16 rows up to the chunk's end"
                                + (", dequantized" if quant else "")
                                + "; the gather, the append and the dequant are not timed"})
            out_rows[-1]["over_library"] = out_rows[-1]["ms"] / out_rows[-1]["library_ms"]
    return out_rows


def grouped_verify_row(torch, randn, checks) -> dict:
    """Prefill-append at the verify chunk with G = 4: q[2,8,5,64], k/v of 2
    heads, frontiers 163 and 62 over 1280 rows, so that one 64-row query
    tile holds every query head's rows. Held in bf16 and f32 against the
    plain version (outputs within the attention bars, the cache its bytes);
    timed in bf16 beside the bound and SDPA with k/v repeated."""
    from repro_torch.kernels.prefill_append import ops as pa_ops
    from repro_torch.kernels.prefill_append import ref as pa_ref

    dev = torch.device("cuda")
    bf16, c, m, limit = torch.bfloat16, VERIFY_C, ENGINE_MAX_LEN + 256, ENGINE_MAX_LEN
    offs = [163, 62]
    off = torch.tensor(offs, dtype=torch.int32, device=dev)
    q, kn, vn = randn(2, 8, c, 64), randn(2, 2, c, 64), randn(2, 2, c, 64) * 0.25
    cache = [randn(2, 2, m, 64), randn(2, 2, m, 64) * 0.25]
    err = None
    for dtype, tol in ((bf16, ATTN_TOL_BF16), (torch.float32, ATTN_TOL_F32)):
        cast = [t.to(dtype) for t in (q, kn, vn)]
        mine = [t.to(dtype).clone() for t in cache]
        plain = [t.clone() for t in mine]
        got = pa_ops.prefill_append(*cast, *mine, off, prefix_limit=limit)
        want = pa_ref.prefill_append(*cast, *plain, off, prefix_limit=limit)
        torch.cuda.synchronize()
        e = (got.float() - want.float()).abs().max().item()
        same = all(torch.equal(a, w) for a, w in zip(mine, plain))
        checks.append({"kernel": "prefill_append", "shape": f"verify G=4 {dtype}",
                       "max_abs_err": e, "max_abs_out": want.abs().max().item(), "tol": tol,
                       "cache_equal": same})
        if not (same and torch.allclose(got.float(), want.float(), atol=tol, rtol=tol)):
            fail(f"prefill_append[verify G=4, {dtype}]: max |kernel - plain| = {e} (bar "
                 f"{tol}), cache equal {same}")
        err = e if err is None else err
    qb, kb, vb = (t.to(bf16) for t in (q, kn, vn))
    sets = [(qb, kb, vb, *[t.to(bf16) for t in cache])]
    end = max(offs) + c
    kd, vd = [t.to(bf16)[:, :, :end].clone() for t in cache]
    for i, o in enumerate(offs):  # the chunk's rows, as appended
        kd[i, :, o:o + c], vd[i, :, o:o + c] = kb[i], vb[i]
    mask = (torch.arange(end, device=dev)[None, None, :]
            <= off[:, None, None].to(torch.int64) + torch.arange(c, device=dev)[None, :, None])
    lib_sets = [(qb, kd.repeat_interleave(4, dim=1), vd.repeat_interleave(4, dim=1),
                 mask[:, None])]
    pairs = sum(o * c for o in offs) + 2 * c * (c + 1) // 2
    nbytes = 2 * _nbytes(qb) + 2 * _nbytes(kb) + (sum(offs) + 2 * c) * 2 * 2 * 64 * 2 + 8
    bms, bby = bound_ms(nbytes, 4 * 64 * 8 * pairs, "bf16")

    def kern(qq, kk, vv, k_c, v_c):
        return pa_ops.prefill_append(qq, kk, vv, k_c, v_c, off, prefix_limit=limit)

    def plain_fn(qq, kk, vv, k_c, v_c):
        return pa_ref.prefill_append(qq, kk, vv, k_c, v_c, off, prefix_limit=limit)

    row = {"name": "prefill_append", "route": "cuda", "shape_tag": "verify G=4",
           "source": "src/repro_torch/kernels/prefill_append/csrc/prefill_append.cu",
           "replaces": "src/repro/kernels/prefill_append/kernel.py:532",
           "shape": f"q[2,8,{c},64] k/v 2 heads (G = 4) offsets {offs} cache [2,2,{m},64] bf16",
           "max_abs_err": err, "ms": time_ms(torch, kern, sets, iters=50),
           "eager_ms": eager_ms(torch, kern, sets, iters=50),
           "plain_ms": time_ms(torch, plain_fn, sets, iters=5), "bound_ms": bms,
           "bound_by": bby,
           "library_ms": time_ms(torch, lambda *a: _sdpa_masked(torch, *a), lib_sets, iters=50),
           "library_note": "SDPA with k/v repeated to 8 heads and the offset-causal mask"}
    row["over_library"] = row["ms"] / row["library_ms"]
    return row


# ---------------------------------------------------------------------------
# the table-lookup kernels (phase kernels)
# ---------------------------------------------------------------------------


def tl_kernel_rows(torch, cfg, randn, int8, packed, unpacked_bf16, quant_close,
                   checks) -> list[dict]:
    """The four TL entry points at the shapes of rows 1 and 3-5: each against
    its plain version and, bit for bit, against its packed twin (the
    prologue: ``norm_quant``'s codes and scale, and tables equal to
    ``build_tables`` of them), timed beside the twin. Bounds: the bytes of
    every input read once (indices, int8 rows or the prologue's f32 tables)
    and every output written once; operations: one lookup-add per (row,
    group, column), plus two adds per table entry built in the kernel,
    counted at the f32 peak."""
    from repro_torch.core import tl_matmul as TL
    from repro_torch.kernels.fused_norm_quant import ops as nq_ops
    from repro_torch.kernels.fused_norm_quant import ref as nq_ref
    from repro_torch.kernels.ternary_matmul import ops as tm_ops
    from repro_torch.kernels.tl_gemv import ops as tl_ops
    from repro_torch.kernels.tl_gemv import ref as tl_ref

    dev = torch.device("cuda")
    bf16 = torch.bfloat16
    d, ff, b = cfg.d_model, cfg.d_ff, 4
    decode_m, prefill_m = b, b * 128
    src_tl = "src/repro_torch/kernels/tl_gemv/csrc/tl_gemv.cu"
    out = []

    def bits_equal(a, w):
        return bool(torch.equal(_bits(torch, a), _bits(torch, w)))

    # --- norm_quant_tables: the prologue with its tables (row 2) ----------
    gamma = randn(d)
    t_d = -(-d // 3)
    for tag, m in (("decode", decode_m), ("prefill", prefill_m)):
        x = randn(m, d, dtype=bf16)
        q, qs, tab = nq_ops.norm_quant_tables(x, gamma)
        q0, s0 = nq_ops.norm_quant(x, gamma)
        pq, ps, ptab = nq_ref.norm_quant_tables(x, gamma)
        twin = bits_equal(q, q0) and bits_equal(qs, s0)
        own = bits_equal(tab, TL.build_tables(q, t=t_d))
        code_err = quant_close(f"norm_quant_tables[{tag}]", (q, qs), (pq, ps))
        err = max(code_err, (tab - ptab).abs().max().item())
        checks.append({"kernel": "norm_quant_tables", "shape": tag, "max_abs_err": err,
                       "bit_equal_norm_quant": twin, "tables_equal_build_tables": own})
        if not (twin and own):
            fail(f"norm_quant_tables[{tag}]: codes and scale bit-equal to norm_quant {twin}, "
                 f"tables equal build_tables of the codes {own}")
        sets = [(x, gamma)]
        nb = _nbytes(x, gamma, q, qs, tab)
        bms, bby = bound_ms(nb, 5 * x.numel() + 2 * tab.numel(), "f32")
        out.append({"name": "norm_quant_tables", "route": "cuda", "main_row": tag == "decode",
                    "source": "src/repro_torch/kernels/fused_norm_quant/csrc/norm_quant.cu",
                    "replaces": "src/repro/kernels/fused_norm_quant/kernel.py:105",
                    "shape": f"x[{m},{d}] bf16 -> tables[{m},{tab.shape[1]}] f32",
                    "max_abs_err": err,
                    "ms": time_ms(torch, nq_ops.norm_quant_tables, sets),
                    "eager_ms": eager_ms(torch, nq_ops.norm_quant_tables, sets),
                    "plain_ms": time_ms(torch, nq_ref.norm_quant_tables, sets, iters=20),
                    "twin_ms": time_ms(torch, nq_ops.norm_quant, sets),
                    "twin": "norm_quant", "bound_ms": bms, "bound_by": bby,
                    "library_ms": None})

    # --- projections: tl_gemv (row 14) and tl_matmul (row 15) -------------
    def projection(name, m, n, k, *, residual, from_tables, main=False):
        wp = packed(n, k)
        w_idx = TL.tl_indices(wp)
        t = w_idx.shape[0]
        ws = torch.tensor(0.02, device=dev)
        x, xs = int8(m, n), randn(m, 1).abs() * 1e-3 + 1e-4
        tab = TL.build_tables(x, t=t) if from_tables else None
        res = randn(m, k, dtype=bf16) if residual else None
        out_dtype = torch.float32 if name == "tl_gemv" else bf16
        if name == "tl_gemv":
            fn, plain, twin_fn = tl_ops.tl_gemv, tl_ref.tl_gemv, tm_ops.ternary_gemv
            kw, twin_kw = {}, {}
        else:
            fn, plain = tl_ops.tl_matmul, tl_ref.tl_matmul
            twin_fn = tm_ops.ternary_gemv if m <= 16 else tm_ops.ternary_matmul
            kw = {"tables": tab, "residual": res, "out_dtype": bf16}
            twin_kw = {"residual": res, "out_dtype": bf16}
        got = fn(x, xs, w_idx, ws, **kw)
        want = plain(x, xs, w_idx, ws, **kw)
        twin = twin_fn(x, xs, wp, ws, **twin_kw)
        err = (got.float() - want.float()).abs().max().item()
        same = bits_equal(got, twin)
        tag = (("decode" if m <= 16 else "prefill") + (" tables" if from_tables else " int8")
               + (" +res" if residual else ""))
        checks.append({"kernel": name, "shape": f"[{m},{n}]x[{t},{k}] {tag}",
                       "max_abs_err": err, "bit_equal_packed_twin": same})
        if err != 0.0 or not same:
            fail(f"{name}[{m},{n},{k} {tag}]: max |kernel - plain| = {err} (bar exact), "
                 f"bit-equal to {twin_fn.__name__} {same}")
        sets = [(x, xs, w_idx.clone(), ws) for _ in range(copies_for(w_idx.numel()))]
        twin_sets = [(x, xs, wp.clone(), ws) for _ in range(copies_for(wp.numel()))]
        lib_n = copies_for(n * k * 2, limit=32)
        wbf = unpacked_bf16(wp, ws)
        xb = (x.to(torch.float32) * xs).to(bf16)
        lib_sets = [(xb, wbf.clone()) for _ in range(lib_n)]
        nb = (_nbytes(xs, w_idx, ws, res) + (_nbytes(tab) if from_tables else _nbytes(x))
              + m * k * got.element_size())
        ops = m * t * k + (0 if from_tables else 2 * 27 * m * t)
        bms, bby = bound_ms(nb, ops, "f32")
        call = lambda *a: fn(*a, **kw)  # noqa: E731
        return {"name": name, "route": "cuda", "main_row": main, "source": src_tl,
                "replaces": ("src/repro/kernels/tl_gemv/kernel.py:91" if name == "tl_gemv"
                             else "src/repro/kernels/tl_gemv/kernel.py:141"),
                "shape": f"x[{m},{n}] x w_idx[{t},{k}] u8, {tag}, {str(out_dtype)[6:]} out",
                "max_abs_err": err,
                "ms": time_ms(torch, call, sets),
                "eager_ms": eager_ms(torch, call, sets),
                "plain_ms": time_ms(torch, lambda *a: plain(*a, **kw), sets,
                                    iters=100 if m <= 16 else 5),
                "twin_ms": time_ms(torch, lambda *a: twin_fn(*a, **twin_kw), twin_sets),
                "twin": twin_fn.__name__, "bound_ms": bms, "bound_by": bby,
                "library_ms": time_ms(torch, torch.matmul, lib_sets)}

    out += [
        projection("tl_gemv", decode_m, d, d, residual=False, from_tables=False, main=True),
        projection("tl_gemv", decode_m, ff, d, residual=False, from_tables=False),
        projection("tl_matmul", decode_m, d, d, residual=False, from_tables=True, main=True),
        projection("tl_matmul", decode_m, ff, d, residual=True, from_tables=False),
        projection("tl_matmul", prefill_m, d, d, residual=False, from_tables=True),
        projection("tl_matmul", prefill_m, d, d, residual=False, from_tables=False),
        projection("tl_matmul", prefill_m, ff, d, residual=True, from_tables=False),
    ]

    # --- tl_swiglu (row 16), from the prologue's tables --------------------
    wg, wu = packed(d, ff), packed(d, ff)
    ig, iu = TL.tl_indices(wg), TL.tl_indices(wu)
    sg, su = torch.tensor(0.03, device=dev), torch.tensor(0.025, device=dev)
    for tag, m in (("decode", decode_m), ("prefill", prefill_m),
                   ("chunk step", ENGINE_SLOTS * CHUNK_ROWS)):
        x, xs = int8(m, d), randn(m, 1).abs() * 1e-3 + 1e-4
        tab = TL.build_tables(x, t=ig.shape[0])
        kw = {"tables": tab, "act_dtype": bf16}
        got = tl_ops.tl_swiglu(x, xs, ig, sg, iu, su, **kw)
        twin = tm_ops.ternary_swiglu(x, xs, wg, sg, wu, su, act_dtype=bf16)
        same = bits_equal(got[0], twin[0]) and bits_equal(got[1], twin[1])
        err = quant_close(f"tl_swiglu[{tag}]", got,
                          tl_ref.tl_swiglu(x, xs, ig, sg, iu, su, **kw))
        checks.append({"kernel": "tl_swiglu", "shape": tag, "max_abs_err": err,
                       "bit_equal_packed_twin": same})
        if not same:
            fail(f"tl_swiglu[{tag}]: codes and scales differ from ternary_swiglu's")
        if m > prefill_m:  # the chunk step's rows: the bit hold only
            continue
        sets = [(x, xs, ig.clone(), sg, iu.clone(), su) for _ in range(copies_for(2 * ig.numel()))]
        twin_sets = [(x, xs, wg.clone(), sg, wu.clone(), su)
                     for _ in range(copies_for(2 * wg.numel()))]
        t = ig.shape[0]
        nb = _nbytes(tab, xs, ig, iu, sg, su) + m * ff + m * 4
        bms, bby = bound_ms(nb, 2 * m * t * ff, "f32")
        out.append({"name": "tl_swiglu", "route": "cuda", "main_row": tag == "decode",
                    "source": src_tl, "replaces": "src/repro/kernels/tl_gemv/kernel.py:216",
                    "shape": f"tables[{m},{tab.shape[1]}] x 2 w_idx[{t},{ff}] u8",
                    "max_abs_err": err,
                    "ms": time_ms(torch, lambda *a: tl_ops.tl_swiglu(*a, **kw), sets),
                    "eager_ms": eager_ms(torch, lambda *a: tl_ops.tl_swiglu(*a, **kw), sets),
                    "plain_ms": time_ms(torch, lambda *a: tl_ref.tl_swiglu(*a, **kw), sets,
                                        iters=100 if m <= 16 else 5),
                    "twin_ms": time_ms(torch, lambda *a: tm_ops.ternary_swiglu(
                        *a, act_dtype=bf16), twin_sets),
                    "twin": "ternary_swiglu", "bound_ms": bms, "bound_by": bby,
                    "library_ms": None})
    return out


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


def profile_device(torch, run, steps: int, warmup: int = 2) -> dict:
    """torch.profiler over ``steps`` calls of ``run()``: device time by
    kernel (kernel events only; an op's own entry repeats its kernels'
    time), the device's busy share of the wall time, and the host ops that
    take the most time, each per call."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with torch.inference_mode():
        for _ in range(warmup):
            run()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t = time.perf_counter()
            for _ in range(steps):
                run()
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


def profile_decode(torch, params, cfg, caches, tok, pos) -> dict:
    """``profile_device`` over three decode steps through the kernels."""
    from repro_torch.kernels import KERNELS
    from repro_torch.models import transformer as Tr

    return profile_device(
        torch, lambda: Tr.decode_step(params, tok, caches, pos, cfg, kernels=KERNELS), steps=3)


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


def generate_prompts(torch, cfg):
    """generate's workload: B = 4 prompts of 100 tokens, seed 0."""
    gen = torch.Generator(device="cuda").manual_seed(0)
    return torch.randint(0, cfg.vocab_size, (4, 100), generator=gen, device="cuda")


def generate_run(torch, cfg, params, prompts, steps: int, kset):
    """The prefill alone, timed after a warm-up, then the whole ``generate``
    (the launch counters reset just before it and read just after, for the
    kernels); returns (result, counts or None, times)."""
    from repro_torch import kernels as K
    from repro_torch.serving import engine as E

    b = prompts.shape[0]
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


def generate_phase(torch, cfg, params, steps: int, report: dict):
    """Returns the kernels' launch counts and their greedy tokens."""
    from repro_torch import kernels as K
    from repro_torch.models import transformer as Tr
    from repro_torch.serving import engine as E

    dev = torch.device("cuda")
    prompts = generate_prompts(torch, cfg)
    b, s = prompts.shape
    res_k, counts, times_k = generate_run(torch, cfg, params, prompts, steps, K.KERNELS)
    res_p, _, times_p = generate_run(torch, cfg, params, prompts, steps, K.PLAIN)
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
    tl = {n: counts[n] for n in TL_PATH + ("tl_gemv",) if counts[n]}
    if tl:
        fail(f"generate: the default engine launched TL kernels: {tl}")
    return counts, toks_k


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


def engine_run(torch, cfg, params, kset, prompts, first_alone: bool = False,
               prefill: str = "auto", slots: int = ENGINE_SLOTS, speculative: bool = False,
               max_new: int = ENGINE_NEW, engine_kw: dict | None = None
               ) -> tuple[dict, list, object]:
    """Serve ``prompts`` to the end; returns (measurements, requests, the
    engine). With ``first_alone`` the first request is served to its end
    before the others are submitted. The launch counters are reset just
    before the first tick and read just after the last. Tick times are kept
    by kind: speculative (verify only, or with a prompt chunk), fused,
    decode-only. ``engine_kw`` goes to the engine's constructor. A tick
    that fails is contained by the engine; without a ``fault_plan`` that is
    a fault of the port and fails the script. Under a plan, each contained
    tick is measured (``containments``: its ms, synchronised at both ends,
    the bytes allocated at its peak beyond those resident before it, the
    requests it ended, the slots and queue and page pool just after)."""
    from repro_torch import kernels as K
    from repro_torch.serving import engine as E

    plan = (engine_kw or {}).get("fault_plan")
    eng = E.ServingEngine(params, cfg, slots=slots, max_len=ENGINE_MAX_LEN,
                          kernels=kset, eos_id=-1, prefill=prefill, speculative=speculative,
                          **(engine_kw or {}))
    contained = []
    reqs = [E.Request(rid=i, prompt=p, max_new=max_new) for i, p in enumerate(prompts)]
    first = {}
    eng.on_emit = lambda req, toks: first.setdefault(
        req.rid, (eng.tick_count, time.perf_counter()))
    waves = [reqs[:1], reqs[1:]] if first_alone else [reqs]
    torch.cuda.synchronize()
    K.reset_launch_counts()
    fused_ms, decode_ms, spec_ms, spec_mixed_ms, spec_tokens = [], [], [], [], 0
    t0 = time.perf_counter()
    for wave in waves:
        for r in wave:
            eng.submit(r)
        while eng.queue or any(r is not None for r in eng.live):
            raising = plan is not None and bool(plan.at(eng.tick_count, "tick_exception"))
            if raising:
                torch.cuda.synchronize()
                ended = {r.rid for r in reqs if r.done}
                torch.cuda.reset_peak_memory_stats()
                resident = torch.cuda.memory_allocated()
            f0, s0, t = eng.fused_ticks, eng.spec_ticks, time.perf_counter()
            n0 = sum(len(r.generated) for r in reqs)
            if not eng.step():
                break
            if eng.consecutive_tick_failures:
                failure = [e for e in eng.events if e["kind"] == "tick_failure"][-1]
                if not raising:
                    fail(f"tick {failure['tick']} failed and was contained: "
                         f"{failure['detail']}")
                torch.cuda.synchronize()
                contained.append({
                    "tick": failure["tick"], "ms": (time.perf_counter() - t) * 1e3,
                    "peak_extra_bytes": torch.cuda.max_memory_allocated() - resident,
                    "ended": [r.rid for r in reqs if r.done and r.rid not in ended],
                    "live_after": sum(r is not None for r in eng.live),
                    "queued": [r.rid for r in eng.queue],
                    "paged": eng.paged.stats() if eng.paged is not None else None})
                continue
            ms = (time.perf_counter() - t) * 1e3
            if eng.spec_ticks > s0:
                (spec_mixed_ms if eng.fused_ticks > f0 else spec_ms).append(ms)
                spec_tokens += sum(len(r.generated) for r in reqs) - n0
            else:
                (fused_ms if eng.fused_ticks > f0 else decode_ms).append(ms)
    wall = time.perf_counter() - t0
    counts = K.launch_counts()
    st = eng.stats()
    tokens = sum(len(r.generated) for r in reqs)

    def mean(xs):
        return sum(xs) / len(xs) if xs else None

    spec = {}
    if speculative:
        spec = {"spec_ticks": st["spec_ticks"], "spec_tick_ms_mean": mean(spec_ms),
                "spec_mixed_tick_ms_mean": mean(spec_mixed_ms), "spec_tick_ms": spec_ms,
                "spec_mixed_tick_ms": spec_mixed_ms, "spec_acceptance": st["spec_acceptance"],
                "spec_drafted": sum(r.spec_drafted for r in reqs),
                "spec_accepted": sum(r.spec_accepted for r in reqs),
                "tokens_per_spec_tick": spec_tokens / max(st["spec_ticks"], 1),
                "still_speculative": st["speculative"]}
    return {"ticks": st["ticks"], "fused_ticks": st["fused_ticks"],
            "host_transfers": st["host_transfers"], "statuses": st["statuses"],
            "wall_s": wall, "tokens": tokens, "tokens_per_s": tokens / wall,
            "fused_tick_ms_mean": mean(fused_ms), "decode_tick_ms_mean": mean(decode_ms),
            "fused_tick_ms": fused_ms, "decode_tick_ms": decode_ms, **spec,
            "first_token_ticks": [first[r.rid][0] for r in reqs if r.rid in first],
            "first_token_ms": [(first[r.rid][1] - t0) * 1e3 for r in reqs if r.rid in first],
            "cache_bytes": E.cache_nbytes(eng.caches), "launch_counts": counts,
            "kv_layout": st["kv_layout"], "paged": st["paged"],
            "containments": contained}, reqs, eng


def engine_phase(torch, cfg, params, report: dict) -> tuple[dict, dict]:
    """The full-width ServingEngine for each cache dtype, through the kernels
    and through the plain versions; returns the kernels' launch counts of
    each run and their streams, by cache dtype."""
    import dataclasses

    from repro_torch import kernels as K

    prompts = _engine_prompts(cfg)
    out = {"phase": "engine", "model": cfg.name, "slots": ENGINE_SLOTS,
           "max_len": ENGINE_MAX_LEN, "requests": ENGINE_REQUESTS, "max_new": ENGINE_NEW,
           "prompt_lengths": [len(p) for p in prompts]}
    counts_by_kv, streams_by_kv = {}, {}
    with torch.inference_mode():
        for kv in ("bf16", "int8"):
            c = dataclasses.replace(cfg, kv_cache_dtype=kv)
            got, reqs, _ = engine_run(torch, c, params, K.KERNELS, prompts)
            streams_by_kv[kv] = [r.generated for r in reqs]
            plain, preqs, _ = engine_run(torch, c, params, K.PLAIN, prompts)
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
            tl = {n: counts[n] for n in TL_PATH + ("tl_gemv",) if counts[n]}
            if tl:
                problems.append(f"the default engine launched TL kernels: {tl}")
            if problems:
                emit(out)
                fail(f"engine[{kv}]: " + "; ".join(problems))
    report["engine"] = out
    emit(out)
    return counts_by_kv, streams_by_kv


def _parting(torch, cfg, cuda_params, cpu_params, prompt, got, want) -> dict:
    """Where a card stream parts from the CPU's: the step, both tokens, the
    gap between their plain logits at that row (a one-shot forward of the
    common prefix on the CPU), and how far the kernels' logits at that row
    lie from the plain ones, relative to max |logit|."""
    from repro_torch.kernels import KERNELS, PLAIN
    from repro_torch.models import transformer as Tr

    step = next(i for i, (x, y) in enumerate(zip(got, want)) if x != y)
    tokens = torch.as_tensor(list(prompt) + list(want[:step]))[None].long()
    lk, _ = Tr.forward(cuda_params, tokens.to("cuda"), cfg, kernels=KERNELS)
    lp, _ = Tr.forward(cpu_params, tokens, cfg, kernels=PLAIN)
    rk, rp = lk[0, -1].float().cpu(), lp[0, -1].float()
    scale = rp.abs().max().item()
    return {"step": step, "tokens": [int(got[step]), int(want[step])],
            "plain_gap": abs(rp[got[step]] - rp[want[step]]).item(),
            "kernel_vs_plain": (rk - rp).abs().max().item(), "max_abs_logit": scale}


def paged_engine_smoke_phase(torch, report: dict) -> None:
    """The f32 smoke config in the paged engine, each cache dtype, two
    prompts sharing a 320-token prefix among them (the second is submitted
    after the first's prefix is interned). On the card through the kernels:
    the same streams as the contiguous engine through the kernels (exact,
    by design), and the same statuses and page statistics as the paged
    engine through the plain versions on the CPU, with the same streams. The
    int8 smoke model is chaotic at the ulp level (PERF.md): where an int8
    stream parts from the CPU's, the parting must be a near tie, the two
    tokens' plain logits closer than the kernels' logits are to the plain
    ones at that row, which lie within the 5 % bar."""
    import dataclasses

    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.core import params as PR
    from repro_torch.kernels import KERNELS, PLAIN
    from repro_torch.models import transformer as Tr
    from repro_torch.serving import engine as E

    base = dataclasses.replace(get_config("tellme-0.7b", smoke=True), dtype=torch.float32,
                               kv_layout="paged")
    specs = Tr.param_specs(base)
    cpu_params = Tr.pack_tree(PR.init_params(specs, seed=0, device="cpu"), specs,
                              dtype=base.dtype)
    cuda_params = _to_cuda(cpu_params)
    rng = np.random.default_rng(8)
    prefix = rng.integers(0, base.vocab_size, 320)
    prompts = [rng.integers(0, base.vocab_size, n) for n in (9, 30, 70, 130, 200)]
    prompts += [np.concatenate([prefix, rng.integers(0, base.vocab_size, n)]) for n in (32, 17)]
    out = {"phase": "paged_engine_smoke"}
    for kv in ("bf16", "int8"):
        cfg = dataclasses.replace(base, kv_cache_dtype=kv)
        runs = []
        for layout, params, kset, device in (("paged", cuda_params, KERNELS, None),
                                             ("contiguous", cuda_params, KERNELS, None),
                                             ("paged", cpu_params, PLAIN, "cpu")):
            eng = E.ServingEngine(params, dataclasses.replace(cfg, kv_layout=layout), slots=2,
                                  max_len=512, kernels=kset, device=device)
            reqs = [E.Request(rid=i, prompt=p, max_new=8) for i, p in enumerate(prompts)]
            for r in reqs[:-1]:
                eng.submit(r)
            eng.run()
            eng.submit(reqs[-1])
            eng.run()
            runs.append(([r.generated for r in reqs], [r.status.name for r in reqs],
                         eng.stats()))
        (got, statuses, st), (contiguous, _, _), (want, want_statuses, ref_st) = runs
        parted = [i for i, (a, b) in enumerate(zip(got, want)) if a != b]
        partings = [dict(request=i, **_parting(torch, cfg, cuda_params, cpu_params, prompts[i],
                                               got[i], want[i])) for i in parted]
        ties = all(kv == "int8" and p["plain_gap"] < p["kernel_vs_plain"]
                   <= LOGIT_REL_TOL * p["max_abs_logit"] for p in partings)
        ok = (got == contiguous and statuses == want_statuses and ties
              and st["paged"] == ref_st["paged"] and st["host_transfers"] == st["ticks"]
              and st["paged"]["prefix_hits"] >= 1)
        out[kv] = {"streams_equal_contiguous_on_card": got == contiguous,
                   "streams_equal_cpu": len(prompts) - len(parted), "partings": partings,
                   "statuses_equal": statuses == want_statuses,
                   "paged_stats_equal": st["paged"] == ref_st["paged"],
                   "ticks": st["ticks"], "host_transfers": st["host_transfers"],
                   "paged": st["paged"]}
        if not ok:
            emit(out)
            fail(f"paged_engine_smoke[{kv}]: streams equal the contiguous engine's on the "
                 f"card {got == contiguous}; streams parting from the CPU's {partings}; "
                 f"statuses equal {statuses == want_statuses}, paged stats equal "
                 f"{st['paged'] == ref_st['paged']}, transfers {st['host_transfers']} for "
                 f"{st['ticks']} ticks, prefix hits {st['paged']['prefix_hits']}")
    report["paged_engine_smoke"] = out
    emit(out)


def _shared_prefix_prompts(cfg):
    import numpy as np

    rng = np.random.default_rng(1)
    prefix = rng.integers(0, cfg.vocab_size, PREFIX_LEN)
    lo, hi = PREFIX_TAILS
    return [np.concatenate([prefix, rng.integers(0, cfg.vocab_size, int(n))])
            for n in rng.integers(lo, hi + 1, ENGINE_REQUESTS)]


def divergence(torch, cfg, params, prompt, a, b) -> dict:
    """Where two greedy streams of one prompt part: the step, both tokens,
    and the gap between their logits at that row of a one-shot forward of
    the common prefix through the kernels, relative to max |logit|."""
    from repro_torch.kernels import KERNELS
    from repro_torch.models import transformer as Tr

    step = next(i for i, (x, y) in enumerate(zip(a, b)) if x != y)
    tokens = torch.as_tensor(list(prompt) + list(a[:step]), device="cuda")[None].long()
    logits, _ = Tr.forward(params, tokens, cfg, kernels=KERNELS)
    row = logits[0, -1].float()
    return {"step": step, "tokens": [int(a[step]), int(b[step])],
            "logit_gap_rel": abs(row[a[step]] - row[b[step]]).item() / row.abs().max().item(),
            "bar": LOGIT_REL_TOL}


def paged_engine_phase(torch, cfg, params, contiguous_streams, report: dict) -> dict:
    """The full-width paged ServingEngine through the kernels, each cache
    dtype: (a) the engine phase's workload, whose streams must equal the
    contiguous kernel streams of the engine phase; (b) 16 requests that
    share a 576-token prefix, the first served alone, against the
    contiguous engine on the same requests. Returns the launch counts of (a)
    by cache dtype, and the streams of (b), paged, by cache dtype."""
    import dataclasses

    from repro_torch import kernels as K

    prompts, shared = _engine_prompts(cfg), _shared_prefix_prompts(cfg)
    out = {"phase": "paged_engine", "model": cfg.name, "slots": ENGINE_SLOTS,
           "max_len": ENGINE_MAX_LEN, "page_size": PAGE_SIZE, "requests": ENGINE_REQUESTS,
           "max_new": ENGINE_NEW, "shared_prefix": PREFIX_LEN,
           "shared_prompt_lengths": [len(p) for p in shared]}
    counts_by_kv, shared_streams = {}, {}
    with torch.inference_mode():
        for kv in ("bf16", "int8"):
            c = dataclasses.replace(cfg, kv_cache_dtype=kv, kv_layout="paged",
                                    kv_page_size=PAGE_SIZE)
            sfx = "_quant" if kv == "int8" else ""
            got, reqs, _ = engine_run(torch, c, params, K.KERNELS, prompts)
            counts = got["launch_counts"]
            counts_by_kv[kv] = counts
            # the contiguous engine again, right after, for the tick times
            again, _, _ = engine_run(torch, dataclasses.replace(c, kv_layout="contiguous"), params,
                                     K.KERNELS, prompts)
            got["contiguous_after"] = {k: again[k] for k in (
                "wall_s", "tokens_per_s", "fused_tick_ms_mean", "decode_tick_ms_mean")}
            streams = [r.generated for r in reqs]
            got["streams_equal_to_contiguous"] = sum(
                a == b for a, b in zip(streams, contiguous_streams[kv]))
            problems = []
            bad = [r.rid for r in reqs if r.status.name != "OK" or len(r.generated) != ENGINE_NEW]
            if bad:
                problems.append(f"requests not OK with {ENGINE_NEW} tokens: {bad}")
            if got["streams_equal_to_contiguous"] != ENGINE_REQUESTS:
                problems.append(f"{got['streams_equal_to_contiguous']} of {ENGINE_REQUESTS} "
                                "streams equal the contiguous engine's")
            if got["host_transfers"] != got["ticks"]:
                problems.append(f"{got['host_transfers']} transfers for {got['ticks']} ticks")
            if counts["decode_attention_paged" + sfx] != cfg.n_layers * got["ticks"]:
                problems.append(f"decode_attention_paged{sfx} launched "
                                f"{counts['decode_attention_paged' + sfx]} times in "
                                f"{got['ticks']} ticks")
            if counts["prefill_append_paged" + sfx] != cfg.n_layers * got["fused_ticks"]:
                problems.append(f"prefill_append_paged{sfx} launched "
                                f"{counts['prefill_append_paged' + sfx]} times in "
                                f"{got['fused_ticks']} fused ticks")
            if counts["decode_attention" + sfx] or counts["prefill_append" + sfx]:
                problems.append("contiguous attention kernels launched on the paged path")
            path = ("norm_quant", "ternary_gemv", "ternary_matmul", "ternary_swiglu")
            missing = [n for n in path if counts[n] <= 0]
            if missing:
                problems.append(f"kernels never launched on the paged path: {missing}")
            if got["cache_bytes"] != PAGED_POOL_BYTES[kv]:
                problems.append(f"pool bytes {got['cache_bytes']} != {PAGED_POOL_BYTES[kv]}")
            # (b) the shared prefix, then the contiguous engine on it
            pre, preqs, _ = engine_run(torch, c, params, K.KERNELS, shared, first_alone=True)
            cont, creqs, _ = engine_run(torch, dataclasses.replace(c, kv_layout="contiguous"),
                                        params, K.KERNELS, shared, first_alone=True)
            pst = pre["paged"]
            shared_streams[kv] = [r.generated for r in preqs]
            equal = [r.generated == q.generated for r, q in zip(preqs, creqs)]
            shared_out = {k: pre[k] for k in ("ticks", "fused_ticks", "host_transfers",
                                              "wall_s", "tokens_per_s", "fused_tick_ms_mean",
                                              "decode_tick_ms_mean", "statuses", "paged")}
            shared_out.update({
                "prefill_tokens_saved": pst["prefix_hit_tokens"],
                "contiguous": {k: cont[k] for k in ("ticks", "fused_ticks", "wall_s",
                                                    "tokens_per_s")},
                "streams_equal_to_contiguous": sum(equal)})
            if not all(equal):
                i = equal.index(False)
                shared_out["first_divergence"] = {
                    "request": i, **divergence(torch, c, params, shared[i],
                                               preqs[i].generated, creqs[i].generated)}
                if shared_out["first_divergence"]["logit_gap_rel"] > LOGIT_REL_TOL:
                    problems.append(f"shared prefix: streams part with a logit gap over the "
                                    f"bar: {shared_out['first_divergence']}")
            if (pst["prefix_hits"] != ENGINE_REQUESTS - 1
                    or pst["prefix_hit_tokens"] != (ENGINE_REQUESTS - 1) * 512
                    or pst["cow_forks"] < ENGINE_REQUESTS - 1):
                problems.append(f"shared prefix: hits {pst['prefix_hits']}, hit tokens "
                                f"{pst['prefix_hit_tokens']}, forks {pst['cow_forks']}")
            if any(r.status.name != "OK" for r in preqs) or pre["host_transfers"] != pre["ticks"]:
                problems.append("shared prefix: a request not OK or more than one transfer a tick")
            got["shared_prefix"] = shared_out
            out[kv] = got
            if problems:
                emit(out)
                fail(f"paged_engine[{kv}]: " + "; ".join(problems))
    report["paged_engine"] = out
    emit(out)
    return counts_by_kv, shared_streams


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
# phases: the one-shot prefill and the per-request (legacy) engine
# ---------------------------------------------------------------------------


def prefill_phase(torch, cfg, params, report: dict) -> None:
    """prefill_bucketed at full width at each of PREFILL_SHAPES, through the
    kernels and through the plain versions on the same prompts: last-token
    logits within the bar, ms per prefill and added peak memory of each, and the
    kernels' launches (counters reset just before the timed prefill, read
    just after): 24 flash-attention launches, one per layer."""
    from repro_torch import kernels as K
    from repro_torch.serving import engine as E

    gen = torch.Generator(device="cuda").manual_seed(5)
    out = {"phase": "prefill", "model": cfg.name, "runs": []}
    problems = []
    with torch.inference_mode():
        for b, s in PREFILL_SHAPES:
            prompts = torch.randint(0, cfg.vocab_size, (b, s), generator=gen, device="cuda")
            run = {"batch": b, "prompt": s, "bucket": E.bucket_length(s, cfg.prefill_chunk_sizes)}
            logits = {}
            for name, kset in (("kernels", K.KERNELS), ("plain", K.PLAIN)):
                E.prefill_bucketed(params, cfg, prompts, kernels=kset)  # warm-up
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                resident = torch.cuda.memory_allocated()
                K.reset_launch_counts()
                t = time.perf_counter()
                last, _ = E.prefill_bucketed(params, cfg, prompts, kernels=kset)
                torch.cuda.synchronize()
                run[f"{name}_ms"] = (time.perf_counter() - t) * 1e3
                run[f"{name}_peak_extra_bytes"] = torch.cuda.max_memory_allocated() - resident
                if kset is K.KERNELS:
                    counts = K.launch_counts()
                logits[name] = last.float()
            lk, lp = logits["kernels"], logits["plain"]
            top2 = lp.topk(2, dim=-1).values
            picked = lp.gather(1, lk.argmax(-1, keepdim=True))[:, 0]
            run.update({
                "logit_max_abs_err": (lk - lp).abs().max().item(),
                "logit_max_abs": lp.abs().max().item(),
                "argmax_equal": bool(torch.equal(lk.argmax(-1), lp.argmax(-1))),
                "argmax_is_plain_argmax": bool(torch.equal(picked, top2[:, 0])),
                "min_top2_gap": (top2[:, 0] - top2[:, 1]).min().item(),
                "launch_counts": {n: c for n, c in counts.items() if c}})
            out["runs"].append(run)
            tag = f"{b}x{s}"
            if not torch.isfinite(lk).all():
                problems.append(f"{tag}: non-finite logits")
            if run["logit_max_abs_err"] > LOGIT_REL_TOL * run["logit_max_abs"]:
                problems.append(f"{tag}: logits differ by {run['logit_max_abs_err']} "
                                f"(max |logit| {run['logit_max_abs']})")
            if counts["flash_attention"] != cfg.n_layers:
                problems.append(f"{tag}: flash_attention launched {counts['flash_attention']} "
                                f"times in one prefill")
            missing = [n for n in ("norm_quant", "ternary_matmul", "ternary_swiglu")
                       if counts[n] <= 0]
            if missing:
                problems.append(f"{tag}: kernels never launched: {missing}")
            if (b, s) == PREFILL_SHAPES[-1]:  # where the long prefill's device time goes
                run["profile"] = profile_device(
                    torch, lambda: E.prefill_bucketed(params, cfg, prompts, kernels=K.KERNELS),
                    steps=2, warmup=1)
    report["prefill"] = out
    emit(out)
    if problems:
        fail("prefill: " + "; ".join(problems))


def legacy_engine_phase(torch, cfg, params, chunked_streams, report: dict) -> None:
    """The engine phase's workload with prefill="legacy", each cache dtype,
    through the kernels: each request's stream held to the port's own
    ``generate`` of that prompt alone (B = 1, the same kernels), and set
    beside the chunked engine's stream of the same request."""
    import dataclasses

    from repro_torch import kernels as K
    from repro_torch.serving import engine as E

    prompts = _engine_prompts(cfg)
    out = {"phase": "legacy_engine", "model": cfg.name, "slots": ENGINE_SLOTS,
           "max_len": ENGINE_MAX_LEN, "requests": ENGINE_REQUESTS, "max_new": ENGINE_NEW}
    with torch.inference_mode():
        for kv in ("bf16", "int8"):
            c = dataclasses.replace(cfg, kv_cache_dtype=kv)
            sfx = "_quant" if kv == "int8" else ""
            got, reqs, _ = engine_run(torch, c, params, K.KERNELS, prompts, prefill="legacy")
            counts = got["launch_counts"]
            streams = [r.generated for r in reqs]
            alone = [E.generate(params, c, torch.as_tensor(p, device="cuda")[None],
                                steps=ENGINE_NEW).tokens[0].tolist() for p in prompts]
            got["streams_equal_to_generate"] = sum(a == g for a, g in zip(streams, alone))
            parted = [i for i, (a, w) in enumerate(zip(streams, chunked_streams[kv])) if a != w]
            got["streams_equal_to_chunked"] = ENGINE_REQUESTS - len(parted)
            got["chunked_partings"] = [
                dict(request=i, **divergence(torch, c, params, prompts[i], streams[i],
                                             chunked_streams[kv][i])) for i in parted]
            out[kv] = got
            problems = []
            bad = [r.rid for r in reqs if r.status.name != "OK" or len(r.generated) != ENGINE_NEW]
            if bad:
                problems.append(f"requests not OK with {ENGINE_NEW} tokens: {bad}")
            if got["streams_equal_to_generate"] != ENGINE_REQUESTS:
                problems.append(f"{got['streams_equal_to_generate']} of {ENGINE_REQUESTS} "
                                "streams equal generate's")
            if got["host_transfers"] != got["ticks"] or got["fused_ticks"]:
                problems.append(f"{got['host_transfers']} transfers for {got['ticks']} ticks, "
                                f"{got['fused_ticks']} fused ticks")
            if counts["flash_attention"] != cfg.n_layers * ENGINE_REQUESTS:
                problems.append(f"flash_attention launched {counts['flash_attention']} times "
                                f"for {ENGINE_REQUESTS} requests")
            if counts["decode_attention" + sfx] != cfg.n_layers * got["ticks"]:
                problems.append(f"decode_attention{sfx} launched "
                                f"{counts['decode_attention' + sfx]} times in {got['ticks']} ticks")
            if counts["prefill_append" + sfx]:
                problems.append(f"prefill_append{sfx} launched on the legacy path")
            path = ("norm_quant", "ternary_gemv", "ternary_matmul", "ternary_swiglu")
            missing = [n for n in path if counts[n] <= 0]
            if missing:
                problems.append(f"kernels never launched on the legacy path: {missing}")
            far = [p for p in got["chunked_partings"] if p["logit_gap_rel"] > LOGIT_REL_TOL]
            if far:
                problems.append(f"streams part from the chunked engine's with a logit gap "
                                f"over the bar: {far}")
            if problems:
                emit(out)
                fail(f"legacy_engine[{kv}]: " + "; ".join(problems))
    report["legacy_engine"] = out
    emit(out)


# ---------------------------------------------------------------------------
# phases: speculative decoding
# ---------------------------------------------------------------------------


def _attention_sfx(layout: str, kv: str) -> str:
    """The attention wrappers' suffix for a layout and a cache dtype."""
    return ("_paged" if layout == "paged" else "") + ("_quant" if kv == "int8" else "")


def _spec_count_problems(counts, st, n_layers: int, sfx: str) -> list[str]:
    """A spec tick launches one prefill-append a layer for the verify and,
    with a prompt chunk, one more; decode attention runs only in the ticks
    that are not speculative; no attention wrapper of another layout or
    cache dtype runs."""
    problems = []
    want_pa = n_layers * (st["spec_ticks"] + st["fused_ticks"])
    if counts["prefill_append" + sfx] != want_pa:
        problems.append(f"prefill_append{sfx} launched {counts['prefill_append' + sfx]} times, "
                        f"not {want_pa} ({st['spec_ticks']} spec ticks, {st['fused_ticks']} "
                        "with a chunk)")
    want_da = n_layers * (st["ticks"] - st["spec_ticks"])
    if counts["decode_attention" + sfx] != want_da:
        problems.append(f"decode_attention{sfx} launched {counts['decode_attention' + sfx]} "
                        f"times, not {want_da}")
    others = {n: v for n, v in counts.items() if v and n.startswith(
        ("prefill_append", "decode_attention")) and n not in (
        "prefill_append" + sfx, "decode_attention" + sfx)}
    if others:
        problems.append(f"attention wrappers of another layout or cache dtype ran: {others}")
    if st["spec_ticks"] <= 0:
        problems.append("no speculative tick ran")
    return problems


def spec_engine_smoke_phase(torch, report: dict) -> None:
    """The f32 smoke config in ServingEngine(speculative=True), each cache
    dtype and layout, five ragged prompts and a tiled phrase: through the
    kernels on the card, the same streams, statuses and per-request drafted
    and accepted counts as through the plain versions on the CPU, and the
    same streams as the engine without speculation on the card; the tiled
    phrase's drafts accepted above 0.2; one host transfer per tick; the
    verify through the prefill-append kernel of the layout and dtype."""
    import dataclasses

    import numpy as np

    from repro_torch import kernels as K
    from repro_torch.configs import get_config
    from repro_torch.core import params as PR
    from repro_torch.models import transformer as Tr
    from repro_torch.serving import engine as E

    base = dataclasses.replace(get_config("tellme-0.7b", smoke=True), dtype=torch.float32)
    specs = Tr.param_specs(base)
    cpu_params = Tr.pack_tree(PR.init_params(specs, seed=0, device="cpu"), specs,
                              dtype=base.dtype)
    cuda_params = _to_cuda(cpu_params)
    rng = np.random.default_rng(9)
    prompts = [rng.integers(0, base.vocab_size, n) for n in (9, 30, 70, 130, 200)]
    prompts.append(np.tile(rng.integers(0, base.vocab_size, 7), 9))
    out = {"phase": "spec_engine_smoke"}
    for layout in ("contiguous", "paged"):
        for kv in ("bf16", "int8"):
            cfg = dataclasses.replace(base, kv_cache_dtype=kv, kv_layout=layout)
            runs = []
            for params, kset, device, spec in ((cuda_params, K.KERNELS, None, True),
                                               (cpu_params, K.PLAIN, "cpu", True),
                                               (cuda_params, K.KERNELS, None, False)):
                eng = E.ServingEngine(params, cfg, slots=2, max_len=256, kernels=kset,
                                      device=device, speculative=spec)
                reqs = [E.Request(rid=i, prompt=p, max_new=16) for i, p in enumerate(prompts)]
                for r in reqs:
                    eng.submit(r)
                K.reset_launch_counts()
                eng.run()
                runs.append(([(r.generated, r.status.name, r.spec_drafted, r.spec_accepted)
                              for r in reqs], eng.stats(), K.launch_counts()))
            (got, st, counts), (want, _, _), (plain, _, _) = runs
            tiled = got[-1][3] / max(got[-1][2], 1)
            res = {"streams_equal_cpu": sum(a[0] == b[0] for a, b in zip(got, want)),
                   "counts_equal_cpu": got == want,
                   "streams_equal_plain_engine": sum(a[0] == b[0] for a, b in zip(got, plain)),
                   "ticks": st["ticks"], "spec_ticks": st["spec_ticks"],
                   "host_transfers": st["host_transfers"],
                   "spec_acceptance": st["spec_acceptance"], "tiled_phrase_acceptance": tiled,
                   "drafted_accepted": [g[2:] for g in got]}
            out[f"{layout} {kv}"] = res
            problems = _spec_count_problems(counts, st, base.n_layers, _attention_sfx(layout, kv))
            if got != want:
                problems.append("streams, statuses or drafted/accepted counts differ from the "
                                "CPU's")
            if [g[:2] for g in got] != [p[:2] for p in plain]:
                problems.append("streams differ from the engine without speculation")
            if st["host_transfers"] != st["ticks"]:
                problems.append(f"{st['host_transfers']} transfers for {st['ticks']} ticks")
            if not tiled > 0.2:
                problems.append(f"the tiled phrase's acceptance is {tiled}")
            if problems:
                emit(out)
                fail(f"spec_engine_smoke[{layout}, {kv}]: " + "; ".join(problems))
    report["spec_engine_smoke"] = out
    emit(out)


def _repetitive_prompts(cfg):
    """8 prompts, each a random phrase of 6-12 tokens tiled to 100-400."""
    import numpy as np

    rng = np.random.default_rng(2)
    out = []
    for _ in range(REPEAT_REQUESTS):
        phrase = rng.integers(0, cfg.vocab_size, int(rng.integers(6, 13)))
        out.append(np.resize(phrase, int(rng.integers(100, 401))))
    return out


def verify_step_check(torch, cfg, params) -> dict:
    """One full-width verify_chunk_step at ``VERIFY_FRONTIERS`` from shared
    caches (a 1024-token prompt per slot prefilled through the kernels, so
    the rows past each frontier hold stale prompt rows), each slot's chunk
    its current token and the greedy continuation of five teacher-forced
    kernel decode steps. Held: kernel logits against plain within
    LOGIT_REL_TOL of max |logit|; kernel verify row j against the kernel's
    decode step j within the same bar, the argmax equal or a near-tie
    reported with its gap; every layer's cache after the kernel verify equal,
    byte for byte, to the plain append of the K/V rows that verify computed
    (the rows at [pos, pos + 5) written, every other row untouched).
    Reported: layer 0's rows against the plain verify's."""
    import dataclasses

    from repro_torch import kernels as K
    from repro_torch.kernels.prefill_append import ref as pa_ref
    from repro_torch.models import transformer as Tr
    from repro_torch.serving import engine as E

    dev = torch.device("cuda")
    b, c = len(VERIFY_FRONTIERS), VERIFY_C
    pos = torch.tensor(VERIFY_FRONTIERS, dtype=torch.int32, device=dev)
    gen = torch.Generator(device=dev).manual_seed(5)
    prompt = torch.randint(0, cfg.vocab_size, (b, ENGINE_MAX_LEN), generator=gen, device=dev)
    m = ENGINE_MAX_LEN + 256

    def copy(caches):
        return {"blocks": {n: {k: v.clone() for k, v in leaves.items()}
                           for n, leaves in caches["blocks"].items()}}

    out = {}
    for kv in ("bf16", "int8"):
        c_kv = dataclasses.replace(cfg, kv_cache_dtype=kv)
        _, caches = Tr.forward(params, prompt, c_kv, kernels=K.KERNELS, collect_cache=True)
        caches = E.fit_caches(caches, c_kv, m)
        dec = copy(caches)
        tok = prompt.gather(1, pos.to(torch.int64)[:, None])[:, 0]
        seq, dec_logits = [tok], []
        for j in range(c):
            lg, _ = Tr.decode_step(params, seq[-1][:, None], dec, pos + j, c_kv,
                                   kernels=K.KERNELS)
            dec_logits.append(lg.float())
            seq.append(torch.argmax(lg, -1))
        chunk = torch.stack(seq[:c], dim=1)
        rows = []  # (k_new, v_new) each layer, as the kernel verify computed them

        def capture(q, k_new, v_new, *a, **kw):
            rows.append((k_new.clone(), v_new.clone()))
            return K.KERNELS.prefill_append(q, k_new, v_new, *a, **kw)

        kset = dataclasses.replace(K.KERNELS, prefill_append=capture)
        before = copy(caches)
        kc, pc = copy(caches), copy(caches)
        lk, _ = Tr.verify_chunk_step(params, chunk, kc, pos, c_kv, kernels=kset,
                                     prefix_limit=ENGINE_MAX_LEN)
        lp, _ = Tr.verify_chunk_step(params, chunk, pc, pos, c_kv, kernels=K.PLAIN,
                                     prefix_limit=ENGINE_MAX_LEN)
        lk, lp = lk.float(), lp.float()
        scale = lp.abs().max().item()
        ref_caches = before["blocks"]["b0"]
        for li, (k_new, v_new) in enumerate(rows):
            layer = {n: t[li] for n, t in ref_caches.items()}
            if kv == "int8":
                pa_ref.append_kv_cache_quant(layer["k"], layer["v"], layer["k_scale"],
                                             layer["v_scale"], k_new, v_new, pos)
            else:
                pa_ref.append_kv_cache(layer["k"], layer["v"], k_new, v_new, pos)
        kb = kc["blocks"]["b0"]
        bytes_equal = len(rows) == cfg.n_layers and all(
            torch.equal(_bits(torch, kb[n]), _bits(torch, ref_caches[n])) for n in kb)
        pb = pc["blocks"]["b0"]
        layer0 = all(torch.equal(_bits(torch, kb[n][0]), _bits(torch, pb[n][0])) for n in kb)
        rows_vs_decode, near_ties = [], []
        for j in range(c):
            d = (lk[:, j] - dec_logits[j]).abs().max().item()
            rows_vs_decode.append(d)
            a_v, a_d = lk[:, j].argmax(-1), dec_logits[j].argmax(-1)
            for s in torch.nonzero(a_v != a_d)[:, 0].tolist():
                row = dec_logits[j][s]
                near_ties.append({"slot": s, "row": j, "tokens": [int(a_v[s]), int(a_d[s])],
                                  "decode_logit_gap_rel": (row[a_d[s]] - row[a_v[s]]).item()
                                  / row.abs().max().item()})
        res = {"logit_max_abs_err_vs_plain": (lk - lp).abs().max().item(),
               "logit_max_abs": scale,
               "rows_vs_decode_max_abs": rows_vs_decode,
               "argmax_partings_vs_decode": near_ties,
               "accepted_of_4": [int(x) for x in
                                 (torch.argmax(lk[:, :c - 1], -1) == chunk[:, 1:]).to(
                                     torch.int32).cumprod(1).sum(1).tolist()],
               "cache_bytes_equal_plain_append": bytes_equal,
               "layer0_rows_equal_plain_verify": layer0}
        out[kv] = res
        problems = []
        if res["logit_max_abs_err_vs_plain"] > LOGIT_REL_TOL * scale:
            problems.append(f"kernel vs plain logits differ by {res['logit_max_abs_err_vs_plain']}")
        if max(rows_vs_decode) > LOGIT_REL_TOL * scale:
            problems.append(f"verify rows vs decode steps differ by {rows_vs_decode}")
        if any(t["decode_logit_gap_rel"] > LOGIT_REL_TOL for t in near_ties):
            problems.append(f"argmax parts from the decode step's over the bar: {near_ties}")
        if not bytes_equal:
            problems.append("the cache after the kernel verify is not the plain append of its "
                            "rows")
        if problems:
            return {**out, "problems": [f"{kv}: " + p for p in problems]}
        del caches, dec, kc, pc, before
    return out


def spec_engine_phase(torch, cfg, params, plain_streams, report: dict) -> dict:
    """The full-width ServingEngine(speculative=True), gamma = 4, through
    the kernels: (a) the engine phase's ragged workload for each cache
    dtype, contiguous and paged; every request OK with 32 tokens, one host
    transfer per tick, the launch counts of a spec tick, 0 <= accepted <=
    drafted, paged streams equal to contiguous ones; set beside the engine
    without speculation (the engine and paged_engine phases of this call),
    with agreement with its streams and, where one parts, the logit gap of
    the two tokens (``divergence``; reported, not held: the verify's and
    decode's attention round bf16 differently); (b) a repetitive workload,
    speculative and not (contiguous, bf16); (c) ``verify_step_check``.
    Returns the launch counts of (a) by (layout, cache dtype)."""
    import dataclasses

    from repro_torch import kernels as K

    prompts = _engine_prompts(cfg)
    out = {"phase": "spec_engine", "model": cfg.name, "slots": ENGINE_SLOTS,
           "max_len": ENGINE_MAX_LEN, "requests": ENGINE_REQUESTS, "max_new": ENGINE_NEW,
           "gamma": cfg.spec_gamma}
    counts_by, spec_streams = {}, {}
    keep = ("ticks", "fused_ticks", "wall_s", "tokens_per_s", "fused_tick_ms_mean",
            "decode_tick_ms_mean")
    with torch.inference_mode():
        for layout in ("contiguous", "paged"):
            for kv in ("bf16", "int8"):
                c = dataclasses.replace(cfg, kv_cache_dtype=kv, kv_layout=layout,
                                        kv_page_size=PAGE_SIZE)
                sfx = _attention_sfx(layout, kv)
                got, reqs, _ = engine_run(torch, c, params, K.KERNELS, prompts, speculative=True)
                counts = got["launch_counts"]
                counts_by[(layout, kv)] = counts
                streams = [r.generated for r in reqs]
                problems = _spec_count_problems(counts, got, cfg.n_layers, sfx)
                bad = [r.rid for r in reqs
                       if r.status.name != "OK" or len(r.generated) != ENGINE_NEW]
                if bad:
                    problems.append(f"requests not OK with {ENGINE_NEW} tokens: {bad}")
                if got["host_transfers"] != got["ticks"]:
                    problems.append(f"{got['host_transfers']} transfers for {got['ticks']} "
                                    "ticks")
                if not all(0 <= r.spec_accepted <= r.spec_drafted for r in reqs):
                    problems.append("accepted drafts outside [0, drafted]")
                if layout == "paged":
                    got["streams_equal_to_contiguous"] = sum(
                        a == b for a, b in zip(streams, spec_streams[kv]))
                    if got["streams_equal_to_contiguous"] != ENGINE_REQUESTS:
                        problems.append(f"{got['streams_equal_to_contiguous']} of "
                                        f"{ENGINE_REQUESTS} paged streams equal the "
                                        "contiguous ones")
                    plain = report["paged_engine"][kv]
                else:
                    spec_streams[kv] = streams
                    plain = report["engine"][kv]
                    parted = [i for i, (a, w) in enumerate(zip(streams, plain_streams[kv]))
                              if a != w]
                    got["streams_equal_to_plain_engine"] = ENGINE_REQUESTS - len(parted)
                    got["plain_engine_partings"] = [
                        dict(request=i, **divergence(torch, c, params, prompts[i], streams[i],
                                                     plain_streams[kv][i])) for i in parted]
                got["plain_engine"] = {k: plain[k] for k in keep}
                out[f"{layout} {kv}"] = got
                if problems:
                    emit(out)
                    fail(f"spec_engine[{layout}, {kv}]: " + "; ".join(problems))
        # (b) a repetitive workload, with and without speculation
        c = dataclasses.replace(cfg, kv_cache_dtype="bf16")
        rep = _repetitive_prompts(cfg)
        spec_b, sreqs, _ = engine_run(torch, c, params, K.KERNELS, rep, speculative=True,
                                      max_new=REPEAT_NEW)
        plain_b, preqs, _ = engine_run(torch, c, params, K.KERNELS, rep, max_new=REPEAT_NEW)
        out["repetitive"] = {
            "prompt_lengths": [len(p) for p in rep], "max_new": REPEAT_NEW,
            "spec": {k: spec_b[k] for k in keep + (
                "spec_ticks", "spec_tick_ms_mean", "spec_mixed_tick_ms_mean",
                "spec_acceptance", "tokens_per_spec_tick", "spec_drafted", "spec_accepted",
                "statuses")},
            "plain": {k: plain_b[k] for k in keep + ("statuses",)},
            "streams_equal": sum(a.generated == b.generated for a, b in zip(sreqs, preqs))}
        # (c) one verify step at the eight frontiers
        out["verify_step"] = verify_step_check(torch, cfg, params)
        if out["verify_step"].get("problems"):
            emit(out)
            fail("spec_engine[verify_step]: " + "; ".join(out["verify_step"]["problems"]))
    for key in [k for k in out if k.startswith(("contiguous", "paged"))]:
        for lst in ("fused_tick_ms", "decode_tick_ms", "spec_tick_ms", "spec_mixed_tick_ms"):
            out[key].pop(lst, None)  # the means stay
    report["spec_engine"] = out
    emit(out)
    return counts_by


# ---------------------------------------------------------------------------
# phases: fault injection and containment in the engine
# ---------------------------------------------------------------------------


def _fault_plan(faults):
    from repro_torch.serving import resilience as R

    return R.FaultPlan(faults=tuple(R.Fault(**f) for f in faults))


def _fault_events(eng) -> list:
    """The engine's events without the wall-clock straggler entries."""
    return [e for e in eng.events if e["kind"] != "straggler"]


def _guarded_run(eng, reqs) -> str | None:
    """Submit and serve ``reqs`` to the end; the error's text if ``step()``
    raised, else None."""
    for r in reqs:
        eng.submit(r)
    try:
        eng.run()
    except Exception as exc:  # noqa: BLE001 -- step() raising is the failed hold
        return f"{type(exc).__name__}: {exc}"
    return None


def fault_engine_smoke_phase(torch, report: dict) -> None:
    """The f32 smoke config under ``FAULT_SMOKE_PLAN`` (NaN on slot 0,
    cache_growth on slot 1, a raising tick, a 0.05 s slow tick), each cache
    dtype, the plain engine and the speculative one with drafter_garbage
    over every tick: through the kernels on the card, the same streams,
    statuses, status details and event kinds (straggler events dropped) as
    through the plain versions on the CPU; step() never raised, and every
    planned fault left its event."""
    import dataclasses

    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.core import params as PR
    from repro_torch.kernels import KERNELS, PLAIN
    from repro_torch.models import transformer as Tr
    from repro_torch.serving import engine as E

    base = dataclasses.replace(get_config("tellme-0.7b", smoke=True), dtype=torch.float32,
                               spec_disable_after=8, spec_min_acceptance=0.3)
    specs = Tr.param_specs(base)
    cpu_params = Tr.pack_tree(PR.init_params(specs, seed=0, device="cpu"), specs,
                              dtype=base.dtype)
    cuda_params = _to_cuda(cpu_params)
    rng = np.random.default_rng(7)
    prompts = [rng.integers(0, base.vocab_size, n) for n in (9, 30, 70, 130, 200)]
    out = {"phase": "fault_engine_smoke", "plan": FAULT_SMOKE_PLAN}
    for kv in ("bf16", "int8"):
        cfg = dataclasses.replace(base, kv_cache_dtype=kv)
        for spec in (False, True):
            faults = FAULT_SMOKE_PLAN + ([dict(kind="drafter_garbage", tick=0, repeat=10**6)]
                                         if spec else [])
            want_kinds = {"quarantine", "cache_growth_fault", "tick_failure",
                          "slow_tick_fault"} | ({"spec_disabled"} if spec else set())
            runs = []
            for params, kset, device in ((cuda_params, KERNELS, None),
                                         (cpu_params, PLAIN, "cpu")):
                eng = E.ServingEngine(params, cfg, slots=2, max_len=256, kernels=kset,
                                      device=device, speculative=spec,
                                      fault_plan=_fault_plan(faults))
                reqs = [E.Request(rid=i, prompt=p, max_new=8) for i, p in enumerate(prompts)]
                raised = _guarded_run(eng, reqs)
                runs.append(([(r.generated, r.status.name, r.status_detail) for r in reqs],
                             [e["kind"] for e in _fault_events(eng)], raised, eng.stats()))
            (got, kinds, raised, st), (want, want_k, cpu_raised, _) = runs
            key = f"{kv} {'speculative' if spec else 'plain'}"
            out[key] = {"streams_equal": got == want, "event_kinds": kinds,
                        "statuses": st["statuses"], "ticks": st["ticks"],
                        "host_transfers": st["host_transfers"]}
            problems = []
            if raised or cpu_raised:
                problems.append(f"step() raised: card {raised}, CPU {cpu_raised}")
            if got != want:
                problems.append("streams, statuses or details differ from the CPU's")
            if kinds != want_k:
                problems.append(f"event kinds {kinds} differ from the CPU's {want_k}")
            if not want_kinds <= set(kinds):
                problems.append(f"planned faults left no event: {want_kinds - set(kinds)}")
            if problems:
                emit(out)
                fail(f"fault_engine_smoke[{key}]: " + "; ".join(problems))
    report["fault_engine_smoke"] = out
    emit(out)


def fault_engine_phase(torch, cfg, params, eng_streams, report: dict) -> None:
    """Full-width tellme-0.7b on the engine phase's workload under faults,
    through the kernels: (a) contiguous bf16 under ``FAULT_PLAN`` (NaN on
    one slot mid-decode, cache_growth on another, a raising tick with 8
    live slots, a 0.25 s slow tick after the straggler monitor's warm-up):
    the hit slot QUARANTINED with guard_flag=1, the raising tick's live
    requests (at least 4) and no other FAILED, the exhausted and FAILED
    requests' tokens a prefix of their engine-phase stream, every request
    that ended OK equal to it (those admitted after the raising tick
    among them), the tick_failure event, consecutive_tick_failures back
    to 0, the slow tick's straggler event, one host transfer per tick that
    ran, no slot live just after the raising tick; that tick's ms (its
    admission, the raise, the FAILED endings and the rebuild of the
    cache, synchronised at both ends), and its peak allocation beyond
    what was resident before it under half the cache's bytes (the old
    cache is freed before the new one is made); (b) the same on
    the paged int8 layout, with the rebuilt pool's page statistics equal
    to a fresh pool's; (c) speculative contiguous bf16 with drafter_garbage
    on every tick: one spec_disabled event below spec_min_acceptance,
    every request OK with 32 tokens, agreement with the plain streams
    reported (the verify runs prefill-append where decode runs decode
    attention, so near-ties may part them); (d) a plan that never fires,
    between two runs without one: streams equal to the engine phase's, the
    same launches of every kernel, tokens/s of each run."""
    import dataclasses

    from repro_torch import kernels as K
    from repro_torch.serving import resilience as R
    from repro_torch.serving.paging import PagedKV

    prompts = _engine_prompts(cfg)
    out = {"phase": "fault_engine", "model": cfg.name, "slots": ENGINE_SLOTS,
           "max_len": ENGINE_MAX_LEN, "requests": ENGINE_REQUESTS, "max_new": ENGINE_NEW,
           "plan": FAULT_PLAN}
    by_tick = {f["kind"]: f for f in FAULT_PLAN}
    keep = ("ticks", "fused_ticks", "host_transfers", "statuses", "wall_s", "tokens",
            "tokens_per_s", "fused_tick_ms_mean", "decode_tick_ms_mean")
    with torch.inference_mode():
        for key, layout, kv in (("a", "contiguous", "bf16"), ("b", "paged", "int8")):
            c = dataclasses.replace(cfg, kv_cache_dtype=kv, kv_layout=layout,
                                    kv_page_size=PAGE_SIZE)
            got, reqs, eng = engine_run(torch, c, params, K.KERNELS, prompts,
                                        engine_kw={"fault_plan": _fault_plan(FAULT_PLAN)})
            rebuilds = got["containments"]
            want = eng_streams[kv]
            events = eng.events
            st = eng.stats()
            problems = []
            quar = [e for e in events if e["kind"] == "quarantine"]
            if ([(e["tick"], e["slot"], e["flag"]) for e in quar]
                    != [(by_tick["nan"]["tick"], by_tick["nan"]["slot"], R.GUARD_LOGITS)]):
                problems.append(f"quarantine events {quar}")
            else:
                hit = reqs[quar[0]["rid"]]
                if (hit.status.name, hit.status_detail) != (
                        "QUARANTINED", f"guard_flag={R.GUARD_LOGITS}"):
                    problems.append(f"the NaN slot's request ended {hit.status.name} "
                                    f"({hit.status_detail})")
            grown = [e for e in events if e["kind"] == "cache_growth_fault"]
            if [(e["tick"], e["slot"]) for e in grown] != [
                    (by_tick["cache_growth"]["tick"], by_tick["cache_growth"]["slot"])]:
                problems.append(f"cache_growth events {grown}")
            failed_tick = [e["tick"] for e in events if e["kind"] == "tick_failure"]
            if failed_tick != [by_tick["tick_exception"]["tick"]]:
                problems.append(f"tick_failure at ticks {failed_tick}")
            slow = by_tick["slow_tick"]["tick"]
            if not any(e["kind"] == "straggler" and e["tick"] == slow for e in events):
                problems.append(f"no straggler event at the slow tick {slow}")
            failed = [r.rid for r in reqs if r.status.name == "FAILED"]
            ended = sorted(rebuilds[0]["ended"]) if rebuilds else []
            live_after = rebuilds[0]["live_after"] if rebuilds else None
            if failed != ended or len(failed) < 4 or live_after != 0:
                problems.append(f"FAILED requests {failed}, ended by the raising tick {ended}, "
                                f"slots live after it {live_after}")
            not_prefix = [r.rid for r in reqs if r.status.name != "OK"
                          and r.generated != want[r.rid][:len(r.generated)]]
            ok_parted = [r.rid for r in reqs
                         if r.status.name == "OK" and r.generated != want[r.rid]]
            if not_prefix:
                problems.append(f"tokens not a prefix of the fault-free stream: {not_prefix}")
            if ok_parted:
                problems.append(f"OK streams differ from the engine phase's: {ok_parted}")
            after = rebuilds[0]["queued"] if rebuilds else []
            if not after or any(reqs[i].status.name != "OK" for i in after):
                problems.append(f"requests admitted after the raising tick: {after}, statuses "
                                f"{[reqs[i].status.name for i in after]}")
            if st["consecutive_tick_failures"] != 0:
                problems.append(f"consecutive_tick_failures {st['consecutive_tick_failures']}")
            if st["host_transfers"] != st["ticks"] - len(failed_tick):
                problems.append(f"{st['host_transfers']} transfers for {st['ticks']} ticks, "
                                f"{len(failed_tick)} of them failed")
            if len(rebuilds) != 1:
                problems.append(f"{len(rebuilds)} containments")
            elif rebuilds[0]["peak_extra_bytes"] >= got["cache_bytes"] // 2:
                problems.append(f"the rebuild held {rebuilds[0]['peak_extra_bytes']} bytes "
                                f"beside the {got['cache_bytes']} of the old cache")
            res = {k: got[k] for k in keep}
            res.update(kv_layout=layout, kv_cache_dtype=kv, event_kinds=sorted(
                {e["kind"] for e in events}), failed=failed, admitted_after=after,
                straggler=st["straggler"], contained_tick_ms=[r["ms"] for r in rebuilds],
                peak_extra_bytes=[r["peak_extra_bytes"] for r in rebuilds],
                cache_bytes=got["cache_bytes"])
            if layout == "paged" and rebuilds:
                fresh = PagedKV(slots=eng.slots, cache_len=eng.cache_len,
                                page_size=eng.paged.page_size, num_pages=eng.paged.num_pages,
                                prefix_cache=eng.paged.prefix_cache).stats()
                res["rebuilt_pool_equals_fresh"] = rebuilds[0]["paged"] == fresh
                if not res["rebuilt_pool_equals_fresh"]:
                    problems.append(f"rebuilt pool {rebuilds[0]['paged']} is not a fresh "
                                    f"pool {fresh}")
            out[key] = res
            if problems:
                emit(out)
                fail(f"fault_engine[{key}, {layout} {kv}]: " + "; ".join(problems))
        # (c) speculation with garbage drafts on every tick
        c = dataclasses.replace(cfg, kv_cache_dtype="bf16")
        got, reqs, eng = engine_run(
            torch, c, params, K.KERNELS, prompts, speculative=True, engine_kw={
                "fault_plan": _fault_plan([dict(kind="drafter_garbage", tick=0, repeat=10**6)])})
        dis = [e for e in eng.events if e["kind"] == "spec_disabled"]
        bad = [r.rid for r in reqs if r.status.name != "OK" or len(r.generated) != ENGINE_NEW]
        out["c"] = {**{k: got[k] for k in keep}, "spec_disabled": dis,
                    "spec_ticks": eng.spec_ticks,
                    "streams_equal_to_plain": sum(r.generated == w for r, w in zip(
                        reqs, eng_streams["bf16"]))}
        problems = []
        if len(dis) != 1 or not dis[0]["acceptance"] < c.spec_min_acceptance:
            problems.append(f"spec_disabled events {dis}")
        if bad:
            problems.append(f"requests not OK with {ENGINE_NEW} tokens: {bad}")
        if problems:
            emit(out)
            fail("fault_engine[c, speculative drafter_garbage]: " + "; ".join(problems))
        # (d) a plan that never fires, between two runs without one
        idle = [dict(kind=k, tick=10**6) for k in R.FAULT_KINDS]
        runs = []
        for armed in (False, True, False):
            kw = {"fault_plan": _fault_plan(idle)} if armed else None
            got, reqs, _ = engine_run(torch, c, params, K.KERNELS, prompts, engine_kw=kw)
            runs.append((got, [r.generated for r in reqs]))
        (u1, s1), (a, sa), (u2, s2) = runs
        out["d"] = {"armed": {k: a[k] for k in keep}, "unarmed": [
            {k: u[k] for k in keep} for u in (u1, u2)]}
        problems = []
        if not sa == s1 == s2 == eng_streams["bf16"]:
            problems.append("streams differ from the engine phase's")
        if not (a["launch_counts"] == u1["launch_counts"] == u2["launch_counts"]
                and a["ticks"] == u1["ticks"] == u2["ticks"]):
            problems.append(f"launches {a['launch_counts']} in {a['ticks']} ticks armed, "
                            f"{u1['launch_counts']} in {u1['ticks']} unarmed")
        if problems:
            emit(out)
            fail("fault_engine[d, armed idle plan]: " + "; ".join(problems))
    report["fault_engine"] = out
    emit(out)


# ---------------------------------------------------------------------------
# phases: the replica pool and the HTTP/SSE front door (A11b)
# ---------------------------------------------------------------------------


class _Sink:
    """A pool sink that keeps every push with its time (time.perf_counter)."""

    def __init__(self):
        self.items, self.times = [], []

    def push(self, item):
        self.items.append(item)
        self.times.append(time.perf_counter())

    @property
    def tokens(self) -> list:
        return [t for it in self.items if it[0] == "tokens" for t in it[1]]

    @property
    def finals(self) -> list:
        return [it for it in self.items if it[0] == "final"]


def _pool_until(pool, pred, what: str, timeout_s: float, each=None) -> None:
    """poll() until ``pred()``; ``each()`` after every poll; fails past the
    timeout."""
    t0 = time.perf_counter()
    while True:
        pool.poll()
        if each is not None:
            each()
        if pred():
            return
        if time.perf_counter() - t0 > timeout_s:
            errors = [repr(r.driver.error) for r in pool.replicas]
            fail(f"timed out after {timeout_s} s waiting for {what}; driver errors {errors}: "
                 f"{pool.stats()}")
        time.sleep(0.001)


def pool_smoke_phase(torch, report: dict) -> None:
    """The f32 smoke pool of two replicas (default warmup) under a
    replica_crash on replica 0, through the kernels on the card and through
    the plain versions on the CPU: equal streams and terminal events, every
    request OK, at least one migrated."""
    import dataclasses

    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.core import params as PR
    from repro_torch.kernels import KERNELS, PLAIN
    from repro_torch.models import transformer as Tr
    from repro_torch.serving import engine as E
    from repro_torch.serving import resilience as R
    from repro_torch.serving.pool import ReplicaPool

    cfg = dataclasses.replace(get_config("tellme-0.7b", smoke=True), dtype=torch.float32,
                              pool_backoff_s=0.1, pool_hang_timeout_s=300.0)
    specs = Tr.param_specs(cfg)
    cpu_params = Tr.pack_tree(PR.init_params(specs, seed=0, device="cpu"), specs,
                              dtype=cfg.dtype)
    cuda_params = _to_cuda(cpu_params)
    rng = np.random.default_rng(12)
    prompts = [rng.integers(0, cfg.vocab_size, n) for n in (40, 70, 30, 17, 25, 55)]
    plan = R.FaultPlan(faults=(R.Fault(**POOL_SMOKE_CRASH),))
    runs = []
    for params, kset, device in ((cuda_params, KERNELS, None), (cpu_params, PLAIN, "cpu")):
        pool = ReplicaPool(lambda idx: E.ServingEngine(params, cfg, slots=2, max_len=192,
                                                       kernels=kset, device=device),
                           cfg, replicas=2, fault_plan=plan)
        pool.start(supervise=False)
        try:
            _pool_until(pool, lambda: all(r.state == "ready" for r in pool.replicas),
                        "the smoke replicas", 300)
            sinks = [_Sink() for _ in prompts]
            for p, s in zip(prompts, sinks):
                pool.submit(p, max_new=10, sink=s)
            _pool_until(pool, pool.idle, "the smoke pool", 300)
            runs.append(([(s.tokens, s.finals) for s in sinks], pool.stats()))
        finally:
            pool.stop()
    (got, st), (want, cpu_st) = runs
    out = {"phase": "pool_smoke", "plan": POOL_SMOKE_CRASH, "streams_equal": got == want,
           "migrated": [st["migrated_total"], cpu_st["migrated_total"]],
           "statuses": st["statuses"]}
    report["pool_smoke"] = out
    emit(out)
    if (got != want or st["statuses"] != {"OK": len(prompts)} or st["migrated_total"] < 1
            or any(len(f) != 1 for _, f in got)):
        fail(f"pool_smoke: card vs CPU streams equal {got == want}, statuses "
             f"{st['statuses']}, migrated {st['migrated_total']}")


def pool_run(torch, cfg, params, prompts, *, plan=None, cfg_kw=None, clock=None,
             each=None) -> tuple[dict, list, dict, object]:
    """Serve ``prompts`` (ENGINE_NEW tokens each) on a ReplicaPool of
    POOL_REPLICAS full-width engines over one params tree (slots, max_len and
    eos as the engine phase's), driven by this thread's poll() every
    millisecond. The replicas warm up (the default: one request each through
    the kernels) before the launch counters are reset; they are read when
    the pool is idle. ``each(pool)`` runs after every poll. Returns
    (measurements, sinks, the pool's stream records by request index, the
    pool, still running: the caller stops it)."""
    import dataclasses

    from repro_torch import kernels as K
    from repro_torch.serving import engine as E
    from repro_torch.serving.pool import ReplicaPool

    c = dataclasses.replace(cfg, **(cfg_kw or {}))
    pool = ReplicaPool(lambda idx: E.ServingEngine(params, c, slots=ENGINE_SLOTS,
                                                   max_len=ENGINE_MAX_LEN, kernels=K.KERNELS,
                                                   eos_id=-1),
                       c, replicas=POOL_REPLICAS, fault_plan=plan,
                       clock=clock or time.monotonic)
    pool.start(supervise=False)
    _pool_until(pool, lambda: all(r.state == "ready" for r in pool.replicas),
                "the replicas' warmup", 300)
    torch.cuda.synchronize()
    K.reset_launch_counts()
    sinks = [_Sink() for _ in prompts]
    seen = {"migrated_at": None, "states": set()}
    t0 = time.perf_counter()
    rids = [pool.submit(p, max_new=ENGINE_NEW, sink=s) for p, s in zip(prompts, sinks)]
    streams = {i: pool._streams[rid] for i, rid in enumerate(rids)}

    def watch():
        if seen["migrated_at"] is None and pool.migrated_total:
            seen["migrated_at"] = time.perf_counter()
        seen["states"] |= {(r.idx, r.state) for r in pool.replicas}
        if each is not None:
            each(pool)

    _pool_until(pool, pool.idle, "the pool to serve the workload", 600, watch)
    wall = time.perf_counter() - t0
    counts = K.launch_counts()
    st = pool.stats()
    tokens = sum(len(s.tokens) for s in sinks)
    firsts = sorted((s.times[0] - t0) * 1e3 for s in sinks if s.tokens)
    per = [{k: r[k] for k in ("replica_id", "state", "crashes", "restarts")}
           | {"ticks": r["engine"]["ticks"] if r["engine"] else None,
              "straggler_events": (r["engine"]["straggler"]["straggler_events"]
                                   if r["engine"] else None)}
           for r in st["per_replica"]]
    return ({"wall_s": wall, "tokens": tokens, "tokens_per_s": tokens / wall,
             "statuses": st["statuses"], "migrated_total": st["migrated_total"],
             "first_token_ms": firsts, "per_replica": per, "launch_counts": counts,
             "drained_replicas": sorted({i for i, s in seen["states"]
                                         if s in ("draining", "quarantined")}),
             "t0": t0, "migrated_at": seen["migrated_at"]},
            sinks, streams, pool)


def _delivery_problems(sinks, streams) -> list[str]:
    """Exactly-once delivery: each sink's tokens are its request's final
    stream (ENGINE_NEW tokens), with one final event ``OK`` of that count."""
    bad = []
    for i, s in enumerate(sinks):
        gen = [int(t) for t in streams[i].req.generated]
        if (s.tokens != gen or len(gen) != ENGINE_NEW
                or s.finals != [("final", "OK", None, ENGINE_NEW)]):
            bad.append(i)
    return [f"delivery not exactly once or not OK: {bad}"] if bad else []


def _resume_ms(res, sinks, streams) -> list:
    """Per migrated stream: ms from the failover (the poll that requeued it)
    to its first token after it, and its longest gap between tokens."""
    t = res["migrated_at"]
    out = []
    for i, s in enumerate(sinks):
        if streams[i].req.migrations:
            after = [x for x, it in zip(s.times, s.items) if it[0] == "tokens" and x >= t]
            gaps = [b - a for a, b in zip(s.times, s.times[1:])]
            out.append({"request": i, "resume_ms": (after[0] - t) * 1e3 if after else None,
                        "max_gap_ms": max(gaps) * 1e3 if gaps else None})
    return out


def pool_phase(torch, cfg, params, eng_streams, report: dict) -> None:
    """tellme-0.7b at full width: a pool of POOL_REPLICAS engines (8 slots,
    max_len 1024, bf16 contiguous cache each) over one params tree, on the
    engine phase's 16-request ragged workload. (a) fault-free: every
    request OK, streams equal to the engine phase's, every kernel of the
    engine's path launched (threads share the counters, so > 0 is held);
    tokens/s beside the engine phase's, straggler events, drains. (b) a
    replica_crash on replica 0 at its tick POOL_CRASH_TICK, the straggler
    gate off: every request OK, at least one migrated, delivery exactly once,
    streams that were not migrated equal to the engine phase's, a migrated
    stream's parting reported with the gap of its two tokens; then, on a
    clock moved past the backoff, the restart from the factory and the
    probe bring replica 0 back to ready, and the peak bytes allocated
    beyond what was resident while it restarts (the dead engine's caches
    live until then). (c) a replica_hang of POOL_HANG on replica 1, the
    straggler gate off: failover on the stale heartbeat, every request OK,
    delivery exactly once after the replica wakes, streams that were not
    migrated equal to the engine phase's (partings of migrated ones
    reported); the ms from the stall to the failover and to each migrated
    stream's next token."""
    import dataclasses

    from repro_torch.serving import resilience as R

    prompts = _engine_prompts(cfg)
    c = dataclasses.replace(cfg, kv_cache_dtype="bf16")
    want = eng_streams["bf16"]
    path = ("norm_quant", "ternary_gemv", "ternary_matmul", "ternary_swiglu",
            "decode_attention", "prefill_append")
    keep = ("wall_s", "tokens", "tokens_per_s", "statuses", "migrated_total", "first_token_ms",
            "per_replica", "drained_replicas")
    out = {"phase": "pool", "model": cfg.name, "replicas": POOL_REPLICAS,
           "slots": ENGINE_SLOTS, "max_len": ENGINE_MAX_LEN, "requests": ENGINE_REQUESTS,
           "max_new": ENGINE_NEW,
           "engine_phase_tokens_per_s": report["engine"]["bf16"]["tokens_per_s"]}
    no_stragglers = {"pool_straggler_events": 10**6}
    with torch.inference_mode():
        # (a) fault-free
        res, sinks, streams, pool = pool_run(torch, c, params, prompts)
        pool.stop()
        problems = _delivery_problems(sinks, streams)
        parted = [i for i, s in enumerate(sinks) if s.tokens != want[i]]
        if parted:
            problems.append(f"streams differ from the engine phase's: {parted}")
        missing = [n for n in path if res["launch_counts"][n] <= 0]
        if missing:
            problems.append(f"kernels never launched on the pool's path: {missing}")
        out["a"] = {k: res[k] for k in keep} | {"streams_equal_to_engine": ENGINE_REQUESTS - len(parted)}
        if problems:
            emit(out)
            fail("pool[a, fault-free]: " + "; ".join(problems))

        # (b) replica_crash on replica 0; a clock this thread moves past the
        # backoff once the workload is served, so the restart runs alone
        offset = [0.0]
        backoff = 30.0
        res, sinks, streams, pool = pool_run(
            torch, c, params, prompts, plan=R.FaultPlan(faults=(R.Fault(**POOL_CRASH),)),
            cfg_kw=no_stragglers | {"pool_backoff_s": backoff, "pool_hang_timeout_s": 300.0},
            clock=lambda: time.monotonic() + offset[0])
        try:
            problems = _delivery_problems(sinks, streams)
            migrated = [i for i in streams if streams[i].req.migrations]
            parted = [i for i, s in enumerate(sinks) if s.tokens != want[i]]
            if res["statuses"] != {"OK": ENGINE_REQUESTS} or not migrated:
                problems.append(f"statuses {res['statuses']}, migrated {migrated}")
            if set(parted) - set(migrated):
                problems.append(f"streams not migrated differ: {sorted(set(parted) - set(migrated))}")
            partings = [divergence(torch, c, params, prompts[i], sinks[i].tokens, want[i])
                        | {"request": i} for i in parted if len(sinks[i].tokens) == ENGINE_NEW]
            rep = pool.replicas[0]
            if rep.state != "quarantined" or rep.crashes != 1:
                problems.append(f"replica 0 is {rep.state} with {rep.crashes} crashes")
            gc.collect()
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            resident = torch.cuda.memory_allocated()
            offset[0] += backoff + 1.0
            t_restart = time.perf_counter()
            _pool_until(pool, lambda: rep.state == "ready", "replica 0's restart and probe", 300)
            restart_ms = (time.perf_counter() - t_restart) * 1e3
            torch.cuda.synchronize()
            peak_extra = torch.cuda.max_memory_allocated() - resident
            gc.collect()
            resident_after = torch.cuda.memory_allocated()
            out["b"] = {k: res[k] for k in keep} | {
                "plan": POOL_CRASH, "migrated_requests": migrated,
                "streams_equal_to_engine": ENGINE_REQUESTS - len(parted), "partings": partings,
                "resume": _resume_ms(res, sinks, streams),
                "restart_to_ready_ms": restart_ms, "restarts": rep.restarts,
                "resident_bytes_before_restart": resident,
                "restart_peak_extra_bytes": peak_extra,
                "resident_bytes_after_restart": resident_after}
            if rep.restarts != 1:
                problems.append(f"replica 0 restarted {rep.restarts} times")
        finally:
            pool.stop()
        if problems:
            emit(out)
            fail("pool[b, replica_crash]: " + "; ".join(problems))

        # (c) replica_hang on replica 1, on the real clock
        hang = {"seen": None}

        def spot(pool):
            if hang["seen"] is None and ("hang", POOL_HANG["tick"], 1) in pool.replicas[1].fired:
                hang["seen"] = time.perf_counter()

        res, sinks, streams, pool = pool_run(
            torch, c, params, prompts, plan=R.FaultPlan(faults=(R.Fault(**POOL_HANG),)),
            cfg_kw=no_stragglers, each=spot)
        try:
            zombie = pool.replicas[1]
            t_wait = time.perf_counter()
            while (zombie.engine.queue or any(r is not None for r in zombie.engine.live)
                   or zombie.driver.beat < time.monotonic() - 1.0):
                if time.perf_counter() - t_wait > 60:
                    fail("pool[c]: the hung replica never woke and retired its copies")
                pool.poll()
                time.sleep(0.01)
            problems = _delivery_problems(sinks, streams)
            migrated = [i for i in streams if streams[i].req.migrations]
            if res["statuses"] != {"OK": ENGINE_REQUESTS} or not migrated:
                problems.append(f"statuses {res['statuses']}, migrated {migrated}")
            if zombie.crashes < 1:  # a probe sent while it still sleeps fails it over again
                problems.append("replica 1 was never failed over")
            parted = [i for i, s in enumerate(sinks) if s.tokens != want[i]]
            if set(parted) - set(migrated):
                problems.append(f"streams not migrated differ: {sorted(set(parted) - set(migrated))}")
            partings = [divergence(torch, c, params, prompts[i], sinks[i].tokens, want[i])
                        | {"request": i} for i in parted if len(sinks[i].tokens) == ENGINE_NEW]
            out["c"] = {k: res[k] for k in keep} | {
                "plan": POOL_HANG, "migrated_requests": migrated, "failovers": zombie.crashes,
                "streams_equal_to_engine": ENGINE_REQUESTS - len(parted), "partings": partings,
                "stall_to_failover_ms": ((res["migrated_at"] - hang["seen"]) * 1e3
                                         if hang["seen"] and res["migrated_at"] else None),
                "resume": _resume_ms(res, sinks, streams)}
        finally:
            pool.stop()
        if problems:
            emit(out)
            fail("pool[c, replica_hang]: " + "; ".join(problems))
    report["pool"] = out
    emit(out)


def _pct(xs, q):
    xs = sorted(xs)
    return xs[min(len(xs) - 1, int(q * len(xs)))] if xs else None


def server_phase(torch, cfg, params, eng_streams, report: dict) -> None:
    """The HTTP/SSE front door at full width: a ServingServer on 127.0.0.1
    (an ephemeral port) over one engine as the engine phase's (bf16
    contiguous cache), warmed up by its default warmup. 16 concurrent SSE
    clients send the engine phase's workload: every stream OK and equal to
    the engine phase's, contiguous token indexes, every kernel of the
    engine's path launched; time to first token (p50, p99) and tokens/s.
    Again with the longest prompt's client hanging up after its first
    token: that request CANCELLED, the other 15 streams unchanged. Then
    ``python -m repro_torch.launch.server --port 0 --replicas 2`` (full
    width) as a subprocess: ready, four requests OK, SIGTERM, exit code 0."""
    import asyncio
    import dataclasses
    import queue
    import signal
    import threading

    from repro_torch import kernels as K
    from repro_torch.serving import engine as E
    from repro_torch.serving.server import ServingServer, http_get, sse_request

    prompts = [[int(t) for t in p] for p in _engine_prompts(cfg)]
    want = eng_streams["bf16"]
    c = dataclasses.replace(cfg, kv_cache_dtype="bf16")
    path = ("norm_quant", "ternary_gemv", "ternary_matmul", "ternary_swiglu",
            "decode_attention", "prefill_append")
    leaver = max(range(len(prompts)), key=lambda i: len(prompts[i]))
    out = {"phase": "server", "model": cfg.name, "clients": len(prompts),
           "slots": ENGINE_SLOTS, "max_len": ENGINE_MAX_LEN, "max_new": ENGINE_NEW}

    async def clients(server, disconnect=None):
        t0 = time.perf_counter()
        recs = await asyncio.gather(*(sse_request(
            server.host, server.port, {"prompt": p, "max_new": ENGINE_NEW},
            disconnect_after=1 if i == disconnect else None) for i, p in enumerate(prompts)))
        return recs, time.perf_counter() - t0

    async def body():
        engine = E.ServingEngine(params, c, slots=ENGINE_SLOTS, max_len=ENGINE_MAX_LEN,
                                 kernels=K.KERNELS, eos_id=-1)
        server = ServingServer(engine, host="127.0.0.1", port=0)
        t_start = time.perf_counter()
        await server.start()
        out["warmup_s"] = time.perf_counter() - t_start
        try:
            torch.cuda.synchronize()
            K.reset_launch_counts()
            recs, wall = await clients(server)
            counts = K.launch_counts()
            recs2, _ = await clients(server, disconnect=leaver)
            t0 = time.perf_counter()
            while True:
                stats = json.loads((await http_get(server.host, server.port, "/v1/stats"))[1])
                if stats["statuses"].get("CANCELLED") or time.perf_counter() - t0 > 60:
                    break
                await asyncio.sleep(0.02)
            return recs, wall, counts, recs2, stats
        finally:
            await server.drain_and_stop(30.0)

    recs, wall, counts, recs2, stats = asyncio.run(asyncio.wait_for(body(), 600))
    problems = []
    bad = [i for i, r in enumerate(recs)
           if r["status"] != "OK" or r["indexes"] != list(range(ENGINE_NEW))]
    parted = [i for i, r in enumerate(recs) if r["tokens"] != want[i]]
    if bad or parted:
        problems.append(f"requests not OK {bad}, streams differing from the engine phase's "
                        f"{parted}")
    missing = [n for n in path if counts[n] <= 0]
    if missing:
        problems.append(f"kernels never launched behind the server: {missing}")
    ttft = [(r["t_first"] - r["t_sent"]) * 1e3 for r in recs if r["t_first"] is not None]
    tokens = sum(len(r["tokens"]) for r in recs)
    kept = [i for i in range(len(prompts)) if i != leaver]
    changed = [i for i in kept if recs2[i]["tokens"] != want[i] or recs2[i]["status"] != "OK"]
    if not recs2[leaver]["disconnected"] or stats["statuses"].get("CANCELLED") != 1 or changed:
        problems.append(f"the disconnect: CANCELLED {stats['statuses'].get('CANCELLED')}, "
                        f"other streams changed {changed}")
    out.update(ttft_ms_p50=_pct(ttft, 0.5), ttft_ms_p99=_pct(ttft, 0.99), ttft_ms=ttft,
               wall_s=wall, tokens=tokens, tokens_per_s=tokens / wall,
               engine_phase_tokens_per_s=report["engine"]["bf16"]["tokens_per_s"],
               streams_equal_to_engine=len(prompts) - len(parted), disconnected=leaver,
               statuses_after_disconnect=stats["statuses"], launch_counts=counts)
    if problems:
        emit(out)
        fail("server: " + "; ".join(problems))

    # the launcher as a process: a pool of two full-width replicas
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.join(ROOT, "src") + os.pathsep + env.get("PYTHONPATH", "")
    t0 = time.perf_counter()
    proc = subprocess.Popen([sys.executable, "-m", "repro_torch.launch.server", "--port", "0",
                             "--replicas", "2"], cwd=ROOT, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    lines: queue.Queue = queue.Queue()
    reader = threading.Thread(target=lambda: [lines.put(x) for x in proc.stdout] + [lines.put(None)],
                              daemon=True)
    reader.start()
    launcher = {"command": "python -m repro_torch.launch.server --port 0 --replicas 2"}
    try:
        try:
            first = lines.get(timeout=300)
        except queue.Empty:
            first = None
        if not first or "listening on http://" not in first:
            fail(f"server: the launcher did not start: {first!r}")
        port = int(first.split("http://")[1].split()[0].rsplit(":", 1)[1])

        async def probe():
            while (await http_get("127.0.0.1", port, "/readyz"))[0] != 200:
                await asyncio.sleep(0.1)
            launcher["ready_s"] = time.perf_counter() - t0
            return await asyncio.gather(*(sse_request("127.0.0.1", port,
                                                      {"prompt": p[:100], "max_new": 8})
                                          for p in prompts[:4]))

        recs = asyncio.run(asyncio.wait_for(probe(), 300))
        launcher["statuses"] = [r["status"] for r in recs]
        proc.send_signal(signal.SIGTERM)
        launcher["exit_code"] = proc.wait(timeout=120)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=60)
    reader.join(timeout=10)
    tail = []
    while not lines.empty():
        x = lines.get()
        if x is not None:
            tail.append(x.rstrip())
    launcher["output_tail"] = tail[-3:]
    out["launcher"] = launcher
    report["server"] = out
    emit(out)
    if launcher["statuses"] != ["OK"] * 4 or launcher["exit_code"] != 0:
        fail(f"server: the launcher served {launcher['statuses']} and exited "
             f"{launcher['exit_code']}")


# ---------------------------------------------------------------------------
# phases: RWKV-6 3B (the ssm family, the WKV kernel B15)
# ---------------------------------------------------------------------------


def rwkv_smoke_phase(torch, report: dict) -> None:
    """The rwkv smoke config in f32 on the card (kernels) against the same
    weights on the CPU (plain versions): generate (B = 3, 13-token prompts,
    12 steps) and the legacy engine (``prefill="auto"``): equal streams and
    statuses, prefill logits within SMOKE_LOGIT_TOL, wkv launched."""
    import dataclasses

    import numpy as np

    from repro_torch import kernels as K
    from repro_torch.configs import get_config
    from repro_torch.core import params as PR
    from repro_torch.models import transformer as Tr
    from repro_torch.serving import engine as E

    cfg = dataclasses.replace(get_config("rwkv6-3b", smoke=True), dtype=torch.float32)
    specs = Tr.param_specs(cfg)
    cpu_params = Tr.pack_tree(PR.init_params(specs, seed=0, device="cpu"), specs,
                              dtype=cfg.dtype)
    cuda_params = _to_cuda(cpu_params)
    gen = torch.Generator().manual_seed(7)
    prompts = torch.randint(0, cfg.vocab_size, (3, 13), generator=gen)
    K.reset_launch_counts()
    on_card = E.generate(cuda_params, cfg, prompts, steps=12, kernels=K.KERNELS)
    wkv_launches = K.launch_counts()["wkv"]
    on_cpu = E.generate(cpu_params, cfg, prompts, steps=12, kernels=K.PLAIN, device="cpu")
    err = (on_card.prefill_logits.cpu() - on_cpu.prefill_logits).abs().max().item()
    out = {"phase": "rwkv_smoke", "generate_streams_equal":
           bool(torch.equal(on_card.tokens, on_cpu.tokens)),
           "prefill_logit_max_abs_err": err, "generate_wkv_launches": wkv_launches}
    rng = np.random.default_rng(7)
    eng_prompts = [rng.integers(0, cfg.vocab_size, n) for n in (9, 30, 70, 130, 200)]
    runs = []
    for params, kset, device in ((cuda_params, K.KERNELS, None), (cpu_params, K.PLAIN, "cpu")):
        eng = E.ServingEngine(params, cfg, slots=2, max_len=256, kernels=kset, device=device)
        reqs = [E.Request(rid=i, prompt=p, max_new=8) for i, p in enumerate(eng_prompts)]
        for r in reqs:
            eng.submit(r)
        eng.run()
        runs.append(([(r.generated, r.status.name) for r in reqs], eng.stats(), eng.prefill))
    (got, st, mode), (want, _, _) = runs
    out.update({"engine_prefill": mode, "engine_streams_equal": got == want,
                "engine_statuses": [x[1] for x in got], "engine_ticks": st["ticks"],
                "engine_host_transfers": st["host_transfers"]})
    report["rwkv_smoke"] = out
    emit(out)
    if not (out["generate_streams_equal"] and err <= SMOKE_LOGIT_TOL and got == want
            and mode == "legacy" and st["host_transfers"] == st["ticks"]
            and wkv_launches == cfg.n_layers):
        fail(f"rwkv_smoke: {out}")


def rwkv_weight_bytes(params) -> int:
    """Bytes a decode step must stream: every packed weight and scale and
    every other leaf of the blocks, the final norm and the LM head (the
    embedding contributes one row a token, left out)."""
    def leaves(node):
        if isinstance(node, dict):
            for v in node.values():
                yield from leaves(v)
        else:
            yield node

    return sum(t.numel() * t.element_size()
               for part in ("blocks", "final_norm", "lm_head") for t in leaves(params[part]))


RWKV_PATH = ("wkv", "ternary_gemv", "ternary_matmul")  # the rwkv runs launch these only


def _rwkv_count_problems(counts, wkv_want: int, path=RWKV_PATH) -> list[str]:
    problems = []
    if counts["wkv"] != wkv_want:
        problems.append(f"wkv launched {counts['wkv']} times, want {wkv_want}")
    missing = [n for n in path if counts[n] <= 0]
    if missing:
        problems.append(f"kernels never launched on the rwkv path: {missing}")
    extra = {n: c for n, c in counts.items() if c and n not in path}
    if extra:
        problems.append(f"kernels the rwkv path must not launch: {extra}")
    return problems


def rwkv_drift(torch, cfg, params, tokens, witness: bool = False) -> dict:
    """The prefill of ``tokens`` block by block along the plain versions'
    trajectory: each block through the kernels and through the plain
    versions from the same input (max difference relative to the block
    output's max |x|), how far the two runs' own trajectories lie apart,
    and the last-token logits of the final norm and LM head on the last
    block's two same-input outputs. Random-weight RWKV-6 at full depth
    amplifies an ulp: the same-input differences are the bar, the
    trajectories are reported. With ``witness``, two more plain
    trajectories show that amplification without any kernel: the
    embedding nudged by one ulp in one element (channel 0 of each
    sequence's first token) and in every element, each against the plain
    trajectory, relative to the same scale."""
    from repro_torch.kernels import KERNELS, PLAIN
    from repro_torch.models import layers as L
    from repro_torch.models import transformer as Tr

    def head(x):
        x = L.rmsnorm(params["final_norm"], x[:, -1:], eps=cfg.norm_eps)
        return L.lm_head(params["lm_head"], x)[:, 0].float()

    def nudged(x, every: bool):
        x = x.clone()
        bits = _bits(torch, x)
        if every:
            bits += 1  # one ulp away from zero in every element
        else:
            bits[:, 0, 0] += 1
        return x

    x_k = x_p = L.embed(params["embed"], tokens, dtype=cfg.dtype)
    others = {"nudge_one_rel": nudged(x_p, False), "nudge_all_rel": nudged(x_p, True)} \
        if witness else {}
    layers = []
    with torch.inference_mode():
        for li in range(cfg.n_layers):
            bp = Tr.layer_slice(params["blocks"]["b0"], li)
            same, _ = Tr.apply_rwkv_block(bp, x_p, cfg, kernels=KERNELS)
            x_k, _ = Tr.apply_rwkv_block(bp, x_k, cfg, kernels=KERNELS)
            x_p, _ = Tr.apply_rwkv_block(bp, x_p, cfg, kernels=PLAIN)
            others = {k: Tr.apply_rwkv_block(bp, x, cfg, kernels=PLAIN)[0]
                      for k, x in others.items()}
            scale = x_p.float().abs().max().item()
            layer = {"layer": li,
                     "same_input_rel": (same.float() - x_p.float()).abs().max().item() / scale,
                     "trajectory_rel": (x_k.float() - x_p.float()).abs().max().item() / scale}
            layer.update({k: (x.float() - x_p.float()).abs().max().item() / scale
                          for k, x in others.items()})
            layers.append(layer)
        lk, lp = head(same), head(x_p)
    out = {"layers": layers, "max_same_input_rel": max(x["same_input_rel"] for x in layers),
           "last_trajectory_rel": layers[-1]["trajectory_rel"],
           "same_input_logit_max_abs_err": (lk - lp).abs().max().item(),
           "logit_max_abs": lp.abs().max().item()}
    out.update({f"last_{k}": layers[-1][k] for k in others})
    return out


def _drift_problems(drift) -> list[str]:
    problems = []
    if not drift["max_same_input_rel"] <= LOGIT_REL_TOL:
        problems.append(f"a block differs from its plain version on the same input by "
                        f"{drift['max_same_input_rel']} of max |x|")
    if not drift["same_input_logit_max_abs_err"] <= LOGIT_REL_TOL * drift["logit_max_abs"]:
        problems.append(f"same-input logits differ by {drift['same_input_logit_max_abs_err']} "
                        f"(max |logit| {drift['logit_max_abs']})")
    return problems


def rwkv_generate_phase(torch, cfg, params, report: dict) -> dict:
    """Full-width rwkv6-3b generate, B = 4, a 100-token prompt (the exact
    length, no bucket), 64 greedy steps, through the kernels (counters
    reset just before, read just after) and through the plain versions:
    32 wkv launches (one prefill), no attention and no norm-quant launch.
    The prefill is held block by block (``rwkv_drift``): each block's
    kernels against its plain version on the same input, and the
    last-token logits from the same input, within LOGIT_REL_TOL. The two
    end-to-end runs are reported (logits, first tokens, streams) but not
    held: with random weights the 32 blocks amplify a one-ulp difference
    until the trajectories decorrelate, which the plain versions show
    alone (``rwkv_drift``'s witness: the embedding nudged by one ulp, plain
    against plain, reported beside the kernels' trajectory). Then eight decode
    steps from the plain prefill's state both ways (the decode runs no
    wkv: its state update is plain torch, and the projections are exact,
    so the logits are held to the same bar), ms per decode step beside its
    weight-stream bound, and torch.profiler over three decode steps (busy
    share). Returns the kernels' launch counts."""
    from repro_torch import kernels as K
    from repro_torch.models import transformer as Tr
    from repro_torch.serving import engine as E

    dev = torch.device("cuda")
    prompts = generate_prompts(torch, cfg)
    b, s = prompts.shape
    res_k, counts, times_k = generate_run(torch, cfg, params, prompts, STEPS, K.KERNELS)
    res_p, _, times_p = generate_run(torch, cfg, params, prompts, STEPS, K.PLAIN)
    toks_k, toks_p = res_k.tokens, res_p.tokens
    lk, lp = res_k.prefill_logits.float(), res_p.prefill_logits.float()
    scale = lp.abs().max().item()
    first_gap = (lp.max(-1).values - lp.gather(1, lk.argmax(-1, keepdim=True))[:, 0]).max()
    with torch.inference_mode():
        _, caches = E.prefill_bucketed(params, cfg, prompts, kernels=K.PLAIN)
        tok = toks_p[:, :1].to(dev).long()
        pos = torch.full((b,), s, dtype=torch.int32, device=dev)
        step_checks = []
        for _ in range(DECODE_CHECK_STEPS):
            copy = {"blocks": {n: {k: v.clone() for k, v in c.items()}
                               for n, c in caches["blocks"].items()}}
            dk, _ = Tr.decode_step(params, tok, copy, pos, cfg, kernels=K.KERNELS)
            dp, _ = Tr.decode_step(params, tok, caches, pos, cfg, kernels=K.PLAIN)
            step_checks.append({"logit_max_abs_err": (dk - dp).abs().max().item(),
                                "logit_max_abs": dp.abs().max().item(),
                                "argmax_equal": bool(torch.equal(dk.argmax(-1), dp.argmax(-1)))})
            tok = dp.argmax(-1, keepdim=True)
            pos = pos + 1
    weight_bytes = rwkv_weight_bytes(params)
    decode_bound_ms = weight_bytes / HBM_BYTES_PER_S * 1e3
    out = {"phase": "rwkv_generate", "model": cfg.name, "batch": b, "prompt": s,
           "steps": STEPS, "kernels": times_k, "plain": times_p,
           "launch_counts": {n: c for n, c in counts.items() if c},
           "first_tokens_equal": bool(torch.equal(toks_k[:, 0], toks_p[:, 0])),
           "first_token_plain_gap_rel": first_gap.item() / scale,
           "stream_agreement": (toks_k == toks_p).float().mean().item(),
           "streams_equal": int((toks_k == toks_p).all(dim=1).sum().item()),
           "prefill_logit_max_abs_err": (lk - lp).abs().max().item(),
           "prefill_logit_max_abs": scale, "decode_step_checks": step_checks,
           "weight_bytes": weight_bytes, "decode_bound_ms": decode_bound_ms,
           "decode_ms_over_bound": times_k["decode_ms_per_step"] / decode_bound_ms}
    out["prefill_drift"] = rwkv_drift(torch, cfg, params, prompts, witness=True)
    out["decode_profile"] = profile_decode(torch, params, cfg, caches, tok, pos)
    report["rwkv_generate"] = out
    emit(out)
    problems = _rwkv_count_problems(counts, cfg.n_layers) + _drift_problems(out["prefill_drift"])
    if tuple(toks_k.shape) != (b, STEPS) or not torch.isfinite(lk).all():
        problems.append("wrong token shape or non-finite logits")
    for i, c in enumerate(step_checks):
        if c["logit_max_abs_err"] > LOGIT_REL_TOL * c["logit_max_abs"]:
            problems.append(f"decode step {i} logits differ by {c['logit_max_abs_err']}")
    if problems:
        fail("rwkv_generate: " + "; ".join(problems))
    return counts


def rwkv_prefill_phase(torch, cfg, params, report: dict) -> None:
    """prefill_bucketed (the exact length) at 1 x 1000 and 1 x 4000 tokens
    through the kernels and the plain versions: ms per prefill, the peak
    memory it adds, 32 wkv launches a prefill (counters reset just before
    the timed prefill, read just after); the blocks and the last-token
    logits held from the same inputs (``rwkv_drift``), the end-to-end
    logits reported; each prefill's device time by kernel and busy share."""
    from repro_torch import kernels as K
    from repro_torch.serving import engine as E

    gen = torch.Generator(device="cuda").manual_seed(5)
    out = {"phase": "rwkv_prefill", "model": cfg.name, "runs": []}
    problems = []
    with torch.inference_mode():
        for b, s in RWKV_PREFILL_SHAPES:
            prompts = torch.randint(0, cfg.vocab_size, (b, s), generator=gen, device="cuda")
            run = {"batch": b, "prompt": s}
            logits = {}
            for name, kset in (("kernels", K.KERNELS), ("plain", K.PLAIN)):
                E.prefill_bucketed(params, cfg, prompts, kernels=kset)  # warm-up
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                resident = torch.cuda.memory_allocated()
                K.reset_launch_counts()
                t = time.perf_counter()
                last, _ = E.prefill_bucketed(params, cfg, prompts, kernels=kset)
                torch.cuda.synchronize()
                run[f"{name}_ms"] = (time.perf_counter() - t) * 1e3
                run[f"{name}_peak_extra_bytes"] = torch.cuda.max_memory_allocated() - resident
                if kset is K.KERNELS:
                    counts = K.launch_counts()
                logits[name] = last.float()
            lk, lp = logits["kernels"], logits["plain"]
            run.update({"end_to_end_logit_max_abs_err": (lk - lp).abs().max().item(),
                        "logit_max_abs": lp.abs().max().item(),
                        "launch_counts": {n: c for n, c in counts.items() if c},
                        "drift": rwkv_drift(torch, cfg, params, prompts)})
            run["profile"] = profile_device(  # where the prefill's device time goes
                torch, lambda: E.prefill_bucketed(params, cfg, prompts, kernels=K.KERNELS),
                steps=2, warmup=1)
            out["runs"].append(run)
            tag = f"{b}x{s}"
            if not torch.isfinite(lk).all():
                problems.append(f"{tag}: non-finite logits")
            problems += [f"{tag}: {p}" for p in _drift_problems(run["drift"])]
            problems += [f"{tag}: {p}" for p in _rwkv_count_problems(
                counts, cfg.n_layers, path=("wkv", "ternary_matmul"))]  # no GEMV rows
    report["rwkv_prefill"] = out
    emit(out)
    if problems:
        fail("rwkv_prefill: " + "; ".join(problems))


def rwkv_engine_phase(torch, cfg, params, report: dict) -> None:
    """ServingEngine(prefill="auto") for rwkv6-3b on the engine phase's
    ragged workload (8 slots, max_len 1024, 16 prompts of 30-875 tokens,
    32 new tokens each), through the kernels: every request OK, one host
    transfer per tick, no fused tick, 32 wkv launches per admitted request
    (counters reset just before the first tick, read just after the last);
    tokens/s, tick times, time to first token and the state's bytes. Then
    the same workload again, every step held against the model's own calls
    on the same inputs (``rwkv_engine_checked``): each admission's slot
    state bit-equal to ``prefill_bucketed`` of that prompt alone and the
    other slots untouched, each tick's logits and the new state of all
    eight slots bit-equal to ``decode_step`` from a copy of the states
    taken just before it. Each stream is set beside the port's own
    generate of that prompt alone (B = 1), a parting reported with the gap
    of its two tokens in the engine's own logits of that step: the engine
    decodes 8 slots a step where generate decodes one, and the plain torch
    ops of the RWKV step (the norms' reductions, the decay LoRA and r.S
    matmuls, the LM head) may round otherwise at another batch, which the
    random-weight model amplifies. Two runs measure that batch effect: the
    first ONE_SLOT_REQUESTS requests through a one-slot engine, whose
    streams must equal generate's (the same batch), and one decode step
    from eight prefilled states, batched and one by one (``batch_effect``:
    how far its logits lie apart)."""
    from repro_torch import kernels as K
    from repro_torch.serving import engine as E

    prompts = _engine_prompts(cfg)
    out = {"phase": "rwkv_engine", "model": cfg.name, "slots": ENGINE_SLOTS,
           "max_len": ENGINE_MAX_LEN, "requests": ENGINE_REQUESTS, "max_new": ENGINE_NEW,
           "prompt_lengths": [len(p) for p in prompts]}
    with torch.inference_mode():
        got, reqs, _ = engine_run(torch, cfg, params, K.KERNELS, prompts, prefill="auto")
        checked, streams, step_logits = rwkv_engine_checked(torch, cfg, params, prompts)
        checked["streams_equal_to_timed_run"] = sum(
            r.generated == x for r, x in zip(reqs, streams))
        alone = [E.generate(params, cfg, torch.as_tensor(p, device="cuda")[None],
                            steps=ENGINE_NEW).tokens[0].tolist() for p in prompts]
        parted = [i for i, (a, w) in enumerate(zip(streams, alone)) if a != w]
        got["checked"] = checked
        got["streams_equal_to_generate"] = ENGINE_REQUESTS - len(parted)
        got["partings"] = [_engine_parting(step_logits, i, streams[i], alone[i])
                           for i in parted]
        one, one_reqs, _ = engine_run(torch, cfg, params, K.KERNELS,
                                      prompts[:ONE_SLOT_REQUESTS], slots=1)
        got["one_slot"] = {k: one[k] for k in ("ticks", "host_transfers", "statuses",
                                                "tokens_per_s")}
        got["one_slot"]["streams_equal_to_generate"] = sum(
            r.generated == a for r, a in zip(one_reqs, alone))
        got["batch_effect"] = rwkv_batch_effect(torch, cfg, params, prompts[:ENGINE_SLOTS])
    out.update(got)
    report["rwkv_engine"] = out
    emit(out)
    counts = got["launch_counts"]
    problems = list(checked["problems"])
    bad = [r.rid for r in reqs if r.status.name != "OK" or len(r.generated) != ENGINE_NEW]
    if bad:
        problems.append(f"requests not OK with {ENGINE_NEW} tokens: {bad}")
    if got["host_transfers"] != got["ticks"] or got["fused_ticks"]:
        problems.append(f"{got['host_transfers']} transfers for {got['ticks']} ticks, "
                        f"{got['fused_ticks']} fused ticks")
    problems += _rwkv_count_problems(counts, cfg.n_layers * ENGINE_REQUESTS)
    if checked["admissions_checked"] != ENGINE_REQUESTS or checked["ticks_checked"] == 0:
        problems.append(f"checked {checked['admissions_checked']} admissions and "
                        f"{checked['ticks_checked']} ticks")
    if got["one_slot"]["streams_equal_to_generate"] != ONE_SLOT_REQUESTS:
        problems.append(f"one-slot engine: {got['one_slot']['streams_equal_to_generate']} of "
                        f"{ONE_SLOT_REQUESTS} streams equal generate's")
    if problems:
        fail("rwkv_engine: " + "; ".join(problems))


def rwkv_engine_checked(torch, cfg, params, prompts) -> tuple[dict, list, dict]:
    """Serve ``prompts`` as ``rwkv_engine_phase`` does, holding every
    admission and every tick bit for bit against the model's own calls on
    the same inputs: after each admission the slot's ``wkv``/``x_time``/
    ``x_chan`` equal ``prefill_bucketed`` of the prompt alone, its first
    token that prefill's argmax, and the other seven slots' state is
    unchanged; each tick's logits, and the state of all eight slots after
    it (the idle ones too), equal ``decode_step`` run from a copy of the
    states, tokens and positions taken just before the tick. Returns the
    measurements (with the problems found), the streams and each
    request's logits row of every decode step, keyed (request, step)."""
    from repro_torch import kernels as K
    from repro_torch.models import transformer as Tr
    from repro_torch.serving import engine as E

    dev = torch.device("cuda")
    eng = E.ServingEngine(params, cfg, slots=ENGINE_SLOTS, max_len=ENGINE_MAX_LEN,
                          kernels=K.KERNELS, eos_id=-1, prefill="auto")
    reqs = [E.Request(rid=i, prompt=p, max_new=ENGINE_NEW) for i, p in enumerate(prompts)]
    problems, seen, step_logits = [], [], {}
    tally = {"admissions_checked": 0, "ticks_checked": 0}

    def state():
        return eng.caches["blocks"]["b0"]

    def copy():
        return {n: t.clone() for n, t in state().items()}

    prefill_slot, decode_tick, advance = eng._prefill_slot, eng._decode_tick, E._advance

    def checked_prefill(slot, req, prompt, remaining):
        before = copy()
        prefill_slot(slot, req, prompt, remaining)
        logits, alone = E.prefill_bucketed(
            params, cfg, torch.as_tensor(prompt, device=dev)[None].long())
        alone = alone["blocks"]["b0"]
        rest = [i for i in range(ENGINE_SLOTS) if i != slot]
        if not all(torch.equal(state()[n][:, slot], alone[n][:, 0]) for n in alone):
            problems.append(f"request {req.rid}: slot {slot}'s state after admission is not "
                            f"prefill_bucketed's of its prompt alone")
        if not all(torch.equal(state()[n][:, rest], before[n][:, rest]) for n in alone):
            problems.append(f"request {req.rid}: admission into slot {slot} changed another "
                            f"slot's state")
        if int(eng.cur_tok[slot]) != int(logits[0].argmax()):
            problems.append(f"request {req.rid}: first token is not the prefill's argmax")
        step_logits[(req.rid, 0)] = logits[0].float()
        tally["admissions_checked"] += 1

    def capture(logits, *a, **kw):
        seen.append(logits)
        return advance(logits, *a, **kw)

    def checked_tick():
        active = torch.tensor([r is not None for r in eng.live], device=dev)
        steps = {s: (r.rid, len(r.generated) + (s in eng._pending_first))
                 for s, r in enumerate(eng.live) if r is not None}
        dpos = torch.where(active, eng.pos, torch.full_like(eng.pos, eng.cache_len - 1))
        snap = {"blocks": {"b0": copy()}}
        want, _ = Tr.decode_step(params, eng.cur_tok[:, None].to(torch.int64), snap, dpos,
                                 cfg, kernels=K.KERNELS)
        ok = decode_tick()
        got = seen.pop()
        tick = eng.tick_count
        if not torch.equal(got, want):
            problems.append(f"tick {tick}: logits differ from decode_step on the same states "
                            f"by {(got.float() - want.float()).abs().max().item()}")
        if not all(torch.equal(state()[n], snap["blocks"]["b0"][n]) for n in state()):
            problems.append(f"tick {tick}: the slots' state differs from decode_step's")
        for s, key in steps.items():
            step_logits[key] = got[s].float()
        tally["ticks_checked"] += 1
        return ok

    eng._prefill_slot, eng._decode_tick, E._advance = checked_prefill, checked_tick, capture
    try:
        for r in reqs:
            eng.submit(r)
        eng.run()
    finally:
        E._advance = advance
    statuses = [r.status.name for r in reqs]
    if any(x != "OK" for x in statuses):
        problems.append(f"checked run statuses {statuses}")
    return dict(tally, problems=problems[:20], n_problems=len(problems)), \
        [r.generated for r in reqs], step_logits


def _engine_parting(step_logits, rid, got, want) -> dict:
    """Where an engine stream parts from generate's: the step, both tokens,
    and their gap in the engine's own logits of that step, relative to its
    max |logit| (the engine's token is that row's argmax)."""
    step = next(i for i, (x, y) in enumerate(zip(got, want)) if x != y)
    row = step_logits[(rid, step)]
    return {"request": rid, "step": step, "tokens": [int(got[step]), int(want[step])],
            "engine_logit_gap_rel": (row[got[step]] - row[want[step]]).item()
            / row.abs().max().item()}


def rwkv_batch_effect(torch, cfg, params, prompts) -> dict:
    """One decode step from the same prefilled states (each prompt alone),
    run as one batch, as the engine's decode tick runs it, and one prompt
    at a time, as generate alone runs it: the largest logit difference,
    relative to max |logit|, and the rows whose argmax differs."""
    from repro_torch.kernels import KERNELS
    from repro_torch.models import transformer as Tr
    from repro_torch.serving import engine as E

    dev = torch.device("cuda")
    states, toks = [], []
    for p in prompts:
        logits, caches = E.prefill_bucketed(params, cfg, torch.as_tensor(p, device=dev)[None])
        states.append(caches["blocks"]["b0"])
        toks.append(logits.argmax(-1))
    tok = torch.stack(toks).long()  # [B, 1]
    pos = torch.tensor([len(p) for p in prompts], dtype=torch.int32, device=dev)
    batched = {"blocks": {"b0": {n: torch.cat([st[n] for st in states], dim=1)
                                 for n in states[0]}}}
    lb, _ = Tr.decode_step(params, tok, batched, pos, cfg, kernels=KERNELS)
    la = torch.cat([Tr.decode_step(params, tok[i:i + 1], {"blocks": {"b0": states[i]}},
                                   pos[i:i + 1], cfg, kernels=KERNELS)[0]
                    for i in range(len(prompts))])
    return {"batch": len(prompts), "logit_max_abs_err": (lb - la).abs().max().item(),
            "logit_max_abs": la.abs().max().item(),
            "rows_differing": int((lb != la).any(dim=-1).sum().item()),
            "argmax_differing": int((lb.argmax(-1) != la.argmax(-1)).sum().item())}


# ---------------------------------------------------------------------------
# phase: tl (the table-lookup engine at full width)
# ---------------------------------------------------------------------------


def _tl_problems(counts) -> list[str]:
    """A TL run launched every TL kernel of the path and none it replaces."""
    out = []
    missing = [n for n in TL_PATH if counts[n] <= 0]
    if missing:
        out.append(f"TL kernels never launched: {missing}")
    packed = {n: counts[n] for n in TL_REPLACED if counts[n]}
    if packed:
        out.append(f"packed projection kernels launched under TL: {packed}")
    return out


def tl_smoke_int8(torch) -> dict:
    """The f32 smoke config in the engine with an int8 cache, each layout:
    TL and packed through the kernels on the card, equal streams and
    statuses."""
    import dataclasses

    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.core import params as PR
    from repro_torch.kernels import KERNELS
    from repro_torch.models import transformer as Tr
    from repro_torch.serving import engine as E

    base = dataclasses.replace(get_config("tellme-0.7b", smoke=True), dtype=torch.float32,
                               kv_cache_dtype="int8")
    specs = Tr.param_specs(base)
    params = Tr.pack_tree(PR.init_params(specs, seed=0, device=torch.device("cuda")), specs,
                          dtype=base.dtype)
    rng = np.random.default_rng(9)
    prefix = rng.integers(0, base.vocab_size, 192)
    prompts = [rng.integers(0, base.vocab_size, n) for n in (9, 30, 70, 130, 200)]
    prompts += [np.concatenate([prefix, rng.integers(0, base.vocab_size, n)]) for n in (20, 9)]
    out = {}
    for layout in ("contiguous", "paged"):
        runs = []
        for engine in ("tl", "packed"):
            cfg = dataclasses.replace(base, kv_layout=layout, matmul_engine=engine)
            eng = E.ServingEngine(params, cfg, slots=2, max_len=512, kernels=KERNELS)
            reqs = [E.Request(rid=i, prompt=p, max_new=8) for i, p in enumerate(prompts)]
            for r in reqs:
                eng.submit(r)
            eng.run()
            runs.append([(r.generated, r.status.name) for r in reqs])
        out[layout] = {"streams_equal": runs[0] == runs[1],
                       "requests": len(prompts)}
    return out


def tl_phase(torch, cfg, params, packed_tokens, engine_streams, shared_streams,
             report: dict) -> dict:
    """The full-width model with matmul_engine="tl" through the kernels:
    generate, the ragged engine workload (contiguous, bf16 cache) and the
    shared-prefix workload (paged, bf16 cache). Every greedy stream equals
    the packed kernels' stream of the same workload from the phases above;
    in every TL run the TL kernels launch and the packed projections and
    the plain prologue do not. Times beside the packed runs' (same call).
    Then the smoke config with an int8 cache, TL against packed. Returns the
    launch counts of the TL generate run."""
    import dataclasses

    from repro_torch import kernels as K
    from repro_torch.serving import engine as E

    gc.collect()  # the earlier phases' engines (on_emit closes a cycle) and their caches
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    t = time.perf_counter()
    tl_cfg = dataclasses.replace(cfg, matmul_engine="tl")
    tl_params = E.engine_params(params, tl_cfg)  # w_idx of every node, once, on the card
    torch.cuda.synchronize()
    idx_s = time.perf_counter() - t
    blocks = tl_params["blocks"]["b0"]
    idx_bytes = sum(node["w_idx"].numel() for sub in blocks.values() for node in sub.values()
                    if isinstance(node, dict) and "w_idx" in node)
    out = {"phase": "tl", "model": cfg.name, "w_idx_build_s": idx_s, "w_idx_bytes": idx_bytes}
    problems = []

    # (a) generate
    prompts = generate_prompts(torch, cfg)
    res, gen_counts, times = generate_run(torch, tl_cfg, tl_params, prompts, STEPS, K.KERNELS)
    equal = int((res.tokens == packed_tokens).all(dim=1).sum().item())
    packed_times = report["generate"]["kernels"]
    out["generate"] = {"tl": times, "packed": {k: packed_times[k] for k in times},
                       "streams_equal_packed": equal, "rows": prompts.shape[0],
                       "launch_counts": gen_counts}
    if equal != prompts.shape[0]:
        problems.append(f"generate: {equal} of {prompts.shape[0]} streams equal packed")
    problems += [f"generate: {p}" for p in _tl_problems(gen_counts)]

    # (b) the ragged engine workload, contiguous bf16; (c) the shared prefix, paged bf16
    keys = ("ticks", "fused_ticks", "wall_s", "tokens_per_s", "fused_tick_ms_mean",
            "decode_tick_ms_mean")
    with torch.inference_mode():
        for tag, c, prompts_e, want, packed_run, first_alone in (
                ("engine", dataclasses.replace(tl_cfg, kv_cache_dtype="bf16"),
                 _engine_prompts(cfg), engine_streams, report["engine"]["bf16"], False),
                ("shared_prefix_paged", dataclasses.replace(
                    tl_cfg, kv_cache_dtype="bf16", kv_layout="paged", kv_page_size=PAGE_SIZE),
                 _shared_prefix_prompts(cfg), shared_streams,
                 report["paged_engine"]["bf16"]["shared_prefix"], True)):
            got, reqs, _ = engine_run(torch, c, tl_params, K.KERNELS, prompts_e,
                                      first_alone=first_alone)
            equal = sum(r.generated == w for r, w in zip(reqs, want))
            res = {"tl": {k: got[k] for k in keys + ("host_transfers", "statuses")},
                   "packed": {k: packed_run[k] for k in keys},
                   "streams_equal_packed": equal, "launch_counts": got["launch_counts"]}
            if got["paged"]:
                res["tl"]["paged"] = got["paged"]
            out[tag] = res
            if equal != len(reqs):
                problems.append(f"{tag}: {equal} of {len(reqs)} streams equal packed")
            if any(r.status.name != "OK" for r in reqs) or got["host_transfers"] != got["ticks"]:
                problems.append(f"{tag}: a request not OK or more than one transfer a tick")
            problems += [f"{tag}: {p}" for p in _tl_problems(got["launch_counts"])]
    out["smoke_int8"] = tl_smoke_int8(torch)
    for layout, r in out["smoke_int8"].items():
        if not r["streams_equal"]:
            problems.append(f"smoke int8 {layout}: TL streams differ from packed")
    report["tl"] = out
    emit(out)
    if problems:
        fail("tl: " + "; ".join(problems))
    return gen_counts


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
    report["build_log"] = (lib_path.parent / "build.log").read_text()
    build["tensor_core_kernels"] = ptxas_usage(report["build_log"])
    build["wkv_kernels"] = ptxas_usage(report["build_log"], _WKV_KERNELS)
    if not build["tensor_core_kernels"] or not build["wkv_kernels"]:
        fail("the build log names no tensor-core kernel or no wkv kernel")
    report["build"] = build
    emit(build)

    cfg = get_config("tellme-0.7b")
    rows = kernel_phase(torch, cfg, report)
    smoke_phase(torch, report)
    engine_smoke_phase(torch, report)
    paged_engine_smoke_phase(torch, report)
    spec_engine_smoke_phase(torch, report)
    fault_engine_smoke_phase(torch, report)
    params = full_params(torch, cfg)
    gen_counts, gen_tokens = generate_phase(torch, cfg, params, STEPS, report)
    eng_counts, eng_streams = engine_phase(torch, cfg, params, report)
    chunk_step_phase(torch, cfg, params, report)
    paged_counts, shared_streams = paged_engine_phase(torch, cfg, params, eng_streams, report)
    tl_counts = tl_phase(torch, cfg, params, gen_tokens, eng_streams["bf16"],
                         shared_streams["bf16"], report)
    prefill_phase(torch, cfg, params, report)
    legacy_engine_phase(torch, cfg, params, eng_streams, report)
    spec_counts = spec_engine_phase(torch, cfg, params, eng_streams, report)
    fault_engine_phase(torch, cfg, params, eng_streams, report)
    pool_smoke_phase(torch, report)
    pool_phase(torch, cfg, params, eng_streams, report)
    server_phase(torch, cfg, params, eng_streams, report)
    spec_run = {"prefill_append": ("contiguous", "bf16"),
                "prefill_append_quant": ("contiguous", "int8"),
                "prefill_append_paged": ("paged", "bf16"),
                "prefill_append_paged_quant": ("paged", "int8")}
    for row in report["prefill_append_verify_shapes"]:  # launches of the spec engine run
        layout, kv = spec_run[row["name"]]
        row["launches"], row["launches_run"] = (
            (0, "no model of the port has G > 1") if row["shape_tag"] == "verify G=4"
            else (spec_counts[(layout, kv)][row["name"]], f"spec engine, {layout} {kv}"))
    verify_keys = ("name", "shape_tag", "shape", "launches", "launches_run", "max_abs_err",
                   "ms", "eager_ms", "plain_ms", "contiguous_twin_ms", "bound_ms", "bound_by",
                   "library_ms", "over_library")
    emit({"phase": "verify_rows",
          "rows": [{k: r[k] for k in verify_keys if k in r}
                   for r in report["prefill_append_verify_shapes"]]})
    del params
    gc.collect()
    torch.cuda.empty_cache()

    rwkv_smoke_phase(torch, report)
    rwkv_cfg = get_config("rwkv6-3b")
    rwkv_params = full_params(torch, rwkv_cfg)
    rwkv_counts = rwkv_generate_phase(torch, rwkv_cfg, rwkv_params, report)
    rwkv_prefill_phase(torch, rwkv_cfg, rwkv_params, report)
    rwkv_engine_phase(torch, rwkv_cfg, rwkv_params, report)
    proj_keys = ("name", "shape", "launches", "max_abs_err", "ms", "plain_ms", "bound_ms",
                 "bound_by", "library_ms", "over_library")
    for row in report["rwkv_projection_shapes"]:  # launches of the rwkv generate run
        row["launches"] = rwkv_counts[row["name"]]
    emit({"phase": "rwkv_projections",
          "rows": [{k: r[k] for k in proj_keys} for r in report["rwkv_projection_shapes"]]})
    # The GEMV's and the SwiGLU's shapes, each with the launches of the run
    # that gives it that shape: generate (decode rows and its 4 x 128
    # prefill), the chunked engine (bf16 cache; its chunk step has 2048
    # rows) and the 4096-token prefill
    prefill_4096 = report["prefill"]["runs"][-1]["launch_counts"]
    for row in report["projection_shapes"]:
        row["launches"], row["launches_run"] = (
            (eng_counts["bf16"][row["name"]], "engine, bf16 cache")
            if row["shape_tag"].startswith(("chunk step", "engine"))
            else (gen_counts[row["name"]], "generate"))
    for row in report["norm_quant_shapes"]:  # rwkv6-3b has no prologue: d_model 2560 is 0
        row["launches"], row["launches_run"] = {
            "prefill 4096": (prefill_4096["norm_quant"], "prefill 1 x 4000"),
            "d_model 2560": (rwkv_counts.get("norm_quant", 0), "rwkv6-3b generate")}.get(
                row["shape_tag"], (gen_counts["norm_quant"], "generate"))
    for row in report["swiglu_shapes"]:
        row["launches"], row["launches_run"] = {
            "chunk step": (eng_counts["bf16"]["ternary_swiglu"], "engine, bf16 cache"),
            "prefill 4096": (prefill_4096["ternary_swiglu"], "prefill 1 x 4000")}.get(
                row["shape_tag"], (gen_counts["ternary_swiglu"], "generate"))
    tm_keys = ("name", "shape", "launches", "launches_run", "max_abs_err", "ms", "eager_ms",
               "plain_ms", "twin_ms", "bound_ms", "bound_by", "library_ms")
    emit({"phase": "ternary_rows",
          "rows": [{k: r[k] for k in tm_keys if k in r}
                   for r in report["norm_quant_shapes"] + report["projection_shapes"]
                   + report["swiglu_shapes"]]})
    for row in rows:  # launches on the main path that runs each kernel
        name = row["name"]
        counts = paged_counts if "_paged" in name else eng_counts
        if name == "wkv":  # the rwkv6-3b generate run
            row["launches"] = rwkv_counts[name]
        elif name in TL_PATH or name == "tl_gemv":  # the TL generate run
            row["launches"] = tl_counts[name]
        elif name.endswith("_quant") and name != "norm_quant":  # the int8 cache's variants
            row["launches"] = counts["int8"][name]
        elif name.startswith("prefill_append") or "_paged" in name:
            row["launches"] = counts["bf16"][name]
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
