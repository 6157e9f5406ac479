"""Batch-serving CLI: packed ternary continuous batching under the
resilience envelope (``repro/launch/serve.py``).

Builds packed weights (random, from ``--seed``) on the device and serves a
batch of prompts through the ``ServingEngine``: chunked prefill in
bucketed chunks while every decoding slot advances each tick (the dense
family, ``--arch gemma2-27b``'s sliding-window local layers included,
``granite-8b``, ``internlm2-20b``, ``llama3-405b`` (``--smoke`` on one
card: about 100 GB packed at full depth), ``musicgen-medium`` and
``internvl2-26b`` (from tokens), and ``--arch arctic-480b`` with
``--prefill chunked``; ``deepseek-v2-lite-16b``,
``jamba-v0.1-52b`` and ``rwkv6-3b`` prefill each request whole at
admission, ``--prefill legacy`` or ``auto``), a bounded
admission queue, per-request deadlines and priorities with preemption, and
the numerics guards. Reports time to first token, throughput and every
request's terminal status. Exit code 0 only if every admitted request ended
``OK``.

Requests come from ``--requests FILE`` (one JSON object a line:
``{"rid": 0, "prompt": [1, 2, 3], "max_new": 16, "priority": 0}``) or,
with no file, a synthetic batch shaped by --prompt-len/--ragged/--gen/--batch
whose tokens numpy draws from ``--seed``.

Only ``--mode packed`` is served: the eval and weight-quantized modes come
with training, and ``--ckpt`` with the checkpoint manager (neither is
ported yet). For the streaming front door see
``repro_torch.launch.server``.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.serve --arch tellme-0.7b --smoke \\
      --prompt-len 64 --gen 32 --batch 4 [--device cpu] [--speculative] \\
      [--queue-cap N] [--deadline-s S] [--json]
  PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma2-27b --smoke \\
      --device cpu --prompt-len 40 --gen 16 --batch 2 --ragged
  PYTHONPATH=src python -m repro_torch.launch.serve --arch jamba-v0.1-52b --smoke \\
      --device cpu --prompt-len 40 --gen 8 --batch 4 --ragged
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time

import numpy as np

from .. import _common as C
from ..configs import get_config
from ..serving import engine as E
from .server import ARCH_HELP, build_params, load_kernels


def _load_requests(path, cfg, args) -> list:
    if path is None:
        lens = [args.prompt_len] * args.batch
        if args.ragged:
            lens = [max(8, args.prompt_len // (1 << (i % 3))) for i in range(args.batch)]
        rng = np.random.default_rng(args.seed)
        return [E.Request(rid=i, prompt=rng.integers(0, cfg.vocab_size, n), max_new=args.gen,
                          deadline_s=args.deadline_s or None)
                for i, n in enumerate(lens)]
    reqs = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            d = json.loads(line)
            reqs.append(E.Request(
                rid=int(d["rid"]), prompt=np.asarray(d["prompt"], np.int64),
                max_new=int(d.get("max_new", 16)), priority=int(d.get("priority", 0)),
                deadline_s=d.get("deadline_s", args.deadline_s or None)))
    return reqs


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="tellme-0.7b", help=ARCH_HELP)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA device; 'cpu' runs the plain "
                         "PyTorch versions on the host)")
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of the random weights and the synthetic prompts")
    ap.add_argument("--prompt-len", type=int, default=64)
    ap.add_argument("--ragged", action="store_true", help="vary prompt lengths across the batch")
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--slots", type=int, default=0, help="decode slots (default: batch)")
    ap.add_argument("--max-len", type=int, default=0,
                    help="cache length (default: the longest prompt + gen + 1)")
    ap.add_argument("--mode", default="packed", choices=["packed"],
                    help="packed only: the eval and wq modes come with training")
    ap.add_argument("--kv-cache-dtype", default="bf16", choices=["bf16", "int8"],
                    help="int8 = absmax-quantized KV cache with per-row f32 scales, "
                         "dequantized inside the attention kernels")
    ap.add_argument("--prefill", default="auto", choices=["auto", "chunked", "legacy"],
                    help="chunked = cache-resident chunked prefill; legacy = one-shot "
                         "prefill of each request at admission")
    ap.add_argument("--speculative", action="store_true",
                    help="prompt-lookup drafting and chunk verify; greedy streams as plain")
    ap.add_argument("--spec-gamma", type=int, default=0,
                    help="draft tokens verified a tick (default: cfg.spec_gamma)")
    ap.add_argument("--queue-cap", type=int, default=0,
                    help="bound the admission queue (0 = unbounded); a full queue "
                         "rejects the submit FAILED/queue_full")
    ap.add_argument("--deadline-s", type=float, default=0.0,
                    help="default per-request TTL (0 = none); expired requests end "
                         "DEADLINE_EXCEEDED")
    ap.add_argument("--requests", default=None, metavar="FILE",
                    help="JSONL request file (default: a synthetic batch)")
    ap.add_argument("--json", action="store_true",
                    help="print one machine-readable result object instead of the summary")
    args = ap.parse_args(argv)
    cfg = dataclasses.replace(get_config(args.arch, smoke=args.smoke),
                              kv_cache_dtype=args.kv_cache_dtype)
    dev = C.resolve_device(args.device)
    load_kernels(dev)
    params = build_params(cfg, seed=args.seed, device=dev)
    reqs = _load_requests(args.requests, cfg, args)
    lens = [len(r.prompt) for r in reqs]
    max_len = args.max_len or max(lens) + max(r.max_new for r in reqs) + 1
    eng = E.ServingEngine(params, cfg, slots=args.slots or len(reqs), max_len=max_len,
                          prefill=args.prefill, speculative=args.speculative,
                          spec_gamma=args.spec_gamma or None, queue_cap=args.queue_cap or None,
                          device=dev)
    admitted = [eng.submit(r) for r in reqs]
    if not args.json:
        print(f"[serve] kv_cache_dtype={cfg.kv_cache_dtype}: cache resident "
              f"{E.cache_nbytes(eng.caches) / 2**20:.2f} MiB on {dev}")
        if args.speculative and not eng.speculative:
            print(f"[serve] speculative requested but prefill={eng.prefill!r} stays on "
                  "plain decode")

    t0 = time.perf_counter()
    first_tok_at = {}
    eng.on_emit = lambda req, toks: first_tok_at.setdefault(req.rid, time.perf_counter() - t0)
    ticks = 0
    while eng.queue or any(s is not None for s in eng.live):
        eng.step()
        ticks += 1
    dt = time.perf_counter() - t0
    stats = eng.stats()
    total = sum(len(r.generated) for r in reqs)
    ttft = sorted(first_tok_at.values())

    if args.json:
        json.dump({
            "requests": [{"rid": r.rid, "status": r.status.name, "detail": r.status_detail,
                          "tokens": [int(t) for t in r.generated],
                          "preemptions": r.preemptions} for r in reqs],
            "admitted": sum(admitted), "rejected": len(reqs) - sum(admitted),
            "tokens": total, "ticks": stats["ticks"], "seconds": dt,
            "ttft_ms": [t * 1e3 for t in ttft], "statuses": stats["statuses"],
            "events": stats["events"], "device": str(dev),
        }, sys.stdout, indent=2)
        print()
    else:
        print(f"[serve] prefill={eng.prefill} lens={lens}: served {sum(admitted)}/{len(reqs)} "
              f"admitted, {total} tokens in {ticks} ticks / {dt * 1e3:.1f} ms")
        if ttft:
            print(f"[serve] time-to-first-token ms: min={ttft[0] * 1e3:.1f} "
                  f"max={ttft[-1] * 1e3:.1f}")
        print(f"[serve] throughput: {total / max(dt, 1e-9):.1f} tok/s")
        if eng.speculative:
            rates = " ".join(f"r{r.rid}={r.spec_acceptance:.2f}" for r in reqs)
            print(f"[serve] speculative gamma={eng.spec_gamma}: acceptance "
                  f"{eng.spec_acceptance_rate:.2f} overall ({rates})")
        for r in reqs:
            note = f" ({r.status_detail})" if r.status_detail else ""
            pre = f" preempted x{r.preemptions}" if r.preemptions else ""
            print(f"  req {r.rid}: prompt={len(r.prompt)} [{r.status.name}{note}]{pre} -> "
                  f"{len(r.generated)} tokens")
        print(f"[serve] statuses: {stats['statuses']} | preemptions={stats['preemptions']} "
              f"quarantined={stats['quarantined']} "
              f"stragglers={stats['straggler']['straggler_events']}")
    bad = [r for r, a in zip(reqs, admitted) if a and r.status.name != "OK"]
    return 1 if bad else 0


if __name__ == "__main__":
    raise SystemExit(main())
