"""HTTP/SSE server launcher: the streaming front door as a process
(``repro/launch/server.py``).

Builds packed ternary weights (random, from ``--seed``) on the device, one
``ServingEngine`` or, with ``--replicas N > 1``, a ``ReplicaPool`` of N
engines over one shared params tree, wraps it in
``serving.server.ServingServer``, turns SIGTERM and SIGINT into the graceful
drain, and serves until drained. Exit code 0 after a clean drain. On a CUDA
device the kernel library is built and loaded on the main thread before any
driver starts; a single engine's warmup error ends the launcher with it.

Endpoints: POST /v1/generate (an SSE token stream), GET /healthz, GET
/readyz, GET /v1/stats.

Run:  PYTHONPATH=src python -m repro_torch.launch.server --smoke --port 8080 [--device cpu]
Try:  curl -N localhost:8080/v1/generate -d '{"prompt": [1,2,3], "max_new": 8}'
"""

from __future__ import annotations

import argparse
import asyncio
import dataclasses
import signal

from .. import _common as C
from ..configs import get_config
from ..core import params as PR
from ..models import transformer as Tr
from ..serving import engine as E
from ..serving.pool import ReplicaPool
from ..serving.server import ServingServer


def build_params(cfg, *, seed: int, device):
    """Packed serving weights, random from ``seed``, on ``device``."""
    specs = Tr.param_specs(cfg)
    return Tr.pack_tree(PR.init_params(specs, seed=seed, device=device), specs,
                        dtype=cfg.dtype)


def load_kernels(dev) -> None:
    """Build and load the kernel library once, on this thread."""
    if dev.type == "cuda":
        from ..kernels import _build

        _build.library()


def _prepare(args):
    """(config, device, params) of the launch; the kernels loaded first."""
    cfg = dataclasses.replace(get_config(args.arch, smoke=args.smoke),
                              kv_cache_dtype=args.kv_cache_dtype)
    dev = C.resolve_device(args.device)
    load_kernels(dev)
    return cfg, dev, build_params(cfg, seed=args.seed, device=dev)


def build_engine(args) -> E.ServingEngine:
    cfg, dev, params = _prepare(args)
    return E.ServingEngine(params, cfg, slots=args.slots, max_len=args.max_len,
                           speculative=args.speculative, queue_cap=args.queue_cap or None,
                           device=dev)


def build_backend(args):
    """One bare engine, or with ``--replicas N > 1`` a ReplicaPool of N
    engines sharing one params tree (resumed streams need identical weights;
    sharing keeps device memory to one copy)."""
    if args.replicas <= 1:
        return build_engine(args)
    cfg, dev, params = _prepare(args)

    def factory(idx):
        return E.ServingEngine(params, cfg, slots=args.slots, max_len=args.max_len,
                               speculative=args.speculative, replica_id=idx, device=dev)

    return ReplicaPool(factory, cfg, replicas=args.replicas, queue_cap=args.queue_cap)


async def amain(args) -> int:
    server = ServingServer(build_backend(args), host=args.host, port=args.port,
                           drain_timeout_s=args.drain_timeout_s or None)
    await server.start()
    loop = asyncio.get_running_loop()
    for sig in (signal.SIGTERM, signal.SIGINT):
        loop.add_signal_handler(sig, server.begin_drain)
    print(f"[server] listening on http://{server.host}:{server.port} "
          f"(replicas={args.replicas} slots={args.slots} "
          f"queue_cap={args.queue_cap or 'unbounded'}); SIGTERM drains", flush=True)
    await server.serve_until_drained()
    print("[server] drained, exiting 0", flush=True)
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="tellme-0.7b")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA device; 'cpu' runs the plain "
                         "PyTorch versions on the host)")
    ap.add_argument("--seed", type=int, default=0, help="seed of the random weights")
    ap.add_argument("--host", default=None, help="bind host (default: cfg.server_host)")
    ap.add_argument("--port", type=int, default=None,
                    help="bind port, 0 = ephemeral (default: cfg.server_port)")
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--max-len", type=int, default=512)
    ap.add_argument("--kv-cache-dtype", default="bf16", choices=["bf16", "int8"])
    ap.add_argument("--speculative", action="store_true")
    ap.add_argument("--queue-cap", type=int, default=32,
                    help="bounded admission queue; full -> HTTP 429 (0 = unbounded)")
    ap.add_argument("--replicas", type=int, default=1,
                    help="N > 1 serves a ReplicaPool: SLO-class admission, health-gated "
                         "routing, crash failover")
    ap.add_argument("--drain-timeout-s", type=float, default=0.0,
                    help="the graceful drain's hard-kill timeout "
                         "(default: cfg.server_drain_timeout_s)")
    return asyncio.run(amain(ap.parse_args(argv)))


if __name__ == "__main__":
    raise SystemExit(main())
