"""PyTorch port, the HTTP/SSE front door (``repro_torch/serving/server.py``)
and its launcher, on the tellme-0.7b smoke config in f32 over real loopback
sockets, against the JAX package's ``ServingServer`` over
``ServingEngine(mode="packed")`` on the same packed weights.

Bars:
* SSE token streams equal JAX's server and a direct run of the port's
  engine, co-batched streams included;
* a deadline (an injected engine clock) ends a queued request
  ``DEADLINE_EXCEEDED`` with no token, and a higher priority (the
  ``x-priority`` header) preempts the running request, whose stream still
  equals its solo run;
* 429 with ``Retry-After`` past the bounded queue; ``/readyz`` 503 during
  the warmup, 200 after it; the graceful drain finishes in-flight streams,
  and its hard-kill timeout cancels the rest; a client that hangs up has
  its request cancelled while a co-batched stream stays equal to its solo
  run; 400 for a malformed body or an unknown SLO class, 404 for any other
  route; ``python -m repro_torch.launch.server ... --device cpu`` exits 0
  on SIGTERM, one engine and a two-replica pool; ``launch.serve`` serves a
  request file to ``OK`` with the engine's streams;
* the two deliberate differences from JAX: a warmup that raises, or whose
  request does not end ``OK``, leaves ``ready`` unset, keeps the error and
  makes ``start()`` raise it; a ``step()`` that raises (the engine's
  rebuild failed) is contained by the driver, which delivers every ended
  stream's ``error`` event and serves on, and when its own rebuild fails
  too, every open stream ends ``error`` and the driver ends ``crashed``.

Every wait is bounded (``asyncio.wait_for``, ``join(timeout)``) and every
server is drained in a ``finally``.
"""

import asyncio
import dataclasses
import json
import os
import signal
import subprocess
import sys
import threading
import time
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config
from repro.core import params as P
from repro.models import transformer as jT
from repro.serving import engine as jE
from repro.serving.server import ServingServer as JServingServer
from repro_torch import interop
from repro_torch.configs import get_config as t_get_config
from repro_torch.kernels import PLAIN
from repro_torch.serving import engine as TE
from repro_torch.serving.server import (SSE_EVENT_FOR_STATUS, ServingServer, http_get,
                                        sse_request)

REPO = Path(__file__).resolve().parents[1]
MAX_LEN = 192
BODY_TIMEOUT_S = 120.0


@pytest.fixture(scope="module")
def models():
    jcfg = dataclasses.replace(get_config("tellme-0.7b", smoke=True), dtype=jnp.float32)
    tcfg = dataclasses.replace(t_get_config("tellme-0.7b", smoke=True), dtype=torch.float32)
    specs = jT.param_specs(jcfg)
    jp = jT.pack_tree(P.init_params(specs, jax.random.PRNGKey(0)), specs)
    tp = interop.from_jax_params(jax.device_get(jp), tcfg, device="cpu")
    return jcfg, tcfg, jp, tp


def _engine(models, **kw):
    _, tcfg, _, tp = models
    kw = {"slots": 2, "max_len": MAX_LEN, "eos_id": -2, **kw}
    return TE.ServingEngine(tp, tcfg, device="cpu", **kw)


def _prompt(n, seed=0):
    rng = np.random.default_rng(seed)
    return [int(t) for t in rng.integers(1, 200, size=n)]


def _solo(models, prompt, max_new):
    eng = _engine(models)
    req = TE.Request(rid=0, prompt=np.asarray(prompt, np.int64), max_new=max_new)
    eng.submit(req)
    eng.run()
    return [int(t) for t in req.generated]


class Clock:
    """A clock that moves only when told to."""

    def __init__(self, t: float = 1000.0):
        self.t = t

    def __call__(self) -> float:
        return self.t

    def advance(self, dt: float) -> None:
        self.t += dt


async def _until(pred, what: str, timeout_s: float = 60.0):
    t0 = time.monotonic()
    while not pred():
        if time.monotonic() - t0 > timeout_s:
            raise AssertionError(f"timed out waiting for {what}")
        await asyncio.sleep(0.01)


def _run(body):
    return asyncio.run(asyncio.wait_for(body(), BODY_TIMEOUT_S))


async def _boot(engine, **kw):
    server = ServingServer(engine, host="127.0.0.1", port=0, **kw)
    await server.start()
    return server


async def _stop(server):
    if not server._drained.is_set():
        await asyncio.wait_for(server.drain_and_stop(5.0), 30.0)


async def _stats(server) -> dict:
    return json.loads((await http_get(server.host, server.port, "/v1/stats"))[1])


# ---------------------------------------------------------------------------
# Streams against JAX and the engine
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("batch", [1, 3])
def test_stream_equals_jax_server_and_engine(models, batch):
    jcfg, _, jp, _ = models
    prompts = [_prompt(n, seed=i) for i, n in enumerate((24, 40, 17)[:batch])]
    max_new = 6

    async def serve(server):
        await server.start()
        try:
            recs = await asyncio.gather(*(sse_request(server.host, server.port,
                                                      {"prompt": p, "max_new": max_new})
                                          for p in prompts))
        finally:
            await asyncio.wait_for(server.drain_and_stop(5.0), 30.0)
        return recs

    async def body():
        got = await serve(ServingServer(_engine(models), host="127.0.0.1", port=0))
        jeng = jE.ServingEngine(jp, jcfg, mode="packed", slots=2, max_len=MAX_LEN, eos_id=-2)
        want = await serve(JServingServer(jeng, host="127.0.0.1", port=0, warmup=False))
        return got, want

    got, want = _run(body)
    for g, w, p in zip(got, want, prompts):
        assert g["http"] == 200 and g["events"][0] == "start"
        assert g["status"] == "OK" and g["events"][-1] == SSE_EVENT_FOR_STATUS["OK"] == "done"
        assert g["indexes"] == list(range(max_new))
        assert g["tokens"] == w["tokens"] and w["status"] == "OK"
        assert g["tokens"] == _solo(models, p, max_new)


def test_deadline_and_priority_map_to_lifecycle(models):
    clock = Clock()
    blocker_prompt, late_prompt = _prompt(40, seed=1), _prompt(16, seed=2)

    async def body():
        server = await _boot(_engine(models, slots=1, clock=clock))
        try:
            blocker = asyncio.ensure_future(sse_request(
                server.host, server.port, {"prompt": blocker_prompt, "max_new": 140}))
            await _until(lambda: server.driver.tracked == 1, "the blocker")
            # the only slot is busy: a queued request whose deadline passes
            # ends DEADLINE_EXCEEDED with no token
            doomed = asyncio.ensure_future(sse_request(
                server.host, server.port,
                {"prompt": _prompt(16, seed=3), "max_new": 8, "deadline_s": 5.0}))
            await _until(lambda: server.driver.tracked == 2, "the deadline request")
            clock.advance(10.0)
            rec = await doomed
            assert rec["status"] == "DEADLINE_EXCEEDED" and rec["tokens"] == []
            assert rec["events"] == ["start", "done"]
            # a higher priority preempts the running blocker
            late = await sse_request(server.host, server.port,
                                     {"prompt": late_prompt, "max_new": 5, "priority": 5})
            assert late["status"] == "OK"
            first = await blocker
            assert first["status"] == "OK"
            stats = await _stats(server)
            assert stats["preemptions"] == 1
            assert stats["statuses"] == {"DEADLINE_EXCEEDED": 1, "OK": 3}  # the warmup's too
            return first["tokens"], late["tokens"]
        finally:
            await _stop(server)

    first, late = _run(body)
    assert first == _solo(models, blocker_prompt, 140)  # resumed as it ran
    assert late == _solo(models, late_prompt, 5)


def test_backpressure_429_with_retry_after(models):
    async def body():
        server = await _boot(_engine(models, slots=1, queue_cap=1))
        try:
            recs = await asyncio.gather(*(sse_request(server.host, server.port,
                                                      {"prompt": _prompt(32, seed=i),
                                                       "max_new": 8})
                                          for i in range(8)))
        finally:
            await _stop(server)
        rejected = [r for r in recs if r["http"] == 429]
        served = [r for r in recs if r["http"] == 200]
        assert rejected, "a burst against queue_cap=1 must meet 429s"
        assert all(r["retry_after"] == "1" for r in rejected)
        assert served and all(r["status"] == "OK" and len(r["tokens"]) == 8 for r in served)

    _run(body)


def test_readyz_false_during_warmup_then_true(models):
    gate = threading.Event()

    async def body():
        server = ServingServer(_engine(models), host="127.0.0.1", port=0,
                               warmup=lambda: gate.wait(60.0))
        starting = asyncio.ensure_future(server.start())  # waits for the warmup
        try:
            await _until(lambda: server.port != 0, "the socket")
            assert await http_get(server.host, server.port, "/readyz") == (503, b"warming up")
            assert (await http_get(server.host, server.port, "/healthz"))[0] == 200
            rec = await sse_request(server.host, server.port, {"prompt": [1, 2], "max_new": 2})
            assert rec["http"] == 503 and rec["retry_after"] == "1"
            assert not starting.done()
            gate.set()
            await asyncio.wait_for(starting, 60.0)
            assert server.ready
            assert await http_get(server.host, server.port, "/readyz") == (200, b"ready")
        finally:
            gate.set()
            await asyncio.wait_for(starting, 60.0)
            await _stop(server)

    _run(body)


def test_graceful_drain_finishes_inflight_streams(models):
    async def body():
        server = await _boot(_engine(models))
        try:
            inflight = asyncio.ensure_future(sse_request(
                server.host, server.port, {"prompt": _prompt(40), "max_new": 16}))
            await _until(lambda: server.driver.tracked == 1, "the stream")
            server.begin_drain()
            assert await http_get(server.host, server.port, "/readyz") == (503, b"draining")
            rec_new = await sse_request(server.host, server.port,
                                        {"prompt": _prompt(8), "max_new": 4})
            assert rec_new["http"] == 503
            rec = await inflight
            assert rec["status"] == "OK" and len(rec["tokens"]) == 16
            await asyncio.wait_for(server.serve_until_drained(), 30.0)
            assert server.driver.stopped and not server.driver.crashed
            assert server.driver.tracked == 0
        finally:
            await _stop(server)

    _run(body)


def test_drain_hard_kill_timeout_cancels_leftovers(models):
    async def body():
        server = await _boot(_engine(models))
        try:
            inflight = asyncio.ensure_future(sse_request(
                server.host, server.port, {"prompt": _prompt(40), "max_new": 4000}))
            await _until(lambda: server.driver.tracked == 1, "the stream")
            await asyncio.wait_for(server.drain_and_stop(0.2), 30.0)  # the hard kill
            rec = await asyncio.wait_for(inflight, 30.0)
            assert rec["status"] in ("CANCELLED", "CACHE_EXHAUSTED")
            assert rec["events"][-1] == "done"
            assert server.driver.tracked == 0
        finally:
            await _stop(server)

    _run(body)


def test_client_disconnect_cancels_and_keeps_cobatch_bit_identical(models):
    keep_prompt = _prompt(24, seed=7)

    async def body():
        server = await _boot(_engine(models))
        try:
            gone, kept = await asyncio.gather(
                sse_request(server.host, server.port,
                            {"prompt": _prompt(40, seed=3), "max_new": 64},
                            disconnect_after=1),
                sse_request(server.host, server.port, {"prompt": keep_prompt, "max_new": 8}))
            assert gone["disconnected"]
            assert kept["status"] == "OK" and len(kept["tokens"]) == 8
            stats = {}

            async def cancelled():
                stats.update(await _stats(server))
                return stats["statuses"].get("CANCELLED") == 1

            t0 = time.monotonic()
            while not await cancelled():
                assert time.monotonic() - t0 < 60, stats
                await asyncio.sleep(0.02)
            assert stats["live"] == 0 and stats["queued"] == 0
            return kept["tokens"]
        finally:
            await _stop(server)

    assert _run(body) == _solo(models, keep_prompt, 8)


def _post(payload: bytes) -> bytes:
    return b"POST /v1/generate HTTP/1.1\r\ncontent-length: %d\r\n\r\n%s" % (len(payload),
                                                                             payload)


@pytest.mark.parametrize("request_text, code", [
    (b"GET /nope HTTP/1.1\r\n\r\n", 404),
    (_post(b'{"max_new": 4}'), 400),  # no prompt
    (_post(b'{"prompt": [1, 2], "max_new": 2, "slo": "platinum"}'), 400),  # unknown class
    (_post(b'{"prompt": [1, 2], "max_new": 0}'), 400),
    (_post(b'{"prompt": [1, 2'), 400),  # not JSON
], ids=["no_route", "no_prompt", "unknown_slo", "max_new_0", "not_json"])
def test_unknown_route_and_bad_request(models, request_text, code):
    async def body():
        server = await _boot(_engine(models))
        try:
            reader, writer = await asyncio.open_connection(server.host, server.port)
            writer.write(request_text)
            await writer.drain()
            status = await asyncio.wait_for(reader.readline(), 30.0)
            writer.close()
            assert int(status.split()[1]) == code
        finally:
            await _stop(server)

    _run(body)


# ---------------------------------------------------------------------------
# The deliberate differences from JAX
# ---------------------------------------------------------------------------


def _boom():
    raise RuntimeError("kernel library failed to load")


def _raising_attention(*args, **kwargs):
    raise RuntimeError("decode attention failed to launch")


@pytest.mark.parametrize("warmup", ["raises", "request_fails"])
def test_warmup_failure_is_not_swallowed(models, warmup):
    """JAX drops a warmup exception and reports ready; the port keeps it,
    leaves ready unset, and start() raises it. The default warmup's request
    must end OK: a kernel that raises makes the engine contain the tick
    (FAILED), which would otherwise pass unseen."""
    if warmup == "raises":
        engine, kw, match = _engine(models), {"warmup": _boom}, "failed to load"
    else:
        kernels = dataclasses.replace(PLAIN, decode_attention=_raising_attention)
        engine, kw, match = _engine(models, kernels=kernels), {}, "warmup request ended FAILED"

    async def body():
        server = ServingServer(engine, host="127.0.0.1", port=0, **kw)
        with pytest.raises(RuntimeError, match=match):
            await server.start()
        drv = server.driver
        drv._thread.join(timeout=30.0)
        assert drv.crashed and not drv.ready.is_set()
        assert isinstance(drv.error, RuntimeError) and not server.ready
        with pytest.raises(ConnectionError):
            drv.submit_request(TE.Request(rid=1, prompt=[1, 2], max_new=1))

    _run(body)


class _LostContextEngine(TE.ServingEngine):
    """An engine whose first tick with three requests raises, and whose
    device-state rebuild then raises ``failures`` times, as after a lost
    CUDA context."""

    def __init__(self, *args, failures: int, **kwargs):
        super().__init__(*args, **kwargs)
        self.failures = failures
        self.rebuilds = 0
        self.tripped = False

    def _dispatch(self):
        if not self.tripped and sum(r is not None for r in self.live) + len(self.queue) == 3:
            self.tripped = True
            raise RuntimeError("kernel launch failed")
        return super()._dispatch()

    def _fail_all_live(self, detail):
        super()._fail_all_live(detail)
        self.rebuilds += 1
        if self.rebuilds <= self.failures:
            raise RuntimeError("CUDA error: the context is lost")


@pytest.mark.parametrize("failures", [1, 2])
def test_raising_step_ends_every_open_stream(models, failures):
    """A tick raises (two live requests, one queued) and the engine's
    rebuild raises, so step() raises. With one failure the driver's own
    containment rebuilds: the live and queued streams end with an error
    event, and the server serves on. With two the driver fails every
    tracked stream (error events) and ends crashed, not stopped; JAX's
    thread would die with the streams open."""
    _, tcfg, _, tp = models
    engine = _LostContextEngine(tp, tcfg, slots=2, max_len=MAX_LEN, eos_id=-2, device="cpu",
                                failures=failures)

    async def body():
        server = await _boot(engine, warmup=False)
        try:
            recs = await asyncio.wait_for(asyncio.gather(*(
                sse_request(server.host, server.port,
                            {"prompt": _prompt(30, seed=i), "max_new": 100})
                for i in range(3))), 60.0)
            for rec in recs:
                assert rec["http"] == 200
                assert rec["status"] == "FAILED" and rec["events"][-1] == "error"
                assert rec["events"].count("error") == 1
            drv = server.driver
            queued = "driver_escape: RuntimeError" if failures == 1 else "driver_crash: RuntimeError"
            assert sorted(r["detail"] for r in recs) == sorted(
                ["RuntimeError: kernel launch failed"] * 2 + [queued])
            if failures == 1:
                assert not drv.crashed and server.ready
                again = await sse_request(server.host, server.port,
                                          {"prompt": _prompt(20, seed=9), "max_new": 4})
                assert again["status"] == "OK" and len(again["tokens"]) == 4
            else:
                drv._thread.join(timeout=30.0)
                assert drv.crashed and isinstance(drv.error, RuntimeError)
                assert drv.tracked == 0 and not server.ready
                assert (await http_get(server.host, server.port, "/readyz"))[0] == 503
        finally:
            await _stop(server)

    _run(body)


# ---------------------------------------------------------------------------
# The launchers
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("replicas", [1, 2])
def test_server_launcher_sigterm_exits_zero(replicas):
    env = dict(os.environ)
    env["PYTHONPATH"] = str(REPO / "src") + os.pathsep + env.get("PYTHONPATH", "")
    proc = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.server", "--smoke", "--port", "0",
         "--device", "cpu", "--slots", "2", "--max-len", "192", "--replicas", str(replicas)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=env, cwd=REPO)
    try:
        line = proc.stdout.readline()
        assert "listening on http://" in line, line
        port = int(line.split("http://")[1].split()[0].rsplit(":", 1)[1])

        async def probe():
            await _until_ready(port)
            return await sse_request("127.0.0.1", port,
                                     {"prompt": list(range(1, 17)), "max_new": 4})

        rec = _run(probe)
        assert rec["status"] == "OK" and len(rec["tokens"]) == 4
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=60) == 0
        assert "drained, exiting 0" in proc.stdout.read()
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=30)
        proc.stdout.close()


async def _until_ready(port, timeout_s=60.0):
    t0 = time.monotonic()
    while (await http_get("127.0.0.1", port, "/readyz"))[0] != 200:
        assert time.monotonic() - t0 < timeout_s, "the launcher never became ready"
        await asyncio.sleep(0.05)


def test_serve_launcher_serves_request_file(tmp_path, capsys):
    from repro_torch.launch import serve
    from repro_torch.launch.server import build_params

    prompts = [_prompt(n, seed=i) for i, n in enumerate((20, 45, 9))]
    path = tmp_path / "requests.jsonl"
    path.write_text("".join(json.dumps({"rid": i, "prompt": p, "max_new": 5}) + "\n"
                            for i, p in enumerate(prompts)))
    rc = serve.main(["--smoke", "--device", "cpu", "--requests", str(path), "--json"])
    out = json.loads(capsys.readouterr().out)
    assert rc == 0 and out["statuses"] == {"OK": 3} and out["admitted"] == 3
    cfg = t_get_config("tellme-0.7b", smoke=True)
    eng = TE.ServingEngine(build_params(cfg, seed=0, device="cpu"), cfg, slots=3,
                           max_len=max(map(len, prompts)) + 6, device="cpu")
    reqs = [TE.Request(rid=i, prompt=np.asarray(p), max_new=5) for i, p in enumerate(prompts)]
    for r in reqs:
        eng.submit(r)
    eng.run()
    assert [r["tokens"] for r in out["requests"]] == [[int(t) for t in r.generated]
                                                      for r in reqs]
