"""Async streaming front door: HTTP/SSE over the ``ServingEngine`` tick loop
(``repro/serving/server.py``).

An asyncio HTTP/1.1 + SSE server on the standard library that streams the
tokens of each scheduler tick and maps every terminal status of a request
onto the transport.

Threading model
---------------
The engine is single-threaded (host bookkeeping, one tick at a time), so all
engine access happens on one **driver thread** (:class:`EngineDriver`): it
drains a thread-safe command queue (submits, cancels, stats snapshots posted
by the asyncio side), then runs ``engine.step()`` whenever work exists.
Results flow the other way through the engine's ``on_emit``/``on_finish``
hooks, fired by ``step()`` after the tick's one device-to-host transfer,
which the driver bridges onto per-request :class:`asyncio.Queue` s via
``loop.call_soon_threadsafe``. The asyncio side never touches the engine or
the card; the driver never touches a socket. The driver steps the engine
under ``torch.inference_mode()``, and every driver launches on the
device's default stream (decode attention's ticket buffer is one per
device, ``kernels/decode_attention/ops.py``).

Transport contract
------------------
``POST /v1/generate`` (JSON body ``{"prompt": [ids], "max_new": N,
"priority": P, "deadline_s": S, "slo": C}``; the ``x-priority``,
``x-deadline-s`` and ``x-slo`` headers stand in for absent keys) answers:

* ``429`` + ``Retry-After`` when the bounded admission queue is full:
  backpressure is a rejection at admission, never unbounded buffering;
* ``503`` during warmup and drain (``/readyz`` mirrors this);
* ``400`` for a malformed body or an unknown SLO class, ``404`` for any
  other route;
* otherwise ``200 text/event-stream``: ``event: start`` ``{"rid": r}``,
  then per emitted token ``event: token`` ``{"index": i, "token": t}``,
  then exactly one terminal event and EOF: ``event: done`` ``{"status":
  "OK" | "CACHE_EXHAUSTED" | "DEADLINE_EXCEEDED" | "CANCELLED", ...}`` or
  ``event: error`` ``{"status": "QUARANTINED" | "FAILED", ...}``. A tick
  the engine contains therefore ends its streams with ``error``, never a
  hung connection.

A client that disconnects mid-stream has its request cancelled; the next
tick retires it ``CANCELLED`` and frees its slot, and co-batched streams do
not change.

Drain (SIGTERM): ``serving -> draining -> stopped``. ``begin_drain()`` flips
``/readyz`` to 503 and rejects new generates at once; in-flight requests
finish or time out on the still-running engine; past ``drain_timeout_s``
every remaining request is cancelled (the hard kill). Then the listener
closes, the driver stops (failing any stream still tracked), lingering
sockets are closed, and the launcher exits 0.

Deliberate differences from JAX, both because a failure on the card must
not hide:

* **The warmup is not swallowed.** The default warmup loads the kernel
  library (on a CUDA engine) and runs one short request through the
  engine, which launches the kernels; the request must end ``OK``, since
  the engine contains a failing tick. An exception there ends the driver
  thread and is kept in ``EngineDriver.error``: ``crashed`` becomes true and
  ``ready`` stays unset. ``ServingServer.start()`` raises it for a single
  engine; a replica pool treats it as a crash (quarantine, backoff, restart
  from the factory). JAX drops any warmup exception and reports ready.
* **A second failure still ends every stream.** ``step()`` raises only when
  the engine could not rebuild its device state (a lost CUDA context). The
  driver then contains the tick itself (:meth:`EngineDriver._contain`);
  if that rebuild raises too, the driver fails every tracked stream
  (``error`` events) and its thread ends ``crashed``, not ``stopped``, so a
  pool migrates the replica's unfinished requests (``export_requests``
  reads host state only). JAX assumes ``step()`` never raises and lets the
  thread die with its streams open. A contained tick also delivers the
  terminal events of the requests it ended, queued and live.
"""

from __future__ import annotations

import asyncio
import itertools
import json
import queue as thread_queue
import threading
import time

import numpy as np
import torch

from ..configs.base import resolve_slo
from . import engine as E
from . import resilience as R

# Terminal status -> SSE event name: QUARANTINED and FAILED are faults of the
# server (event: error), every other status a normal end (event: done)
SSE_EVENT_FOR_STATUS = {
    "OK": "done",
    "CACHE_EXHAUSTED": "done",
    "DEADLINE_EXCEEDED": "done",
    "CANCELLED": "done",
    "QUARANTINED": "error",
    "FAILED": "error",
}

_MAX_BODY_BYTES = 8 << 20
_HEADER_TIMEOUT_S = 30.0


def sse_event(event: str, data: dict) -> bytes:
    return f"event: {event}\ndata: {json.dumps(data)}\n\n".encode()


class _StreamSink:
    """Driver thread -> asyncio bridge for one request's event stream."""

    def __init__(self, loop: asyncio.AbstractEventLoop):
        self.loop = loop
        self.queue: asyncio.Queue = asyncio.Queue()

    def push(self, item) -> None:  # driver thread
        try:
            self.loop.call_soon_threadsafe(self.queue.put_nowait, item)
        except RuntimeError:
            pass  # the loop is closed: the stream's connection is gone too


class EngineDriver:
    """Owns the engine's thread; the only code that touches the engine.

    Commands (submit, cancel, stats) arrive on a thread-safe queue and run
    between ticks; tokens and terminal events ride the engine's
    ``on_emit``/``on_finish`` hooks. The pool's taps: ``emit_listener(req,
    toks)`` and ``finish_listener(req)`` fire on the driver thread for every
    request; ``fault_hook(driver)`` runs at the top of each loop iteration
    (where a pool injects ``replica_crash``, a ``SystemExit`` that ends the
    thread with no cleanup, and ``replica_hang``, a sleep); ``beat`` is the
    loop's heartbeat on ``clock``, which the pool's hang detector reads.
    See the module docstring for the warmup and the second failure.
    """

    def __init__(self, engine: E.ServingEngine, *, poll_s: float | None = None,
                 warmup=True, name: str = "engine-driver", clock=time.monotonic):
        self.engine = engine
        self.poll_s = (float(getattr(engine.cfg, "server_poll_s", 0.001))
                       if poll_s is None else float(poll_s))
        self._warmup = warmup  # True: the default request; a callable: custom
        self._clock = clock
        self._cmds: thread_queue.SimpleQueue = thread_queue.SimpleQueue()
        self._post_lock = threading.Lock()
        self._closed = False  # no command is taken once the loop has ended
        self._wake = threading.Event()
        self._stop = threading.Event()
        self.ready = threading.Event()  # set once the warmup completed
        self.error: BaseException | None = None  # why the thread ended early
        self._rids = itertools.count(1)
        self._sinks: dict[int, _StreamSink] = {}  # driver thread only
        self._open: dict[int, E.Request] = {}  # submitted here, not yet finished
        self.emit_listener = None  # callable(req, list[int]) | None
        self.finish_listener = None  # callable(req) | None
        self.fault_hook = None  # callable(driver) | None
        self.beat = clock()
        engine.on_emit = self._on_emit
        engine.on_finish = self._on_finish
        self._thread = threading.Thread(target=self._run, name=name, daemon=True)

    # -- asyncio-side API ----------------------------------------------------

    def start(self) -> None:
        self._thread.start()

    @property
    def stopped(self) -> bool:
        return self._stop.is_set() or self._closed or not self._thread.is_alive()

    @property
    def crashed(self) -> bool:
        """The thread ended without being asked to stop: a crash, a failed
        warmup or an uncontainable tick (never true before ``start()``)."""
        return (self._thread.ident is not None and not self._thread.is_alive()
                and not self._stop.is_set())

    @property
    def tracked(self) -> int:
        """Streams with no terminal event delivered yet."""
        return len(self._sinks)

    def tracked_rids(self) -> list[int]:
        return list(self._sinks)

    async def wait_warmup(self, poll_s: float = 0.01) -> None:
        """Return once the warmup completed; raise its error if it failed
        (or ``RuntimeError`` if the thread ended another way first)."""
        while not self.ready.is_set():
            if self.crashed:
                if self.error is not None:
                    raise self.error
                raise RuntimeError("the engine driver ended during its warmup")
            await asyncio.sleep(poll_s)

    async def submit(self, prompt, *, max_new: int, priority: int = 0,
                     deadline_s: float | None = None, slo: str | None = None,
                     budget_weight: float = 1.0):
        """Submit on the driver thread; returns ``(rid, sink)``, or None when
        the bounded admission queue rejected it (the HTTP 429 path)."""
        loop = asyncio.get_running_loop()
        fut: asyncio.Future = loop.create_future()
        rid = next(self._rids)
        sink = _StreamSink(loop)
        prompt = np.asarray(prompt, np.int64)

        def cmd():
            req = E.Request(rid=rid, prompt=prompt, max_new=int(max_new),
                            priority=int(priority),
                            deadline_s=None if deadline_s is None else float(deadline_s),
                            slo=slo, budget_weight=float(budget_weight))
            ok = self.engine.submit(req)
            if ok:
                self._sinks[rid] = sink
                self._open[rid] = req
            loop.call_soon_threadsafe(_resolve, fut, ok)

        self._post(cmd)
        return (rid, sink) if await fut else None

    def cancel(self, rid: int) -> None:
        self._post(lambda: self.engine.cancel(rid))

    # -- pool-side API (thread-safe, no asyncio loop needed) -----------------

    def submit_request(self, req: E.Request, cb=None) -> None:
        """Post a built :class:`Request` for admission on the driver thread;
        ``cb(ok)`` runs there right after ``engine.submit``. Raises
        ``ConnectionError`` when the driver has stopped or died."""
        def cmd():
            ok = self.engine.submit(req)
            if ok:
                self._open[req.rid] = req
            if cb is not None:
                cb(ok)

        self._post(cmd)

    def stats_blocking(self, timeout_s: float = 1.0) -> dict | None:
        """Engine stats taken on the driver thread, awaited with a plain
        event; None when the driver has stopped, died, or is wedged past
        ``timeout_s`` (a hung replica must not hang ``/v1/stats``)."""
        box: dict = {}
        done = threading.Event()

        def cmd():
            box["s"] = self.engine.stats()
            done.set()

        try:
            self._post(cmd)
        except ConnectionError:
            return None
        if not done.wait(timeout_s):
            return None
        return box.get("s")

    async def stats(self) -> dict:
        """Engine stats taken on the driver thread (no torn reads)."""
        loop = asyncio.get_running_loop()
        fut: asyncio.Future = loop.create_future()

        def cmd():
            s = self.engine.stats()
            s["tracked_streams"] = self.tracked
            loop.call_soon_threadsafe(_resolve, fut, s)

        self._post(cmd)
        return await fut

    def stop(self) -> None:
        """Stop the driver (blocking; from asyncio via ``asyncio.to_thread``).
        Every stream still tracked is failed so that none hangs."""
        self._stop.set()
        self._wake.set()
        if self._thread.ident is not None:
            self._thread.join(timeout=10.0)

    # -- driver thread -------------------------------------------------------

    def _post(self, cmd) -> None:
        with self._post_lock:
            if self.stopped:
                # fail now rather than queue into a dead thread, whose
                # commands' futures would never complete
                raise ConnectionError("engine driver is stopped")
            self._cmds.put(cmd)
        self._wake.set()

    def _close(self) -> None:
        """Take no more commands, run those already posted, then end every
        tracked stream: nothing is left waiting on this thread."""
        with self._post_lock:
            self._closed = True
        self._drain_cmds()

    def _run(self) -> None:
        # inference mode is per thread: an engine built under it (its caches
        # inference tensors) is updated in place here
        with torch.inference_mode():
            self._serve()

    def _serve(self) -> None:
        try:
            if callable(self._warmup):
                self._warmup()
            elif self._warmup:
                self._default_warmup()
        except Exception as exc:  # noqa: BLE001 -- kept, and the thread ends
            self.error = exc
            self._close()
            self._fail_tracked(f"warmup_failed: {type(exc).__name__}")
            return
        self.ready.set()
        eng = self.engine
        while not self._stop.is_set():
            self.beat = self._clock()
            if self.fault_hook is not None:
                # may raise SystemExit (replica_crash: the thread dies here
                # with no cleanup, as in a real crash) or sleep (replica_hang)
                self.fault_hook(self)
            self._drain_cmds()
            if eng.queue or any(r is not None for r in eng.live):
                try:
                    eng.step()
                except Exception as exc:  # noqa: BLE001 -- the rebuild failed
                    try:
                        self._contain(f"driver_escape: {type(exc).__name__}")
                    except Exception as again:  # noqa: BLE001 -- uncontainable
                        self.error = again
                        self._close()
                        self._fail_tracked(f"driver_crash: {type(again).__name__}")
                        return
            else:
                self._wake.wait(self.poll_s)
                self._wake.clear()
        self._close()
        self._fail_tracked("server_shutdown")

    def _drain_cmds(self) -> None:
        while True:
            try:
                cmd = self._cmds.get_nowait()
            except thread_queue.Empty:
                return
            try:
                cmd()
            except Exception:  # noqa: BLE001 -- a bad command must not kill us
                pass

    def _default_warmup(self) -> None:
        """Before ``/readyz`` goes true: load the kernel library (a CUDA
        engine) and run one short request through prefill and decode, which
        launches the kernels. rid 0 is never handed out, so the hooks and a
        pool ignore it. Any exception propagates, and so does a request that
        did not end ``OK``: the engine contains a failing tick (the request
        ends ``FAILED``), so a kernel that fails would pass unseen."""
        eng = self.engine
        if eng.dev.type == "cuda":
            from ..kernels import _build

            _build.library()
        vocab = int(getattr(eng.cfg, "vocab_size", 2))
        req = E.Request(rid=0, prompt=np.arange(1, 9, dtype=np.int64) % vocab, max_new=2)
        eng.submit(req)
        while not req.done and (eng.queue or any(r is not None for r in eng.live)):
            eng.step()
        if req.status is not R.Status.OK:
            raise RuntimeError(f"the warmup request ended {req.status.name} "
                               f"({req.status_detail})")

    def _contain(self, detail: str) -> None:
        """``step()`` raised, so the engine could not rebuild its device
        state: end every live and queued request ``FAILED``, rebuild once
        more, and deliver the terminal events of every request that ended.
        Raises if the rebuild fails again."""
        eng = self.engine
        eng._fail_all_live(detail)
        queued, eng.queue = list(eng.queue), []
        for req in queued:
            eng._finish(None, req, R.Status.FAILED, detail=detail)
        for req in list(self._open.values()):
            if req.done:
                self._on_finish(req)

    def _fail_tracked(self, detail: str) -> None:
        """Deliver a terminal event to every stream still tracked: no
        connection waits on a queue nobody will fill."""
        for rid in list(self._sinks):
            req = self._open.get(rid)
            if req is None:
                req = E.Request(rid=rid, prompt=[], max_new=0)
            if not req.done:
                req.done = True
                req.status = R.Status.FAILED
                req.status_detail = detail
            self._on_finish(req)

    # -- engine hooks (driver thread, fired by step()) -----------------------

    def _on_emit(self, req: E.Request, toks: list) -> None:
        if self.emit_listener is not None:
            self.emit_listener(req, toks)
        sink = self._sinks.get(req.rid)
        if sink is not None:
            sink.push(("tokens", [int(t) for t in toks]))

    def _on_finish(self, req: E.Request) -> None:
        if self.finish_listener is not None:
            self.finish_listener(req)
        sink = self._sinks.pop(req.rid, None)
        self._open.pop(req.rid, None)
        if sink is not None:
            sink.push(("final", req.status.name, req.status_detail, len(req.generated)))


def _resolve(fut: asyncio.Future, value) -> None:
    if not fut.done():
        fut.set_result(value)


class ServingServer:
    """The HTTP/SSE front door over one backend: a bare ``ServingEngine``
    (wrapped in one :class:`EngineDriver`) or a ``serving.pool.ReplicaPool``
    (its ``IS_POOL`` marker; the pool owns its drivers, SLO admission,
    routing and failover, and the server routes submits, cancels and stats
    to it).

    Lifecycle: ``await start()`` binds the socket (``/readyz`` answers 503
    until ready), starts the driver and, for a single engine, waits for the
    warmup and raises its error; ``begin_drain()`` is the SIGTERM handler (idempotent); ``await
    serve_until_drained()`` is the launcher's main await. Tests call
    ``drain_and_stop`` directly with a short timeout.
    """

    def __init__(self, engine, *, host: str | None = None, port: int | None = None,
                 drain_timeout_s: float | None = None, warmup=True,
                 poll_s: float | None = None):
        cfg = engine.cfg
        self.cfg = cfg
        if getattr(engine, "IS_POOL", False):
            self.pool = engine
            self.driver = None
        else:
            self.pool = None
            self.driver = EngineDriver(engine, warmup=warmup, poll_s=poll_s)
        self.host = getattr(cfg, "server_host", "127.0.0.1") if host is None else host
        self.port = int(getattr(cfg, "server_port", 8080)) if port is None else int(port)
        self.drain_timeout_s = (float(getattr(cfg, "server_drain_timeout_s", 30.0))
                                if drain_timeout_s is None else float(drain_timeout_s))
        self.draining = False
        self._drained = None  # asyncio.Event, made by start()
        self._server = None
        self._loop = None
        self._writers: set[asyncio.StreamWriter] = set()

    # -- lifecycle -----------------------------------------------------------

    async def start(self) -> "ServingServer":
        self._loop = asyncio.get_running_loop()
        self._drained = asyncio.Event()
        if self.pool is not None:
            self.pool.start()
        else:
            self.driver.start()
        self._server = await asyncio.start_server(self._handle, self.host, self.port)
        self.port = self._server.sockets[0].getsockname()[1]
        if self.driver is not None:
            try:
                await self.driver.wait_warmup()
            except BaseException:
                self._server.close()
                await self._server.wait_closed()
                raise
        return self

    @property
    def ready(self) -> bool:
        if self.pool is not None:
            return self.pool.ready and not self.draining and not self.pool.stopped
        return self.driver.ready.is_set() and not self.draining and not self.driver.stopped

    def _not_ready_text(self) -> str:
        if self.draining:
            return "draining"
        if self.driver is not None and self.driver.crashed:
            return "engine failed"
        return "warming up"

    def begin_drain(self) -> None:
        """SIGTERM: flip to draining now (readyz 503, new generates
        rejected) and finish the rest asynchronously."""
        if not self.draining:
            self.draining = True
            self._loop.create_task(self.drain_and_stop())

    async def drain_and_stop(self, timeout_s: float | None = None) -> None:
        """Stop admitting, let in-flight requests finish or time out,
        cancel the leftovers at the timeout, then stop the driver and close
        lingering sockets."""
        self.draining = True
        timeout = self.drain_timeout_s if timeout_s is None else timeout_s
        deadline = self._loop.time() + timeout
        while self._loop.time() < deadline and not await self._idle():
            await asyncio.sleep(0.02)
        if not await self._idle():  # the hard kill
            for rid in self._tracked_rids():
                self._cancel(rid)
            grace = self._loop.time() + 2.0
            while self._loop.time() < grace and not await self._idle():
                await asyncio.sleep(0.02)
        self._server.close()
        await self._server.wait_closed()
        stop = self.pool.stop if self.pool is not None else self.driver.stop
        await asyncio.to_thread(stop)  # fails any leftover stream
        await asyncio.sleep(0.05)  # let the final events flush through the handlers
        for w in list(self._writers):  # no stuck connection
            w.close()
        self._drained.set()

    async def serve_until_drained(self) -> None:
        await self._drained.wait()

    def _tracked_rids(self) -> list[int]:
        return self.pool.tracked_rids() if self.pool is not None else self.driver.tracked_rids()

    def _cancel(self, rid: int) -> None:
        try:
            (self.pool or self.driver).cancel(rid)
        except ConnectionError:
            pass  # the driver is gone: its streams were failed on the way out

    async def _idle(self) -> bool:
        if self.pool is not None:
            return self.pool.stopped or self.pool.idle()
        if self.driver.stopped:
            return True
        try:
            s = await self.driver.stats()
        except ConnectionError:
            return True
        return s["queued"] == 0 and s["live"] == 0 and s["tracked_streams"] == 0

    # -- HTTP ----------------------------------------------------------------

    async def _handle(self, reader: asyncio.StreamReader,
                      writer: asyncio.StreamWriter) -> None:
        self._writers.add(writer)
        try:
            try:
                method, path, headers, body = await asyncio.wait_for(
                    _read_request(reader), _HEADER_TIMEOUT_S)
            except (asyncio.TimeoutError, asyncio.IncompleteReadError, ValueError,
                    ConnectionError):
                return
            if method == "GET" and path == "/healthz":
                await _plain(writer, 200, "ok")
            elif method == "GET" and path == "/readyz":
                if self.ready:
                    await _plain(writer, 200, "ready")
                else:
                    await _plain(writer, 503, self._not_ready_text())
            elif method == "GET" and path == "/v1/stats":
                await self._handle_stats(writer)
            elif method == "POST" and path == "/v1/generate":
                await self._handle_generate(reader, writer, headers, body)
            else:
                await _plain(writer, 404, f"no route {method} {path}")
        except (ConnectionError, asyncio.CancelledError):
            pass
        finally:
            self._writers.discard(writer)
            writer.close()
            try:
                await writer.wait_closed()
            except Exception:  # noqa: BLE001
                pass

    async def _handle_stats(self, writer: asyncio.StreamWriter) -> None:
        if self.pool is not None:
            if self.pool.stopped:
                return await _plain(writer, 503, "stopped")
            # a wedged replica makes pool.stats() wait its per-replica
            # timeout: keep the event loop out of that wait
            s = await asyncio.to_thread(self.pool.stats)
        else:
            if self.driver.stopped:
                return await _plain(writer, 503, "stopped")
            s = await self.driver.stats()
        s["draining"] = self.draining
        s["ready"] = self.ready
        await _plain(writer, 200, json.dumps(s), ctype="application/json")

    async def _handle_generate(self, reader, writer, headers: dict, body: bytes) -> None:
        if not self.ready:
            return await _plain(writer, 503, self._not_ready_text(),
                                extra={"retry-after": "1"})
        try:
            payload = json.loads(body or b"{}")
            prompt = [int(t) for t in payload["prompt"]]
            max_new = int(payload.get("max_new", 16))
            # the SLO class seeds priority, deadline and chunk-budget weight;
            # explicit priority/deadline_s override it; an unknown class is
            # a KeyError, so a 400
            slo = payload.get("slo", headers.get("x-slo"))
            slo = None if slo is None else str(slo)
            priority, deadline_s, weight = 0, None, 1.0
            if slo is not None:
                priority, deadline_s, weight = resolve_slo(self.cfg, slo)
            raw_prio = payload.get("priority", headers.get("x-priority"))
            if raw_prio is not None:
                priority = int(raw_prio)
            raw_deadline = payload.get("deadline_s", headers.get("x-deadline-s"))
            if raw_deadline is not None:
                deadline_s = float(raw_deadline)
            if max_new < 1:
                raise ValueError("max_new must be >= 1")
        except (KeyError, TypeError, ValueError) as exc:
            return await _plain(writer, 400, f"bad request: {exc}")

        if self.pool is not None:
            sink = _StreamSink(asyncio.get_running_loop())
            rid = self.pool.submit(prompt, max_new=max_new, slo=slo, priority=priority,
                                   deadline_s=deadline_s, budget_weight=weight, sink=sink)
            sub = None if rid is None else (rid, sink)
        else:
            sub = await self.driver.submit(prompt, max_new=max_new, priority=priority,
                                           deadline_s=deadline_s, slo=slo,
                                           budget_weight=weight)
        if sub is None:  # the bounded admission queue: backpressure, not buffering
            return await _plain(writer, 429, "admission queue full",
                                extra={"retry-after": "1"})
        rid, sink = sub
        writer.write(b"HTTP/1.1 200 OK\r\n"
                     b"content-type: text/event-stream\r\n"
                     b"cache-control: no-cache\r\n"
                     b"connection: close\r\n\r\n")
        writer.write(sse_event("start", {"rid": rid}))
        try:
            await writer.drain()
        except ConnectionError:
            self._cancel(rid)

        # reader EOF = the client went away: cancel, then keep draining the
        # sink until the terminal event ends the stream
        eof_task = asyncio.ensure_future(reader.read())
        get_task = asyncio.ensure_future(sink.queue.get())
        disconnected = False
        idx = 0
        try:
            while True:
                pending = {get_task} | ({eof_task} if not disconnected else set())
                done, _ = await asyncio.wait(pending, return_when=asyncio.FIRST_COMPLETED)
                if eof_task in done and not disconnected:
                    disconnected = True
                    self._cancel(rid)
                if get_task not in done:
                    continue
                item = get_task.result()
                if item[0] == "tokens":
                    if not disconnected:
                        for t in item[1]:
                            writer.write(sse_event("token", {"index": idx, "token": t}))
                            idx += 1
                        try:
                            await writer.drain()
                        except ConnectionError:
                            disconnected = True
                            self._cancel(rid)
                    else:
                        idx += len(item[1])
                    get_task = asyncio.ensure_future(sink.queue.get())
                    continue
                _, status, detail, n_tokens = item
                if not disconnected:
                    writer.write(sse_event(SSE_EVENT_FOR_STATUS.get(status, "error"),
                                           {"status": status, "detail": detail,
                                            "tokens": n_tokens}))
                    try:
                        await writer.drain()
                    except ConnectionError:
                        pass
                return
        finally:
            for t in (eof_task, get_task):
                if not t.done():
                    t.cancel()


async def _read_request(reader: asyncio.StreamReader):
    """A minimal HTTP/1.1 request parse: request line, headers, a body by
    Content-Length. One request per connection (``Connection: close``)."""
    line = await reader.readline()
    if not line:
        raise ConnectionError("empty request")
    method, path, _ = line.decode("latin-1").split()
    headers: dict[str, str] = {}
    while True:
        raw = await reader.readline()
        if raw in (b"\r\n", b"\n", b""):
            break
        key, _, value = raw.decode("latin-1").partition(":")
        headers[key.strip().lower()] = value.strip()
    length = int(headers.get("content-length", 0))
    if length > _MAX_BODY_BYTES:
        raise ValueError(f"body too large: {length}")
    body = await reader.readexactly(length) if length else b""
    return method, path.split("?", 1)[0], headers, body


async def _plain(writer: asyncio.StreamWriter, status: int, text: str, *,
                 ctype: str = "text/plain", extra: dict | None = None) -> None:
    reason = {200: "OK", 400: "Bad Request", 404: "Not Found", 413: "Payload Too Large",
              429: "Too Many Requests", 503: "Service Unavailable"}.get(status, "")
    body = text.encode()
    head = [f"HTTP/1.1 {status} {reason}", f"content-type: {ctype}",
            f"content-length: {len(body)}", "connection: close"]
    for k, v in (extra or {}).items():
        head.append(f"{k}: {v}")
    writer.write(("\r\n".join(head) + "\r\n\r\n").encode() + body)
    try:
        await writer.drain()
    except ConnectionError:
        pass


# ---------------------------------------------------------------------------
# A client of the front door (the tests and the on-card check use it)
# ---------------------------------------------------------------------------


async def sse_request(host: str, port: int, payload: dict, *,
                      disconnect_after: int | None = None) -> dict:
    """One ``POST /v1/generate``; returns what the client saw: the HTTP
    status, the SSE events, the token ids and their indexes, the terminal
    status and detail, ``Retry-After``, the send and first-token times
    (``time.perf_counter``), and whether it hung up after
    ``disconnect_after`` tokens."""
    rec = {"http": None, "tokens": [], "indexes": [], "events": [], "status": None,
           "detail": None, "t_sent": time.perf_counter(), "t_first": None,
           "retry_after": None, "disconnected": False}
    reader, writer = await asyncio.open_connection(host, port)
    try:
        body = json.dumps(payload).encode()
        writer.write((f"POST /v1/generate HTTP/1.1\r\nhost: {host}\r\n"
                      f"content-length: {len(body)}\r\n\r\n").encode() + body)
        await writer.drain()
        status_line = await reader.readline()
        rec["http"] = int(status_line.split()[1])
        headers = {}
        while True:
            line = await reader.readline()
            if line in (b"\r\n", b"\n", b""):
                break
            k, _, v = line.decode().partition(":")
            headers[k.strip().lower()] = v.strip()
        rec["retry_after"] = headers.get("retry-after")
        if rec["http"] != 200:
            return rec
        event = None
        while True:
            line = await reader.readline()
            if not line:
                break  # EOF: the stream closed after its terminal event
            line = line.strip().decode()
            if line.startswith("event:"):
                event = line.split(":", 1)[1].strip()
            elif line.startswith("data:"):
                data = json.loads(line.split(":", 1)[1])
                rec["events"].append(event)
                if event == "token":
                    if rec["t_first"] is None:
                        rec["t_first"] = time.perf_counter()
                    rec["tokens"].append(data["token"])
                    rec["indexes"].append(data["index"])
                    if disconnect_after is not None and len(rec["tokens"]) >= disconnect_after:
                        rec["disconnected"] = True
                        return rec  # an abrupt close: the server must cancel
                elif event in ("done", "error"):
                    rec["status"] = data["status"]
                    rec["detail"] = data.get("detail")
        return rec
    finally:
        writer.close()
        try:
            await writer.wait_closed()
        except Exception:  # noqa: BLE001
            pass


async def http_get(host: str, port: int, path: str) -> tuple[int, bytes]:
    """One GET; returns (status, body)."""
    reader, writer = await asyncio.open_connection(host, port)
    try:
        writer.write(f"GET {path} HTTP/1.1\r\nhost: {host}\r\n\r\n".encode())
        await writer.drain()
        raw = await reader.read()
    finally:
        writer.close()
    head, _, body = raw.partition(b"\r\n\r\n")
    return int(head.split()[1]), body
