"""Greedy generation and the chunked continuous-batching engine on the
packed model (``repro/serving/engine.py``).

``generate`` runs a length-bucketed one-shot prefill, then one decode step
per token. Tokens, positions and done flags stay on the device for the whole
loop; the token ids cross to the host once, at the end.

``ServingEngine`` serves a stream of requests over a fixed number of slots
(``engine.py:481``). Prompts prefill in chunks of ``cfg.prefill_chunk_sizes``
appended straight into the batched KV cache at each slot's offset, while
every decoding slot advances one token in the same tick (the fused tick:
decode first, then the chunk), so prefill never stalls decode. Slots with no
work in a tick are diverted into a trash tail past ``max_len``: a chunk at
``trash_base``, a decode row at ``cache_len - 1``. Per-slot decode state
stays on the device, and each tick makes exactly one device-to-host
transfer, of one packed int32 array. The contiguous layout is ported, with a
bf16 (activation-dtype) or int8 KV cache. Not ported yet: the legacy
per-request prefill of other families, speculative ticks, the paged layout,
fault injection, the straggler monitor and request export. A tick that
raises propagates out of :meth:`ServingEngine.step`: there is no fallback
to the plain versions or to the CPU.
"""

from __future__ import annotations

import collections
import dataclasses
import time
from typing import Any

import numpy as np
import torch

from .. import _common as C
from ..kernels import KERNELS
from ..models import transformer as Tr
from . import resilience as R


def bucket_length(s: int, sizes=(64, 128, 256)) -> int:
    """The smallest size that fits ``s``, else the next multiple of the
    largest size."""
    sizes = sorted(sizes)
    for b in sizes:
        if s <= b:
            return b
    return C.round_up(s, sizes[-1])


def chunk_schedule(length: int, sizes=(64, 128, 256)) -> list[int]:
    """Split a prompt into chunk sizes from ``sizes``, greedily large to
    small, the tail padded up to the smallest size. Each size must divide
    every larger one, so a chunk of size C always starts at a multiple of C
    (the kernel's aligned append window)."""
    sizes = sorted(sizes)
    for a, b in zip(sizes, sizes[1:]):
        if b % a:
            raise ValueError(f"chunk sizes must form a divisibility chain: {sizes}")
    rem = C.round_up(max(length, 1), sizes[0])
    out = []
    while rem:
        c = next(s for s in reversed(sizes) if s <= rem)
        out.append(c)
        rem -= c
    return out


def init_caches(cfg, batch: int, max_len: int, *, device=None) -> dict:
    """Zeroed cache tree (:func:`transformer.cache_specs` layout)."""
    return Tr.cache_zeros(cfg, batch, max_len, C.resolve_device(device))


def cache_nbytes(caches) -> int:
    """Bytes resident in a cache tree, int8 scale leaves included."""
    return sum(t.numel() * t.element_size()
               for leaves in caches["blocks"].values() for t in leaves.values())


def _resize_caches(caches, cfg, max_len: int, *, crop: bool) -> dict:
    """Pad (and, with ``crop``, slice) every leaf's sequence axis to
    ``max_len``. It is axis 3 of every leaf of the one layout: k/v
    [L, B, HK, M, D] and the int8 scales [L, B, HK, M]. A cache whose leaves
    disagree with ``cfg.kv_cache_dtype`` is rejected."""
    want = set(Tr.cache_specs(cfg, 1, 1)["blocks"]["b0"])

    def fit(c):
        n = c.shape[3]
        if n > max_len and crop:
            return c[:, :, :, :max_len].contiguous()
        return C.pad_to(c, 3, max_len) if n < max_len else c

    out = {}
    for b, leaves in caches["blocks"].items():
        if set(leaves) != want:
            raise ValueError(f"cache layout mismatch: cache has keys {sorted(leaves)} but "
                             f"kv_cache_dtype={cfg.kv_cache_dtype!r} expects {sorted(want)}")
        out[b] = {k: fit(v) for k, v in leaves.items()}
    return {"blocks": out}


def grow_caches(caches, cfg, max_len: int) -> dict:
    """Zero-pad caches out to ``max_len`` positions; longer ones pass through."""
    return _resize_caches(caches, cfg, max_len, crop=False)


def fit_caches(caches, cfg, max_len: int) -> dict:
    """Grow (zero-pad) or crop every cache to ``max_len`` positions.
    Cropped rows lie past every live frontier, so no attended state goes."""
    return _resize_caches(caches, cfg, max_len, crop=True)


def prefill_bucketed(params, cfg, prompts: torch.Tensor, *, kernels=KERNELS):
    """Prefill ``prompts [B, S]`` padded (with token 0) to the chunk-size
    bucket; pad tokens sit past every row's causal frontier. Returns
    (logits at the last prompt token [B, V], caches of the bucket's
    length)."""
    s = prompts.shape[1]
    padded = C.pad_to(prompts, 1, bucket_length(s, cfg.prefill_chunk_sizes))
    logits, caches = Tr.forward(params, padded, cfg, kernels=kernels, collect_cache=True)
    return logits[:, s - 1], caches


@dataclasses.dataclass
class GenerationResult:
    tokens: torch.Tensor  # [B, steps] int32 on the host
    prefill_logits: torch.Tensor  # [B, V] f32 on the device


def _sample(logits, temperature: float, generator):
    if temperature <= 0:
        return torch.argmax(logits, dim=-1).to(torch.int32)
    probs = torch.softmax(logits / temperature, dim=-1)
    return torch.multinomial(probs, 1, generator=generator)[:, 0].to(torch.int32)


def generate(params, cfg, prompts, *, steps: int, temperature: float = 0.0,
             generator: torch.Generator | None = None, eos_id: int | None = None,
             kernels=KERNELS, device=None) -> GenerationResult:
    """Bucketed prefill, then ``steps - 1`` decode steps; ``steps`` tokens
    per row. Greedy at ``temperature <= 0`` (the stream the tests compare);
    otherwise sampled with ``generator``. With ``eos_id``, a finished row
    emits ``eos_id`` and its position stops advancing (its decode still runs;
    the write lands on its frozen position). ``params`` must live on the
    device (CUDA unless ``device="cpu"``)."""
    dev = C.resolve_device(device)
    prompts = torch.as_tensor(prompts, device=dev).to(torch.int64)
    b, s = prompts.shape
    with torch.inference_mode():
        last_logits, caches = prefill_bucketed(params, cfg, prompts, kernels=kernels)
        caches = fit_caches(caches, cfg, s + steps)
        tok = _sample(last_logits, temperature, generator)
        pos = torch.full((b,), s, dtype=torch.int32, device=dev)
        done = (tok == eos_id) if eos_id is not None else torch.zeros(b, dtype=torch.bool, device=dev)
        out = [tok]
        for _ in range(steps - 1):
            logits, caches = Tr.decode_step(params, tok[:, None].to(torch.int64), caches,
                                            pos, cfg, kernels=kernels)
            nxt = _sample(logits, temperature, generator)
            if eos_id is not None:
                nxt = torch.where(done, torch.full_like(nxt, eos_id), nxt)
                new_done = done | (nxt == eos_id)
            else:
                new_done = done
            pos = pos + (~done).to(torch.int32)
            done = new_done
            tok = nxt
            out.append(tok)
        tokens = torch.stack(out, dim=1).cpu()  # the one device->host transfer
    return GenerationResult(tokens=tokens, prefill_logits=last_logits)


# ---------------------------------------------------------------------------
# Continuous batching: the device-side tick functions
# ---------------------------------------------------------------------------


def _retire(next_tok, new_pos, new_count, max_new, *, eos_id: int, max_len: int):
    """The one retirement predicate both tick paths share: EOS emitted,
    generation budget spent, or cache full."""
    return (next_tok == eos_id) | (new_count >= max_new) | (new_pos >= max_len - 1)


def _prefill_handoff(first_logits, finishing, fin_pos, new_tok, new_pos, new_count,
                     new_done, max_new, *, eos_id: int, max_len: int):
    """Prefill-to-decode handoff: finishing slots start decoding from their
    chunk's last real row (count 1, pos = the true prompt length), the first
    token going through the same retirement predicate as every emission.
    Returns (first_tok, new_tok, new_pos, new_count, new_done)."""
    first_tok = torch.argmax(first_logits, dim=-1).to(torch.int32)
    one = torch.ones_like(new_count)
    new_tok = torch.where(finishing, first_tok, new_tok)
    new_pos = torch.where(finishing, fin_pos, new_pos)
    new_count = torch.where(finishing, one, new_count)
    fin_done = _retire(first_tok, fin_pos, one, max_new, eos_id=eos_id, max_len=max_len)
    return first_tok, new_tok, new_pos, new_count, torch.where(finishing, fin_done, new_done)


def _guard_row(logit_bad, caches, rows, valid):
    """The packed guard-flag row: resilience.GUARD_* bits per slot."""
    scale_bad = R.scale_guard(caches, rows, valid)
    return (logit_bad.to(torch.int32) * R.GUARD_LOGITS
            + scale_bad.to(torch.int32) * R.GUARD_SCALES)


def _advance(logits, pos, done, gen_count, max_new, active, caches, *, eos_id: int,
             max_len: int, guards: bool):
    """State transition of a decode-only tick: greedy tokens, active slots'
    positions and counts advanced, retirements folded into ``done``. Returns
    the new (cur_tok, pos, done, gen_count) and the packed int32 state
    [next token, position, done, count (, guard flags)] x slots."""
    next_tok = torch.argmax(logits, dim=-1).to(torch.int32)
    inc = active.to(torch.int32)
    new_pos, new_count = pos + inc, gen_count + inc
    new_done = done | (active & _retire(next_tok, new_pos, new_count, max_new,
                                        eos_id=eos_id, max_len=max_len))
    rows = [next_tok, new_pos, new_done.to(torch.int32), new_count]
    if guards:
        rows.append(_guard_row(R.logits_guard(logits, where=active), caches,
                               pos[:, None], active[:, None]))
    return next_tok, new_pos, new_done, new_count, torch.stack(rows)


def _fused_tick_step(params, caches, cur_tok, pos, done, gen_count, max_new, dec_active,
                     chunk_tok, chunk_off, finishing, last_row, fin_pos, *, cfg, kernels,
                     eos_id: int, max_len: int, cache_len: int, trash_base: int,
                     guards: bool):
    """One fused tick (``engine.py:1674-1761``): a decode token for every
    decoding slot (the others diverted to row ``cache_len - 1``), then one
    prompt chunk per selected slot at its offset (the others write into the
    trash tail at ``trash_base``, write-only), the LM head only at each
    slot's ``last_row``, and the prefill-to-decode handoff. Returns the new
    (cur_tok, pos, done, gen_count) and the packed int32 state [token,
    position, done, count (, guard flags)] x slots."""
    dpos = torch.where(dec_active, pos, torch.full_like(pos, cache_len - 1))
    dec_logits, caches = Tr.decode_step(params, cur_tok[:, None].to(torch.int64), caches,
                                        dpos, cfg, kernels=kernels)
    first_logits, caches = Tr.prefill_chunk_step(
        params, chunk_tok, caches, chunk_off, cfg, kernels=kernels, last_row=last_row,
        prefix_limit=trash_base)
    next_dec = torch.argmax(dec_logits, dim=-1).to(torch.int32)
    inc = dec_active.to(torch.int32)
    new_pos, new_count = pos + inc, gen_count + inc
    new_done = done | (dec_active & _retire(next_dec, new_pos, new_count, max_new,
                                            eos_id=eos_id, max_len=max_len))
    new_tok = torch.where(dec_active, next_dec, cur_tok)
    _, new_tok, new_pos, new_count, new_done = _prefill_handoff(
        first_logits, finishing, fin_pos, new_tok, new_pos, new_count, new_done, max_new,
        eos_id=eos_id, max_len=max_len)
    rows = [new_tok, new_pos, new_done.to(torch.int32), new_count]
    if guards:
        # logits of the rows that emit; scales of the rows written live
        chunk = chunk_tok.shape[1]
        crows = chunk_off[:, None] + torch.arange(chunk, dtype=torch.int32,
                                                  device=chunk_off.device)[None, :]
        live_chunk = (chunk_off < trash_base)[:, None].expand(-1, chunk)
        rows.append(_guard_row(
            R.logits_guard(dec_logits, where=dec_active)
            | R.logits_guard(first_logits, where=finishing), caches,
            torch.cat([dpos[:, None], crows], dim=1),
            torch.cat([dec_active[:, None], live_chunk], dim=1)))
    return new_tok, new_pos, new_done, new_count, torch.stack(rows)


# ---------------------------------------------------------------------------
# Continuous batching: the scheduler
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class Request:
    rid: int
    prompt: Any  # token ids [S] (numpy, list or CPU tensor)
    max_new: int
    generated: list = dataclasses.field(default_factory=list)
    done: bool = False  # terminal
    status: R.Status = R.Status.PENDING
    status_detail: str | None = None
    priority: int = 0  # preemption: higher wins a slot from a lower
    deadline_s: float | None = None  # TTL from submit (None: cfg.request_ttl_s)
    submitted_at: float | None = None
    finished_at: float | None = None
    cancel_requested: bool = False
    preemptions: int = 0  # times evicted and requeued for re-prefill
    _seq: int = 0  # submission order (FIFO within a priority, preemption ties)

    def expired(self, now: float) -> bool:
        return (self.deadline_s is not None and self.submitted_at is not None
                and now - self.submitted_at > self.deadline_s)


@dataclasses.dataclass
class _PrefillPlan:
    """Host-side chunk bookkeeping for a slot mid-prefill."""
    tokens: np.ndarray  # [P] prompt padded to the chunk schedule
    chunks: list  # chunk sizes, greedy large to small
    ci: int  # next chunk index
    off: int  # cache offset consumed so far (≡ 0 mod chunks[ci])
    true_len: int  # unpadded prompt length


class ServingEngine:
    """Continuous batching over a fused chunked-prefill + decode tick.

    ``slots`` decode slots; finished requests retire their slot and queued
    ones are admitted into free slots, then prefill a chunk per tick (up to
    ``cfg.prefill_chunk_budget`` chunk tokens, one chunk size per tick) while
    every decoding slot advances one token. The cache holds ``cache_len =
    trash_base + chunk_max`` rows per slot, ``trash_base = round_up(max_len,
    chunk_max)``: the tail absorbs the writes of slots with no work.

    Every request ends in exactly one terminal ``resilience.Status``:
    ``submit`` applies queue backpressure (``queue_cap`` /
    ``cfg.admission_queue_cap``), deadlines come from ``Request.deadline_s``
    or ``cfg.request_ttl_s``, ``cancel`` marks a request for the next tick,
    a strictly higher-priority waiter preempts the lowest-priority slot when
    all are taken, and with ``guards`` (default on) a slot whose logits or
    new int8 scales are not finite is quarantined. ``step()`` makes one
    device-to-host transfer per tick (``stats()["host_transfers"]``).
    ``on_emit(req, tokens)`` and ``on_finish(req)`` fire after each tick.
    ``params`` live on ``device`` (CUDA unless ``device="cpu"``); ``kernels``
    is the kernel set the model runs through.
    """

    def __init__(self, params, cfg, *, slots: int = 8, max_len: int = 2048,
                 eos_id: int = -1, queue_cap: int | None = None, guards: bool = True,
                 clock=time.monotonic, kernels=KERNELS, device=None):
        self.dev = C.resolve_device(device)
        self.params, self.cfg, self.kernels = params, cfg, kernels
        self.slots, self.max_len, self.eos_id = slots, max_len, eos_id
        sizes = tuple(sorted(cfg.prefill_chunk_sizes)) or (64, 128, 256)
        # chunk sizes no admissible prompt (len < max_len) can fill are dropped
        self.chunk_sizes = tuple(s for s in sizes if s <= bucket_length(max_len, sizes))
        chunk_schedule(1, self.chunk_sizes)  # validates the divisibility chain
        cmax = self.chunk_sizes[-1]
        self.trash_base = C.round_up(max_len, cmax)
        self.cache_len = self.trash_base + cmax
        self.caches = init_caches(cfg, slots, self.cache_len, device=self.dev)

        def zeros(dtype):
            return torch.zeros((slots,), dtype=dtype, device=self.dev)

        self.pos, self.cur_tok = zeros(torch.int32), zeros(torch.int32)
        self.gen_count, self.max_new_arr = zeros(torch.int32), zeros(torch.int32)
        self.done = zeros(torch.bool)
        self.live: list[Request | None] = [None] * slots
        self.queue: list[Request] = []
        self._plan: list[_PrefillPlan | None] = [None] * slots
        self.queue_cap = int(cfg.admission_queue_cap if queue_cap is None else queue_cap)
        self.guards = bool(guards)
        self._clock = clock
        self._started_at = clock()
        self.tick_count = 0
        self.fused_ticks = 0  # ticks that appended prompt chunks
        self.host_transfers = 0
        self.events: list[dict] = []  # a bounded ring of scheduler events
        self.events_cap = int(cfg.stats_ring_events)
        self.events_dropped = 0
        self.on_emit = None  # callable(req, list[int]) | None
        self.on_finish = None  # callable(req) | None
        self.status_counts: collections.Counter = collections.Counter()
        self._seq = 0

    # -- lifecycle ----------------------------------------------------------

    def submit(self, req: Request) -> bool:
        """Enqueue ``req``; returns False (terminal ``FAILED``, detail
        ``queue_full``) when the bounded admission queue is full."""
        if self.queue_cap and len(self.queue) >= self.queue_cap:
            self._finish(None, req, R.Status.FAILED, detail="queue_full")
            self._event("admission_reject", rid=req.rid, detail="queue_full")
            return False
        req.done = False
        req.status = R.Status.QUEUED
        req.status_detail = None
        if req.submitted_at is None:
            req.submitted_at = self._clock()
        if req.deadline_s is None and self.cfg.request_ttl_s > 0:
            req.deadline_s = float(self.cfg.request_ttl_s)
        req._seq = self._seq
        self._seq += 1
        self.queue.append(req)
        return True

    def cancel(self, rid: int) -> bool:
        """Mark a queued or running request; the next ``step()`` retires it
        ``CANCELLED``."""
        for req in self.queue + [r for r in self.live if r is not None]:
            if req.rid == rid:
                req.cancel_requested = True
                return True
        return False

    def _event(self, kind: str, **detail):
        if self.events_cap and len(self.events) >= self.events_cap:
            del self.events[0]  # drop the oldest, keep counting
            self.events_dropped += 1
        self.events.append({"kind": kind, "tick": self.tick_count, **detail})

    def _finish(self, slot: int | None, req: Request, status: R.Status,
                detail: str | None = None):
        """Stamp the terminal status and free the slot. Its device rows need
        no cleanup: they lie past every later occupant's frontier until its
        own writes land there."""
        req.done = True
        req.status = status
        if detail is not None:
            req.status_detail = detail
        req.finished_at = self._clock()
        self.status_counts[status] += 1
        if slot is not None:
            self.live[slot] = None
            self._plan[slot] = None

    def _terminal_status(self, req: Request) -> R.Status:
        """Why a device-side retirement fired: EOS or budget (``OK``), else
        the cache ceiling (``CACHE_EXHAUSTED``), read from the stream."""
        if req.generated and req.generated[-1] == self.eos_id:
            return R.Status.OK
        if len(req.generated) >= req.max_new:
            return R.Status.OK
        return R.Status.CACHE_EXHAUSTED

    def _quarantine(self, slot: int, req: Request, flag: int):
        """A guard tripped on ``slot``: drop this tick's emission, end the
        request ``QUARANTINED``, free the slot; the others are untouched."""
        self._event("quarantine", rid=req.rid, slot=slot, flag=int(flag))
        self._finish(slot, req, R.Status.QUARANTINED, detail=f"guard_flag={int(flag)}")

    def _expire_and_cancel(self, now: float):
        """Deadline expiry and cancellation, in the queue and in the slots."""
        keep = []
        for req in self.queue:
            if req.cancel_requested:
                self._finish(None, req, R.Status.CANCELLED)
            elif req.expired(now):
                self._finish(None, req, R.Status.DEADLINE_EXCEEDED)
            else:
                keep.append(req)
        self.queue = keep
        for slot, req in enumerate(self.live):
            if req is None:
                continue
            if req.cancel_requested:
                self._finish(slot, req, R.Status.CANCELLED)
            elif req.expired(now):
                self._finish(slot, req, R.Status.DEADLINE_EXCEEDED)

    def stats(self) -> dict:
        """Serving and lifecycle counters for CLIs and tests."""
        return {
            "ticks": self.tick_count,
            "fused_ticks": self.fused_ticks,
            "host_transfers": self.host_transfers,
            "uptime_s": max(self._clock() - self._started_at, 0.0),
            "statuses": {s.name: n for s, n in sorted(
                self.status_counts.items(), key=lambda kv: kv[0].name)},
            "events": [dict(e) for e in self.events],
            "events_dropped": self.events_dropped,
            "queued": len(self.queue),
            "live": sum(r is not None for r in self.live),
            "preemptions": sum(1 for e in self.events if e["kind"] == "preempt"),
            "quarantined": self.status_counts.get(R.Status.QUARANTINED, 0),
            "kv_layout": "contiguous",
            "kv_cache_dtype": self.cfg.kv_cache_dtype,
        }

    @property
    def prefilling_slots(self) -> int:
        """Slots mid-prefill (chunks still pending)."""
        return sum(p is not None for p in self._plan)

    @property
    def decoding_slots(self) -> int:
        """Live slots past their prefill."""
        return sum(r is not None and p is None for r, p in zip(self.live, self._plan))

    # -- admission ----------------------------------------------------------

    def _admit(self, slot: int, req: Request) -> bool:
        """Admit ``req`` into ``slot``, or end it (False) when it was
        cancelled, has expired, or cannot fit the cache. A preempted request
        re-prefills its prompt and emitted tokens with the remaining budget."""
        if req.cancel_requested:
            self._finish(None, req, R.Status.CANCELLED)
            return False
        if req.expired(self._clock()):
            self._finish(None, req, R.Status.DEADLINE_EXCEEDED)
            return False
        prompt = np.asarray(req.prompt)
        remaining = req.max_new
        if req.generated:
            prompt = np.concatenate([prompt, np.asarray(req.generated, dtype=prompt.dtype)])
            remaining = req.max_new - len(req.generated)
        plen = int(prompt.shape[0])
        if plen == 0 or plen >= self.max_len:
            self._finish(None, req, R.Status.CACHE_EXHAUSTED if req.generated
                         else R.Status.FAILED, detail=None if req.generated else "bad_prompt")
            return False
        if plen >= self.max_len - 1 and req.generated:
            self._finish(None, req, R.Status.CACHE_EXHAUSTED)
            return False
        req.status = R.Status.RUNNING
        chunks = chunk_schedule(plen, self.chunk_sizes)
        padded = np.zeros((sum(chunks),), np.int64)
        padded[:plen] = prompt
        self._plan[slot] = _PrefillPlan(tokens=padded, chunks=chunks, ci=0, off=0,
                                        true_len=plen)
        self.live[slot] = req
        self.max_new_arr[slot] = remaining
        return True

    def _pop_queued(self) -> Request:
        """Highest-priority waiter, FIFO within a priority."""
        i = max(range(len(self.queue)),
                key=lambda j: (self.queue[j].priority, -self.queue[j]._seq))
        return self.queue.pop(i)

    def _preempt(self, slot: int):
        """Evict ``slot``'s request and requeue it (at the back of its
        priority) for re-prefill from prompt and emitted tokens."""
        req = self.live[slot]
        self._event("preempt", rid=req.rid, slot=slot, priority=req.priority,
                    emitted=len(req.generated))
        req.preemptions += 1
        req.status = R.Status.QUEUED
        self.live[slot] = None
        self._plan[slot] = None
        req._seq = self._seq
        self._seq += 1
        self.queue.append(req)

    def _admission(self):
        """Fill free slots from the queue, highest priority first; then, with
        every slot taken, let a strictly higher-priority waiter preempt the
        lowest-priority slot (tie: the latest submitted)."""
        for slot in range(self.slots):
            while self.live[slot] is None and self.queue:
                if self._admit(slot, self._pop_queued()):
                    break  # a rejected request does not take the slot
        rounds = 0
        while self.queue and rounds < self.slots:
            waiter = max(self.queue, key=lambda r: (r.priority, -r._seq))
            live = [s for s in range(self.slots) if self.live[s] is not None]
            if not live:
                break
            victim = min(live, key=lambda s: (self.live[s].priority, -self.live[s]._seq))
            if waiter.priority <= self.live[victim].priority:
                break
            rounds += 1
            self._preempt(victim)
            self.queue.remove(waiter)
            while not self._admit(victim, waiter) and self.queue:
                waiter = self._pop_queued()

    # -- the ticks ----------------------------------------------------------

    def _chunk_budget(self) -> int:
        """Chunk tokens this tick may append (at least one chunk is taken)."""
        return max(1, int(self.cfg.prefill_chunk_budget))

    def _plan_chunks(self, prefilling: list, budget: int):
        """This tick's chunk work: the first prefilling slot's next chunk size
        wins, slots whose next chunk has that size fill the ``budget``, and
        finishing slots record their first-token row and handoff position."""
        slots = self.slots
        head = self._plan[prefilling[0]]
        chunk = head.chunks[head.ci]
        budget = max(budget, chunk)
        selected = [s for s in prefilling if self._plan[s].chunks[self._plan[s].ci] == chunk]
        selected = selected[: budget // chunk]
        chunk_tok = np.zeros((slots, chunk), np.int64)
        chunk_off = np.full((slots,), self.trash_base, np.int32)
        finishing = np.zeros((slots,), bool)
        last_row = np.zeros((slots,), np.int32)
        fin_pos = np.zeros((slots,), np.int32)
        for s in selected:
            p = self._plan[s]
            chunk_tok[s] = p.tokens[p.off: p.off + chunk]
            chunk_off[s] = p.off
            if p.ci == len(p.chunks) - 1:
                finishing[s] = True
                last_row[s] = p.true_len - 1 - p.off
                fin_pos[s] = p.true_len
        return chunk, selected, chunk_tok, chunk_off, finishing, last_row, fin_pos

    def _to_device(self, a: np.ndarray) -> torch.Tensor:
        return torch.as_tensor(a, device=self.dev)

    def _transfer(self, packed: torch.Tensor) -> np.ndarray:
        """The tick's one device-to-host transfer."""
        self.host_transfers += 1
        return packed.cpu().numpy()

    def _fused_tick(self, prefilling: list) -> bool:
        (chunk, selected, chunk_tok, chunk_off, finishing, last_row,
         fin_pos) = self._plan_chunks(prefilling, self._chunk_budget())
        dec_active = np.array([self.live[s] is not None and self._plan[s] is None
                               for s in range(self.slots)])
        self.fused_ticks += 1
        (self.cur_tok, self.pos, self.done, self.gen_count, packed) = _fused_tick_step(
            self.params, self.caches, self.cur_tok, self.pos, self.done, self.gen_count,
            self.max_new_arr, self._to_device(dec_active), self._to_device(chunk_tok),
            self._to_device(chunk_off), self._to_device(finishing),
            self._to_device(last_row), self._to_device(fin_pos), cfg=self.cfg,
            kernels=self.kernels, eos_id=self.eos_id, max_len=self.max_len,
            cache_len=self.cache_len, trash_base=self.trash_base, guards=self.guards)
        state = self._transfer(packed)
        tok, done = state[0], state[2]
        guard = state[4] if self.guards else np.zeros((self.slots,), np.int64)
        for s, req in enumerate(self.live):
            if req is None:
                continue
            if guard[s]:
                self._quarantine(s, req, guard[s])
            elif finishing[s]:
                self._plan[s] = None
                req.generated.append(int(tok[s]))
                if done[s]:
                    self._finish(s, req, self._terminal_status(req))
            elif s in selected:  # mid-prefill: advance the plan
                p = self._plan[s]
                p.off += chunk
                p.ci += 1
            elif dec_active[s]:
                req.generated.append(int(tok[s]))
                if done[s]:
                    self._finish(s, req, self._terminal_status(req))
        return True

    def _decode_tick(self) -> bool:
        active_np = np.array([r is not None for r in self.live])
        active = self._to_device(active_np)
        logits, _ = Tr.decode_step(self.params, self.cur_tok[:, None].to(torch.int64),
                                   self.caches, self.pos, self.cfg, kernels=self.kernels)
        (self.cur_tok, self.pos, self.done, self.gen_count, packed) = _advance(
            logits, self.pos, self.done, self.gen_count, self.max_new_arr, active,
            self.caches, eos_id=self.eos_id, max_len=self.max_len, guards=self.guards)
        state = self._transfer(packed)
        nxt, done = state[0], state[2]
        guard = state[4] if self.guards else np.zeros((self.slots,), np.int64)
        for s, req in enumerate(self.live):
            if req is None:
                continue
            if guard[s]:
                self._quarantine(s, req, guard[s])
                continue
            req.generated.append(int(nxt[s]))
            if done[s]:
                self._finish(s, req, self._terminal_status(req))
        return True

    def _dispatch(self) -> bool:
        prefilling = [s for s in range(self.slots) if self._plan[s] is not None]
        with torch.no_grad():
            return self._fused_tick(prefilling) if prefilling else self._decode_tick()

    def step(self) -> bool:
        """One scheduler tick: expiry and cancellation, admission (with
        preemption), then a fused or decode-only tick with its one host
        transfer. Returns False when there was nothing to run. Afterwards
        ``on_emit`` fires for each request that emitted (its new tokens) and
        ``on_finish`` for each that ended, tokens before the finish."""
        watch = None
        if self.on_emit is not None or self.on_finish is not None:
            watch = [(r, len(r.generated))
                     for r in self.queue + [x for x in self.live if x is not None]]
        out = self._step_impl()
        if watch is not None:
            for req, n in watch:
                if self.on_emit is not None and len(req.generated) > n:
                    self.on_emit(req, req.generated[n:])
                if self.on_finish is not None and req.done:
                    self.on_finish(req)
        return out

    def _step_impl(self) -> bool:
        self._expire_and_cancel(self._clock())
        self._admission()
        if all(r is None for r in self.live):
            return False
        try:
            return self._dispatch()
        finally:
            self.tick_count += 1

    def run(self):
        while self.queue or any(r is not None for r in self.live):
            if not self.step():
                break
