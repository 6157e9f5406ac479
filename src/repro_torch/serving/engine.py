"""Greedy generation and the chunked continuous-batching engine on the
packed model (``repro/serving/engine.py``).

``make_prefill_step`` and ``make_serve_step`` (``engine.py:96-123``) are
the pure steps: one exact-length ``forward`` and one ``decode_step``, on
tokens or, for a config with a ``frontend``, on precomputed embeddings.
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
transfer, of one packed int32 array. Both KV layouts are ported, with a
bf16 (activation-dtype) or int8 KV cache: contiguous per-slot rows, and
(``cfg.kv_layout="paged"``) a page pool with a per-slot page table, shared
prompt prefixes and copy-on-write (``serving/paging.py``). With
``prefill="legacy"`` (contiguous layout only) a request is instead
prefilled whole at admission, by the one-shot ``prefill_bucketed`` of
``generate``, and its caches are written into the slot's rows; its first
token is recorded on the next decode-only tick. The RWKV-6 family (``ssm``)
is served this way only, its per-slot recurrent state written into the
slot in place of cache rows. With ``ServingEngine(speculative=True)``
(chunked prefill, either layout, either cache dtype) every decoding slot
drafts ``spec_gamma`` tokens a tick from its device-resident token history
(prompt lookup, ``serving/speculative.py``) and verifies them in one
``spec_gamma + 1``-row chunk through the prefill-append kernels at its
frontier; it emits the accepted prefix and the model's correction, then
rewinds its frontier past the rejected rows. Greedy streams are the plain
engine's.

Fault injection and containment (``engine.py:1168-1510``): a
``resilience.FaultPlan`` poisons a slot's logits with NaN at the guards'
observation point (the guard quarantines it), deranges its speculative
drafts (the acceptance watchdog stops speculating), retires it
``CACHE_EXHAUSTED``, stalls a tick, or makes a tick raise before any device
work. Each tick's wall time feeds a ``StragglerMonitor``
(``runtime/fault_tolerance.py``), and ``export_requests`` snapshots every
unfinished request for a fresh engine to resume. A tick that raises is contained: its
live requests end ``FAILED`` (the tokens they emitted kept), the device
state is rebuilt, and the queue is served on. This is the port's one
difference from JAX there: JAX first flips a sticky kernel-to-XLA
attention fallback and retries the tick; the port has no second
implementation to fall back to, neither the plain versions nor the CPU, so
it goes straight to JAX's last resort. A page pool that runs dry fails the
request that needed the page (``FAILED``, ``page_pool_exhausted``). The
``mla_moe`` family is served like the ssm family, by the legacy prefill
on the contiguous layout: JAX's ``apply_block`` refuses a chunk against an
MLA latent cache and a page table for it (``transformer.py:389-392,
417-421``). The ``moe`` family takes ``"auto"`` as legacy too, as in JAX,
and runs the chunked prefill, the paged layout and speculative decoding
when asked (``prefill="chunked"``). Under MoE the rows of idle and
trash-diverted slots share the routed experts' capacity with the live
ones, so they are JAX's rows: zeros at ``trash_base`` in a chunk, the
slot's token at ``cache_len - 1`` in a fused tick's decode, at its own
position in a decode-only tick, and ``[token, drafts]`` at ``trash_base``
in a verify chunk. The hybrid family (Jamba) is served by the legacy
prefill on the contiguous layout, as the mla_moe family: JAX's
``apply_block`` refuses a chunk against a Mamba state and a page table for
it. Its cache tree mixes the attention layers' K/V with the Mamba layers'
state leaves (``ssm``, ``conv``), which have no sequence axis: admission
overwrites them whole, and every cache walk goes through
``transformer.cache_layout``.
"""

from __future__ import annotations

import collections
import dataclasses
import time
from typing import Any

import numpy as np
import torch

from .. import _common as C
from ..core import bitlinear
from ..core.ternary import mask_past_frontier
from ..kernels import KERNELS
from ..models import transformer as Tr
from ..runtime import fault_tolerance as FT
from . import resilience as R
from . import speculative as Sp
from .paging import PagedKV, PagePoolExhausted


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


def init_caches(cfg, batch: int, max_len: int, *, device=None,
                kv_pages: int | None = None) -> dict:
    """Zeroed cache tree (:func:`transformer.cache_specs` layout). ``kv_pages``
    switches to page pools of that many pages, an explicit opt-in, never
    read from ``cfg.kv_layout``: ``generate`` always builds the contiguous
    layout."""
    return Tr.cache_zeros(cfg, batch, max_len, C.resolve_device(device), kv_pages=kv_pages)


def cache_nbytes(caches) -> int:
    """Bytes resident in a cache tree, int8 scale leaves included."""
    return sum(t.numel() * t.element_size() for _, t in Tr.tree_leaves(caches))


def _checked_leaves(caches, cfg) -> dict:
    """``{path: (leaf, batch axis, sequence axis or None)}`` of a contiguous
    cache tree (``transformer.cache_layout``); a tree whose leaves disagree
    with ``cfg`` (another ``kv_cache_dtype``, another family) is rejected."""
    layout = Tr.cache_layout(cfg)
    leaves = dict(Tr.tree_leaves(caches))
    if set(leaves) != set(layout):
        raise ValueError(f"cache layout mismatch: cache has leaves {sorted(leaves)} but "
                         f"kv_cache_dtype={cfg.kv_cache_dtype!r} expects {sorted(layout)}")
    return {path: (leaf, *layout[path]) for path, leaf in leaves.items()}


def _resize_caches(caches, cfg, max_len: int, *, crop: bool) -> dict:
    """Pad (and, with ``crop``, slice) the sequence axis of every leaf that
    has one (``transformer.cache_layout``) to ``max_len``: k/v and the int8
    scales of attention layers, MLA's ``c_kv`` and ``k_rope``. Leaves
    without one, the ssm family's recurrent state, pass through unchanged
    (``engine.py:158-197``). A cache whose leaves disagree with
    ``cfg.kv_cache_dtype`` is rejected."""
    out = {}
    for path, (leaf, _, seq) in _checked_leaves(caches, cfg).items():
        if seq is not None and leaf.shape[seq] > max_len and crop:
            leaf = leaf.narrow(seq, 0, max_len).contiguous()
        elif seq is not None and leaf.shape[seq] < max_len:
            leaf = C.pad_to(leaf, seq, max_len)
        Tr.tree_set(out, path, leaf)
    return out


def grow_caches(caches, cfg, max_len: int) -> dict:
    """Zero-pad caches out to ``max_len`` positions; longer ones, and leaves
    without positions, pass through."""
    return _resize_caches(caches, cfg, max_len, crop=False)


def fit_caches(caches, cfg, max_len: int) -> dict:
    """Grow (zero-pad) or crop every cache to ``max_len`` positions; leaves
    without positions pass through. Cropped rows lie past every live
    frontier, so no attended state goes."""
    return _resize_caches(caches, cfg, max_len, crop=True)


def live_cache_state(caches, cfg, frontier) -> dict:
    """The live view of a contiguous cache tree for state comparisons
    (``engine.py:1586-1605``): every row of a sequence leaf (int8 scales
    included) at or past the slot's ``frontier [B]`` is zeroed. Rows past a
    frontier are dead, so two engine states are the same when their live
    views are."""
    out = {}
    for path, (leaf, batch, seq) in _checked_leaves(caches, cfg).items():
        if seq is not None:
            leaf = mask_past_frontier(leaf, frontier, seq_axis=seq, batch_axis=batch)
        Tr.tree_set(out, path, leaf)
    return out


def engine_params(params, cfg):
    """The table-lookup engine's offline step (``engine.py:77-87``): with
    ``cfg.matmul_engine == "tl"`` every packed node gains its group indices
    ``w_idx``, made once on the device of ``wp``; a tree that already has
    them, and every tree under another engine, passes through."""
    if cfg.matmul_engine == "tl":
        return bitlinear.with_tl_tree(params)
    return params


def prefill_bucketed(params, cfg, prompts: torch.Tensor, *, kernels=KERNELS):
    """Prefill ``prompts [B, S]`` padded (with token 0) to the chunk-size
    bucket; pad tokens sit past every row's causal frontier. Returns
    (logits at the last prompt token [B, V], caches of the bucket's
    length). Only the dense family is padded (``engine.py:275-279``): a
    recurrent state would integrate the pad tokens, so every other family
    prefills the exact length."""
    s = prompts.shape[1]
    bucket = bucket_length(s, cfg.prefill_chunk_sizes) if cfg.family == "dense" else s
    padded = C.pad_to(prompts, 1, bucket)
    logits, caches = Tr.forward(params, padded, cfg, kernels=kernels, collect_cache=True)
    return logits[:, s - 1], caches


def _batch_on(batch, device) -> dict:
    """A token tensor or batch dict (``transformer.embed_inputs``) as a
    dict of tensors on ``device``: tokens int64, embeddings as they are."""
    if not isinstance(batch, dict):
        batch = {"tokens": batch}
    out = {}
    for k, v in batch.items():
        v = torch.as_tensor(v, device=device)
        out[k] = v.to(torch.int64) if k == "tokens" else v
    return out


def make_prefill_step(cfg, *, kernels=KERNELS, device=None):
    """``prefill_step(params, batch) -> (logits at the last row [B, V],
    caches of length S)`` (``engine.py:96-105``): one ``forward`` over the
    whole ``batch`` at its exact length, no bucket. ``batch`` is a token
    tensor ``[B, S]`` or JAX's batch dict, ``{"tokens"}`` or, for a config
    with a ``frontend``, ``{"embeddings": [B, S, Dfe]}``; it is moved to
    the device (CUDA unless ``device="cpu"``), where ``params`` must live.
    The entry point through which precomputed embeddings are served;
    ``generate`` and the ``ServingEngine`` take tokens only, as JAX's do."""
    dev = C.resolve_device(device)

    def prefill_step(params, batch):
        with torch.inference_mode():
            logits, caches = Tr.forward(params, _batch_on(batch, dev), cfg, kernels=kernels,
                                        collect_cache=True)
        return logits[:, -1], caches

    return prefill_step


def make_serve_step(cfg, *, kernels=KERNELS, device=None):
    """``serve_step(params, batch, caches, pos, page_table=None) -> (logits
    [B, V], caches)`` (``engine.py:108-123``): one ``decode_step`` of a
    one-row ``batch`` (tokens ``[B, 1]`` or a batch dict, as
    :func:`make_prefill_step` takes) at ``pos``, an int or ``[B]``, writing
    each layer's new row into ``caches`` in place (grow them first,
    :func:`grow_caches`). Device as :func:`make_prefill_step`."""
    dev = C.resolve_device(device)

    def serve_step(params, batch, caches, pos, page_table=None):
        batch = _batch_on(batch, dev)
        b = next(iter(batch.values())).shape[0]
        pos = torch.as_tensor(pos, dtype=torch.int32, device=dev).expand(b).contiguous()
        with torch.inference_mode():
            return Tr.decode_step(params, batch, caches, pos, cfg, kernels=kernels,
                                  page_table=page_table)

    return serve_step


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
        params = engine_params(params, cfg)
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


def _guard_row(logit_bad, caches, rows, valid, paged: bool):
    """The packed guard-flag row: resilience.GUARD_* bits per slot."""
    scale_bad = R.scale_guard(caches, rows, valid, paged=paged)
    return (logit_bad.to(torch.int32) * R.GUARD_LOGITS
            + scale_bad.to(torch.int32) * R.GUARD_SCALES)


def _poison(logits, fault_nan):
    """The ``nan`` fault: the masked slots' logits (slots on axis 0) become
    NaN; ``None`` leaves them as they are."""
    if fault_nan is None:
        return logits
    return logits.masked_fill(fault_nan.reshape((-1,) + (1,) * (logits.dim() - 1)),
                              float("nan"))


def _advance(logits, first_tok, pos, done, gen_count, max_new, active, caches, *, eos_id: int,
             max_len: int, guards: bool, paged: bool = False, fault_nan=None):
    """State transition of a decode-only tick (``engine.py:1501-1549``):
    greedy tokens, active slots' positions and counts advanced, retirements
    folded into ``done``. Returns the new (cur_tok, pos, done, gen_count) and
    the packed int32 state [prefill token, next token, position, done,
    count, done at entry (, guard flags)] x slots: ``first_tok`` is the
    token each slot entered the tick with, which a legacy prefill set, and a
    slot done at entry retired on it, so its decode output is dropped.
    ``fault_nan`` [slots] (or None) poisons the logits of the ``nan``
    fault's slots."""
    logits = _poison(logits, fault_nan)
    next_tok = torch.argmax(logits, dim=-1).to(torch.int32)
    inc = active.to(torch.int32)
    new_pos, new_count = pos + inc, gen_count + inc
    new_done = done | (active & _retire(next_tok, new_pos, new_count, max_new,
                                        eos_id=eos_id, max_len=max_len))
    rows = [first_tok, next_tok, new_pos, new_done.to(torch.int32), new_count,
            done.to(torch.int32)]
    if guards:
        rows.append(_guard_row(R.logits_guard(logits, where=active), caches,
                               pos[:, None], active[:, None], paged))
    return next_tok, new_pos, new_done, new_count, torch.stack(rows)


def _prefix_limit(cfg, trash_base: int) -> int:
    """The chunk steps' write-only frontier: ``trash_base``, past which the
    diverted rows skip their prefix scan, or 0 where routed experts share
    capacity across rows (the ``moe`` family). There a diverted row's
    hidden state decides which live rows its expert choices crowd out, so
    it attends as JAX's XLA append form has every row attend (its prefix
    and its chunk, ``attention.py:270-300``), the form JAX's engine runs
    off the TPU."""
    routed = any(k.ffn != "dense" for kinds in Tr.block_plan(cfg)[:2] for k in kinds)
    return 0 if routed else trash_base


def _fused_tick_step(params, caches, cur_tok, pos, done, gen_count, max_new, dec_active,
                     chunk_tok, chunk_off, finishing, last_row, fin_pos, page_table, *, cfg,
                     kernels, eos_id: int, max_len: int, cache_len: int, trash_base: int,
                     guards: bool, fault_nan=None):
    """One fused tick (``engine.py:1674-1761``): a decode token for every
    decoding slot (the others diverted to row ``cache_len - 1``), then one
    prompt chunk per selected slot at its offset (the others write into the
    trash tail at ``trash_base``, write-only), the LM head only at each
    slot's ``last_row``, and the prefill-to-decode handoff. ``page_table``
    (None on the contiguous layout) addresses the paged pools; the trash
    region's entries map the garbage page. ``fault_nan`` [slots] (or None)
    poisons both logits of the ``nan`` fault's slots. Returns the new
    (cur_tok, pos, done, gen_count) and the packed int32 state [token,
    position, done, count (, guard flags)] x slots."""
    dpos = torch.where(dec_active, pos, torch.full_like(pos, cache_len - 1))
    dec_logits, caches = Tr.decode_step(params, cur_tok[:, None].to(torch.int64), caches,
                                        dpos, cfg, kernels=kernels, page_table=page_table)
    first_logits, caches = Tr.prefill_chunk_step(
        params, chunk_tok, caches, chunk_off, cfg, kernels=kernels, last_row=last_row,
        prefix_limit=_prefix_limit(cfg, trash_base), page_table=page_table)
    dec_logits, first_logits = _poison(dec_logits, fault_nan), _poison(first_logits, fault_nan)
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
            torch.cat([dec_active[:, None], live_chunk], dim=1), page_table is not None))
    return new_tok, new_pos, new_done, new_count, torch.stack(rows)


def _spec_tick_step(params, caches, hist, cur_tok, pos, done, gen_count, max_new, dec_active,
                    chunk_tok, chunk_off, finishing, last_row, fin_pos, page_table, *, cfg,
                    kernels, drafter, gamma: int, eos_id: int, max_len: int, trash_base: int,
                    guards: bool, fault_nan=None, fault_draft=None):
    """One speculative tick (``engine.py:1764-1900``): every decoding slot
    drafts ``gamma`` tokens from its history ``hist [B, L]`` and verifies
    them in one ``gamma + 1``-row chunk at its frontier (the others diverted
    to ``trash_base``, write-only); with ``chunk_tok`` (None: no prefill
    work) one prompt chunk per selected slot follows, as in the fused tick.
    A decoding slot emits n in [1, gamma + 1] tokens: the accepted drafts
    and the model's correction, cut at the first token that retires it
    (``_retire`` per micro-step), so the stream is what n decode ticks give.
    Its frontier advances by n only: the rejected rows are rolled back by
    that rewind. Returns the new (hist, cur_tok, pos, done, gen_count) and
    the packed int32 state [gamma + 1 emission rows, emitted count,
    chargeable drafts, done (, guard flags)] x slots; a finishing slot's
    first token is its emission row 0. ``fault_draft`` [slots] (or None)
    deranges the drafts of the ``drafter_garbage`` fault's slots;
    ``fault_nan`` poisons the verify and chunk logits of the ``nan``
    fault's."""
    drafts = drafter(hist, pos)
    if fault_draft is not None:
        drafts = R.scramble_tokens(drafts, fault_draft, cfg.vocab_size)
    ver_tok = torch.cat([cur_tok[:, None], drafts], dim=1).to(torch.int64)
    ver_off = torch.where(dec_active, pos, torch.full_like(pos, trash_base))
    ver_logits, caches = Tr.verify_chunk_step(params, ver_tok, caches, ver_off, cfg,
                                              kernels=kernels,
                                              prefix_limit=_prefix_limit(cfg, trash_base),
                                              page_table=page_table)
    ver_logits = _poison(ver_logits, fault_nan)
    targets, k = Sp.accept_tokens(drafts, ver_logits)
    # micro-step j emits targets[:, j] while j <= k, and stops after the
    # first token that retires the slot
    dev = pos.device
    j = torch.arange(gamma + 1, dtype=torch.int32, device=dev)[None, :]
    retire_j = _retire(targets, pos[:, None] + j + 1, gen_count[:, None] + j + 1,
                       max_new[:, None], eos_id=eos_id, max_len=max_len)
    stop_before = torch.cumsum(torch.nn.functional.pad(retire_j[:, :-1].to(torch.int32),
                                                       (1, 0)), dim=1) > 0
    emit = (j <= k[:, None]) & ~stop_before & dec_active[:, None]
    n_emit = emit.sum(dim=1).to(torch.int32)
    last_tok = targets.gather(1, (n_emit - 1).clamp(min=0).to(torch.int64)[:, None])[:, 0]
    new_tok = torch.where(dec_active, last_tok, cur_tok)
    new_pos, new_count = pos + n_emit, gen_count + n_emit  # the rewind is the rollback
    new_done = done | (retire_j & emit).any(dim=1)
    # the emissions into the history: micro-step j's token at pos + 1 + j
    hidx = torch.arange(hist.shape[1], device=dev)[None, :]
    rel = hidx - (pos.to(torch.int64)[:, None] + 1)
    relc = rel.clamp(0, gamma)
    write = emit.gather(1, relc) & (rel >= 0) & (rel <= gamma)
    hist = torch.where(write, targets.gather(1, relc), hist)
    if chunk_tok is not None:  # the mixed tick: the fused tick's prefill phase
        first_logits, caches = Tr.prefill_chunk_step(
            params, chunk_tok, caches, chunk_off, cfg, kernels=kernels, last_row=last_row,
            prefix_limit=_prefix_limit(cfg, trash_base), page_table=page_table)
        first_logits = _poison(first_logits, fault_nan)
        first_tok, new_tok, new_pos, new_count, new_done = _prefill_handoff(
            first_logits, finishing, fin_pos, new_tok, new_pos, new_count, new_done, max_new,
            eos_id=eos_id, max_len=max_len)
        hist = torch.where((hidx == fin_pos.to(torch.int64)[:, None]) & finishing[:, None],
                           first_tok[:, None], hist)
        emit0 = torch.where(finishing, first_tok, targets[:, 0])
        n_out = torch.where(finishing, torch.ones_like(n_emit), n_emit)
    else:
        emit0, n_out = targets[:, 0], n_emit
    # drafts chargeable to the acceptance: only positions the budget and the
    # cache could have emitted (an EOS cut still counts)
    window = torch.minimum(torch.minimum(max_new - gen_count, (max_len - 1) - pos),
                           torch.full_like(pos, gamma + 1))
    drafted = (window - 1).clamp(0, gamma) * dec_active.to(torch.int32)
    rows = [torch.cat([emit0[:, None], targets[:, 1:]], dim=1).T, n_out[None], drafted[None],
            new_done.to(torch.int32)[None]]
    if guards:
        # logits of the emitting rows; scales of the rows written live
        logit_bad = R.logits_guard(ver_logits, where=dec_active)
        grows = ver_off[:, None] + j
        gvalid = dec_active[:, None].expand(-1, gamma + 1)
        if chunk_tok is not None:
            chunk = chunk_tok.shape[1]
            logit_bad = logit_bad | R.logits_guard(first_logits, where=finishing)
            grows = torch.cat([grows, chunk_off[:, None] + torch.arange(
                chunk, dtype=torch.int32, device=dev)[None, :]], dim=1)
            gvalid = torch.cat([gvalid, (chunk_off < trash_base)[:, None].expand(-1, chunk)],
                               dim=1)
        rows.append(_guard_row(logit_bad, caches, grows, gvalid, page_table is not None)[None])
    return hist, new_tok, new_pos, new_done, new_count, torch.cat(rows).to(torch.int32)


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
    migrations: int = 0  # times moved to another replica after a crash or hang
    # SLO class (None outside a pool) and its chunk-budget weight: the
    # highest weight among the slots mid-prefill scales the tick's
    # prefill_chunk_budget (1.0, the default, leaves it as it is)
    slo: str | None = None
    budget_weight: float = 1.0
    _seq: int = 0  # submission order (FIFO within a priority, preemption ties)
    # speculative decoding: drafts offered and accepted over its verify ticks
    spec_drafted: int = 0
    spec_accepted: int = 0

    @property
    def spec_acceptance(self) -> float:
        """Share of the drafted tokens accepted (0.0 when none was drafted)."""
        return self.spec_accepted / self.spec_drafted if self.spec_drafted else 0.0

    def expired(self, now: float) -> bool:
        return (self.deadline_s is not None and self.submitted_at is not None
                and now - self.submitted_at > self.deadline_s)


def snapshot_request(req: Request) -> Request:
    """A resumable copy of ``req`` (``engine.py:452-470``): the prompt and
    emitted tokens (copies, never aliased) and the lifecycle fields. A fresh
    engine re-prefills prompt and history with the budget left, which gives
    the same greedy stream, as after a preemption."""
    snap = Request(rid=req.rid, prompt=np.array(req.prompt), max_new=req.max_new,
                   generated=list(req.generated))
    snap.priority = req.priority
    snap.deadline_s = req.deadline_s
    snap.submitted_at = req.submitted_at
    snap.preemptions = req.preemptions
    snap.migrations = req.migrations
    snap.slo = req.slo
    snap.budget_weight = req.budget_weight
    return snap


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

    With ``cfg.kv_layout="paged"`` the rows live in a pool of
    ``cfg.kv_page_size``-row pages (``cfg.kv_num_pages``, 0 = one page per
    slot and block plus the garbage page) that each slot reaches through its
    row of ``self.paged.table``. Before each tick the pages it writes are
    made exclusive (fresh pages, or copy-on-write forks of shared ones);
    with ``cfg.prefix_cache`` a finished prefill's full prompt pages are
    interned, and a later prompt with the same prefix maps them read-only
    and prefills only its tail. The host mirrors each slot's frontier in
    ``_pos_host`` from the plan and the tick's one transfer.

    ``prefill="legacy"`` (``engine.py:539-560``) prefills each request
    whole at admission (:meth:`_prefill_slot`): the cache then holds
    ``cache_len = max_len`` rows per slot with no trash tail, every tick is
    a decode-only tick, and the paged layout is refused. ``"auto"`` is
    ``"chunked"`` for the dense family and ``"legacy"`` for every other,
    as in JAX; the moe family runs ``"chunked"`` (and so the paged layout
    and speculation) when asked, the mla_moe and hybrid families legacy
    only, as JAX's blocks refuse a chunk against an MLA latent cache or a
    Mamba state. The ssm family (RWKV-6) runs legacy only: its state has no
    rows to append a chunk to, and ``"chunked"`` or the paged layout raise
    (JAX serves chunked ssm through its XLA WKV from a warm state; the
    port's WKV kernel starts from zero, as the TPU kernel does). Admission
    overwrites every state leaf of the slot, and in a decode-only tick idle
    slots step their state too, as in JAX; the scale guard finds no int8
    scales there, so only the logits guard acts.

    ``speculative=True`` (``engine.py:606-623``; the chunked prefill only,
    so the ssm family stays on plain decode) turns every tick with a
    decoding slot into a speculative tick (:meth:`_spec_tick`): each
    decoding slot drafts ``spec_gamma`` (default ``cfg.spec_gamma``) tokens
    from its row of the device-resident history ``hist [slots, cache_len]``
    (prompt and emissions) and verifies them in one chunk at its frontier;
    the verify rows ride the tick's chunk budget, and a prompt chunk may
    follow in the same tick. A pure-prefill tick stays the plain fused tick.
    Once ``cfg.spec_disable_after`` drafts were offered at an acceptance
    below ``cfg.spec_min_acceptance`` the engine stops speculating (event
    ``spec_disabled``).

    Every request ends in exactly one terminal ``resilience.Status``:
    ``submit`` applies queue backpressure (``queue_cap`` /
    ``cfg.admission_queue_cap``), deadlines come from ``Request.deadline_s``
    or ``cfg.request_ttl_s``, ``cancel`` marks a request for the next tick,
    a strictly higher-priority waiter preempts the lowest-priority slot when
    all are taken, and with ``guards`` (default on) a slot whose logits or
    new int8 scales are not finite is quarantined. ``step()`` makes one
    device-to-host transfer per tick that runs (``stats()["host_transfers"]``).
    ``on_emit(req, tokens)`` and ``on_finish(req)`` fire after each tick.
    ``params`` live on ``device`` (CUDA unless ``device="cpu"``); ``kernels``
    is the kernel set the model runs through.

    A ``fault_plan`` (``resilience.FaultPlan``) injects faults on the ticks
    it names (see the module docstring); without one, or on a tick it does
    not target, the tick runs exactly as without a plan. ``straggler`` (a
    fresh ``StragglerMonitor`` when None) gets each tick's wall time, and
    ``replica_id`` names the engine in ``stats()``. A tick that raises is
    contained (:meth:`_fail_all_live`): ``consecutive_tick_failures``
    counts such ticks until a clean one resets it, the live requests end
    ``FAILED`` and the device state is rebuilt. There is no retry on other
    kernels, the plain versions or the CPU. ``step()`` raises only when the
    rebuild itself fails (a sticky CUDA error: the context is lost).
    ``_chunk_budget`` scales ``cfg.prefill_chunk_budget`` by the highest
    ``Request.budget_weight`` among the slots mid-prefill.
    """

    def __init__(self, params, cfg, *, slots: int = 8, max_len: int = 2048,
                 eos_id: int = -1, prefill: str = "auto", queue_cap: int | None = None,
                 guards: bool = True, clock=time.monotonic, kernels=KERNELS, device=None,
                 speculative: bool = False, spec_gamma: int | None = None,
                 fault_plan: R.FaultPlan | None = None,
                 straggler: FT.StragglerMonitor | None = None,
                 replica_id: int | str | None = None):
        self.dev = C.resolve_device(device)
        self.params, self.cfg, self.kernels = engine_params(params, cfg), cfg, kernels
        self.slots, self.max_len, self.eos_id = slots, max_len, eos_id
        if prefill == "auto":  # engine.py:539-545
            prefill = "chunked" if cfg.family == "dense" else "legacy"
        if prefill not in ("chunked", "legacy"):
            raise ValueError(f"prefill must be 'auto', 'chunked' or 'legacy', got {prefill!r}")
        # the chunked and paged paths serve the attention families (dense,
        # moe); JAX's apply_block refuses both for MLA and Mamba mixers, and
        # the port's WKV kernel starts from a zero state
        why = ("its recurrent state has no rows to append a chunk to or to page, and the "
               "WKV kernel starts from a zero state" if cfg.family == "ssm"
               else Tr.legacy_only_reason(cfg))
        if why is not None and (prefill == "chunked" or cfg.kv_layout == "paged"):
            raise ValueError(
                f"the {cfg.family!r} family runs prefill='legacy' on the contiguous layout "
                f"only (got prefill={prefill!r}, kv_layout={cfg.kv_layout!r}): {why}")
        self.prefill = prefill
        sizes = tuple(sorted(cfg.prefill_chunk_sizes)) or (64, 128, 256)
        # chunk sizes no admissible prompt (len < max_len) can fill are dropped
        self.chunk_sizes = tuple(s for s in sizes if s <= bucket_length(max_len, sizes))
        chunk_schedule(1, self.chunk_sizes)  # validates the divisibility chain
        cmax = self.chunk_sizes[-1]
        if prefill == "chunked":  # [0, trash_base) usable, then the trash tail
            self.trash_base = C.round_up(max_len, cmax)
            self.cache_len = self.trash_base + cmax
        else:
            self.trash_base = None
            self.cache_len = max_len
        # the paged layout (engine.py:562-594): a host page allocator with
        # refcounts, a prefix trie, and one garbage page behind every table
        # entry that maps nothing (the trash tail's included)
        if cfg.kv_layout == "paged":
            if prefill != "chunked":
                raise ValueError("kv_layout='paged' requires the chunked prefill path "
                                 f"(prefill={prefill!r})")
            ps = int(cfg.kv_page_size)
            if ps <= 0 or self.chunk_sizes[0] % ps:
                raise ValueError(
                    f"kv_page_size={ps} must divide the smallest prefill chunk size "
                    f"({self.chunk_sizes[0]}) so every chunk append covers whole pages")
            self.paged = PagedKV(slots=slots, cache_len=self.cache_len, page_size=ps,
                                 num_pages=int(cfg.kv_num_pages),
                                 prefix_cache=bool(cfg.prefix_cache))
            # host mirror of the device frontier: the allocator needs this
            # tick's written blocks before the tick runs
            self._pos_host = np.zeros((slots,), np.int32)
        elif cfg.kv_layout == "contiguous":
            self.paged = None
            self._pos_host = None
        else:
            raise ValueError(f"kv_layout must be 'contiguous' or 'paged', got "
                             f"{cfg.kv_layout!r}")
        self.caches = init_caches(
            cfg, slots, self.cache_len, device=self.dev,
            kv_pages=self.paged.num_pages if self.paged is not None else None)
        # speculative decoding (engine.py:606-623): chunked engines only
        self.speculative = bool(speculative) and prefill == "chunked"
        self.spec_gamma = int(spec_gamma if spec_gamma is not None else cfg.spec_gamma)
        if self.speculative and not 1 <= self.spec_gamma < cmax:
            raise ValueError(f"spec_gamma={self.spec_gamma} must be in [1, {cmax}): the "
                             "gamma + 1 verify chunk must fit the chunk_max trash tail")
        self._drafter = Sp.make_drafter(cfg, gamma=self.spec_gamma) if self.speculative else None
        # the drafter's corpus, each slot's prompt and emissions; live at <= pos
        self.hist = (torch.zeros((slots, self.cache_len), dtype=torch.int32, device=self.dev)
                     if self.speculative else None)
        self.spec_drafted_total = 0
        self.spec_accepted_total = 0

        def zeros(dtype):
            return torch.zeros((slots,), dtype=dtype, device=self.dev)

        self.pos, self.cur_tok = zeros(torch.int32), zeros(torch.int32)
        self.gen_count, self.max_new_arr = zeros(torch.int32), zeros(torch.int32)
        self.done = zeros(torch.bool)
        self.live: list[Request | None] = [None] * slots
        self.queue: list[Request] = []
        self._plan: list[_PrefillPlan | None] = [None] * slots
        self._pending_first: set[int] = set()  # legacy: prefill token not yet recorded
        self.queue_cap = int(cfg.admission_queue_cap if queue_cap is None else queue_cap)
        self.guards = bool(guards)
        self._clock = clock
        self._fault_plan = fault_plan
        self.straggler = straggler or FT.StragglerMonitor()
        # the pool's identity and drain gate: ticks that entered the
        # exception path since the last clean one (not reset by the rebuild)
        self.replica_id = replica_id
        self.consecutive_tick_failures = 0
        self._started_at = clock()
        self.tick_count = 0
        self.fused_ticks = 0  # ticks that appended prompt chunks
        self.spec_ticks = 0  # speculative ticks (verify, with or without a chunk)
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
        own writes land there. Paged, the slot's pages are released (shared
        prefix pages live on while the trie or another slot holds them)."""
        req.done = True
        req.status = status
        if detail is not None:
            req.status_detail = detail
        req.finished_at = self._clock()
        self.status_counts[status] += 1
        if slot is not None:
            self.live[slot] = None
            self._plan[slot] = None
            self._pending_first.discard(slot)
            self._release_pages(slot)

    def _release_pages(self, slot: int):
        if self.paged is not None:
            self.paged.release(slot)
            self._pos_host[slot] = 0

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

    def _fail_all_live(self, detail: str):
        """Containment of a failed tick (``engine.py:769-796``): every live
        request ends ``FAILED`` with the tokens it emitted, and the device
        state is rebuilt (the old caches dropped first), a fresh page pool
        and prefix trie on the paged layout, so the engine serves the queue
        on. An error of the rebuild itself leaves ``step()``."""
        self._event("tick_failure", detail=detail)
        for slot in range(self.slots):
            req = self.live[slot]
            if req is not None:
                self._finish(slot, req, R.Status.FAILED, detail=detail)
        self.caches = None  # freed before the new caches are made
        if self.paged is not None:
            # a fresh pool and trie: the pages may hold garbage, and a
            # poisoned interned prefix must not reach a new request
            self.paged = PagedKV(slots=self.slots, cache_len=self.cache_len,
                                 page_size=self.paged.page_size,
                                 num_pages=self.paged.num_pages,
                                 prefix_cache=self.paged.prefix_cache)
            self._pos_host[:] = 0
        self.caches = init_caches(
            self.cfg, self.slots, self.cache_len, device=self.dev,
            kv_pages=self.paged.num_pages if self.paged is not None else None)
        for name in ("pos", "cur_tok", "gen_count", "max_new_arr"):
            setattr(self, name, torch.zeros((self.slots,), dtype=torch.int32, device=self.dev))
        self.done = torch.zeros((self.slots,), dtype=torch.bool, device=self.dev)
        if self.hist is not None:
            self.hist = torch.zeros((self.slots, self.cache_len), dtype=torch.int32,
                                    device=self.dev)

    def export_requests(self) -> list[Request]:
        """Resumable snapshots (:func:`snapshot_request`) of every request
        not yet ended, queued first, then by slot (``engine.py:823-846``).
        No device state crosses: a fresh engine that re-prefills prompt and
        history gives the same streams."""
        return [snapshot_request(req)
                for req in list(self.queue) + [r for r in self.live if r is not None]
                if not req.done]

    def stats(self) -> dict:
        """Serving and lifecycle counters for CLIs and tests."""
        return {
            "replica_id": self.replica_id,
            "ticks": self.tick_count,
            "fused_ticks": self.fused_ticks,
            "spec_ticks": self.spec_ticks,
            "host_transfers": self.host_transfers,
            "uptime_s": max(self._clock() - self._started_at, 0.0),
            "consecutive_tick_failures": self.consecutive_tick_failures,
            "statuses": {s.name: n for s, n in sorted(
                self.status_counts.items(), key=lambda kv: kv[0].name)},
            "events": [dict(e) for e in self.events],
            "events_dropped": self.events_dropped,
            "queued": len(self.queue),
            "live": sum(r is not None for r in self.live),
            "straggler": self.straggler.report(),
            "preemptions": sum(1 for e in self.events if e["kind"] == "preempt"),
            "quarantined": self.status_counts.get(R.Status.QUARANTINED, 0),
            "kv_layout": "paged" if self.paged is not None else "contiguous",
            "paged": self.paged.stats() if self.paged is not None else None,
            "kv_cache_dtype": self.cfg.kv_cache_dtype,
            "speculative": self.speculative,
            "spec_acceptance": self.spec_acceptance_rate,
        }

    @property
    def spec_acceptance_rate(self) -> float:
        """Drafted tokens accepted over every verify tick."""
        return (self.spec_accepted_total / self.spec_drafted_total
                if self.spec_drafted_total else 0.0)

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
        if self.prefill == "legacy":
            self._prefill_slot(slot, req, prompt, remaining)
            return True
        tail_start = 0
        if self.paged is not None:
            # prefix reuse (engine.py:917-935): the matched prompt pages are
            # mapped read-only and only the tail is prefilled; the tail start
            # is floored to the largest chunk size, so every chunk C still
            # starts at a multiple of C
            tail_start = self.paged.admit(slot, prompt, chunk0=self.chunk_sizes[-1])
            if tail_start > 0:
                self._event("prefix_hit", rid=req.rid, slot=slot, tokens=tail_start)
        chunks = chunk_schedule(plen - tail_start, self.chunk_sizes)
        padded = np.zeros((tail_start + sum(chunks),), np.int64)
        padded[:plen] = prompt
        self._plan[slot] = _PrefillPlan(tokens=padded, chunks=chunks, ci=0, off=tail_start,
                                        true_len=plen)
        self.live[slot] = req
        self.max_new_arr[slot] = remaining
        if self.speculative:  # seed the drafter's history with the prompt
            self.hist[slot, :plen] = torch.as_tensor(prompt, device=self.dev).to(torch.int32)
        return True

    def _prefill_slot(self, slot: int, req: Request, prompt: np.ndarray, remaining: int):
        """The legacy per-request prefill (``engine.py:994-1036``): the one-shot
        ``prefill_bucketed`` of ``prompt`` alone, its caches fitted to
        ``cache_len`` and written into the slot's rows in place. The prefill
        token goes through the retirement predicate on the device (no
        transfer); the next decode-only tick records it. A preempted request
        resumes here with its prompt, its emitted tokens and the budget left."""
        tokens = torch.as_tensor(prompt, device=self.dev).to(torch.int64)[None]
        plen = int(prompt.shape[0])
        with torch.no_grad():
            logits, caches = prefill_bucketed(self.params, self.cfg, tokens,
                                              kernels=self.kernels)
            caches = fit_caches(caches, self.cfg, self.cache_len)
            for path, (leaf, batch, _) in _checked_leaves(caches, self.cfg).items():
                # the request's one slot into this slot, on the batch axis
                Tr.tree_get(self.caches, path).select(batch, slot).copy_(leaf.select(batch, 0))
            first = torch.argmax(logits[0]).to(torch.int32)
            self.pos[slot] = plen
            self.cur_tok[slot] = first
            self.done[slot] = _retire(first, plen, 1, remaining, eos_id=self.eos_id,
                                      max_len=self.max_len)
            self.gen_count[slot] = 1
            self.max_new_arr[slot] = remaining
        self.live[slot] = req
        self._pending_first.add(slot)

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
        self._pending_first.discard(slot)
        self._release_pages(slot)
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
        """Chunk tokens this tick may append (``engine.py:1110-1124``): the
        base ``cfg.prefill_chunk_budget`` scaled by the highest
        ``budget_weight`` among the requests mid-prefill, so the highest SLO
        class present sets the pace. All weights 1.0 give the base budget;
        ``_plan_chunks`` still takes at least one chunk."""
        w = max((self.live[s].budget_weight for s in range(self.slots)
                 if self._plan[s] is not None and self.live[s] is not None),
                default=1.0)
        return max(1, int(round(self.cfg.prefill_chunk_budget * w)))

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

    # -- paged-KV write preparation (engine.py:1038-1106) ---------------------

    def _apply_page_copies(self, pairs: list[tuple[int, int]]):
        """Apply the COW (src, dst) page copies over every pool leaf before
        the tick runs. The list is padded to a power of two with garbage
        self-copies, as the JAX engine pads it, so the copy takes few shapes."""
        n = 1 << max(len(pairs) - 1, 0).bit_length()
        src = np.full((n,), self.paged.garbage, np.int64)
        dst = np.full((n,), self.paged.garbage, np.int64)
        for i, (s, d) in enumerate(pairs):
            src[i], dst[i] = s, d
        src, dst = self._to_device(src), self._to_device(dst)
        for _, leaf in Tr.tree_leaves(self.caches):  # [L, P, ...]: pages on axis 1
            leaf[:, dst] = leaf[:, src]

    def _cow_prepare(self, writes: list) -> list[int]:
        """Make the blocks this tick writes exclusive (``writes``: (slot,
        blocks) pairs) and apply the COW copies. A slot the pool cannot cover
        even after trie eviction ends ``FAILED`` (``page_pool_exhausted``),
        its pages released; the failed slots are returned so that the caller
        diverts them out of the tick."""
        pairs, failed = [], []
        for s, blocks in writes:
            if self.live[s] is None:
                continue
            try:
                pairs += self.paged.ensure_writable(s, blocks)
            except PagePoolExhausted:
                req = self.live[s]
                self._event("page_pool_exhausted", rid=req.rid, slot=s)
                self._finish(s, req, R.Status.FAILED, detail="page_pool_exhausted")
                failed.append(s)
        if pairs:
            self._event("cow_fork", pairs=len(pairs), forks_total=self.paged.cow_forks)
            self._apply_page_copies(pairs)
        return failed

    def _prepare_tick_pages(self, selected, chunk, chunk_tok, chunk_off, finishing,
                            last_row, fin_pos, dec_active, dec_span: int = 1):
        """Page preparation for a fused or speculative tick: the chunk
        windows of the selected slots and the ``dec_span`` rows from the
        frontier of each decoding slot (one decode row, or the verify chunk,
        which may straddle two pages) become exclusive; slots shed on pool
        exhaustion are diverted in place (their chunk to the trash tail,
        their decode and handoff masked off). Returns the device page table,
        or None on the contiguous layout."""
        if self.paged is None:
            return None
        ps = self.paged.page_size
        writes = [(s, range(int(chunk_off[s]) // ps, (int(chunk_off[s]) + chunk) // ps))
                  for s in selected]
        writes += [(s, range(int(self._pos_host[s]) // ps,
                             (int(self._pos_host[s]) + dec_span - 1) // ps + 1))
                   for s in range(self.slots) if dec_active[s]]
        for s in self._cow_prepare(writes):
            if s in selected:
                selected.remove(s)
            chunk_tok[s] = 0
            chunk_off[s] = self.trash_base
            finishing[s] = False
            last_row[s] = 0
            fin_pos[s] = 0
            dec_active[s] = False
        return self._to_device(self.paged.table)

    # -- fault injection (engine.py:1168-1186) ---------------------------------

    def _maybe_raise_tick_fault(self):
        """The ``tick_exception`` fault: raise before any device work of the
        tick, as a failing kernel launch would."""
        if self._fault_plan is not None and self._fault_plan.at(self.tick_count,
                                                                 "tick_exception"):
            raise R.FaultInjected(f"injected tick exception @ tick {self.tick_count}")

    def _fault_mask(self, kind: str) -> torch.Tensor | None:
        """The [slots] device mask of the slots ``kind`` targets this tick,
        or None when it targets none (then the tick runs as with no plan)."""
        if self._fault_plan is None:
            return None
        mask = self._fault_plan.slot_mask(self.tick_count, kind, self.slots)
        return self._to_device(mask) if mask.any() else None

    def _transfer(self, packed: torch.Tensor) -> np.ndarray:
        """The tick's one device-to-host transfer."""
        self.host_transfers += 1
        return packed.cpu().numpy()

    def _fused_tick(self, prefilling: list) -> bool:
        self._maybe_raise_tick_fault()
        (chunk, selected, chunk_tok, chunk_off, finishing, last_row,
         fin_pos) = self._plan_chunks(prefilling, self._chunk_budget())
        dec_active = np.array([self.live[s] is not None and self._plan[s] is None
                               for s in range(self.slots)])
        page_table = self._prepare_tick_pages(selected, chunk, chunk_tok, chunk_off,
                                              finishing, last_row, fin_pos, dec_active)
        self.fused_ticks += 1
        (self.cur_tok, self.pos, self.done, self.gen_count, packed) = _fused_tick_step(
            self.params, self.caches, self.cur_tok, self.pos, self.done, self.gen_count,
            self.max_new_arr, self._to_device(dec_active), self._to_device(chunk_tok),
            self._to_device(chunk_off), self._to_device(finishing),
            self._to_device(last_row), self._to_device(fin_pos), page_table, cfg=self.cfg,
            kernels=self.kernels, eos_id=self.eos_id, max_len=self.max_len,
            cache_len=self.cache_len, trash_base=self.trash_base, guards=self.guards,
            fault_nan=self._fault_mask("nan"))
        state = self._transfer(packed)
        tok, done = state[0], state[2]
        guard = state[4] if self.guards else np.zeros((self.slots,), np.int64)
        if self.paged is not None:  # mirror the device frontier's advance
            self._pos_host[dec_active] += 1
            self._pos_host[finishing] = fin_pos[finishing]
        for s, req in enumerate(self.live):
            if req is None:
                continue
            if guard[s]:
                self._quarantine(s, req, guard[s])
            elif finishing[s]:
                self._plan[s] = None
                if self.paged is not None:  # intern the finished prefill
                    self.paged.insert_prefix(s)
                req.generated.append(int(tok[s]))
                if self.hist is not None:  # keep the drafter's history current
                    self.hist[s, int(fin_pos[s])] = int(tok[s])
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

    def _spec_tick(self, prefilling: list) -> bool:
        """One speculative tick (``engine.py:1256-1348``): draft and verify
        ``spec_gamma`` tokens for every decoding slot and, with slots
        mid-prefill, one prompt chunk per selected slot; one host transfer."""
        self._maybe_raise_tick_fault()
        slots, gamma = self.slots, self.spec_gamma
        dec_active = np.array([self.live[s] is not None and self._plan[s] is None
                               for s in range(slots)])
        if prefilling:
            # the verify rows ride the chunk budget: every decoding slot spends
            # gamma + 1 rows, prompts get the rest (at least one chunk)
            (chunk, selected, chunk_tok, chunk_off, finishing, last_row,
             fin_pos) = self._plan_chunks(
                prefilling, self._chunk_budget() - int(dec_active.sum()) * (gamma + 1))
        else:
            chunk, selected = None, []
            chunk_tok = np.zeros((slots, 1), np.int64)
            chunk_off = np.full((slots,), self.trash_base, np.int32)
            finishing = np.zeros((slots,), bool)
            last_row = np.zeros((slots,), np.int32)
            fin_pos = np.zeros((slots,), np.int32)
        # the verify writes gamma + 1 rows from each decoding slot's frontier;
        # rejected ones roll back by the rewind alone, in pages already its own
        page_table = self._prepare_tick_pages(selected, chunk, chunk_tok, chunk_off,
                                              finishing, last_row, fin_pos, dec_active,
                                              dec_span=gamma + 1)
        self.spec_ticks += 1
        self.fused_ticks += int(chunk is not None)
        (self.hist, self.cur_tok, self.pos, self.done, self.gen_count,
         packed) = _spec_tick_step(
            self.params, self.caches, self.hist, self.cur_tok, self.pos, self.done,
            self.gen_count, self.max_new_arr, self._to_device(dec_active),
            self._to_device(chunk_tok) if chunk is not None else None,
            self._to_device(chunk_off), self._to_device(finishing),
            self._to_device(last_row), self._to_device(fin_pos), page_table, cfg=self.cfg,
            kernels=self.kernels, drafter=self._drafter, gamma=gamma, eos_id=self.eos_id,
            max_len=self.max_len, trash_base=self.trash_base, guards=self.guards,
            fault_nan=self._fault_mask("nan"), fault_draft=self._fault_mask("drafter_garbage"))
        state = self._transfer(packed)
        toks, n_out = state[: gamma + 1], state[gamma + 1]
        drafted, done = state[gamma + 2], state[gamma + 3]
        guard = state[gamma + 4] if self.guards else np.zeros((slots,), np.int64)
        if self.paged is not None:  # mirror the device frontier's advance
            self._pos_host[dec_active] += n_out[dec_active]
            self._pos_host[finishing] = fin_pos[finishing]
        for s, req in enumerate(self.live):
            if req is None:
                continue
            if guard[s]:
                self._quarantine(s, req, guard[s])
            elif finishing[s]:
                self._plan[s] = None
                if self.paged is not None:  # intern the finished prefill
                    self.paged.insert_prefix(s)
                req.generated.append(int(toks[0, s]))
                if done[s]:
                    self._finish(s, req, self._terminal_status(req))
            elif s in selected:  # mid-prefill: advance the plan
                p = self._plan[s]
                p.off += chunk
                p.ci += 1
            elif dec_active[s]:
                n, d = int(n_out[s]), int(drafted[s])
                req.generated.extend(int(toks[j, s]) for j in range(n))
                req.spec_drafted += d
                req.spec_accepted += min(n - 1, d)
                self.spec_drafted_total += d
                self.spec_accepted_total += min(n - 1, d)
                if done[s]:
                    self._finish(s, req, self._terminal_status(req))
        # the acceptance watchdog: with enough drafts offered to judge, a
        # collapsed acceptance makes every verify pure overhead
        if (self.cfg.spec_disable_after > 0
                and self.spec_drafted_total >= self.cfg.spec_disable_after
                and self.spec_acceptance_rate < self.cfg.spec_min_acceptance):
            self.speculative = False
            self._event("spec_disabled", acceptance=round(self.spec_acceptance_rate, 4),
                        drafted=self.spec_drafted_total)
        return True

    def _decode_tick(self) -> bool:
        self._maybe_raise_tick_fault()
        page_table = None
        if self.paged is not None:
            # one frontier row per live slot; empty slots write the garbage
            # page through their released (all-garbage) table rows
            ps = self.paged.page_size
            self._cow_prepare([(s, [int(self._pos_host[s]) // ps])
                               for s in range(self.slots) if self.live[s] is not None])
            page_table = self._to_device(self.paged.table)
        active_np = np.array([r is not None for r in self.live])
        active = self._to_device(active_np)
        # idle slots write and read row cache_len - 1, as in the fused tick: a
        # retired slot's position may stand at max_len, which is cache_len
        # under the legacy prefill. Under MoE the idle rows share expert
        # capacity with the live ones, so they decode what JAX's do: their
        # last token at their own position (engine.py:539-545). MLA's row
        # write skips a position past the cache, as JAX's one-hot does; the
        # attention kernels take none, so the moe and hybrid families' is
        # clamped into it. An idle slot's Mamba state steps too, and is
        # overwritten at the next admission
        kinds = [k for ks in Tr.block_plan(self.cfg)[:2] for k in ks]
        if not any(k.ffn.startswith("moe") for k in kinds):
            idle = torch.full_like(self.pos, self.cache_len - 1)
        elif any(k.mixer == "mla" for k in kinds):
            idle = self.pos
        else:
            idle = self.pos.clamp(max=self.cache_len - 1)
        dpos = torch.where(active, self.pos, idle)
        logits, _ = Tr.decode_step(self.params, self.cur_tok[:, None].to(torch.int64),
                                   self.caches, dpos, self.cfg, kernels=self.kernels,
                                   page_table=page_table)
        (self.cur_tok, self.pos, self.done, self.gen_count, packed) = _advance(
            logits, self.cur_tok, self.pos, self.done, self.gen_count, self.max_new_arr,
            active, self.caches, eos_id=self.eos_id, max_len=self.max_len,
            guards=self.guards, paged=page_table is not None, fault_nan=self._fault_mask("nan"))
        state = self._transfer(packed)
        if self.paged is not None:  # mirror the device frontier's advance
            self._pos_host[active_np] += 1
        first, nxt, done, entry_done = state[0], state[1], state[3], state[5]
        guard = state[6] if self.guards else np.zeros((self.slots,), np.int64)
        for s, req in enumerate(self.live):
            if req is None:
                continue
            if guard[s]:
                self._quarantine(s, req, guard[s])
                continue
            if s in self._pending_first:  # the legacy prefill's token
                req.generated.append(int(first[s]))
                self._pending_first.discard(s)
                if entry_done[s]:  # retired on it: this tick's token is dropped
                    self._finish(s, req, self._terminal_status(req))
                    continue
            req.generated.append(int(nxt[s]))
            if done[s]:
                self._finish(s, req, self._terminal_status(req))
        return True

    def _dispatch(self) -> bool:
        prefilling = [s for s in range(self.slots) if self._plan[s] is not None]
        with torch.no_grad():
            if self.speculative and any(r is not None and p is None
                                        for r, p in zip(self.live, self._plan)):
                return self._spec_tick(prefilling)
            # a pure-prefill tick has nothing to verify: the plain fused tick
            return self._fused_tick(prefilling) if prefilling else self._decode_tick()

    def step(self) -> bool:
        """One scheduler tick: expiry and cancellation, admission (with
        preemption), then a fused or decode-only tick with its one host
        transfer. Returns False when there was nothing to run. A tick that
        raises is contained (:meth:`_fail_all_live`), so ``step()`` raises
        only when rebuilding the device state fails. Afterwards ``on_emit``
        fires for each request that emitted (its new tokens) and
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
        tick = self.tick_count
        self._expire_and_cancel(self._clock())
        if self._fault_plan is not None:
            # cache_growth: the slot's cache cannot hold the request; it
            # retires CACHE_EXHAUSTED with the tokens it emitted
            for f in self._fault_plan.at(tick, "cache_growth"):
                for s in (range(self.slots) if f.slot is None else [f.slot]):
                    if 0 <= s < self.slots and self.live[s] is not None:
                        self._event("cache_growth_fault", rid=self.live[s].rid, slot=s)
                        self._finish(s, self.live[s], R.Status.CACHE_EXHAUSTED,
                                     detail="fault_injected")
        self._admission()
        if all(r is None for r in self.live):
            return False
        t0 = time.perf_counter()
        try:
            if self._fault_plan is not None:
                for f in self._fault_plan.at(tick, "slow_tick"):
                    self._event("slow_tick_fault", duration_s=f.duration_s)
                    time.sleep(f.duration_s)
            failure = None
            try:
                out = self._dispatch()
                self.consecutive_tick_failures = 0  # a clean tick resets the gate
            except Exception as exc:  # noqa: BLE001 -- a failing tick is contained
                self.consecutive_tick_failures += 1
                failure = f"{type(exc).__name__}: {exc}"[:200]
            if failure is not None:
                # JAX's engine first flips a sticky kernel-to-XLA attention
                # and retries (engine.py:1413-1440); the port has no second
                # implementation and takes JAX's last resort at once. Outside
                # the except block the traceback is gone, and with it the
                # raising frames' references to the old caches.
                self._fail_all_live(failure)
                out = True
        finally:
            # the tick's wall time; on the card it includes the tick's
            # synchronising transfer
            dur = time.perf_counter() - t0
            if self.straggler.record(tick, dur):
                self._event("straggler", duration_s=round(dur, 4))
            self.tick_count += 1
        return out

    def run(self):
        while self.queue or any(r is not None for r in self.live):
            if not self.step():
                break
