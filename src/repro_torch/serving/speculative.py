"""Speculative decoding: prompt-lookup drafting and acceptance
(``repro/serving/speculative.py``).

A decode step streams every weight and the whole KV cache for one token
per slot. Speculation drafts ``gamma`` tokens per slot cheaply, verifies
them in one ``gamma + 1``-row chunk through the prefill-append path
(``models.transformer.verify_chunk_step``, logits at every row), and emits
the longest accepted prefix plus the model's own next token: up to
``gamma + 1`` tokens for one pass over the weights.

* ``ngram_draft`` drafts by prompt lookup: the longest n-gram suffix
  (n <= ``ngram_max``) of the slot's prompt and emitted history is matched
  against that history, and the tokens after its most recent match are
  proposed. It is shifted-equality compares on device tensors, with no
  host loop and no transfer. ``DRAFTERS`` maps ``cfg.spec_draft`` to a
  drafter of the signature ``(hist, pos) -> drafts``.
* ``accept_tokens`` turns the verify logits into emissions. Greedy: a draft
  is accepted when it equals the argmax of its row, so the stream is the
  plain greedy stream. With ``temperature > 0``: speculative sampling for a
  deterministic drafter (accept ``d`` with probability ``p(d)``, on a
  rejection sample from ``p`` without ``d``, after ``gamma`` accepts sample
  the bonus row from ``p``), drawn from an explicit ``torch.Generator``
  where JAX takes a key. The engine decodes greedily.

Rejected rows need no cache surgery: the engine rewinds the slot's
frontier, every attention read stops below it, and the next tick writes
over them (``core.ternary.mask_past_frontier``). On the paged layout the
pages holding them are already the slot's own (``ensure_writable`` ran
before the tick), so the page table is not touched either.
"""

from __future__ import annotations

import torch


def ngram_draft(hist: torch.Tensor, pos: torch.Tensor, *, gamma: int,
                ngram_max: int = 3) -> torch.Tensor:
    """Prompt-lookup drafts: ``gamma`` tokens per slot.

    ``hist [B, L]`` int32 is each slot's token history, valid at positions
    ``0..pos`` (``hist[pos]`` is the current token, whose successors are
    drafted; later entries are stale and never read); ``pos [B]`` int32.
    For ``n = ngram_max..1``, longest first, the suffix
    ``hist[pos-n+1..pos]`` is matched at every earlier start ``s`` with
    ``s + n <= pos``; the most recent match wins and
    ``hist[s+n .. s+n+gamma)`` is proposed, clamped at ``pos``. With no
    match the current token is repeated. Returns [B, gamma] of hist's
    dtype."""
    b, length = hist.shape
    dev = hist.device
    pos = pos.to(torch.int64)
    idx = torch.arange(length, device=dev)
    found = torch.zeros((b,), dtype=torch.bool, device=dev)
    start = pos  # no match: the continuation starts at the current token
    for n in range(ngram_max, 0, -1):
        eq = torch.ones((b, length), dtype=torch.bool, device=dev)
        for i in range(n):
            suf_i = hist.gather(1, (pos - n + 1 + i).clamp(0, length - 1)[:, None])
            # column s of the shifted view holds hist[s + i] (-1 past the end)
            shifted = torch.cat([hist[:, i:], hist.new_full((b, i), -1)], dim=1)
            eq &= shifted == suf_i
        # s + n <= pos: a continuation exists and the suffix itself is left
        # out; pos + 1 >= n: the suffix exists
        valid = (idx[None, :] + n <= pos[:, None]) & (pos[:, None] + 1 >= n)
        m = eq & valid
        hit = m.any(dim=1)
        s_last = torch.where(m, idx[None, :], torch.full_like(idx, -1)[None, :]).amax(dim=1)
        start = torch.where(hit & ~found, s_last + n, start)
        found = found | hit
    j = torch.arange(gamma, device=dev)
    gidx = torch.minimum(start[:, None] + j[None, :], pos[:, None])
    return hist.gather(1, gidx)


DRAFTERS = {"ngram": ngram_draft}


def make_drafter(cfg, *, gamma: int | None = None):
    """``cfg.spec_draft`` as a ``(hist, pos) -> drafts [B, gamma]``
    closure (``speculative.py:95-111``). A draft model would close over its
    own parameters here behind the same signature."""
    impl = cfg.spec_draft
    if impl not in DRAFTERS:
        raise ValueError(f"unknown spec_draft {impl!r}; have {sorted(DRAFTERS)}")
    fn = DRAFTERS[impl]
    g = int(gamma if gamma is not None else cfg.spec_gamma)
    if g < 1:
        raise ValueError(f"spec_gamma must be >= 1, got {g}")
    nmax = int(cfg.spec_ngram_max)
    return lambda hist, pos: fn(hist, pos, gamma=g, ngram_max=nmax)


def _cumprod_sum(ok: torch.Tensor) -> torch.Tensor:
    """The length of each row's leading run of True, int32."""
    return torch.cumprod(ok.to(torch.int32), dim=1).sum(dim=1).to(torch.int32)


def accept_tokens(drafts: torch.Tensor, logits: torch.Tensor, *, temperature: float = 0.0,
                  generator: torch.Generator | None = None):
    """Emissions from the verify logits (``speculative.py:114-153``).

    ``drafts [B, gamma]``; ``logits [B, gamma + 1, V]``, row j the model's
    distribution after [t0, d_1..d_j]. Returns ``(targets [B, gamma + 1]
    int32, k [B] int32)``: ``targets[:, j]`` is the token of micro-step j
    and ``k`` the number of accepted drafts, so rows ``0..k`` are the
    emissions. Greedy at ``temperature <= 0``; otherwise speculative
    sampling with ``generator`` on the logits' device (required)."""
    b, g1, v = logits.shape
    gamma = g1 - 1
    greedy = torch.argmax(logits, dim=-1).to(torch.int32)
    if temperature <= 0:
        return greedy, _cumprod_sum(drafts == greedy[:, :gamma])
    if generator is None:
        raise ValueError("temperature > 0 requires a torch.Generator")
    dev = logits.device
    drafts = drafts.to(torch.int64)
    p = torch.softmax(logits[:, :gamma].to(torch.float32) / temperature, dim=-1)
    p_draft = p.gather(-1, drafts[..., None])[..., 0]
    ok = torch.rand(p_draft.shape, generator=generator, device=dev) < p_draft
    k = _cumprod_sum(ok)
    # the residual of a delta proposal: p without the draft, renormalized
    res_logits = torch.log(p + 1e-30).scatter(-1, drafts[..., None], float("-inf"))
    res = torch.multinomial(torch.softmax(res_logits, dim=-1).reshape(b * gamma, v), 1,
                            generator=generator)
    res = res.reshape(b, gamma)
    bonus = torch.multinomial(
        torch.softmax(logits[:, gamma].to(torch.float32) / temperature, dim=-1), 1,
        generator=generator)
    samples = torch.cat([res, bonus], dim=1).to(torch.int32)
    j = torch.arange(g1, device=dev)[None, :]
    drafts_row = torch.cat([drafts.to(torch.int32), samples.new_zeros((b, 1))], dim=1)
    return torch.where(j < k[:, None], drafts_row, samples), k
