"""Greedy generation on the packed model (``repro/serving/engine.py``).

``generate`` runs a length-bucketed one-shot prefill, then one decode step
per token. Tokens, positions and done flags stay on the device for the whole
loop; the token ids cross to the host once, at the end. The chunked
continuous-batching ``ServingEngine`` is not ported yet.
"""

from __future__ import annotations

import dataclasses

import torch

from .. import _common as C
from ..kernels import KERNELS
from ..models import transformer as Tr


def bucket_length(s: int, sizes=(64, 128, 256)) -> int:
    """The smallest size that fits ``s``, else the next multiple of the
    largest size."""
    sizes = sorted(sizes)
    for b in sizes:
        if s <= b:
            return b
    return C.round_up(s, sizes[-1])


def init_caches(cfg, batch: int, max_len: int, *, device=None) -> dict:
    """Zeroed cache tree ([L, B, HK, max_len, D] leaves)."""
    return Tr.cache_zeros(cfg, batch, max_len, C.resolve_device(device))


def fit_caches(caches, cfg, max_len: int) -> dict:
    """Grow (zero-pad) or crop every cache to ``max_len`` positions.
    Cropped rows lie past every live frontier, so no attended state goes."""
    del cfg  # one layout: the sequence axis is axis 3 of every leaf

    def fit(c):
        if c.shape[3] >= max_len:
            return c[:, :, :, :max_len].contiguous()
        return C.pad_to(c, 3, max_len)

    return {"blocks": {b: {k: fit(v) for k, v in leaves.items()}
                       for b, leaves in caches["blocks"].items()}}


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
