"""The decoder stack on the packed serving path (``repro/models/transformer.py``)
for two families: the dense transformer (fused attn+dense branch) and
``ssm``, RWKV-6 (``transformer.py:393-414``).

Parameters keep the JAX tree and layouts: the layer stack lives in
``params["blocks"]["b0"]`` with a leading ``[L]`` axis on every leaf (the
JAX tree's one-layer period: every layer of either family is the same),
and the KV caches are ``[L, B, HK, M, D]`` (int8 cache: with f32 row scales
``[L, B, HK, M]``), or, for the engine's paged layout, page pools
``[L, P, HK, ps, D]`` (``[L, P, HK, ps]``) that ``decode_step`` and
``prefill_chunk_step`` address through a ``page_table [B, NB]`` shared by
every layer. The JAX package scans over the
stacked layers; here a Python loop walks them. Every dense block runs the
int8-resident pipeline of ``transformer.py:422-447``: norm-quant prologue,
q/k/v projections on the int8 row, RoPE, attention, the o projection with
the residual in its epilogue, norm-quant, fused SwiGLU, and the down
projection with the residual in its epilogue. Each block resolves the
matmul engine of its projections once (``cfg.matmul_engine``); where q
(gate) resolves to the table-lookup engine, the first (second) prologue
also emits the TL tables, which q, k and v (gate and up) consume; o and
down quantize their own input.

An RWKV block norms with plain ``rmsnorm``, its projections quantize their
own lerped inputs, and its residual adds follow the projections, rounded
to the activation dtype, as in JAX. Its "cache" is a recurrent state of
O(1) per slot: ``wkv [L, B, H, n, n]`` f32 and the token-shift carries
``x_time``, ``x_chan [L, B, 1, d]``, with no sequence axis. ``forward``
prefills from a zero state (the WKV through ``kernels.wkv``), ``decode_step``
advances the state in place; a multi-token step against an existing state
(``prefill_chunk_step``) raises, as the WKV kernel, like the TPU kernel,
starts from zero, and the paged layout pages attention K/V only.
"""

from __future__ import annotations

import dataclasses

import torch

from ..core import bitlinear
from ..core.params import ParamSpec
from ..core.ternary import dequantize_kv, kv_page_rows, quantize_kv, update_kv_pages
from . import attention as attn_ops
from . import layers as L
from . import rwkv as rwkv_mod

FAMILIES = ("dense", "ssm")


def _attn_spec(cfg) -> dict:
    d, h, hk, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    return {
        "q": bitlinear.spec(d, h * hd),
        "k": bitlinear.spec(d, hk * hd),
        "v": bitlinear.spec(d, hk * hd),
        "o": bitlinear.spec(h * hd, d),
    }


def _layer_spec(cfg) -> dict:
    if cfg.family not in FAMILIES:
        raise ValueError(f"family must be one of {FAMILIES}, got {cfg.family!r}")
    if cfg.family == "ssm":
        spec = rwkv_mod.rwkv_spec(cfg)
        return {"ln1": L.rmsnorm_spec(cfg.d_model), "ln2": L.rmsnorm_spec(cfg.d_model),
                "time": spec["time"], "channel": spec["channel"]}
    return {
        "ln1": L.rmsnorm_spec(cfg.d_model),
        "ln2": L.rmsnorm_spec(cfg.d_model),
        "attn": _attn_spec(cfg),
        "ffn": L.mlp_spec(cfg.d_model, cfg.d_ff),
    }


def _stack(tree, n: int):
    if isinstance(tree, ParamSpec):
        return dataclasses.replace(tree, shape=(n,) + tree.shape)
    return {k: _stack(v, n) for k, v in tree.items()}


def param_specs(cfg) -> dict:
    return {
        "embed": L.embedding_spec(cfg.padded_vocab, cfg.d_model),
        "blocks": {"b0": _stack(_layer_spec(cfg), cfg.n_layers)},
        "final_norm": L.rmsnorm_spec(cfg.d_model),
        "lm_head": L.lm_head_spec(cfg.d_model, cfg.padded_vocab),
    }


# Float matrices the serving path casts to the activation dtype.
DENSE_LEAVES = {("embed", "table"), ("lm_head", "w")}


def pack_tree(params, specs, *, dtype=None) -> dict:
    """Latent float tree -> serving tree: every ternary ``{"w"}`` node
    becomes ``{"wp", "scale"}`` (``bitlinear.pack_params``). With ``dtype``,
    the :data:`DENSE_LEAVES` (embedding table, LM head weight) are cast to
    it once — the cast ``embed``/``dense_apply`` would otherwise apply on
    every call, so the values used are the same."""

    def rec(p, s, path):
        if isinstance(s, ParamSpec):
            return p.to(dtype) if dtype is not None and path[-2:] in DENSE_LEAVES else p
        if set(s) == {"w"} and isinstance(s["w"], ParamSpec) and s["w"].quant == "ternary":
            return bitlinear.pack_params(p["w"])
        return {k: rec(p[k], s[k], path + (k,)) for k in s}

    return rec(params, specs, ())


def layer_slice(tree, i: int):
    """Layer ``i`` of a stacked tree (views, no copies)."""
    if isinstance(tree, dict):
        return {k: layer_slice(v, i) for k, v in tree.items()}
    return tree[i]


# The projections of a block, by (sub-block, name).
PROJECTIONS = (("attn", "q"), ("attn", "k"), ("attn", "v"), ("attn", "o"),
               ("ffn", "gate"), ("ffn", "down"))


_FIXED = {e: {name: e for _, name in PROJECTIONS} for e in ("tl", "packed")}


def block_engines(bp, rows: int, engine: str) -> dict:
    """The matmul engine of each projection of one block over ``rows`` rows
    (``transformer.py:428-445``), resolved once per block: a forced or
    pinned engine is every projection's; ``"auto"`` asks each node."""
    if engine in _FIXED:
        return _FIXED[engine]
    return {name: bitlinear.resolve_engine(bp[sub][name], rows, engine=engine)
            for sub, name in PROJECTIONS}


def _apply_attn(bp, x, xq, cfg, rope, *, kernels, engines=None, cache=None, pos=None,
                prefix_limit=0, page_table=None, page_rows=None):
    """Attention sub-block on the int8 row ``xq`` (the prologue's pair, or
    its triple with TL tables); ``engines`` maps q, k, v and o to their
    matmul engine (:func:`block_engines`; alone, each resolves
    ``cfg.matmul_engine``). Returns (x + attn(x), the
    cache rows of this call). ``cache`` is this layer's cache leaves
    ``{"k", "v"[, "k_scale", "v_scale"]}`` (views, updated in place): for a
    decode step (one row, written at ``pos``) or a prefill chunk (rows
    appended at the offsets ``pos``); with ``page_table`` they are page
    pools, read and written through it (``transformer.py:249-330``); a
    decode step's ``page_rows`` are ``kv_page_rows`` of its frontier. None
    for a one-shot prefill, which returns its K/V as ``{"k", "v"}``, or,
    with ``cfg.kv_cache_dtype == "int8"``, quantized and attended as their
    dequantized rows (``transformer.py:242-256``)."""
    b, s, _ = x.shape
    h, hk, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    engines = engines or dict.fromkeys(("q", "k", "v", "o"), cfg.matmul_engine)

    def proj(name, heads):
        y = bitlinear.apply(bp[name], xq, kernels=kernels, out_dtype=x.dtype,
                            engine=engines[name])
        return y.reshape(b, s, heads, hd).transpose(1, 2)

    rope_h = (rope[0][:, None], rope[1][:, None])  # broadcast over heads
    q = L.apply_rope_tables(proj("q", h), rope_h)
    k = L.apply_rope_tables(proj("k", hk), rope_h)
    v = proj("v", hk)
    new = None
    if page_table is not None and cache is None:
        raise ValueError("paged attention requires an existing cache pool")
    if cache is None:
        if cfg.kv_cache_dtype == "int8":
            (k_i8, ks), (v_i8, vs) = quantize_kv(k), quantize_kv(v)
            k, v = dequantize_kv(k_i8, ks, k.dtype), dequantize_kv(v_i8, vs, v.dtype)
            new = {"k": k_i8, "k_scale": ks, "v": v_i8, "v_scale": vs}
        else:
            new = {"k": k, "v": v}
        out = attn_ops.prefill_attention(q, k, v, kernels=kernels)
    elif s > 1 and page_table is not None:  # a chunk, through the page table
        out = attn_ops.prefill_append_attention_paged(
            q, k, v, cache["k"], cache["v"], page_table, pos, kernels=kernels,
            k_scale=cache.get("k_scale"), v_scale=cache.get("v_scale"),
            prefix_limit=prefix_limit)
    elif s > 1:  # a prefill chunk against the cache prefix
        out = attn_ops.prefill_append_attention(
            q, k, v, cache["k"], cache["v"], pos, kernels=kernels,
            k_scale=cache.get("k_scale"), v_scale=cache.get("v_scale"),
            prefix_limit=prefix_limit)
    elif page_table is not None:  # a decode row, through the page table
        ps = cache["k"].shape[2]
        if "k_scale" in cache:
            for name, new_rows in (("k", k[:, :, 0]), ("v", v[:, :, 0])):
                codes, scales = quantize_kv(new_rows)
                update_kv_pages(cache[name], page_table, codes, pos, ps, rows=page_rows)
                update_kv_pages(cache[name + "_scale"], page_table, scales, pos, ps,
                                rows=page_rows)
        else:
            update_kv_pages(cache["k"], page_table, k[:, :, 0], pos, ps, rows=page_rows)
            update_kv_pages(cache["v"], page_table, v[:, :, 0], pos, ps, rows=page_rows)
        out = attn_ops.decode_attention_paged(
            q[:, :, 0], cache["k"], cache["v"], page_table, pos, kernels=kernels,
            k_scale=cache.get("k_scale"), v_scale=cache.get("v_scale"))[:, :, None]
    else:
        if "k_scale" in cache:
            attn_ops.update_kv_cache_quant(cache["k"], cache["v"], cache["k_scale"],
                                           cache["v_scale"], k[:, :, 0], v[:, :, 0], pos)
        else:
            attn_ops.update_kv_cache(cache["k"], cache["v"], k[:, :, 0], v[:, :, 0], pos)
        out = attn_ops.decode_attention(
            q[:, :, 0], cache["k"], cache["v"], pos, kernels=kernels,
            k_scale=cache.get("k_scale"), v_scale=cache.get("v_scale"))[:, :, None]
    out = out.transpose(1, 2).reshape(b, s, h * hd)
    x = bitlinear.apply(bp["o"], out, kernels=kernels, out_dtype=x.dtype, residual=x,
                        engine=engines["o"])
    return x, new


def apply_block(bp, x, cfg, rope, *, kernels, cache=None, pos=None, prefix_limit=0,
                page_table=None, page_rows=None):
    """The fused attn+dense block (``transformer.py:422-447``). Returns
    (x, the cache rows of a one-shot prefill or None)."""
    engines = block_engines(bp, x.shape[0] * x.shape[1], cfg.matmul_engine)
    hq = L.norm_quant(bp["ln1"], x, kernels=kernels, eps=cfg.norm_eps,
                      tables=engines["q"] == "tl")
    x, kv = _apply_attn(bp["attn"], x, hq, cfg, rope, kernels=kernels, engines=engines,
                        cache=cache, pos=pos, prefix_limit=prefix_limit,
                        page_table=page_table, page_rows=page_rows)
    h2q = L.norm_quant(bp["ln2"], x, kernels=kernels, eps=cfg.norm_eps,
                       tables=engines["gate"] == "tl")
    x = L.mlp_fused(bp["ffn"], h2q, kernels=kernels, out_dtype=x.dtype, residual=x,
                    engines=engines)
    return x, kv


def apply_rwkv_block(bp, x, cfg, *, kernels, state=None):
    """The RWKV block (``transformer.py:393-414``). With ``state`` None, a
    prefill of ``x [B, S, d]`` from a zero state, returning (x, its final
    state ``{"wkv", "x_time", "x_chan"}``); with this layer's state leaves
    (views), one decode token, which updates them in place, returning
    (x, None)."""
    h = L.rmsnorm(bp["ln1"], x, eps=cfg.norm_eps)
    if state is None:
        zeros = torch.zeros((x.shape[0], 1, cfg.d_model), dtype=x.dtype, device=x.device)
        y, x_time, wkv = rwkv_mod.time_mix(bp["time"], h, zeros, cfg, kernels=kernels)
        x_chan_prev = zeros
    else:
        if x.shape[1] != 1:
            raise NotImplementedError(
                "a multi-token step against an existing RWKV state is not ported: the "
                "WKV kernel, like the TPU kernel, starts from a zero state")
        y, new = rwkv_mod.time_mix_decode(bp["time"], h, state, cfg, kernels=kernels)
        x_time, wkv = new["x_time"], new["wkv"]
        x_chan_prev = state["x_chan"]
    x = x + y
    h2 = L.rmsnorm(bp["ln2"], x, eps=cfg.norm_eps)
    y2, x_chan = rwkv_mod.channel_mix(bp["channel"], h2, x_chan_prev.to(h2.dtype),
                                      kernels=kernels)
    x = x + y2
    new = {"wkv": wkv, "x_time": x_time, "x_chan": x_chan}
    if state is None:
        return x, new
    for name, t in new.items():
        state[name].copy_(t)
    return x, None


def rope_for(cfg, positions):
    """The step's RoPE tables, shared by every layer."""
    return {"attn": L.rope_tables(positions, cfg.head_dim, theta=cfg.rope_theta)}


def _head(params, x, cfg):
    x = L.rmsnorm(params["final_norm"], x, eps=cfg.norm_eps)
    return L.lm_head(params["lm_head"], x)


def _layer_cache(caches, li: int) -> dict:
    """Layer ``li``'s cache leaves (views into the stacked [L, ...] leaves)."""
    return {n: leaf[li] for n, leaf in caches["blocks"]["b0"].items()}


def forward(params, tokens: torch.Tensor, cfg, *, kernels, collect_cache: bool = False):
    """Full-sequence pass over ``tokens [B, S]``. Returns (logits [B, S, V]
    f32, caches | None) with caches ``{"blocks": {"b0": {...}}}`` of
    :func:`cache_specs` layout at length S."""
    x = L.embed(params["embed"], tokens, dtype=cfg.dtype)
    b, s = tokens.shape
    caches = cache_zeros(cfg, b, s, x.device) if collect_cache else None
    if cfg.family == "ssm":
        def block(bp, x):
            return apply_rwkv_block(bp, x, cfg, kernels=kernels)
    else:
        positions = torch.arange(s, dtype=torch.int32, device=x.device)[None].expand(b, s)
        rope = rope_for(cfg, positions)["attn"]

        def block(bp, x):
            return apply_block(bp, x, cfg, rope, kernels=kernels)
    for li in range(cfg.n_layers):
        x, new = block(layer_slice(params["blocks"]["b0"], li), x)
        if collect_cache:
            for n, rows in new.items():
                caches["blocks"]["b0"][n][li] = rows
    return _head(params, x, cfg), caches


def decode_step(params, tokens: torch.Tensor, caches, pos: torch.Tensor, cfg, *, kernels,
                page_table=None):
    """One autoregressive step: ``tokens [B, 1]`` at per-slot positions
    ``pos [B]`` int32. Writes each layer's new K/V into ``caches`` in place
    and returns (logits [B, V], caches). ``page_table [B, NB]`` int32 makes
    ``caches`` page pools (:func:`cache_specs` with ``kv_pages``). The ssm
    family advances its state leaves in place and reads no position."""
    x = L.embed(params["embed"], tokens, dtype=cfg.dtype)
    if cfg.family == "ssm":
        if page_table is not None:
            raise NotImplementedError("the paged layout pages attention K/V; the ssm family "
                                      "has none")
        for li in range(cfg.n_layers):
            x, _ = apply_rwkv_block(layer_slice(params["blocks"]["b0"], li), x, cfg,
                                    kernels=kernels, state=_layer_cache(caches, li))
        return _head(params, x, cfg)[:, 0], caches
    rope = rope_for(cfg, pos[:, None])["attn"]
    page_rows = None
    if page_table is not None:  # the frontier rows' pool addresses, shared by all layers
        page_rows = kv_page_rows(page_table, pos, caches["blocks"]["b0"]["k"].shape[3])
    for li in range(cfg.n_layers):
        bp = layer_slice(params["blocks"]["b0"], li)
        x, _ = apply_block(bp, x, cfg, rope, kernels=kernels, cache=_layer_cache(caches, li),
                           pos=pos, page_table=page_table, page_rows=page_rows)
    return _head(params, x, cfg)[:, 0], caches


def prefill_chunk_step(params, tokens: torch.Tensor, caches, offset: torch.Tensor, cfg, *,
                       kernels, last_row=None, prefix_limit: int = 0, page_table=None):
    """One chunked-prefill step (``transformer.py:608-666``): ``tokens
    [B, C]`` at positions ``offset[b] + [0, C)`` (``offset [B]`` int32, any
    offset with ``offset + C`` within the cache) attend to each slot's cache
    prefix and to themselves, and
    every layer appends the chunk's K/V into ``caches`` in place. Offsets
    at or past ``prefix_limit > 0`` are write-only. Returns (logits, caches):
    logits [B, C, V], or with ``last_row [B]`` only each slot's row, gathered
    before the final norm and the LM head, [B, V]. ``page_table`` as in
    :func:`decode_step`. The dense family only: an RWKV chunk against an
    existing state raises ``NotImplementedError``."""
    if cfg.family != "dense":
        raise NotImplementedError(
            f"prefill_chunk_step is the attention mixer's; the {cfg.family!r} family's "
            "recurrent state is prefilled whole, from zero (ServingEngine prefill='legacy')")
    x = L.embed(params["embed"], tokens, dtype=cfg.dtype)
    b, c = tokens.shape
    positions = offset.to(torch.int32)[:, None] + torch.arange(
        c, dtype=torch.int32, device=x.device)[None, :]
    rope = rope_for(cfg, positions)["attn"]
    for li in range(cfg.n_layers):
        bp = layer_slice(params["blocks"]["b0"], li)
        x, _ = apply_block(bp, x, cfg, rope, kernels=kernels,
                           cache=_layer_cache(caches, li), pos=offset,
                           prefix_limit=prefix_limit, page_table=page_table)
    if last_row is not None:
        idx = last_row.to(torch.int64)[:, None, None].expand(b, 1, x.shape[-1])
        return _head(params, x.gather(1, idx), cfg)[:, 0], caches
    return _head(params, x, cfg), caches


def verify_chunk_step(params, tokens: torch.Tensor, caches, offset: torch.Tensor, cfg, *,
                      kernels, prefix_limit: int = 0, page_table=None):
    """The speculative verify step (``transformer.py:669-703``): the chunk
    ``tokens [B, C]`` = [current token, C - 1 drafts] at each slot's decode
    frontier ``offset [B]`` (anywhere, not a multiple of C), through
    :func:`prefill_chunk_step`, returning (logits at every chunk row
    [B, C, V], caches). Row j is the model's distribution after chunk rows
    0..j, what j + 1 decode steps give one by one. The chunk's K/V land at
    ``[offset, offset + C)``; the rows of rejected drafts are rolled back by
    rewinding the frontier (``core.ternary.mask_past_frontier``). The
    port's prefill-append kernel runs here at any frontier, where JAX pins
    its XLA form."""
    return prefill_chunk_step(params, tokens, caches, offset, cfg, kernels=kernels,
                              prefix_limit=prefix_limit, page_table=page_table)


def cache_specs(cfg, batch: int, seq: int, *, kv_pages: int | None = None) -> dict:
    """Shape and dtype of every cache leaf: ``{"blocks": {"b0": {"k":
    (shape, dtype), "v": ...}}}`` with k/v [L, B, HK, seq, D] in ``cfg.dtype``;
    with ``cfg.kv_cache_dtype == "int8"``, k/v int8 and ``k_scale``/``v_scale``
    [L, B, HK, seq] f32 row scales. ``kv_pages`` switches to the paged
    layout (``transformer.py:711-741``): one pool shared by every slot, k/v
    [L, kv_pages, HK, cfg.kv_page_size, D] (and scales [L, kv_pages, HK,
    cfg.kv_page_size]); ``batch`` and ``seq`` then go unused. It is an
    explicit opt-in: only the engine pages. The ssm family's leaves are its
    recurrent state, with no sequence axis (``transformer.py:779-789``):
    ``wkv [L, batch, H, n, n]`` f32 and ``x_time``, ``x_chan [L, batch, 1,
    d]`` in ``cfg.dtype``; ``seq`` goes unused, and it has no paged layout."""
    if cfg.kv_cache_dtype not in ("bf16", "int8"):
        raise ValueError(f"kv_cache_dtype must be 'bf16' or 'int8', got "
                         f"{cfg.kv_cache_dtype!r}")
    if cfg.family == "ssm":
        if kv_pages is not None:
            raise NotImplementedError("the paged layout pages attention K/V; the ssm family "
                                      "has none")
        n, d = cfg.rwkv_head_dim, cfg.d_model
        carry = ((cfg.n_layers, batch, 1, d), cfg.dtype)
        return {"blocks": {"b0": {
            "wkv": ((cfg.n_layers, batch, d // n, n, n), torch.float32),
            "x_time": carry, "x_chan": carry}}}
    if kv_pages is not None:
        shape = (cfg.n_layers, kv_pages, cfg.n_kv_heads, cfg.kv_page_size, cfg.head_dim)
    else:
        shape = (cfg.n_layers, batch, cfg.n_kv_heads, seq, cfg.head_dim)
    if cfg.kv_cache_dtype == "int8":
        scales = (shape[:-1], torch.float32)
        leaves = {"k": (shape, torch.int8), "k_scale": scales,
                  "v": (shape, torch.int8), "v_scale": scales}
    else:
        leaves = {"k": (shape, cfg.dtype), "v": (shape, cfg.dtype)}
    return {"blocks": {"b0": leaves}}


def seq_leaves(cfg) -> frozenset:
    """The cache leaves with a sequence axis (axis 3, the one the engine
    grows and crops): every leaf of the dense family, none of the ssm
    family's state (JAX: the leaves whose axes hold ``act_kv_seq``)."""
    if cfg.family == "ssm":
        return frozenset()
    return frozenset(cache_specs(cfg, 1, 1)["blocks"]["b0"])


def cache_zeros(cfg, batch: int, seq: int, device, *, kv_pages: int | None = None) -> dict:
    specs = cache_specs(cfg, batch, seq, kv_pages=kv_pages)
    return {"blocks": {b: {n: torch.zeros(shape, dtype=dt, device=device)
                           for n, (shape, dt) in leaves.items()}
                       for b, leaves in specs["blocks"].items()}}
