"""Decoder-only dense transformer on the packed serving path
(``repro/models/transformer.py``, dense family, fused attn+dense branch).

Parameters keep the JAX tree and layouts: the layer stack lives in
``params["blocks"]["b0"]`` with a leading ``[L]`` axis on every leaf (the
JAX tree's one-layer period: every layer of this family is the same), and
the KV caches are ``[L, B, HK, M, D]`` (int8 cache: with f32 row scales
``[L, B, HK, M]``). The JAX package scans over the
stacked layers; here a Python loop walks them. Every block runs the
int8-resident pipeline of ``transformer.py:422-447``: norm-quant prologue,
q/k/v projections on the int8 row, RoPE, attention, the o projection with
the residual in its epilogue, norm-quant, fused SwiGLU, and the down
projection with the residual in its epilogue.
"""

from __future__ import annotations

import dataclasses

import torch

from ..core import bitlinear
from ..core.params import ParamSpec
from ..core.ternary import dequantize_kv, quantize_kv
from . import attention as attn_ops
from . import layers as L


def _attn_spec(cfg) -> dict:
    d, h, hk, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    return {
        "q": bitlinear.spec(d, h * hd),
        "k": bitlinear.spec(d, hk * hd),
        "v": bitlinear.spec(d, hk * hd),
        "o": bitlinear.spec(h * hd, d),
    }


def _layer_spec(cfg) -> dict:
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


def _apply_attn(bp, x, xq, cfg, rope, *, kernels, cache=None, pos=None,
                prefix_limit=0):
    """Attention sub-block on the int8 row ``xq``; returns (x + attn(x), the
    cache rows of this call). ``cache`` is this layer's cache leaves
    ``{"k", "v"[, "k_scale", "v_scale"]}`` (views, updated in place): for a
    decode step (one row, written at ``pos``) or a prefill chunk (rows
    appended at the offsets ``pos``). None for a one-shot prefill, which
    returns its K/V as ``{"k", "v"}``, or, with ``cfg.kv_cache_dtype ==
    "int8"``, quantized and attended as their dequantized rows
    (``transformer.py:242-256``)."""
    b, s, _ = x.shape
    h, hk, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim

    def proj(name, heads):
        y = bitlinear.apply(bp[name], xq, kernels=kernels, out_dtype=x.dtype)
        return y.reshape(b, s, heads, hd).transpose(1, 2)

    rope_h = (rope[0][:, None], rope[1][:, None])  # broadcast over heads
    q = L.apply_rope_tables(proj("q", h), rope_h)
    k = L.apply_rope_tables(proj("k", hk), rope_h)
    v = proj("v", hk)
    new = None
    if cache is None:
        if cfg.kv_cache_dtype == "int8":
            (k_i8, ks), (v_i8, vs) = quantize_kv(k), quantize_kv(v)
            k, v = dequantize_kv(k_i8, ks, k.dtype), dequantize_kv(v_i8, vs, v.dtype)
            new = {"k": k_i8, "k_scale": ks, "v": v_i8, "v_scale": vs}
        else:
            new = {"k": k, "v": v}
        out = attn_ops.prefill_attention(q, k, v)
    elif s > 1:  # a prefill chunk against the cache prefix
        out = attn_ops.prefill_append_attention(
            q, k, v, cache["k"], cache["v"], pos, kernels=kernels,
            k_scale=cache.get("k_scale"), v_scale=cache.get("v_scale"),
            prefix_limit=prefix_limit)
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
    x = bitlinear.apply(bp["o"], out, kernels=kernels, out_dtype=x.dtype, residual=x)
    return x, new


def apply_block(bp, x, cfg, rope, *, kernels, cache=None, pos=None, prefix_limit=0):
    """The fused attn+dense block (``transformer.py:422-447``). Returns
    (x, the cache rows of a one-shot prefill or None)."""
    hq = L.norm_quant(bp["ln1"], x, kernels=kernels, eps=cfg.norm_eps)
    x, kv = _apply_attn(bp["attn"], x, hq, cfg, rope, kernels=kernels,
                        cache=cache, pos=pos, prefix_limit=prefix_limit)
    h2q = L.norm_quant(bp["ln2"], x, kernels=kernels, eps=cfg.norm_eps)
    x = L.mlp_fused(bp["ffn"], h2q, kernels=kernels, out_dtype=x.dtype, residual=x)
    return x, kv


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
    positions = torch.arange(s, dtype=torch.int32, device=x.device)[None].expand(b, s)
    rope = rope_for(cfg, positions)["attn"]
    caches = cache_zeros(cfg, b, s, x.device) if collect_cache else None
    for li in range(cfg.n_layers):
        bp = layer_slice(params["blocks"]["b0"], li)
        x, new = apply_block(bp, x, cfg, rope, kernels=kernels)
        if collect_cache:
            for n, rows in new.items():
                caches["blocks"]["b0"][n][li] = rows
    return _head(params, x, cfg), caches


def decode_step(params, tokens: torch.Tensor, caches, pos: torch.Tensor, cfg, *, kernels):
    """One autoregressive step: ``tokens [B, 1]`` at per-slot positions
    ``pos [B]`` int32. Writes each layer's new K/V into ``caches`` in place
    and returns (logits [B, V], caches)."""
    x = L.embed(params["embed"], tokens, dtype=cfg.dtype)
    rope = rope_for(cfg, pos[:, None])["attn"]
    for li in range(cfg.n_layers):
        bp = layer_slice(params["blocks"]["b0"], li)
        x, _ = apply_block(bp, x, cfg, rope, kernels=kernels,
                           cache=_layer_cache(caches, li), pos=pos)
    return _head(params, x, cfg)[:, 0], caches


def prefill_chunk_step(params, tokens: torch.Tensor, caches, offset: torch.Tensor, cfg, *,
                       kernels, last_row=None, prefix_limit: int = 0):
    """One chunked-prefill step (``transformer.py:608-666``): ``tokens
    [B, C]`` at positions ``offset[b] + [0, C)`` (``offset [B]`` int32,
    ≡ 0 mod C) attend to each slot's cache prefix and to themselves, and
    every layer appends the chunk's K/V into ``caches`` in place. Offsets
    at or past ``prefix_limit > 0`` are write-only. Returns (logits, caches):
    logits [B, C, V], or with ``last_row [B]`` only each slot's row, gathered
    before the final norm and the LM head, [B, V]."""
    x = L.embed(params["embed"], tokens, dtype=cfg.dtype)
    b, c = tokens.shape
    positions = offset.to(torch.int32)[:, None] + torch.arange(
        c, dtype=torch.int32, device=x.device)[None, :]
    rope = rope_for(cfg, positions)["attn"]
    for li in range(cfg.n_layers):
        bp = layer_slice(params["blocks"]["b0"], li)
        x, _ = apply_block(bp, x, cfg, rope, kernels=kernels,
                           cache=_layer_cache(caches, li), pos=offset,
                           prefix_limit=prefix_limit)
    if last_row is not None:
        idx = last_row.to(torch.int64)[:, None, None].expand(b, 1, x.shape[-1])
        return _head(params, x.gather(1, idx), cfg)[:, 0], caches
    return _head(params, x, cfg), caches


def cache_specs(cfg, batch: int, seq: int) -> dict:
    """Shape and dtype of every cache leaf: ``{"blocks": {"b0": {"k":
    (shape, dtype), "v": ...}}}`` with k/v [L, B, HK, seq, D] in ``cfg.dtype``;
    with ``cfg.kv_cache_dtype == "int8"``, k/v int8 and ``k_scale``/``v_scale``
    [L, B, HK, seq] f32 row scales."""
    shape = (cfg.n_layers, batch, cfg.n_kv_heads, seq, cfg.head_dim)
    if cfg.kv_cache_dtype == "int8":
        scales = (shape[:-1], torch.float32)
        leaves = {"k": (shape, torch.int8), "k_scale": scales,
                  "v": (shape, torch.int8), "v_scale": scales}
    elif cfg.kv_cache_dtype == "bf16":
        leaves = {"k": (shape, cfg.dtype), "v": (shape, cfg.dtype)}
    else:
        raise ValueError(f"kv_cache_dtype must be 'bf16' or 'int8', got "
                         f"{cfg.kv_cache_dtype!r}")
    return {"blocks": {"b0": leaves}}


def cache_zeros(cfg, batch: int, seq: int, device) -> dict:
    specs = cache_specs(cfg, batch, seq)
    return {"blocks": {b: {n: torch.zeros(shape, dtype=dt, device=device)
                           for n, (shape, dt) in leaves.items()}
                       for b, leaves in specs["blocks"].items()}}
