"""The decoder stack on the packed serving path (``repro/models/transformer.py``)
for five families: the dense transformer, ``moe`` (Arctic: attention, then
a token-choice MoE beside a dense residual MLP), ``mla_moe`` (DeepSeek-V2:
latent attention, a dense first layer, then MoE with shared experts),
``hybrid`` (Jamba: Mamba mixers with one attention layer a period, MoE
every ``moe_every``-th layer, ``transformer.py:68-77``) and ``ssm``, RWKV-6
(``transformer.py:393-414``).

A model is a block plan (``transformer.py:38-77``): an unstacked prelude
of layers (DeepSeek's dense first layer), then a period of layer kinds
repeated ``n_periods`` times. Parameters keep the JAX tree and layouts:
prelude layer ``i`` lives in ``params["prelude_{i}"]``, period layer ``i``
in ``params["blocks"]["b{i}"]`` with a leading ``[n_periods]`` axis on
every leaf. The ssm family and a dense config without ``local_global_period``
have a one-kind period and no prelude, so their trees are ``{"blocks":
{"b0": ...}}``; gemma2's period is ``[local, global]`` attention
(``transformer.py:51-60``), ``{"blocks": {"b0": local, "b1": global}}``;
Jamba's has ``attn_layer_period`` kinds, ``b{attn_layer_offset}`` the
attention layer, the others Mamba (``layer["mamba"]``, ``models/mamba.py``).
A local layer masks keys at ``qpos - kpos >= cfg.sliding_window`` in every
attention form; every attention layer scores ``softcap * tanh(s /
softcap)`` with ``cfg.attn_logit_softcap``, and the LM head caps its logits
with ``cfg.final_logit_softcap`` (0 = none, for both). The
JAX package scans over the stacked layers; here a Python loop walks them.

An attention block with a dense FFN (local or global) runs the int8-resident pipeline of
``transformer.py:422-447`` unless ``fused=False``: norm-quant prologue,
q/k/v projections on the int8 row, RoPE, attention, the o projection with
the residual in its epilogue, norm-quant, fused SwiGLU, and the down
projection with the residual in its epilogue. Each block resolves the
matmul engine of its projections once (``cfg.matmul_engine``); where q
(gate) resolves to the table-lookup engine, the first (second) prologue
also emits the TL tables, which q, k and v (gate and up) consume; o and
down quantize their own input. Every other kind, and a dense block with
``fused=False``, runs the unfused branch (``transformer.py:449-475``):
``rmsnorm``, the mixer on the float row (attention, MLA's prefill or
weight-absorbed decode, ``models/mla.py``, or Mamba's prefill from a zero
state or one decode token, ``models/mamba.py``), the residual add, ``rmsnorm``,
then the FFN (the unfused SwiGLU, or ``models/moe.py``'s experts, with the
shared or dense MLP added). Its projections quantize their own input and
take the ``"auto"`` engine, as JAX's do. On the plain versions the two
branches of a dense block are equal bit for bit.

The first residual row comes from :func:`embed_inputs`
(``transformer.py:498-503``): a token tensor, or JAX's batch dict
``{"tokens"}``, through the embedding table; for a config with a
``frontend`` (musicgen-medium's audio frames, internvl2-26b's image
patches), ``{"embeddings": [B, S, FRONTEND_DIMS[frontend]]}`` through the
f32 ``params["frontend"]`` projection (``torch.matmul`` in ``cfg.dtype``,
as JAX's ``jnp.matmul`` outside any Pallas kernel). ``forward``,
``decode_step`` and ``prefill_chunk_step`` take either.

The KV caches are, per attention layer, ``[B, HK, M, D]`` (int8 cache:
with f32 row scales ``[B, HK, M]``), or, for the engine's paged layout
(the dense and moe families), page pools ``[P, HK, ps, D]`` (``[P, HK, ps]``) that
``decode_step`` and ``prefill_chunk_step`` address through a ``page_table
[B, NB]`` shared by every layer; per MLA layer, the latent ``c_kv [B, M,
R]`` and the shared rope key ``k_rope [B, M, rope]`` in the activation
dtype (no int8 form: ``kv_cache_dtype`` leaves them as they are, as in
JAX); per Mamba layer, its state ``ssm [B, d_inner, d_state]`` f32 and
``conv [B, d_conv - 1, d_inner]`` in the activation dtype, with no
sequence axis. Period leaves carry the ``[n_periods]`` axis in front.
:func:`cache_layout` gives each leaf's batch and sequence axis.

An RWKV block norms with plain ``rmsnorm``, its projections quantize their
own lerped inputs, and its residual adds follow the projections, rounded
to the activation dtype, as in JAX. Its "cache" is a recurrent state of
O(1) per slot: ``wkv [L, B, H, n, n]`` f32 and the token-shift carries
``x_time``, ``x_chan [L, B, 1, d]``, with no sequence axis. ``forward``
prefills from a zero state (the WKV through ``kernels.wkv``), ``decode_step``
advances the state in place; a multi-token step against an existing state
(``prefill_chunk_step``) raises, as the WKV kernel, like the TPU kernel,
starts from zero, and the paged layout pages attention K/V only.
``prefill_chunk_step`` and the paged layout serve the families whose
layers are all attention mixers (dense and moe). An MLA or a Mamba layer
refuses a chunk against its latent cache or state and a page table, as
JAX's ``apply_block`` does (``transformer.py:389-392, 417-421``).
"""

from __future__ import annotations

import dataclasses

import torch

from ..core import bitlinear, ternary
from ..core.params import ParamSpec
from ..core.ternary import dequantize_kv, kv_page_rows, quantize_kv, update_kv_pages
from . import attention as attn_ops
from . import layers as L
from . import mamba as mamba_mod
from . import mla as mla_mod
from . import moe as moe_mod
from . import rwkv as rwkv_mod

FAMILIES = ("dense", "moe", "mla_moe", "hybrid", "ssm")


@dataclasses.dataclass(frozen=True)
class LayerKind:
    mixer: str  # attn | mla | mamba | rwkv
    ffn: str  # dense | moe | moe_shared | moe_dense | rwkv_channel
    local: bool = False  # sliding-window attention (gemma2's local layers)


def block_plan(cfg) -> tuple[list[LayerKind], list[LayerKind], int]:
    """(prelude kinds, period kinds, n_periods) (``transformer.py:49-79``)."""
    if cfg.family == "dense":
        if cfg.local_global_period:
            period = [LayerKind("attn", "dense", local=i % cfg.local_global_period == 0)
                      for i in range(cfg.local_global_period)]
        else:
            period = [LayerKind("attn", "dense")]
        if cfg.n_layers % len(period):
            raise ValueError(f"n_layers={cfg.n_layers} is not a multiple of the period "
                             f"{len(period)}")
        return [], period, cfg.n_layers // len(period)
    if cfg.family == "moe":
        return [], [LayerKind("attn", "moe_dense" if cfg.dense_residual else "moe")], cfg.n_layers
    if cfg.family == "mla_moe":
        prelude = [LayerKind("mla", "dense")] * cfg.first_dense_layers
        period = [LayerKind("mla", "moe_shared" if cfg.n_shared_experts else "moe")]
        return prelude, period, cfg.n_layers - cfg.first_dense_layers
    if cfg.family == "ssm":
        return [], [LayerKind("rwkv", "rwkv_channel")], cfg.n_layers
    if cfg.family == "hybrid":  # transformer.py:68-77
        p = cfg.attn_layer_period
        period = [LayerKind("attn" if i == cfg.attn_layer_offset else "mamba",
                            "moe" if cfg.n_experts and i % cfg.moe_every == cfg.moe_every - 1
                            else "dense") for i in range(p)]
        if cfg.n_layers % p:
            raise ValueError(f"n_layers={cfg.n_layers} is not a multiple of the period {p}")
        return [], period, cfg.n_layers // p
    raise ValueError(f"family must be one of {FAMILIES}, got {cfg.family!r}")


def _attn_spec(cfg) -> dict:
    d, h, hk, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    return {
        "q": bitlinear.spec(d, h * hd),
        "k": bitlinear.spec(d, hk * hd),
        "v": bitlinear.spec(d, hk * hd),
        "o": bitlinear.spec(h * hd, d),
    }


def _ffn_spec(cfg, kind: LayerKind) -> dict:
    """``transformer.py:97-113``: a dense layer of ``mla_moe`` is
    ``dense_ff`` wide, of every other family ``d_ff``."""
    if kind.ffn == "dense":
        return L.mlp_spec(cfg.d_model, cfg.dense_ff if cfg.family == "mla_moe" else cfg.d_ff)
    spec = {"moe": moe_mod.moe_spec(cfg.d_model, cfg.d_ff, cfg.n_experts)}
    if kind.ffn == "moe_shared":
        ff = (cfg.shared_expert_ff or cfg.d_ff) * cfg.n_shared_experts
        spec["shared"] = L.mlp_spec(cfg.d_model, ff)
    if kind.ffn == "moe_dense":
        spec["dense"] = L.mlp_spec(cfg.d_model, cfg.dense_ff or cfg.d_ff)
    return spec


def layer_spec(cfg, kind: LayerKind) -> dict:
    if kind.mixer == "rwkv":
        spec = rwkv_mod.rwkv_spec(cfg)
        return {"ln1": L.rmsnorm_spec(cfg.d_model), "ln2": L.rmsnorm_spec(cfg.d_model),
                "time": spec["time"], "channel": spec["channel"]}
    if kind.mixer == "mamba":
        mixer = {"mamba": mamba_mod.mamba_spec(cfg)}
    else:
        mixer = {"attn": _attn_spec(cfg) if kind.mixer == "attn" else mla_mod.mla_spec(cfg)}
    return {"ln1": L.rmsnorm_spec(cfg.d_model), "ln2": L.rmsnorm_spec(cfg.d_model), **mixer,
            "ffn": _ffn_spec(cfg, kind)}


def _stack(tree, n: int):
    if isinstance(tree, ParamSpec):
        return dataclasses.replace(tree, shape=(n,) + tree.shape)
    return {k: _stack(v, n) for k, v in tree.items()}


# The width of the precomputed embeddings each frontend feeds (transformer.py:149)
FRONTEND_DIMS = {"audio": 128, "vision": 1024}


def param_specs(cfg) -> dict:
    """``transformer.py:152-166``: prelude leaves unstacked, period leaves
    with a leading ``[n_periods]`` axis; with a ``frontend``, its dense
    projection ``frontend/w [FRONTEND_DIMS[frontend], d_model]``, which no
    packing or cast touches (f32 in the serving tree, as in JAX's)."""
    prelude, period, n_periods = block_plan(cfg)
    specs = {}
    if cfg.frontend != "none":
        specs["frontend"] = bitlinear.dense_spec(FRONTEND_DIMS[cfg.frontend], cfg.d_model)
    specs["embed"] = L.embedding_spec(cfg.padded_vocab, cfg.d_model)
    for i, kind in enumerate(prelude):
        specs[f"prelude_{i}"] = layer_spec(cfg, kind)
    specs["blocks"] = {f"b{i}": _stack(layer_spec(cfg, kind), n_periods)
                       for i, kind in enumerate(period)}
    specs["final_norm"] = L.rmsnorm_spec(cfg.d_model)
    specs["lm_head"] = L.lm_head_spec(cfg.d_model, cfg.padded_vocab)
    return specs


def packed_param_specs(cfg) -> dict:
    """The serving tree's ``(shape, dtype)`` leaves (``transformer.py:169-190``):
    every ternary ``{"w" [..., N, K]}`` node becomes ``{"wp": uint8 [..., N/4,
    K], "scale": f32 [...]}``, one scale per stacked matrix; every other
    leaf keeps its f32 shape (before :func:`pack_tree`'s cast of the
    :data:`DENSE_LEAVES`)."""

    def rec(node):
        if isinstance(node, ParamSpec):
            return node.shape, torch.float32
        w = node.get("w")
        if isinstance(w, ParamSpec) and w.quant == "ternary":
            n_in, lead = w.shape[-2], w.shape[:-2]
            if n_in % 4:
                raise ValueError(f"contraction dim {n_in} not packable (need %4==0)")
            return {"wp": (lead + (n_in // 4, w.shape[-1]), torch.uint8),
                    "scale": (lead, torch.float32)}
        return {k: rec(v) for k, v in node.items()}

    return rec(param_specs(cfg))


# Float matrices the serving path casts to the activation dtype. The
# frontend's projection is not one: JAX's packed tree keeps it f32 and
# ``dense_apply`` casts it at each use (bitlinear.py:343-345).
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


def _layers(cfg, params):
    """Every layer in order, the prelude's then the period's: (kind, its
    parameters (views), its place ``(key, period index or None)``)."""
    prelude, period, n_periods = block_plan(cfg)
    for i, kind in enumerate(prelude):
        yield kind, params[f"prelude_{i}"], (f"prelude_{i}", None)
    for p in range(n_periods):
        for i, kind in enumerate(period):
            yield kind, layer_slice(params["blocks"][f"b{i}"], p), (f"b{i}", p)


def _cache_at(caches, place) -> dict:
    """A layer's cache leaves (views into the stacked leaves) at its place."""
    key, p = place
    if p is None:
        return caches[key]
    return {n: leaf[p] for n, leaf in caches["blocks"][key].items()}


# The projections of a dense block, by (sub-block, name).
PROJECTIONS = (("attn", "q"), ("attn", "k"), ("attn", "v"), ("attn", "o"),
               ("ffn", "gate"), ("ffn", "down"))


_FIXED = {e: {name: e for _, name in PROJECTIONS} for e in ("tl", "packed")}


def block_engines(bp, rows: int, engine: str) -> dict:
    """The matmul engine of each projection of one dense block over ``rows``
    rows (``transformer.py:428-445``), resolved once per block: a forced or
    pinned engine is every projection's; ``"auto"`` asks each node."""
    if engine in _FIXED:
        return _FIXED[engine]
    return {name: bitlinear.resolve_engine(bp[sub][name], rows, engine=engine)
            for sub, name in PROJECTIONS}


def _apply_attn(bp, x, xq, cfg, rope, *, kernels, kind: LayerKind | None = None,
                engines=None, cache=None, pos=None, prefix_limit=0, page_table=None,
                page_rows=None, residual: bool = True):
    """Attention sub-block on the int8 row ``xq`` (the prologue's pair, or
    its triple with TL tables), with the sliding window of a local ``kind``
    (None: a global layer) and ``cfg``'s attention softcap in every form;
    ``engines`` maps q, k, v and o to their
    matmul engine (:func:`block_engines`; alone, each resolves
    ``cfg.matmul_engine``). Returns (x + attn(x), the
    cache rows of this call); with ``residual=False`` (the unfused block),
    attn(x) alone, x then only giving the shape and dtype. ``cache`` is this layer's cache leaves
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
    # transformer.py:226: the local layers' window, every layer's softcap
    mask = {"window": cfg.sliding_window if kind is not None and kind.local else 0,
            "softcap": cfg.attn_logit_softcap}

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
        out = attn_ops.prefill_attention(q, k, v, kernels=kernels, **mask)
    elif s > 1 and page_table is not None:  # a chunk, through the page table
        out = attn_ops.prefill_append_attention_paged(
            q, k, v, cache["k"], cache["v"], page_table, pos, kernels=kernels,
            k_scale=cache.get("k_scale"), v_scale=cache.get("v_scale"),
            prefix_limit=prefix_limit, **mask)
    elif s > 1:  # a prefill chunk against the cache prefix
        out = attn_ops.prefill_append_attention(
            q, k, v, cache["k"], cache["v"], pos, kernels=kernels,
            k_scale=cache.get("k_scale"), v_scale=cache.get("v_scale"),
            prefix_limit=prefix_limit, **mask)
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
            k_scale=cache.get("k_scale"), v_scale=cache.get("v_scale"), **mask)[:, :, None]
    else:
        if "k_scale" in cache:
            attn_ops.update_kv_cache_quant(cache["k"], cache["v"], cache["k_scale"],
                                           cache["v_scale"], k[:, :, 0], v[:, :, 0], pos)
        else:
            attn_ops.update_kv_cache(cache["k"], cache["v"], k[:, :, 0], v[:, :, 0], pos)
        out = attn_ops.decode_attention(
            q[:, :, 0], cache["k"], cache["v"], pos, kernels=kernels,
            k_scale=cache.get("k_scale"), v_scale=cache.get("v_scale"), **mask)[:, :, None]
    out = out.transpose(1, 2).reshape(b, s, h * hd)
    x = bitlinear.apply(bp["o"], out, kernels=kernels, out_dtype=x.dtype,
                        residual=x if residual else None, engine=engines["o"])
    return x, new


def _apply_ffn(fp, x, cfg, kind: LayerKind, *, kernels) -> torch.Tensor:
    """The unfused FFN (``transformer.py:356-371``) on the normed row: the
    SwiGLU MLP, or the routed experts (``group_size`` 1024, the serving
    path's) with the shared or the dense MLP added in x's dtype."""
    if kind.ffn == "dense":
        return L.mlp(fp, x, kernels=kernels)
    out, _ = moe_mod.moe_ffn(fp["moe"], x, top_k=cfg.experts_per_tok, kernels=kernels,
                             capacity_factor=cfg.capacity_factor)
    if kind.ffn == "moe_shared":
        out = out + L.mlp(fp["shared"], x, kernels=kernels)
    if kind.ffn == "moe_dense":
        out = out + L.mlp(fp["dense"], x, kernels=kernels)
    return out


def _apply_unfused(kind: LayerKind, bp, x, cfg, rope, *, kernels, cache=None, pos=None,
                   prefix_limit=0, page_table=None, page_rows=None):
    """``transformer.py:449-475``. Returns (x, the cache rows of a one-shot
    prefill or None). A Mamba mixer prefills from a zero state when
    ``cache`` is None, else takes one decode token and updates its state
    leaves in place (``transformer.py:462-466``)."""
    h = L.rmsnorm(bp["ln1"], x, eps=cfg.norm_eps)
    if cache is not None and x.shape[1] > 1 and kind.mixer != "attn":
        raise NotImplementedError(_chunk_refusal(kind.mixer))
    if kind.mixer == "attn":
        y, new = _apply_attn(bp["attn"], h, ternary.quantize_act(h), cfg, rope["attn"],
                             kernels=kernels, kind=kind, engines=dict.fromkeys("qkvo", "auto"),
                             cache=cache, pos=pos, prefix_limit=prefix_limit,
                             page_table=page_table, page_rows=page_rows, residual=False)
    elif kind.mixer == "mamba" and cache is None:
        y, new = mamba_mod.mamba_prefill(bp["mamba"], h, cfg, kernels=kernels)
    elif kind.mixer == "mamba":
        y, new = mamba_mod.mamba_decode(bp["mamba"], h, cfg, cache, kernels=kernels), None
    elif cache is None:
        y, new = mla_mod.mla_prefill(bp["attn"], h, cfg, rope["mla"], kernels=kernels)
    else:
        y, new = mla_mod.mla_decode(bp["attn"], h, cfg, cache, pos, rope["mla"],
                                    kernels=kernels), None
    x = x + y
    h2 = L.rmsnorm(bp["ln2"], x, eps=cfg.norm_eps)
    return x + _apply_ffn(bp["ffn"], h2, cfg, kind, kernels=kernels), new


def apply_block(kind: LayerKind, bp, x, cfg, rope, *, kernels, cache=None, pos=None,
                prefix_limit=0, page_table=None, page_rows=None, fused=None):
    """One layer of kind ``kind`` (``transformer.py:374-475``); ``rope`` is
    :func:`rope_for`'s per-mixer tables. An attention block with a dense
    FFN, local or global, takes the fused int8-resident branch
    (``transformer.py:422-447``) unless ``fused`` is False; every other
    kind the unfused one; an RWKV block its own. Returns (x, the cache rows
    of a one-shot prefill or None)."""
    if kind.mixer == "rwkv":
        return apply_rwkv_block(bp, x, cfg, kernels=kernels, state=cache)
    if fused is False or not (kind.mixer == "attn" and kind.ffn == "dense"):
        return _apply_unfused(kind, bp, x, cfg, rope, kernels=kernels, cache=cache, pos=pos,
                              prefix_limit=prefix_limit, page_table=page_table,
                              page_rows=page_rows)
    engines = block_engines(bp, x.shape[0] * x.shape[1], cfg.matmul_engine)
    hq = L.norm_quant(bp["ln1"], x, kernels=kernels, eps=cfg.norm_eps,
                      tables=engines["q"] == "tl")
    x, kv = _apply_attn(bp["attn"], x, hq, cfg, rope["attn"], kernels=kernels, kind=kind,
                        engines=engines, cache=cache, pos=pos, prefix_limit=prefix_limit,
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


def rope_for(cfg, positions) -> dict:
    """The step's RoPE tables, shared by every layer, per mixer
    (``transformer.py:483-495``): ``attn`` at ``head_dim``, ``mla`` at
    ``qk_rope_head_dim``."""
    prelude, period, _ = block_plan(cfg)
    mixers = {k.mixer for k in prelude + period}
    tables = {}
    if "attn" in mixers:
        tables["attn"] = L.rope_tables(positions, cfg.head_dim, theta=cfg.rope_theta)
    if "mla" in mixers:
        tables["mla"] = L.rope_tables(positions, cfg.qk_rope_head_dim, theta=cfg.rope_theta)
    return tables


def embed_inputs(params, inputs, cfg) -> torch.Tensor:
    """The first residual row ``[B, S, d]`` in ``cfg.dtype``
    (``transformer.py:498-503``). ``inputs`` is a token tensor ``[B, S]``
    or JAX's batch dict: ``{"tokens": [B, S]}``, or, for a config with a
    ``frontend``, ``{"embeddings": [B, S, FRONTEND_DIMS[frontend]]}``,
    projected by ``params["frontend"]`` after a cast to ``cfg.dtype``.
    Tokens go through the embedding table, on every config."""
    if not isinstance(inputs, dict):
        inputs = {"tokens": inputs}
    if cfg.frontend != "none" and "embeddings" in inputs:
        return bitlinear.dense_apply(params["frontend"], inputs["embeddings"].to(cfg.dtype))
    return L.embed(params["embed"], inputs["tokens"], dtype=cfg.dtype)


def _head(params, x, cfg):
    x = L.rmsnorm(params["final_norm"], x, eps=cfg.norm_eps)
    return L.lm_head(params["lm_head"], x, softcap=cfg.final_logit_softcap)


def forward(params, inputs, cfg, *, kernels, collect_cache: bool = False, fused=None):
    """Full-sequence pass over ``inputs``: tokens ``[B, S]`` or a batch
    dict (:func:`embed_inputs`). Returns (logits [B, S, V] f32, caches |
    None) with caches of :func:`cache_specs` layout at length S.
    ``fused=False`` runs dense blocks through the unfused branch."""
    x = embed_inputs(params, inputs, cfg)
    b, s = x.shape[:2]
    caches = cache_zeros(cfg, b, s, x.device) if collect_cache else None
    positions = torch.arange(s, dtype=torch.int32, device=x.device)[None].expand(b, s)
    rope = rope_for(cfg, positions)
    for kind, bp, place in _layers(cfg, params):
        x, new = apply_block(kind, bp, x, cfg, rope, kernels=kernels, fused=fused)
        if collect_cache:
            leaves = _cache_at(caches, place)
            for n, rows in new.items():
                leaves[n].copy_(rows)
    return _head(params, x, cfg), caches


# JAX's apply_block refuses both for a non-attention mixer (transformer.py:389-392,
# 417-421): a chunk against MLA's latent cache or a Mamba state, and a page table
_MIXER_STATE = {"mla": ("an MLA latent cache", "MLA"), "mamba": ("a Mamba state", "Mamba")}


def _chunk_refusal(mixer: str) -> str:
    return (f"a multi-token step against {_MIXER_STATE[mixer][0]} is refused, as JAX's "
            "apply_block refuses it (transformer.py:417-421); the family prefills whole "
            "(ServingEngine prefill='legacy')")


def _refused_mixer(cfg) -> str | None:
    """A mixer of ``cfg`` with a cache that JAX's apply_block takes no chunk
    and no page table against (MLA, Mamba), or None."""
    prelude, period, _ = block_plan(cfg)
    return next((k.mixer for k in prelude + period if k.mixer in _MIXER_STATE), None)


def legacy_only_reason(cfg) -> str | None:
    """Why JAX's apply_block takes neither a chunk nor a page table for a
    mixer of ``cfg`` (MLA, Mamba), or None."""
    mixer = _refused_mixer(cfg)
    if mixer is None:
        return None
    what, name = _MIXER_STATE[mixer]
    return (f"JAX's apply_block refuses a chunk against {what} and a page table for the "
            f"{name} mixer (transformer.py:389-392, 417-421)")


def _refuse_paged(cfg):
    if cfg.family == "ssm":
        raise NotImplementedError("the paged layout pages attention K/V; the ssm family "
                                  "has none")
    mixer = _refused_mixer(cfg)
    if mixer is not None:
        raise NotImplementedError(
            "the paged layout pages attention K/V only, as JAX's apply_block refuses a page "
            f"table for the {_MIXER_STATE[mixer][1]} mixer (transformer.py:389-392)")


def decode_step(params, inputs, caches, pos: torch.Tensor, cfg, *, kernels,
                page_table=None, fused=None):
    """One autoregressive step: ``inputs`` tokens ``[B, 1]`` (or a batch
    dict of one row, :func:`embed_inputs`) at per-slot positions
    ``pos [B]`` int32. Writes each layer's new K/V (MLA: latent row) into
    ``caches`` in place and returns (logits [B, V], caches). ``page_table
    [B, NB]`` int32 makes ``caches`` page pools (:func:`cache_specs` with
    ``kv_pages``, the dense and moe families). The ssm family advances its state
    leaves in place and reads no position."""
    x = embed_inputs(params, inputs, cfg)
    page_rows = None
    if page_table is not None:  # the frontier rows' pool addresses, shared by all layers
        _refuse_paged(cfg)
        page_rows = kv_page_rows(page_table, pos, caches["blocks"]["b0"]["k"].shape[3])
    rope = rope_for(cfg, pos[:, None])
    for kind, bp, place in _layers(cfg, params):
        x, _ = apply_block(kind, bp, x, cfg, rope, kernels=kernels,
                           cache=_cache_at(caches, place), pos=pos, page_table=page_table,
                           page_rows=page_rows, fused=fused)
    return _head(params, x, cfg)[:, 0], caches


def prefill_chunk_step(params, inputs, caches, offset: torch.Tensor, cfg, *, kernels,
                       last_row=None, prefix_limit: int = 0, page_table=None, fused=None):
    """One chunked-prefill step (``transformer.py:608-666``): ``inputs``
    tokens ``[B, C]`` (or a batch dict, :func:`embed_inputs`) at positions
    ``offset[b] + [0, C)`` (``offset [B]`` int32, any offset with ``offset
    + C`` within the cache) attend to each slot's cache prefix and to
    themselves, and every layer appends the chunk's K/V into ``caches`` in place. Offsets
    at or past ``prefix_limit > 0`` are write-only. Returns (logits, caches):
    logits [B, C, V], or with ``last_row [B]`` only each slot's row, gathered
    before the final norm and the LM head, [B, V]. ``page_table`` as in
    :func:`decode_step`. Every family whose layers are all attention
    mixers (dense, moe): an RWKV chunk against an existing state, and a
    chunk against an MLA latent cache or a Mamba state (JAX's
    ``transformer.py:417-421``), raise ``NotImplementedError``."""
    mixer = _refused_mixer(cfg)
    if mixer is not None:
        raise NotImplementedError(_chunk_refusal(mixer))
    prelude, period, _ = block_plan(cfg)
    if {k.mixer for k in prelude + period} != {"attn"}:
        raise NotImplementedError(
            f"prefill_chunk_step needs attention mixers; the {cfg.family!r} family is "
            "prefilled whole (ServingEngine prefill='legacy')")
    x = embed_inputs(params, inputs, cfg)
    b, c = x.shape[:2]
    positions = offset.to(torch.int32)[:, None] + torch.arange(
        c, dtype=torch.int32, device=x.device)[None, :]
    rope = rope_for(cfg, positions)
    for kind, bp, place in _layers(cfg, params):
        x, _ = apply_block(kind, bp, x, cfg, rope, kernels=kernels,
                           cache=_cache_at(caches, place), pos=offset,
                           prefix_limit=prefix_limit, page_table=page_table, fused=fused)
    if last_row is not None:
        idx = last_row.to(torch.int64)[:, None, None].expand(b, 1, x.shape[-1])
        return _head(params, x.gather(1, idx), cfg)[:, 0], caches
    return _head(params, x, cfg), caches


def verify_chunk_step(params, inputs, caches, offset: torch.Tensor, cfg, *, kernels,
                      prefix_limit: int = 0, page_table=None, fused=None):
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
    return prefill_chunk_step(params, inputs, caches, offset, cfg, kernels=kernels,
                              prefix_limit=prefix_limit, page_table=page_table, fused=fused)


def _kind_cache_spec(cfg, kind: LayerKind, batch: int, seq: int, kv_pages) -> dict:
    """One layer's cache leaves ``{name: (shape, dtype)}``, unstacked
    (``transformer.py:711-790``)."""
    if kind.mixer == "rwkv":
        n, d = cfg.rwkv_head_dim, cfg.d_model
        carry = ((batch, 1, d), cfg.dtype)
        return {"wkv": ((batch, d // n, n, n), torch.float32), "x_time": carry,
                "x_chan": carry}
    if kind.mixer == "mla":
        return {"c_kv": ((batch, seq, cfg.kv_lora_rank), cfg.dtype),
                "k_rope": ((batch, seq, cfg.qk_rope_head_dim), cfg.dtype)}
    if kind.mixer == "mamba":  # transformer.py:771-777
        di, ds, _ = mamba_mod.dims(cfg)
        return {"ssm": ((batch, di, ds), torch.float32),
                "conv": ((batch, cfg.mamba_d_conv - 1, di), cfg.dtype)}
    if kv_pages is not None:
        shape = (kv_pages, cfg.n_kv_heads, cfg.kv_page_size, cfg.head_dim)
    else:
        shape = (batch, cfg.n_kv_heads, seq, cfg.head_dim)
    if cfg.kv_cache_dtype == "int8":
        scales = (shape[:-1], torch.float32)
        return {"k": (shape, torch.int8), "k_scale": scales,
                "v": (shape, torch.int8), "v_scale": scales}
    return {"k": (shape, cfg.dtype), "v": (shape, cfg.dtype)}


def cache_specs(cfg, batch: int, seq: int, *, kv_pages: int | None = None) -> dict:
    """Shape and dtype of every cache leaf (``transformer.py:793-834``):
    ``{"prelude_{i}": {...}, "blocks": {"b{i}": {...}}}``, period leaves
    stacked ``[n_periods, ...]``. An attention layer's k/v are [B, HK, seq,
    D] in ``cfg.dtype``; with ``cfg.kv_cache_dtype == "int8"``, k/v int8 and
    ``k_scale``/``v_scale`` [B, HK, seq] f32 row scales. An MLA layer's are
    ``c_kv [B, seq, R]`` and ``k_rope [B, seq, rope]`` in ``cfg.dtype``
    under either cache dtype; a Mamba layer's ``ssm [B, d_inner, d_state]``
    f32 and ``conv [B, d_conv - 1, d_inner]`` in ``cfg.dtype``, with no
    sequence axis. ``kv_pages`` switches the dense and moe families to the
    paged layout (``transformer.py:711-741``): one pool shared by every
    slot, k/v [L, kv_pages, HK, cfg.kv_page_size, D] (and scales [L,
    kv_pages, HK, cfg.kv_page_size]); ``batch`` and ``seq`` then go unused.
    It is an explicit opt-in: only the engine pages. The ssm family's leaves
    are its recurrent state, with no sequence axis (``transformer.py:779-789``):
    ``wkv [L, batch, H, n, n]`` f32 and ``x_time``, ``x_chan [L, batch, 1,
    d]`` in ``cfg.dtype``; ``seq`` goes unused."""
    if cfg.kv_cache_dtype not in ("bf16", "int8"):
        raise ValueError(f"kv_cache_dtype must be 'bf16' or 'int8', got "
                         f"{cfg.kv_cache_dtype!r}")
    if kv_pages is not None:
        _refuse_paged(cfg)
    prelude, period, n_periods = block_plan(cfg)
    out = {f"prelude_{i}": _kind_cache_spec(cfg, kind, batch, seq, kv_pages)
           for i, kind in enumerate(prelude)}
    out["blocks"] = {
        f"b{i}": {n: ((n_periods,) + shape, dt) for n, (shape, dt) in
                  _kind_cache_spec(cfg, kind, batch, seq, kv_pages).items()}
        for i, kind in enumerate(period)}
    return out


def cache_layout(cfg) -> dict:
    """Every leaf of a contiguous cache tree: ``{path: (batch axis, sequence
    axis or None)}``, ``path`` the tuple of keys. Period leaves: attention
    k/v and scales (1, 3), MLA latents (1, 2), Mamba and RWKV state (1, None);
    prelude leaves have no layer axis, so one less (MLA: (0, 1)). JAX keys
    the same choice on the ``act_kv_seq`` axis name (``engine.py:158-197``)."""
    prelude, period, _ = block_plan(cfg)
    seq_axis = {"attn": 2, "mla": 1, "mamba": None, "rwkv": None}
    out = {}
    for kinds, key, stacked in ((prelude, "prelude_{}", 0), (period, "blocks/b{}", 1)):
        for i, kind in enumerate(kinds):
            s = seq_axis[kind.mixer]
            for name in _kind_cache_spec(cfg, kind, 1, 1, None):
                path = tuple(key.format(i).split("/")) + (name,)
                out[path] = (stacked, None if s is None else s + stacked)
    return out


def tree_leaves(tree, path: tuple = ()):
    """(path, leaf) of every leaf of a nested dict, in order."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from tree_leaves(v, path + (k,))
    else:
        yield path, tree


def tree_get(tree, path: tuple):
    for k in path:
        tree = tree[k]
    return tree


def tree_set(tree: dict, path: tuple, value) -> None:
    """Set the leaf at ``path``, making the dicts on the way."""
    for k in path[:-1]:
        tree = tree.setdefault(k, {})
    tree[path[-1]] = value


def cache_zeros(cfg, batch: int, seq: int, device, *, kv_pages: int | None = None) -> dict:
    def rec(node):
        if isinstance(node, dict):
            return {k: rec(v) for k, v in node.items()}
        shape, dt = node
        return torch.zeros(shape, dtype=dt, device=device)

    return rec(cache_specs(cfg, batch, seq, kv_pages=kv_pages))
