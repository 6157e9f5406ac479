"""Multi-head Latent Attention (DeepSeek-V2) on the packed serving path
(``repro/models/mla.py:25-134``).

The KV stream is compressed into a latent ``c_kv [B, M, R]`` (R =
kv_lora_rank, RMS-normed) plus one RoPE key ``k_rope [B, M, rope]`` shared
by every head; the cache holds those two, in the activation dtype. Every
projection is a ternary BitLinear through the kernel set.

* ``mla_prefill`` decompresses K and V per head through ``k_up`` and
  ``v_up`` (which quantize ``c_kv``), joins each head's nope key with the
  shared rope key, and runs the one-shot causal attention with
  ``Dqk = nope + rope`` and ``Dv = v_head_dim`` at ``scale =
  1/sqrt(Dqk)``: the flash-attention kernel at (192, 128) for
  DeepSeek-V2-Lite.
* ``mla_decode`` is weight-absorbed: the float ``k_up``/``v_up`` matrices
  (``bitlinear.material_weight``) fold into the query and the context, so
  the scores contract against the latent directly, then a ``-1e30`` mask
  past each slot's position, the softmax, the latent context and ``v_up``.
  JAX runs these contractions outside any Pallas kernel, so they are plain
  torch here. The new latent row is written in place at ``pos`` (an index
  write where JAX blends a one-hot row, ``mla.py:106-111``: the same values
  for finite rows; a position past the cache writes nothing, as the
  one-hot writes nothing).

As in JAX, prefill quantizes ``c_kv`` before ``k_up``/``v_up`` while decode
absorbs the float weights, so a decode step is not teacher-forced equal to
the prefill at the same position.
"""

from __future__ import annotations

import math

import torch

from ..core import bitlinear, ternary
from . import attention as attn_ops
from . import layers as L


def mla_spec(cfg) -> dict:
    d, h = cfg.d_model, cfg.n_heads
    qk_head = cfg.qk_nope_head_dim + cfg.qk_rope_head_dim
    return {
        "q_proj": bitlinear.spec(d, h * qk_head),
        "kv_down": bitlinear.spec(d, cfg.kv_lora_rank + cfg.qk_rope_head_dim),
        "kv_norm": L.rmsnorm_spec(cfg.kv_lora_rank),
        "k_up": bitlinear.spec(cfg.kv_lora_rank, h * cfg.qk_nope_head_dim),
        "v_up": bitlinear.spec(cfg.kv_lora_rank, h * cfg.v_head_dim),
        "o_proj": bitlinear.spec(h * cfg.v_head_dim, d),
    }


def _project_qkv(params, x, cfg, rope, *, kernels):
    """-> q_nope [B, H, S, nope], q_rope [B, H, S, rope] (rotated), c_kv
    [B, S, R] (normed) and k_rope [B, S, rope] (rotated). q and kv_down
    project the one ``quantize_act(x)``."""
    b, s, _ = x.shape
    h, nope, rdim = cfg.n_heads, cfg.qk_nope_head_dim, cfg.qk_rope_head_dim
    rope_h = (rope[0][:, None], rope[1][:, None])  # broadcast over heads
    xq = ternary.quantize_act(x)
    q = bitlinear.apply(params["q_proj"], xq, kernels=kernels, out_dtype=x.dtype)
    q = q.reshape(b, s, h, nope + rdim)
    q_rope = L.apply_rope_tables(q[..., nope:].transpose(1, 2), rope_h)
    kv = bitlinear.apply(params["kv_down"], xq, kernels=kernels, out_dtype=x.dtype)
    c_kv = L.rmsnorm(params["kv_norm"], kv[..., : cfg.kv_lora_rank], eps=cfg.norm_eps)
    k_rope = L.apply_rope_tables(kv[..., cfg.kv_lora_rank:][:, None], rope_h)
    return q[..., :nope].transpose(1, 2), q_rope, c_kv, k_rope[:, 0]


def _scale(cfg) -> float:
    return 1.0 / math.sqrt(cfg.qk_nope_head_dim + cfg.qk_rope_head_dim)


def mla_prefill(params, x, cfg, rope, *, kernels):
    """``x [B, S, d]`` (normed) -> (attention output [B, S, d], the cache
    rows ``{"c_kv" [B, S, R], "k_rope" [B, S, rope]}``)."""
    b, s, _ = x.shape
    h, nope, rdim = cfg.n_heads, cfg.qk_nope_head_dim, cfg.qk_rope_head_dim
    q_nope, q_rope, c_kv, k_rope = _project_qkv(params, x, cfg, rope, kernels=kernels)
    cq = ternary.quantize_act(c_kv)
    k_nope = bitlinear.apply(params["k_up"], cq, kernels=kernels, out_dtype=x.dtype)
    k_nope = k_nope.reshape(b, s, h, nope).transpose(1, 2)
    v = bitlinear.apply(params["v_up"], cq, kernels=kernels, out_dtype=x.dtype)
    v = v.reshape(b, s, h, cfg.v_head_dim).transpose(1, 2)
    q = torch.cat([q_nope, q_rope], dim=-1)
    k = torch.cat([k_nope, k_rope[:, None].expand(b, h, s, rdim)], dim=-1)
    out = attn_ops.prefill_attention(q, k, v, kernels=kernels, scale=_scale(cfg))
    out = out.transpose(1, 2).reshape(b, s, h * cfg.v_head_dim)
    return (bitlinear.apply(params["o_proj"], out, kernels=kernels),
            {"c_kv": c_kv, "k_rope": k_rope})


def _write_row(cache: torch.Tensor, new: torch.Tensor, pos: torch.Tensor) -> None:
    """Row ``pos[b]`` of each slot's ``cache [B, M, ...]`` becomes ``new
    [B, ...]``, in place; a slot at ``pos >= M`` keeps its rows."""
    m = cache.shape[1]
    slots = torch.arange(cache.shape[0], device=cache.device)
    rows = pos.to(torch.int64).clamp(max=m - 1)
    live = (pos < m).reshape((-1,) + (1,) * (new.dim() - 1))
    cache[slots, rows] = torch.where(live, new.to(cache.dtype), cache[slots, rows])


def mla_decode(params, x, cfg, cache: dict, pos: torch.Tensor, rope, *, kernels):
    """One token per slot, ``x [B, 1, d]`` (normed) at ``pos [B]``, against
    this layer's cache leaves ``{"c_kv" [B, M, R], "k_rope" [B, M, rope]}``
    (views, written in place). Returns the attention output [B, 1, d]."""
    b = x.shape[0]
    h, r = cfg.n_heads, cfg.kv_lora_rank
    q_nope, q_rope, c_new, kr_new = _project_qkv(params, x, cfg, rope, kernels=kernels)
    _write_row(cache["c_kv"], c_new[:, 0], pos)
    _write_row(cache["k_rope"], kr_new[:, 0], pos)
    c_kv, k_rope = cache["c_kv"], cache["k_rope"]
    m = c_kv.shape[1]
    w_kup = bitlinear.material_weight(params["k_up"], dtype=x.dtype)
    w_vup = bitlinear.material_weight(params["v_up"], dtype=x.dtype)
    w_kup = w_kup.reshape(r, h, cfg.qk_nope_head_dim)
    w_vup = w_vup.reshape(r, h, cfg.v_head_dim)
    f32 = torch.float32
    q_abs = torch.einsum("bhn,rhn->bhr", q_nope[:, :, 0], w_kup)  # absorb k_up
    c32 = c_kv.to(f32)
    s = torch.einsum("bhr,bmr->bhm", q_abs.to(f32), c32)
    s = s + torch.einsum("bhn,bmn->bhm", q_rope[:, :, 0].to(f32), k_rope.to(f32))
    s = s * _scale(cfg)
    live = torch.arange(m, device=x.device)[None, :] <= pos[:, None]
    s = torch.where(live[:, None], s, torch.full_like(s, -1e30))
    p = torch.softmax(s, dim=-1)
    ctx = torch.einsum("bhm,bmr->bhr", p, c32).to(x.dtype)
    out = torch.einsum("bhr,rhv->bhv", ctx, w_vup).reshape(b, 1, h * cfg.v_head_dim)
    return bitlinear.apply(params["o_proj"], out, kernels=kernels)
