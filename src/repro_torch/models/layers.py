"""Shared model layers (``repro/models/layers.py:29-175``): RMSNorm, the
fused norm-quant prologue (with or without the TL tables), RoPE, embedding,
LM head, the fused SwiGLU MLP and its unfused form."""

from __future__ import annotations

import torch

from ..core import bitlinear, ternary
from ..core.params import ParamSpec
from ..kernels.ternary_matmul.ref import silu


def rmsnorm_spec(dim: int) -> dict:
    return {"gamma": ParamSpec((dim,), init="ones")}


def rmsnorm(params: dict, x: torch.Tensor, *, eps: float = 1e-5) -> torch.Tensor:
    xf = x.to(torch.float32)
    rms = torch.rsqrt(torch.mean(xf * xf, dim=-1, keepdim=True) + eps)
    return (xf * rms * params["gamma"].to(torch.float32)).to(x.dtype)


def norm_quant(params: dict, x: torch.Tensor, *, kernels, eps: float = 1e-5,
               tables: bool = False) -> tuple:
    """Fused RMSNorm + per-token int8: ``(x_i8 [..., N], x_scale [..., 1])``,
    equal to ``quantize_act(rmsnorm(params, x))``; with ``tables`` also the
    TL engine's tables of the int8 row, ``(x_i8, x_scale, tables)``, the
    first two unchanged."""
    if tables:
        return kernels.norm_quant_tables(x, params["gamma"], eps=eps)
    return kernels.norm_quant(x, params["gamma"], eps=eps)


def rope_tables(positions: torch.Tensor, head_dim: int, *,
                theta: float = 10000.0) -> tuple[torch.Tensor, torch.Tensor]:
    """(cos, sin) [..., S, D/2] in f32 for ``positions [..., S]``."""
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=positions.device) / head_dim
    freqs = 1.0 / (theta ** exps)
    angles = positions[..., None].to(torch.float32) * freqs
    return torch.cos(angles), torch.sin(angles)


def apply_rope_tables(x: torch.Tensor, rope: tuple) -> torch.Tensor:
    """x [..., S, D] rotated by precomputed (cos, sin) [..., S, D/2]."""
    d = x.shape[-1]
    cos, sin = rope
    x1 = x[..., : d // 2].to(torch.float32)
    x2 = x[..., d // 2:].to(torch.float32)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def embedding_spec(vocab: int, dim: int) -> dict:
    return {"table": ParamSpec((vocab, dim), init="embed", scale=0.02)}


def embed(params: dict, tokens: torch.Tensor, dtype=torch.bfloat16) -> torch.Tensor:
    return params["table"][tokens].to(dtype)


def lm_head_spec(dim: int, vocab: int) -> dict:
    return bitlinear.dense_spec(dim, vocab)


def lm_head(params: dict, x: torch.Tensor, *, softcap: float = 0.0) -> torch.Tensor:
    """f32 logits; with ``softcap`` > 0 capped as ``softcap * tanh(logits /
    softcap)`` in f32 (``layers.py:123-126``, gemma2's final softcap)."""
    logits = bitlinear.dense_apply(params, x, out_dtype=torch.float32)
    if softcap > 0:
        logits = softcap * torch.tanh(logits / softcap)
    return logits


def mlp_spec(dim: int, hidden: int) -> dict:
    return {
        "gate": bitlinear.spec(dim, hidden),
        "up": bitlinear.spec(dim, hidden),
        "down": bitlinear.spec(hidden, dim),
    }


def mlp_fused(params: dict, xq: tuple, *, kernels, out_dtype, residual=None,
              engines=None):
    """SwiGLU over the int8 pipeline: fused gate/up/SiLU/requant, then the
    down projection with ``residual`` in its epilogue. ``engines`` maps
    ``"gate"`` and ``"down"`` to their matmul engine (default ``"auto"``)."""
    engines = engines or {}
    hq = bitlinear.swiglu(params["gate"], params["up"], xq, kernels=kernels,
                          act_dtype=out_dtype, engine=engines.get("gate", "auto"))
    return bitlinear.apply(params["down"], hq, kernels=kernels, out_dtype=out_dtype,
                           residual=residual, engine=engines.get("down", "auto"))


def mlp(params: dict, x: torch.Tensor, *, kernels) -> torch.Tensor:
    """The unfused SwiGLU MLP (``layers.py:143-148``) on a float row: gate
    and up each project ``quantize_act(x)`` (quantized once here, the same
    codes JAX's two projections make), ``silu(g) · u`` in x's dtype at the
    SwiGLU's rounding points, then the down projection quantizes its own
    input. Equal to :func:`mlp_fused` of ``quantize_act(x)`` with the plain
    versions: the fused SwiGLU computes the same ops."""
    xq = ternary.quantize_act(x)
    g = bitlinear.apply(params["gate"], xq, kernels=kernels, out_dtype=x.dtype)
    u = bitlinear.apply(params["up"], xq, kernels=kernels, out_dtype=x.dtype)
    return bitlinear.apply(params["down"], silu(g) * u, kernels=kernels)
