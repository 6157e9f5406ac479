"""Token-choice top-k Mixture-of-Experts on the packed serving path
(``repro/models/moe.py:24-168``).

Tokens are grouped as JAX groups them (``g = min(group_size, tokens)``,
halved until it divides the token count), each group routes its tokens by
an f32 softmax over the router logits and takes the top ``k`` experts,
whose gates are renormalized (floor ``1e-9``). Every (token, choice) takes
the next free slot of its expert's queue in the token-major, then-choice
order of JAX's cumsum (``moe.py:131-136``); an expert holds ``cap =
max(int(g · k · capacity_factor / E), 4)`` slots a group, and the choices
past it are dropped.

Dispatch and combine are index writes and gathers where JAX contracts dense
one-hot tensors. Dispatch is exact either way: each (expert, group, slot)
receives at most one token, times 1.0. Combine is the f32 sum of at most
``k`` gated expert rows per token, whose order may differ from XLA's
contraction by an ulp. Dropped choices write to a spare slot past ``cap``
that no expert reads, so the routing never leaves the device.

The experts run on the kernel set: the slot rows ``[E, groups · cap, d]``
are quantized once (per row, ``quantize_act``), then each expert's gate, up
and down projections are one ``ternary_gemv`` launch each (the GEMV up to
16 rows, the tiled matmul above). JAX runs the stacked expert weights
through its XLA form (``bitlinear.py:164``); the int32 sums and the
``(acc · x_scale) · w_scale`` epilogue are the same, so the expert outputs
are too.
"""

from __future__ import annotations

import torch

from ..core import ternary
from ..core.params import ParamSpec
from ..kernels.ternary_matmul.ref import silu


def moe_spec(dim: int, hidden: int, n_experts: int) -> dict:
    """The f32 router ``[d, E]`` and the stacked ternary expert weights."""
    return {
        "router": {"w": ParamSpec((dim, n_experts))},
        "gate": {"w": ParamSpec((n_experts, dim, hidden), quant="ternary")},
        "up": {"w": ParamSpec((n_experts, dim, hidden), quant="ternary")},
        "down": {"w": ParamSpec((n_experts, hidden, dim), quant="ternary")},
    }


def group_shape(tokens: int, group_size: int, top_k: int, capacity_factor: float,
                n_experts: int) -> tuple[int, int, int]:
    """(groups, tokens per group, capacity per expert and group), as JAX
    sizes them (``moe.py:103-109``)."""
    g = min(group_size, tokens)
    while tokens % g:
        g //= 2
    cap = max(int(g * top_k * capacity_factor / n_experts), 4)
    return tokens // g, g, cap


def route(params: dict, xt: torch.Tensor, *, top_k: int, cap: int) -> dict:
    """The routing of grouped tokens ``xt [N, g, d]``: router ``probs [N, g,
    E]`` f32, the chosen experts ``idx [N, g, k]``, their renormalized
    ``gates`` f32, each choice's ``slot`` in its expert's queue and ``keep``
    (slot < cap)."""
    n, g, _ = xt.shape
    w = params["router"]["w"].to(torch.float32)
    probs = torch.softmax(torch.matmul(xt.to(torch.float32), w), dim=-1)
    e = probs.shape[-1]
    gates, idx = torch.topk(probs, top_k, dim=-1)
    gates = gates / torch.clamp(gates.sum(dim=-1, keepdim=True), min=1e-9)
    flat = idx.reshape(n, g * top_k)
    onehot = torch.nn.functional.one_hot(flat, e).to(torch.int32)  # [N, g*k, E]
    slot = (torch.cumsum(onehot, dim=1) - 1).gather(2, flat[..., None])[..., 0]
    slot = slot.reshape(n, g, top_k)
    return {"probs": probs, "idx": idx, "gates": gates, "slot": slot, "keep": slot < cap}


def dispatch(xt: torch.Tensor, r: dict, n_experts: int, cap: int) -> torch.Tensor:
    """Each kept choice's token row into its (expert, group, slot):
    ``[E, N, cap, d]`` in xt's dtype, zeros in the free slots."""
    n, g, d = xt.shape
    k = r["idx"].shape[-1]
    xe = xt.new_zeros((n_experts, n, cap + 1, d))  # slot cap: the dropped choices' spare
    grp = torch.arange(n, device=xt.device)[:, None, None].expand(n, g, k)
    tok = torch.arange(g, device=xt.device)[None, :, None].expand(n, g, k)
    slot = torch.where(r["keep"], r["slot"], torch.full_like(r["slot"], cap))
    xe[r["idx"], grp, slot] = xt[grp, tok]
    return xe[:, :, :cap]


def expert_ffn(params: dict, xe: torch.Tensor, *, kernels) -> torch.Tensor:
    """``xe [E, R, d]`` -> ``[E, R, d]`` in xe's dtype: each expert's SwiGLU
    on its rows, one ``ternary_gemv`` launch per expert and projection."""
    def proj(name, xq):
        # one view per expert, each made by one unbind rather than a Python index
        rows = zip(*(t.unbind(0) for t in (*xq, params[name]["wp"], params[name]["scale"])))
        return torch.stack([kernels.ternary_gemv(a, s, wp, ws, out_dtype=xe.dtype)
                            for a, s, wp, ws in rows])

    xq = ternary.quantize_act(xe)
    h = silu(proj("gate", xq)) * proj("up", xq)
    return proj("down", ternary.quantize_act(h))


def combine(ye: torch.Tensor, r: dict, cap: int) -> torch.Tensor:
    """``ye [E, N, cap, d]`` -> ``[N, g, d]`` f32: each token's kept expert
    rows times their gates, summed over its choices in f32."""
    _, n, _, d = ye.shape
    g, k = r["idx"].shape[1:]
    grp = torch.arange(n, device=ye.device)[:, None, None].expand(n, g, k)
    rows = ye[r["idx"], grp, r["slot"].clamp(max=cap - 1)].to(torch.float32)  # [N, g, k, d]
    w = torch.where(r["keep"], r["gates"], torch.zeros_like(r["gates"]))
    return (rows * w[..., None]).sum(dim=2)


def aux_loss(probs: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Switch-style load-balance loss (``moe.py:154-160``): the fraction of
    tokens routed to each expert times its mean router probability, summed
    over experts, averaged over groups, times E."""
    e = probs.shape[-1]
    onehot = torch.nn.functional.one_hot(idx, e).to(torch.float32)  # [N, g, k, E]
    density = onehot.sum(dim=2).mean(dim=1)
    prob_mass = probs.mean(dim=1)
    return (density * prob_mass).sum(dim=-1).mean() * e


def moe_ffn(params: dict, x: torch.Tensor, *, top_k: int, kernels,
            capacity_factor: float = 1.25, group_size: int = 1024) -> tuple:
    """``x [B, S, d]`` -> (``[B, S, d]`` in x's dtype, the aux loss)."""
    b, s, dim = x.shape
    e = params["router"]["w"].shape[1]
    n, g, cap = group_shape(b * s, group_size, top_k, capacity_factor, e)
    xt = x.reshape(n, g, dim)
    r = route(params, xt, top_k=top_k, cap=cap)
    xe = dispatch(xt, r, e, cap).reshape(e, n * cap, dim)
    ye = expert_ffn(params, xe, kernels=kernels).reshape(e, n, cap, dim)
    out = combine(ye, r, cap)
    return out.reshape(b, s, dim).to(x.dtype), aux_loss(r["probs"], r["idx"])
