"""The Mamba selective-SSM mixer of the hybrid family (``repro/models/mamba.py``).

The in, x and out projections are ternary BitLinear on the kernel set; the
depthwise causal conv, ``dt_proj`` (a float product outside any Pallas
kernel in JAX too), the decay and the state update are plain torch, as they
are XLA in JAX (``mamba.py:42-158``). Every rounding point keeps JAX's
form: the projections, the conv, ``dt``, ``y + u · d_skip`` and ``· silu(z)``
in the activation dtype; ``exp(dt · A)``, the state and the read-out ``y =
h · C`` in f32. The prefill's conv adds its taps one by one, the decode's
is one reduction (``mamba.py:65-70, 140``).

The prefill runs the recurrence ``h_t = exp(dt_t A) h_{t-1} + (dt_t u_t) B_t``
as a parallel scan in f32, never a loop over tokens and never a division
by a cumulative decay. Rows go in blocks of at most :data:`SCAN_BLOCK_BYTES`
of state ``[B, rows, d_inner, d_state]``; a block splits into chunks of
:data:`SCAN_CHUNK` rows, each scanned by doubling (``log2`` steps of
``(a, b) ∘ (a', b') = (a a', b a' + b')``, every factor a decay in (0, 1]),
then the chunks' end states compose by a second doubling scan, and the
state carried into each chunk enters as ``A_t · h_start`` with ``A_t`` the
chunk's product of decays. The association order and the chunking differ
from JAX's (an associative scan inside chunks of up to 256 rows, halved
until they divide the length, carried by ``lax.scan``), so the prefill
agrees with JAX's to f32 rounding, not bit for bit.

The state of a layer is ``{"ssm" [B, d_inner, d_state] f32, "conv" [B,
d_conv - 1, d_inner]}``, the last ``d_conv - 1`` inputs of the conv (left
padded with zeros after a prompt shorter than that), with no sequence axis.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .. import _common as C
from ..core import bitlinear
from ..core.params import ParamSpec
from ..kernels.ternary_matmul.ref import silu

SCAN_CHUNK = 16  # rows of one doubling scan; the chunks' states compose by a second one
SCAN_BLOCK_BYTES = 1 << 29  # f32 state [B, rows, d_inner, d_state] of one block of rows


def dims(cfg) -> tuple[int, int, int]:
    """(d_inner, d_state, dt_rank) (``mamba.py:25-28``)."""
    return cfg.mamba_expand * cfg.d_model, cfg.mamba_d_state, max(cfg.d_model // 16, 8)


def mamba_spec(cfg) -> dict:
    """``mamba.py:24-39``. ``dt_proj.b`` declares ``init="ones"`` with a
    scale of -4.6, which JAX's ``"ones"`` ignores (``params.py:73-86``): the
    bias is 1.0 there and here."""
    d = cfg.d_model
    di, ds, dt_rank = dims(cfg)
    return {
        "in_proj": bitlinear.spec(d, 2 * di),
        "conv_w": ParamSpec((cfg.mamba_d_conv, di), scale=0.5),
        "conv_b": ParamSpec((di,), init="zeros"),
        "x_proj": bitlinear.spec(di, dt_rank + 2 * ds),
        "dt_proj": {"w": ParamSpec((dt_rank, di)),
                    "b": ParamSpec((di,), init="ones", scale=-4.6)},
        "a_log": ParamSpec((di, ds), init="ones"),
        "d_skip": ParamSpec((di,), init="ones"),
        "out_proj": bitlinear.spec(di, d),
    }


def softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``, JAX's ``logaddexp(x, 0)``: ``max(x, 0) +
    log1p(exp(-|x|))`` in x's dtype."""
    return torch.clamp_min(x, 0) + torch.log1p(torch.exp(-x.abs()))


def _dt_bc(p, xdbc, dtype, ds: int):
    """(dt, B, C) from x_proj's output (``mamba.py:54-59``): ``dt =
    softplus(xdbc[:r] · dt_proj.w + dt_proj.b)`` in ``dtype``."""
    r = p["dt_proj"]["w"].shape[0]
    dt = softplus(torch.matmul(xdbc[..., :r], p["dt_proj"]["w"].to(dtype))
                  + p["dt_proj"]["b"].to(dtype))
    return dt, xdbc[..., r:r + ds], xdbc[..., r + ds:]


def causal_conv(u: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv over the sequence, ``u [B, S, D]``, ``w [K, D]``:
    the taps added one by one in u's dtype (``mamba.py:63-70``)."""
    k, s = w.shape[0], u.shape[1]
    padded = F.pad(u, (0, 0, k - 1, 0))
    out = torch.zeros_like(u)
    for i in range(k):
        out = out + padded[:, i:i + s] * w[i].to(u.dtype)
    return out + b.to(u.dtype)


def _doubling_scan(a: torch.Tensor, b: torch.Tensor, dim: int):
    """Inclusive scan of ``h_t = a_t h_{t-1} + b_t`` from ``h = 0`` along
    ``dim``: returns (the products of ``a`` up to t, ``h_t``)."""
    n, k = a.shape[dim], 1
    while k < n:
        lo_a, hi_a = a.narrow(dim, 0, n - k), a.narrow(dim, k, n - k)
        nb = b.clone()
        nb.narrow(dim, k, n - k).addcmul_(hi_a, b.narrow(dim, 0, n - k))
        na = a.clone()
        na.narrow(dim, k, n - k).mul_(lo_a)
        a, b, k = na, nb, 2 * k
    return a, b


def selective_scan(dt, u, bmat, cmat, a, h0, *, block_rows: int | None = None):
    """The state recurrence over ``dt, u [B, S, di]``, ``bmat, cmat [B, S,
    ds]`` from ``h0 [B, di, ds]`` with ``a [di, ds]`` (negative), in f32:
    returns (``y [B, S, di]`` f32, the final state). ``block_rows``
    overrides the rows a block of :data:`SCAN_BLOCK_BYTES` holds."""
    b, s, di = u.shape
    ds = a.shape[1]
    c = SCAN_CHUNK
    if block_rows is None:
        block_rows = SCAN_BLOCK_BYTES // (b * di * ds * 4)
    block_rows = max(c, block_rows // c * c)
    ys, h = [], h0
    for start in range(0, s, block_rows):
        n = min(block_rows, s - start)
        rows = slice(start, start + n)
        decay = torch.exp(dt[:, rows].float()[..., None] * a)  # [B, n, di, ds]
        bx = (dt[:, rows] * u[:, rows]).float()[..., None] * bmat[:, rows].float()[:, :, None]
        pad = -n % c  # identity rows past the end: decay 1, input 0
        decay = F.pad(decay, (0, 0, 0, 0, 0, pad), value=1.0)
        bx = F.pad(bx, (0, 0, 0, 0, 0, pad))
        nc = (n + pad) // c
        prod, hs = _doubling_scan(decay.view(b, nc, c, di, ds), bx.view(b, nc, c, di, ds), 2)
        del decay, bx
        # each chunk's end, composed over the chunks before it, from h
        end_a, end_h = _doubling_scan(prod[:, :, -1], hs[:, :, -1], 1)
        ends = end_h + end_a * h[:, None]
        starts = torch.cat([h[:, None], ends[:, :-1]], dim=1)
        hs = (hs + prod * starts[:, :, None]).view(b, nc * c, di, ds)[:, :n]
        del prod
        ys.append(torch.einsum("bsdn,bsn->bsd", hs, cmat[:, rows].float()))
        h = hs[:, -1].clone()
    return torch.cat(ys, dim=1), h


def mamba_prefill(p, x, cfg, *, kernels):
    """``x [B, S, d]`` from a zero state (``mamba.py:85-126``): returns
    (``y [B, S, d]``, ``{"ssm" [B, di, ds] f32, "conv" [B, K - 1, di]}``)."""
    b, s, _ = x.shape
    di, ds, _ = dims(cfg)
    k = cfg.mamba_d_conv
    xz = bitlinear.apply(p["in_proj"], x, kernels=kernels)
    u_raw, z = xz[..., :di], xz[..., di:]
    u = silu(causal_conv(u_raw, p["conv_w"], p["conv_b"]))
    dt, bmat, cmat = _dt_bc(p, bitlinear.apply(p["x_proj"], u, kernels=kernels), x.dtype, ds)
    a = -torch.exp(p["a_log"].to(torch.float32))
    h0 = torch.zeros((b, di, ds), dtype=torch.float32, device=x.device)
    y, h = selective_scan(dt, u, bmat, cmat, a, h0)
    y = y.to(x.dtype)
    y = y + u * p["d_skip"].to(x.dtype)
    y = y * silu(z)
    out = bitlinear.apply(p["out_proj"], y, kernels=kernels)
    tail = u_raw[:, s - (k - 1):] if s >= k - 1 else F.pad(u_raw, (0, 0, k - 1 - s, 0))
    return out, {"ssm": h, "conv": tail}


def mamba_decode(p, x, cfg, state, *, kernels):
    """One token ``x [B, 1, d]`` (``mamba.py:129-158``): updates this layer's
    state leaves ``state`` (views) in place and returns ``y [B, 1, d]``."""
    di, ds, _ = dims(cfg)
    xz = bitlinear.apply(p["in_proj"], x, kernels=kernels)
    u, z = xz[..., :di], xz[..., di:]
    conv_in = torch.cat([state["conv"], u], dim=1)  # [B, K, di]
    u = (conv_in * p["conv_w"].to(u.dtype)[None]).sum(dim=1, keepdim=True)
    u = silu(u + p["conv_b"].to(u.dtype))
    dt, bmat, cmat = _dt_bc(p, bitlinear.apply(p["x_proj"], u, kernels=kernels), x.dtype, ds)
    a = -torch.exp(p["a_log"].to(torch.float32))
    decay = torch.exp(dt[:, 0].to(torch.float32)[..., None] * a)  # [B, di, ds]
    h = state["ssm"] * decay + ((dt[:, 0] * u[:, 0]).to(torch.float32)[..., None]
                                * bmat[:, 0].to(torch.float32)[:, None, :])
    y = torch.einsum("bds,bs->bd", h, cmat[:, 0].to(torch.float32))[:, None].to(x.dtype)
    y = y + u * p["d_skip"].to(x.dtype)
    y = y * silu(z)
    out = bitlinear.apply(p["out_proj"], y, kernels=kernels)
    state["ssm"].copy_(h)
    state["conv"].copy_(conv_in[:, 1:])
    return out


def mamba_init_state(cfg, batch: int, device=None) -> dict:
    """A zero state (``mamba.py:161-166``): ``ssm`` f32, ``conv`` bf16, on
    the CUDA device unless ``device`` names another."""
    di, ds, _ = dims(cfg)
    dev = C.resolve_device(device)
    return {"ssm": torch.zeros((batch, di, ds), dtype=torch.float32, device=dev),
            "conv": torch.zeros((batch, cfg.mamba_d_conv - 1, di), dtype=torch.bfloat16,
                                device=dev)}
