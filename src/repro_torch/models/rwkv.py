"""RWKV-6 ("Finch") layer on the packed serving path (``repro/models/rwkv.py``):
attention-free time mixing with a data-dependent decay, and squared-ReLU
channel mixing, every projection a ternary BitLinear.

Per head (size n) the WKV recurrence carries a state S [n_key, n_value]:
``S_t = diag(w_t) S_{t-1} + k_t v_t^T``, ``y_t = r_t (S_{t-1} + diag(u)
k_t v_t^T)``, with ``w_t = exp(-exp(w0 + tanh(x_w W1) W2))``. A prefill runs
the chunked form from a zero state through ``kernels.wkv`` (the CUDA kernel
on the card, B15 of the TPU kernels), where JAX calls ``_wkv_chunked``
(``rwkv.py:171``); a decode step updates the state in plain torch, as JAX
does it in XLA (``rwkv.py:214-218``).

Each step keeps the dtype JAX uses: the lerps, the gate and the
projections' outputs in the activation dtype, the decay and the WKV in
f32, and the per-head group norm in f32 with the population variance
(``jnp.var``, so ``correction=0``). The decay LoRA is an f32 matmul, which
PyTorch runs in full f32 on the card (TF32 is off by default). JAX pads the
heads to a multiple of 16 (``rwkv.py:154-166``) so that the WKV tensors
shard over its 16-way model axis; the padded heads are zero and sliced off,
so the port, which shards nothing, does not pad.
"""

from __future__ import annotations

import torch

from ..core import bitlinear
from ..core.params import ParamSpec

_LORA = 64
_GROUP_NORM_EPS = 64e-5


def rwkv_spec(cfg) -> dict:
    d, n = cfg.d_model, cfg.rwkv_head_dim
    ones, zeros = ParamSpec((d,), init="ones"), ParamSpec((d,), init="zeros")
    return {
        "time": {
            "mix_r": ones, "mix_k": ones, "mix_v": ones, "mix_g": ones, "mix_w": ones,
            "w0": zeros,
            "w1": ParamSpec((d, _LORA), scale=0.01),
            "w2": ParamSpec((_LORA, d), scale=0.01),
            "bonus": ParamSpec((d // n, n), scale=0.1),
            "Wr": bitlinear.spec(d, d),
            "Wk": bitlinear.spec(d, d),
            "Wv": bitlinear.spec(d, d),
            "Wg": bitlinear.spec(d, d),
            "Wo": bitlinear.spec(d, d),
            "ln_w": ones,
            "ln_b": zeros,
        },
        "channel": {
            "mix_k": ones, "mix_r": ones,
            "Wk": bitlinear.spec(d, cfg.d_ff),
            "Wv": bitlinear.spec(cfg.d_ff, d),
            "Wr": bitlinear.spec(d, d),
        },
    }


def _sigmoid(x):
    """``jax.nn.sigmoid`` as XLA expands it: ``1 / (1 + exp(-x))``, rounded
    to x's dtype at each op (``torch.sigmoid`` rounds a bf16 result once,
    and differs from it in a third of bf16 values)."""
    return 1 / (1 + torch.exp(-x))


def _lerp(x, x_prev, mix):
    m = _sigmoid(mix.to(x.dtype))
    return x * m + x_prev * (1 - m)


def _decay(tp, xw):
    """Data-dependent decay, per channel: log w in [-10, -1e-4], f32."""
    f32 = torch.float32
    lora = torch.tanh(torch.matmul(xw.to(f32), tp["w1"].to(f32)))
    logw = -torch.exp(torch.clamp(tp["w0"].to(f32) + torch.matmul(lora, tp["w2"].to(f32)),
                                  -8.0, 4.0))
    return torch.clamp(logw, -10.0, -1e-4)


def _heads(t, h, n):
    """[B, S, h*n] -> [B, h, S, n] (a view)."""
    b, s, _ = t.shape
    return t.reshape(b, s, h, n).transpose(1, 2)


def _proj(params, x, kernels):
    return bitlinear.apply(params, x, kernels=kernels)


def _group_norm_gate(tp, y, g, b, s, h, n):
    """Per-head group norm in f32, the affine, then the gate in g's dtype."""
    y = y.reshape(b, s, h, n)
    mu = y.mean(-1, keepdim=True)
    var = y.var(-1, keepdim=True, correction=0)
    y = (y - mu) * torch.rsqrt(var + _GROUP_NORM_EPS)
    f32 = torch.float32
    y = y.reshape(b, s, h * n) * tp["ln_w"].to(f32) + tp["ln_b"].to(f32)
    return y.to(g.dtype) * g


def _streams(tp, x, shifted, kernels):
    """The five lerped streams; r, k, v and the gate g projected."""
    xr, xk, xv, xg, xw = (_lerp(x, shifted, tp[f"mix_{c}"]) for c in "rkvgw")
    r, k, v = (_proj(tp[name], xs, kernels) for name, xs in (("Wr", xr), ("Wk", xk),
                                                               ("Wv", xv)))
    gate = _proj(tp["Wg"], xg, kernels)
    return r, k, v, gate * _sigmoid(gate), xw  # jax.nn.silu


def time_mix(tp, x, x_prev, cfg, *, kernels):
    """x [B, S, d], x_prev [B, 1, d] (the token shift's carry) from a zero
    WKV state. Returns (out [B, S, d], x[:, -1:], the final state
    [B, H, n, n] f32)."""
    b, s, d = x.shape
    n = cfg.rwkv_head_dim
    h = d // n
    shifted = torch.cat([x_prev, x[:, :-1]], dim=1)
    r, k, v, g, xw = _streams(tp, x, shifted, kernels)
    logw = _heads(_decay(tp, xw), h, n)
    y, s_n = kernels.wkv(_heads(r, h, n), _heads(k, h, n), _heads(v, h, n), logw,
                         tp["bonus"].to(torch.float32))
    y = y.transpose(1, 2)  # [B, S, H, n]
    out = _proj(tp["Wo"], _group_norm_gate(tp, y, g, b, s, h, n), kernels)
    return out, x[:, -1:], s_n


def channel_mix(cp, x, x_prev, *, kernels):
    """Squared-ReLU channel mix; returns (out, x[:, -1:])."""
    shifted = torch.cat([x_prev, x[:, :-1]], dim=1)
    xk = _lerp(x, shifted, cp["mix_k"])
    xr = _lerp(x, shifted, cp["mix_r"])
    k = torch.square(torch.relu(_proj(cp["Wk"], xk, kernels)))
    kv = _proj(cp["Wv"], k, kernels)
    return _sigmoid(_proj(cp["Wr"], xr, kernels)) * kv, x[:, -1:]


def time_mix_decode(tp, x, state, cfg, *, kernels):
    """One token: x [B, 1, d]; state {"wkv" [B, H, n, n] f32, "x_time"
    [B, 1, d]}. Returns (out, the new state {"wkv", "x_time"})."""
    b, _, d = x.shape
    n = cfg.rwkv_head_dim
    h = d // n
    f32 = torch.float32
    r, k, v, g, xw = _streams(tp, x, state["x_time"].to(x.dtype), kernels)
    r, k, v = (t.reshape(b, h, n).to(f32) for t in (r, k, v))
    w = torch.exp(_decay(tp, xw)[:, 0].reshape(b, h, n))
    s_prev = state["wkv"]
    u = tp["bonus"].to(f32)
    kv = k[..., :, None] * v[..., None, :]  # [B, H, n, n]
    y = torch.matmul(r[:, :, None, :], s_prev + u[None, :, :, None] * kv)[:, :, 0]
    s_new = w[..., :, None] * s_prev + kv
    out = _proj(tp["Wo"], _group_norm_gate(tp, y, g, b, 1, h, n), kernels)
    return out, {"wkv": s_new, "x_time": x}


def channel_mix_decode(cp, x, x_prev, *, kernels):
    out, _ = channel_mix(cp, x, x_prev.to(x.dtype), kernels=kernels)
    return out, x
