"""Plain PyTorch version of the flash-attention kernel.

It computes what ``repro/kernels/flash_attention/kernel.py`` computes with
the whole sequence as one kv block: f32 scores times the scale, the
softcap ``softcap * tanh(s / softcap)`` when ``softcap > 0``, the ``-1e30``
mask above the diagonal and, with a sliding ``window > 0``, at ``qpos -
kpos >= window`` (``kernel.py:68-75``), unnormalized probabilities cast to
q's dtype before P·V, and the ``max(l, 1e-30)`` finalize. The kernel's online softmax rescales block
by block, so the two agree to rounding, not bit for bit. ``causal_skip``
picks the kernel's schedule (skip the blocks above the diagonal, or visit
and mask them, the paper's Table II ablation); both compute the same
function, so here it is accepted and ignored. v may have another head
dim than q and k (MLA: 192 and 128), and ``scale`` replaces the default
1/sqrt(Dqk) (``kernel.py:111``).
"""

from __future__ import annotations

import math

import torch

NEG_INF = -1e30


def flash_attention(q, k, v, *, scale: float | None = None, window: int = 0,
                    softcap: float = 0.0, causal_skip: bool = True) -> torch.Tensor:
    """q [B, H, S, D], k [B, HK, S, D], v [B, HK, S, Dv] (GQA: H % HK == 0)
    -> [B, H, S, Dv]; scores times ``scale`` (default 1/sqrt(D)), then
    capped by ``softcap`` and masked outside the causal ``window``."""
    del causal_skip  # a schedule of the kernel, not part of the function
    b, h, s, d = q.shape
    hk, dv = k.shape[1], v.shape[-1]
    scale = 1.0 / math.sqrt(d) if scale is None else scale
    g = h // hk
    qg = q.reshape(b, hk, g, s, d).to(torch.float32)
    kf = k.to(torch.float32)[:, :, None]
    sc = torch.matmul(qg, kf.transpose(-1, -2)) * scale  # [B, HK, G, S, S]
    if softcap > 0:
        sc = softcap * torch.tanh(sc / softcap)
    idx = torch.arange(s, device=q.device)
    mask = idx[:, None] >= idx[None, :]
    if window > 0:
        mask = mask & (idx[:, None] - idx[None, :] < window)
    sc = torch.where(mask, sc, torch.full_like(sc, NEG_INF))
    p = torch.exp(sc - sc.amax(dim=-1, keepdim=True))
    l = p.sum(dim=-1, keepdim=True)
    o = torch.matmul(p.to(q.dtype).to(torch.float32), v.to(torch.float32)[:, :, None])
    o = o / torch.clamp(l, min=1e-30)
    return o.to(q.dtype).reshape(b, h, s, dv)
