"""Plain PyTorch version of the WKV kernel.

It is ``_wkv_chunked`` (``repro/models/rwkv.py:80-130``) from a zero
state, in f32, with the signature of ``repro/kernels/wkv/ref.py`` minus
``s0``: the chunk is ``min(CHUNK, S)`` halved until it divides S, as in
JAX, so that the CPU tests compare like with like, and a Python loop over
the chunks takes the place of ``lax.scan`` (``jax.checkpoint`` serves
training only and is left out). The decay terms ``exp(e_t - lc_s)`` for
s >= t, which JAX computes and masks after, are masked in the exponent
here (``exp(-inf) = 0``), so no inf enters a sum; the kept terms are the
same.
"""

from __future__ import annotations

import torch

CHUNK = 64  # JAX's default chunk; the kernel's fixed one


def wkv(r, k, v, logw, u):
    """r/k/v/logw [B, H, S, n], u [H, n] -> (y [B, H, S, n] f32, the final
    state sN [B, H, n, n] f32)."""
    b, h, s, n = r.shape
    chunk = min(CHUNK, s)
    while s % chunk:
        chunk //= 2
    f32 = torch.float32
    uf = u.to(f32)
    tri = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool, device=r.device), -1)
    state = torch.zeros((b, h, n, n), dtype=f32, device=r.device)
    ys = []
    for c0 in range(0, s, chunk):
        rc, kc, vc, wc = (t[:, :, c0:c0 + chunk].to(f32) for t in (r, k, v, logw))
        lc = torch.cumsum(wc, dim=2)  # inclusive cum-log-decay
        e = lc - wc  # exclusive
        # intra-chunk: A[t, s] = sum_i r_t[i] k_s[i] exp(e_t[i] - lc_s[i]), s < t
        expo = e[:, :, :, None, :] - lc[:, :, None, :, :]  # [B, H, C, C, n]
        dec = torch.exp(torch.where(tri[:, :, None], expo, torch.full_like(expo, -torch.inf)))
        amat = (rc[:, :, :, None, :] * kc[:, :, None, :, :] * dec).sum(-1)
        diag = (rc * kc * uf[None, :, None, :]).sum(-1)
        y = torch.matmul(amat, vc) + diag[..., None] * vc
        # cross-chunk: y += (r * exp(e)) @ S
        y = y + torch.matmul(rc * torch.exp(e), state)
        # state: S' = diag(exp(lc_last)) S + sum_s exp(lc_last - lc_s) k_s v_s^T
        last = lc[:, :, -1]
        state = torch.exp(last)[..., None] * state + torch.matmul(
            (kc * torch.exp(last[:, :, None, :] - lc)).transpose(-1, -2), vc)
        ys.append(y)
    return torch.cat(ys, dim=2), state
