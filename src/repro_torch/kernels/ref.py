"""Plain torch oracles for the kernels (naive, readable, obviously
correct): copies of ``src/repro/kernels/ref.py``, on its layouts (flash
on the model-facing layout, wkv6 on the folded one)."""
from __future__ import annotations

import torch

__all__ = ["flash_attention_ref", "rglru_scan_ref", "wkv6_ref",
           "rmsnorm_ref"]


def flash_attention_ref(q, k, v, *, causal: bool = True, window: int = 0):
    """q: (B, S, K, G, D) — NOT pre-scaled; k, v: (B, T, K, D)."""
    B, S, K, G, D = q.shape
    T = k.shape[1]
    s = torch.einsum("bqkgd,btkd->bkgqt", q.float(), k.float()) / (D ** 0.5)
    q_pos = torch.arange(S, device=q.device)[:, None]
    k_pos = torch.arange(T, device=q.device)[None, :]
    mask = torch.ones((S, T), dtype=torch.bool, device=q.device)
    if causal:
        mask = mask & (q_pos >= k_pos)
    if window:
        mask = mask & ((q_pos - k_pos) < window)
    s = torch.where(mask, s, torch.full_like(s, -1e30))
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgqt,btkd->bqkgd", p, v.float())
    return o.to(q.dtype)


def rglru_scan_ref(a, b):
    """h_t = a_t h_{t-1} + b_t, sequential scan along axis 1 from h = 0.
    a, b: (B, T, D) → h (B, T, D) fp32."""
    a32, b32 = a.float(), b.float()
    h = torch.zeros_like(a32[:, 0])
    out = torch.empty_like(a32)
    for t in range(a32.shape[1]):
        h = a32[:, t] * h + b32[:, t]
        out[:, t] = h
    return out


def wkv6_ref(r, k, v, w, u):
    """Sequential RWKV-6.  r, k, v, w: (BH, T, hs); u: (BH, hs).
    Returns (o (BH, T, hs) fp32, final state (BH, hs, hs) fp32)."""
    BH, T, hs = r.shape
    r, k, v, w = (x.float() for x in (r, k, v, w))
    uu = u.float()[..., None]
    s = torch.zeros((BH, hs, hs), dtype=torch.float32, device=r.device)
    o = torch.empty((BH, T, hs), dtype=torch.float32, device=r.device)
    for t in range(T):
        kv = k[:, t, :, None] * v[:, t, None, :]
        o[:, t] = torch.einsum("bi,bij->bj", r[:, t], s + uu * kv)
        s = w[:, t, :, None] * s + kv
    return o, s


def rmsnorm_ref(x, w, *, eps: float = 1e-6):
    """Row RMSNorm: fp32 mean square, rsqrt, cast to x's dtype, then * w."""
    x32 = x.float()
    var = torch.mean(x32 * x32, dim=-1, keepdim=True)
    return (x32 * torch.rsqrt(var + eps)).to(x.dtype) * w
