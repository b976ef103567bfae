"""Plain torch oracles for the kernels (naive, readable, obviously
correct), on the model-facing layouts."""
from __future__ import annotations

import torch

__all__ = ["flash_attention_ref"]


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
