"""Attention: GQA with RoPE, the blockwise online-softmax path (no S x S
scores), and sliding-window local attention.

The port of ``src/repro/models/attention.py``'s training/prefill path.
``attn_apply(use_pallas=True)`` takes the CUDA flash kernel through
``kernels.ops.flash_attention`` (its plain version for CPU tensors);
``use_pallas=False`` takes ``blockwise_attention``, as the reference does.
Decode and the KV cache wait for the serving slice.
"""
from __future__ import annotations

from typing import Dict

import torch

from ..kernels import ops as kops
from .layers import P, apply_rope, no_policy, rms_norm

__all__ = ["attn_spec", "attn_apply", "blockwise_attention"]

NEG_INF = -1e30


def attn_spec(cfg, prefix_shape=(), prefix_names=()) -> Dict[str, P]:
    pa, pn = tuple(prefix_shape), tuple(prefix_names)
    d = cfg.d_model
    spec = {
        "w_q": P(pa + (d, cfg.n_heads, cfg.d_head),
                 pn + ("embed", "heads", "head_dim")),
        "w_k": P(pa + (d, cfg.n_kv_heads, cfg.d_head),
                 pn + ("embed", "kv_heads", "head_dim")),
        "w_v": P(pa + (d, cfg.n_kv_heads, cfg.d_head),
                 pn + ("embed", "kv_heads", "head_dim")),
        "w_o": P(pa + (cfg.n_heads, cfg.d_head, d),
                 pn + ("heads", "head_dim", "embed")),
    }
    if cfg.qkv_bias:
        spec["b_q"] = P(pa + (cfg.n_heads, cfg.d_head),
                        pn + ("heads", "head_dim"), init="zeros")
        spec["b_k"] = P(pa + (cfg.n_kv_heads, cfg.d_head),
                        pn + ("kv_heads", "head_dim"), init="zeros")
        spec["b_v"] = P(pa + (cfg.n_kv_heads, cfg.d_head),
                        pn + ("kv_heads", "head_dim"), init="zeros")
    if cfg.qk_norm:
        spec["qnorm"] = P(pa + (cfg.d_head,), pn + ("head_dim",),
                          init="ones")
        spec["knorm"] = P(pa + (cfg.d_head,), pn + ("head_dim",),
                          init="ones")
    return spec


def _project_qkv(params, x, cfg, positions):
    q = torch.einsum("bsd,dhk->bshk", x, params["w_q"])
    k = torch.einsum("bsd,dhk->bshk", x, params["w_k"])
    v = torch.einsum("bsd,dhk->bshk", x, params["w_v"])
    if "b_q" in params:
        q = q + params["b_q"]
        k = k + params["b_k"]
        v = v + params["b_v"]
    if "qnorm" in params:
        q = rms_norm(q, params["qnorm"])
        k = rms_norm(k, params["knorm"])
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def blockwise_attention(q, k, v, *, causal: bool = True, window: int = 0,
                        q_chunk: int = 512, kv_chunk: int = 512,
                        q_offset: int = 0):
    """Flash-style attention without S x S scores.

    q: (B, S, K, G, D) — G query heads per KV head; k, v: (B, T, K, D).
    Online softmax over KV chunks, one Q chunk at a time."""
    B, S, K, G, D = q.shape
    T = k.shape[1]
    q_chunk = min(q_chunk, S)
    kv_chunk = min(kv_chunk, T)
    if S % q_chunk or T % kv_chunk:
        raise ValueError(f"chunks do not divide: S={S} q_chunk={q_chunk}, "
                         f"T={T} kv_chunk={kv_chunk}")
    scale = 1.0 / (D ** 0.5)
    qf = q * scale
    dev = q.device
    outs = []
    for q0 in range(0, S, q_chunk):
        qblk = qf[:, q0:q0 + q_chunk].float()          # (B, qc, K, G, D)
        q_pos = q_offset + q0 + torch.arange(q_chunk, device=dev)
        o = torch.zeros((B, K, G, q_chunk, D), dtype=torch.float32,
                        device=dev)
        m = torch.full((B, K, G, q_chunk), NEG_INF, dtype=torch.float32,
                       device=dev)
        lse = torch.zeros((B, K, G, q_chunk), dtype=torch.float32,
                          device=dev)
        for k0 in range(0, T, kv_chunk):
            k_pos = k0 + torch.arange(kv_chunk, device=dev)
            s = torch.einsum("bqkgd,btkd->bkgqt", qblk,
                             k[:, k0:k0 + kv_chunk].float())
            mask = torch.ones((q_chunk, kv_chunk), dtype=torch.bool,
                              device=dev)
            if causal:
                mask = mask & (q_pos[:, None] >= k_pos[None, :])
            if window:
                mask = mask & ((q_pos[:, None] - k_pos[None, :]) < window)
            s = torch.where(mask, s, torch.full_like(s, NEG_INF))
            m_new = torch.maximum(m, s.amax(dim=-1))
            p = torch.exp(s - m_new[..., None])
            corr = torch.exp(m - m_new)
            lse = lse * corr + p.sum(dim=-1)
            pv = torch.einsum("bkgqt,btkd->bkgqd", p,
                              v[:, k0:k0 + kv_chunk].float())
            o = o * corr[..., None] + pv
            m = m_new
        o = o / torch.clamp(lse[..., None], min=1e-30)
        outs.append(o.permute(0, 3, 1, 2, 4))          # (B, qc, K, G, D)
    return torch.cat(outs, dim=1).to(q.dtype)


def attn_apply(params, x, cfg, positions, *, policy=None, window: int = 0,
               use_pallas: bool = False):
    """Training / prefill self-attention.  x: (B, S, d_model)."""
    no_policy(policy)
    B, S, _ = x.shape
    K, G = cfg.n_kv_heads, cfg.n_heads // cfg.n_kv_heads
    q, k, v = _project_qkv(params, x, cfg, positions)
    q = q.reshape(B, S, K, G, cfg.d_head)
    if use_pallas:
        o = kops.flash_attention(q, k, v, causal=True, window=window)
    else:
        o = blockwise_attention(q, k, v, causal=True, window=window)
    o = o.reshape(B, S, cfg.n_heads, cfg.d_head)
    return torch.einsum("bshk,hkd->bsd", o, params["w_o"])
