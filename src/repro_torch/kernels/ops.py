"""Model-facing wrappers for the hand-written kernels.

These fold the model layouts into the kernel layouts.  They take torch
tensors (CUDA tensors reach the CUDA kernel, CPU tensors its plain
version) or numpy arrays, which host blocks and the numpy backend pass:
those run the plain version on the CPU and come back as numpy.
"""
from __future__ import annotations

import numpy as np
import torch

from . import flash_attention as _fa

__all__ = ["flash_attention", "fold_attention"]


def fold_attention(q, k, v):
    """(B,S,K,G,D), (B,T,K,D) x2 → the kernel's folded, contiguous
    q (B·K,S,G,D) pre-scaled by 1/sqrt(D) and k, v (B·K,T,D)."""
    B, S, K, G, D = q.shape
    T = k.shape[1]
    qf = (q * (1.0 / D ** 0.5)).permute(0, 2, 1, 3, 4).reshape(B * K, S, G, D)
    kf = k.permute(0, 2, 1, 3).reshape(B * K, T, D)
    vf = v.permute(0, 2, 1, 3).reshape(B * K, T, D)
    return qf.contiguous(), kf.contiguous(), vf.contiguous()


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0,
                    block_q: int = 128, block_k: int = 128):
    """q: (B, S, K, G, D); k, v: (B, T, K, D) → (B, S, K, G, D).
    Forward only: the gradient comes with the training port."""
    if any(isinstance(x, np.ndarray) for x in (q, k, v)):
        out = flash_attention(*(torch.as_tensor(np.asarray(x))
                                for x in (q, k, v)),
                              causal=causal, window=window,
                              block_q=block_q, block_k=block_k)
        return np.ascontiguousarray(out.numpy())
    B, S, K, G, D = q.shape
    o = _fa.flash_attention_folded(*fold_attention(q, k, v), causal=causal,
                                   window=window, block_q=block_q,
                                   block_k=block_k)
    return o.reshape(B, K, S, G, D).permute(0, 2, 1, 3, 4)
