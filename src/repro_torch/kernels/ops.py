"""Model-facing wrappers for the hand-written kernels.

These fold the model layouts into the kernel layouts.  They take torch
tensors: CUDA tensors reach the CUDA kernel, CPU tensors its plain
version.  ``flash_attention`` also takes numpy arrays, which host blocks
and the numpy backend pass: those run the plain version on the CPU and
come back as numpy.
"""
from __future__ import annotations

import numpy as np
import torch

from . import flash_attention as _fa
from . import rglru_scan as _rg
from . import rmsnorm as _rn
from . import wkv6 as _wkv

__all__ = ["flash_attention", "fold_attention", "rglru_scan", "wkv6",
           "rmsnorm", "BACKWARD_RANGE"]

# the profiler range flash's backward (the blockwise recompute) runs in
BACKWARD_RANGE = "flash_attention.backward"


def fold_attention(q, k, v):
    """(B,S,K,G,D), (B,T,K,D) x2 → the kernel's folded, contiguous
    q (B·K,S,G,D) pre-scaled by 1/sqrt(D) and k, v (B·K,T,D)."""
    B, S, K, G, D = q.shape
    T = k.shape[1]
    qf = (q * (1.0 / D ** 0.5)).permute(0, 2, 1, 3, 4).reshape(B * K, S, G, D)
    kf = k.permute(0, 2, 1, 3).reshape(B * K, T, D)
    vf = v.permute(0, 2, 1, 3).reshape(B * K, T, D)
    return qf.contiguous(), kf.contiguous(), vf.contiguous()


class _FlashAttention(torch.autograd.Function):
    """The kernel's forward with the reference's backward: the gradient
    is recomputed through ``models.attention.blockwise_attention``, the
    memory-efficient form the reference's ``_flash_bwd`` differentiates
    (``src/repro/kernels/ops.py``).  CPU tensors take the same Function,
    with the kernel's plain version as the forward."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, block_q, block_k):
        B, S, K, G, D = q.shape
        o = _fa.flash_attention_folded(*fold_attention(q, k, v),
                                       causal=causal, window=window,
                                       block_q=block_q, block_k=block_k)
        ctx.save_for_backward(q, k, v)
        ctx.causal, ctx.window = causal, window
        return o.reshape(B, K, S, G, D).permute(0, 2, 1, 3, 4)

    @staticmethod
    def backward(ctx, g):
        from ..models.attention import blockwise_attention
        q, k, v = (x.detach().requires_grad_() for x in ctx.saved_tensors)
        with torch.enable_grad(), torch.profiler.record_function(
                BACKWARD_RANGE):
            o = blockwise_attention(q, k, v, causal=ctx.causal,
                                    window=ctx.window)
            dq, dk, dv = torch.autograd.grad(o, (q, k, v), g)
        return dq, dk, dv, None, None, None, None


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0,
                    block_q: int = 128, block_k: int = 128):
    """q: (B, S, K, G, D); k, v: (B, T, K, D) → (B, S, K, G, D).
    Differentiable: the kernel's forward, and a backward that recomputes
    through ``blockwise_attention``."""
    if any(isinstance(x, np.ndarray) for x in (q, k, v)):
        out = flash_attention(*(torch.as_tensor(np.asarray(x))
                                for x in (q, k, v)),
                              causal=causal, window=window,
                              block_q=block_q, block_k=block_k)
        return np.ascontiguousarray(out.numpy())
    return _FlashAttention.apply(q, k, v, causal, window, block_q, block_k)


def _no_backward(kernel: str, *inputs) -> None:
    """Raise where autograd would record through a kernel that has no
    backward: its output would carry no gradient to its inputs."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in inputs):
        raise NotImplementedError(
            f"{kernel}: the kernel has no backward, and the reference has "
            "none either (jax.grad through its Pallas kernel raises); "
            "train with use_pallas=False")


def rglru_scan(a, b, *, block_t: int = 256):
    """a, b: (B, T, D) → h (B, T, D) fp32.  Forward only: raises under
    grad (``_no_backward``)."""
    _no_backward("rglru_scan", a, b)
    return _rg.rglru_scan(a, b, block_t=block_t)


def wkv6(r, k, v, w, u, *, block_t: int = 64):
    """r, k, v, w: (B, T, H, hs); u: (H, hs).
    Returns (o (B, T, H, hs) fp32, state (B, H, hs, hs) fp32).  w goes to
    the kernel in fp32, the type the kernel computes it in.  Forward only:
    raises under grad (``_no_backward``)."""
    _no_backward("wkv6", r, k, v, w, u)
    B, T, H, hs = r.shape

    def fold(t):
        return t.permute(0, 2, 1, 3).reshape(B * H, T, hs).contiguous()

    uu = u[None].expand(B, H, hs).reshape(B * H, hs).contiguous()
    o, s = _wkv.wkv6_folded(fold(r), fold(k), fold(v), fold(w.float()), uu,
                            block_t=block_t)
    o = o.reshape(B, H, T, hs).permute(0, 2, 1, 3)
    return o, s.reshape(B, H, hs, hs)


def rmsnorm(x, w, *, eps: float = 1e-6, block_rows: int = 256):
    """x: (..., D); w: (D,).  Halves ``block_rows`` until it divides the
    row count, as the reference's wrapper does."""
    shape = x.shape
    xf = x.reshape(-1, shape[-1]).contiguous()
    n = xf.shape[0]
    br = block_rows
    while n % br:
        br //= 2
    o = _rn.rmsnorm(xf, w, eps=eps, block_rows=max(br, 1))
    return o.reshape(shape)
