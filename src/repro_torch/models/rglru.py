"""Griffin recurrent block: temporal conv + RG-LRU gated linear recurrence
[arXiv:2402.19427].

The port of ``src/repro/models/rglru.py``.  The
RG-LRU diagonal recurrence
    h_t = a_t ⊙ h_{t-1} + sqrt(1 - a_t²) ⊙ (i_t ⊙ x_t)
    a_t = exp(-c · softplus(Λ) ⊙ σ(W_a x_t))
runs through the CUDA kernel (``kernels.ops.rglru_scan``) when
``use_pallas``, else through ``rglru_scan_ref``, a plain sequential loop
(torch has no public associative scan).  The block is
    out = W_out ( GeLU(W_gate x) ⊙ RG-LRU(conv1d(W_x x)) ).
Decode (``rglru_decode``) is a single-step update carrying (h, conv
window), with no kernel, as in the reference.
"""
from __future__ import annotations

from typing import Any, Dict

import torch
import torch.nn.functional as F

from ..kernels import ops as kops
from ..kernels.ref import rglru_scan_ref
from .layers import P, gelu, no_policy

__all__ = ["rglru_spec", "rglru_apply", "rglru_decode", "init_rglru_cache",
           "rglru_scan_ref", "RGLRU_C"]

RGLRU_C = 8.0


def rglru_spec(cfg, prefix_shape=(), prefix_names=()) -> Dict[str, Any]:
    pa, pn = tuple(prefix_shape), tuple(prefix_names)
    d = cfg.d_model
    w = cfg.rglru_conv_width
    return {
        "w_x":    P(pa + (d, d), pn + ("embed", "rnn")),
        "w_gate": P(pa + (d, d), pn + ("embed", "rnn")),
        "w_out":  P(pa + (d, d), pn + ("rnn", "embed")),
        "conv_w": P(pa + (w, d), pn + (None, "rnn"), init="zeros"),
        "conv_b": P(pa + (d,), pn + ("rnn",), init="zeros"),
        "w_a":    P(pa + (d, d), pn + ("embed", "rnn")),
        "w_i":    P(pa + (d, d), pn + ("embed", "rnn")),
        "lam":    P(pa + (d,), pn + ("rnn",), init="ones"),
    }


def _gates(params, u, x):
    """u: conv output (..., d) drives the recurrence input; x: raw block
    input drives the gates (a_t, i_t)."""
    a = torch.exp(-RGLRU_C * F.softplus(params["lam"]).float()
                  * torch.sigmoid(x @ params["w_a"]).float())
    i = torch.sigmoid(x @ params["w_i"]).float()
    b = torch.sqrt(torch.clamp(1.0 - a * a, min=1e-12)) * (i * u.float())
    return a, b


def _conv1d(params, x, width: int, state=None):
    """Causal depthwise temporal conv.  x: (B, T, d).  ``state``: (B, w-1,
    d) previous inputs for decode continuity (zero history if None).
    Returns (out, the last width-1 inputs)."""
    if state is None:
        pad = torch.zeros((x.shape[0], width - 1, x.shape[2]),
                          dtype=x.dtype, device=x.device)
    else:
        pad = state.to(x.dtype)
    xp = torch.cat([pad, x], dim=1)
    out = sum(xp[:, i:i + x.shape[1]] * params["conv_w"][i]
              for i in range(width))
    return out + params["conv_b"], xp[:, -(width - 1):]


def rglru_apply(params, x, cfg, *, policy=None, use_pallas: bool = False):
    """Training/prefill.  x: (B, T, d).  Returns (out (B, T, d), (h, conv)):
    the last step's fp32 hidden state and the conv window, the layer's
    decode cache after the prompt."""
    no_policy(policy)
    u = x @ params["w_x"]
    u, conv_state = _conv1d(params, u, cfg.rglru_conv_width)
    a, b = _gates(params, u, x)
    if use_pallas:
        h = kops.rglru_scan(a, b)
    else:
        h = rglru_scan_ref(a, b)
    state = (h[:, -1].float(), conv_state)
    gate = gelu(x @ params["w_gate"])
    return (gate * h.to(x.dtype)) @ params["w_out"], state


def init_rglru_cache(cfg, n_layers: int, batch: int, dtype=torch.bfloat16,
                     device=None):
    d, w = cfg.d_model, cfg.rglru_conv_width
    return {
        "h": torch.zeros((n_layers, batch, d), dtype=torch.float32,
                         device=device),
        "conv": torch.zeros((n_layers, batch, w - 1, d), dtype=dtype,
                            device=device),
    }


def rglru_decode(params, x, cfg, cache, *, policy=None):
    """One step.  x: (B, 1, d); cache: dict(h (B, d) fp32, conv (B, w-1,
    d)) of THIS layer, written in place.  Returns (out, cache)."""
    no_policy(policy)
    u = x @ params["w_x"]
    u, conv_state = _conv1d(params, u, cfg.rglru_conv_width,
                            state=cache["conv"])
    a, b = _gates(params, u, x)
    h = a[:, 0] * cache["h"] + b[:, 0]                 # (B, d) fp32
    gate = gelu(x @ params["w_gate"])
    out = (gate * h[:, None].to(x.dtype)) @ params["w_out"]
    cache["h"].copy_(h)
    cache["conv"].copy_(conv_state)
    return out, cache
