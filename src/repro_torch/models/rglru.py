"""Griffin recurrent block: temporal conv + RG-LRU gated linear recurrence
[arXiv:2402.19427].

The port of ``src/repro/models/rglru.py``'s training/prefill path.  The
RG-LRU diagonal recurrence
    h_t = a_t ⊙ h_{t-1} + sqrt(1 - a_t²) ⊙ (i_t ⊙ x_t)
    a_t = exp(-c · softplus(Λ) ⊙ σ(W_a x_t))
runs through the CUDA kernel (``kernels.ops.rglru_scan``) when
``use_pallas``, else through ``rglru_scan_ref``, a plain sequential loop
(torch has no public associative scan).  The block is
    out = W_out ( GeLU(W_gate x) ⊙ RG-LRU(conv1d(W_x x)) ).
Decode and its cache wait for the serving slice.
"""
from __future__ import annotations

from typing import Any, Dict

import torch
import torch.nn.functional as F

from ..kernels import ops as kops
from ..kernels.ref import rglru_scan_ref
from .layers import P, gelu, no_policy

__all__ = ["rglru_spec", "rglru_apply", "rglru_scan_ref", "RGLRU_C"]

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


def _conv1d(params, x, width: int):
    """Causal depthwise temporal conv from zero history.  x: (B, T, d).
    Returns (out, the last width-1 inputs)."""
    pad = torch.zeros((x.shape[0], width - 1, x.shape[2]), dtype=x.dtype,
                      device=x.device)
    xp = torch.cat([pad, x], dim=1)
    out = sum(xp[:, i:i + x.shape[1]] * params["conv_w"][i]
              for i in range(width))
    return out + params["conv_b"], xp[:, -(width - 1):]


def rglru_apply(params, x, cfg, *, policy=None, use_pallas: bool = False):
    """Training/prefill.  x: (B, T, d) -> (B, T, d)."""
    no_policy(policy)
    u = x @ params["w_x"]
    u, _ = _conv1d(params, u, cfg.rglru_conv_width)
    a, b = _gates(params, u, x)
    if use_pallas:
        h = kops.rglru_scan(a, b)
    else:
        h = rglru_scan_ref(a, b)
    h = h.to(x.dtype)
    gate = gelu(x @ params["w_gate"])
    return (gate * h) @ params["w_out"]
