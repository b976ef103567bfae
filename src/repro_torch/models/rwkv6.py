"""RWKV-6 "Finch" block [arXiv:2404.05892]: attention-free time-mix with
data-dependent per-channel decay + squared-ReLU channel-mix.

The port of ``src/repro/models/rwkv6.py``.  Per head (head size hs), with
state S ∈ R^{hs×hs}:
    o_t[j] = Σ_i r_t[i] · (S_{t-1}[i,j] + u[i]·k_t[i]·v_t[j])
    S_t    = diag(w_t) · S_{t-1} + k_t ⊗ v_t
where w_t = exp(-exp(w0 + lora_w(x̃_t))) and the x̃ inputs are ddlerp
token shifts.  The recurrence runs through the CUDA kernel
(``kernels.ops.wkv6``) when ``use_pallas`` and no state is given, else
through a plain sequential loop, in the reference's branch order.
Decode carries (S, x_prev) per layer (``init_rwkv_cache``): a state given
to ``rwkv6_time_mix`` takes the sequential loop, never the kernel.
"""
from __future__ import annotations

from typing import Any, Dict

import torch
import torch.nn.functional as F

from ..kernels import ops as kops
from .layers import P, no_policy, rms_norm

__all__ = ["rwkv6_spec", "rwkv6_time_mix", "rwkv6_channel_mix",
           "init_rwkv_cache", "wkv6_scan_ref"]

LORA_R = 32
_MIX = ("w", "k", "v", "r", "g")


def rwkv6_spec(cfg, prefix_shape=(), prefix_names=()) -> Dict[str, Any]:
    pa, pn = tuple(prefix_shape), tuple(prefix_names)
    d, f = cfg.d_model, cfg.d_ff
    tm: Dict[str, Any] = {
        "mu_x": P(pa + (d,), pn + ("embed",), init="zeros"),
        "w0":   P(pa + (d,), pn + ("embed",), init="zeros"),
        "u":    P(pa + (d,), pn + ("embed",), init="zeros"),
        "ln_x": P(pa + (d,), pn + ("embed",), init="ones"),
        "w_out": P(pa + (d, d), pn + ("heads", "embed")),
    }
    for z in _MIX:
        tm[f"mu_{z}"] = P(pa + (d,), pn + ("embed",), init="zeros")
        tm[f"lora_a_{z}"] = P(pa + (d, LORA_R), pn + ("embed", None))
        tm[f"lora_b_{z}"] = P(pa + (LORA_R, d), pn + (None, "embed"),
                              init="zeros")
        if z != "w":
            tm[f"w_{z}"] = P(pa + (d, d), pn + ("embed", "heads"))
    cm = {
        "mu_k": P(pa + (d,), pn + ("embed",), init="zeros"),
        "mu_r": P(pa + (d,), pn + ("embed",), init="zeros"),
        "w_k": P(pa + (d, f), pn + ("embed", "ffn")),
        "w_v": P(pa + (f, d), pn + ("ffn", "embed")),
        "w_r": P(pa + (d, d), pn + ("embed", "embed_out")),
    }
    return {"tm": tm, "cm": cm}


def _token_shift(x, x_prev):
    """x: (B, T, d); x_prev: (B, d) last token of the previous segment.
    Returns the previous-token tensor aligned with x."""
    return torch.cat([x_prev[:, None], x[:, :-1]], dim=1)


def _ddlerp(p, x, sx, z: str):
    """Data-dependent lerp (RWKV-6): mix x with shifted sx."""
    xx = sx - x
    inner = x + xx * p["mu_x"]
    lora = torch.tanh(inner @ p[f"lora_a_{z}"]) @ p[f"lora_b_{z}"]
    return x + xx * (p[f"mu_{z}"] + lora)


def _wkv_with_state(r, k, v, w, u, s0):
    """The sequential recurrence from state s0.  r, k, v, w: (B, T, H, hs);
    u: (H, hs); s0: (B, H, hs, hs).  Returns (o fp32, final state fp32)."""
    rr, kk, vv, ww = (t.float() for t in (r, k, v, w))
    uu = u.float()[..., :, None]
    s = s0.float()
    o = torch.empty(rr.shape, dtype=torch.float32, device=rr.device)
    for t in range(rr.shape[1]):
        kv = kk[:, t, ..., :, None] * vv[:, t, ..., None, :]
        o[:, t] = torch.einsum("bhi,bhij->bhj", rr[:, t], s + uu * kv)
        s = ww[:, t, ..., :, None] * s + kv
    return o, s


def wkv6_scan_ref(r, k, v, w, u):
    """Sequential oracle from S = 0.  r, k, v, w: (B, T, H, hs); u: (H, hs)
    bonus.  Returns (o (B,T,H,hs), final state (B,H,hs,hs))."""
    B, T, H, hs = r.shape
    s0 = torch.zeros((B, H, hs, hs), dtype=torch.float32, device=r.device)
    return _wkv_with_state(r, k, v, w, u, s0)


def rwkv6_time_mix(p, x, cfg, *, x_prev=None, state=None, policy=None,
                   use_pallas: bool = False):
    """x: (B, T, d).  Returns (out, (new_x_prev, new_state))."""
    no_policy(policy)
    B, T, d = x.shape
    hs = cfg.rwkv_head_size
    H = d // hs
    if x_prev is None:
        x_prev = torch.zeros((B, d), dtype=x.dtype, device=x.device)
    sx = _token_shift(x, x_prev)

    xw = _ddlerp(p, x, sx, "w")
    xk = _ddlerp(p, x, sx, "k")
    xv = _ddlerp(p, x, sx, "v")
    xr = _ddlerp(p, x, sx, "r")
    xg = _ddlerp(p, x, sx, "g")

    r = (xr @ p["w_r"]).reshape(B, T, H, hs)
    k = (xk @ p["w_k"]).reshape(B, T, H, hs)
    v = (xv @ p["w_v"]).reshape(B, T, H, hs)
    g = F.silu(xg @ p["w_g"])
    dec = p["w0"] + torch.tanh(xw @ p["lora_a_w"]) @ p["lora_b_w"]
    w = torch.exp(-torch.exp(dec.float())).reshape(B, T, H, hs)
    u = p["u"].reshape(H, hs)

    if state is not None:
        # segment continuation: fold the initial state in via the scan
        o, new_state = _wkv_with_state(r, k, v, w, u, state)
    elif use_pallas:
        o, new_state = kops.wkv6(r, k, v, w, u)
    else:
        o, new_state = wkv6_scan_ref(r, k, v, w, u)

    o = o.reshape(B, T, d).to(x.dtype)
    o = rms_norm(o.reshape(B, T, H, hs),
                 torch.ones((hs,), dtype=x.dtype, device=x.device)
                 ).reshape(B, T, d) * p["ln_x"]
    out = (o * g) @ p["w_out"]
    return out, (x[:, -1], new_state)


def rwkv6_channel_mix(p, x, cfg, *, x_prev=None):
    """Squared-ReLU channel mix with simple token-shift lerp."""
    B, T, d = x.shape
    if x_prev is None:
        x_prev = torch.zeros((B, d), dtype=x.dtype, device=x.device)
    sx = _token_shift(x, x_prev)
    xx = sx - x
    xk = x + xx * p["mu_k"]
    xr = x + xx * p["mu_r"]
    kk = torch.square(F.relu(xk @ p["w_k"]))
    return torch.sigmoid(xr @ p["w_r"]) * (kk @ p["w_v"]), x[:, -1]


def init_rwkv_cache(cfg, n_layers: int, batch: int, dtype=torch.bfloat16,
                    device=None):
    d = cfg.d_model
    hs = cfg.rwkv_head_size
    H = d // hs
    return {
        "tm_x": torch.zeros((n_layers, batch, d), dtype=dtype, device=device),
        "cm_x": torch.zeros((n_layers, batch, d), dtype=dtype, device=device),
        "state": torch.zeros((n_layers, batch, H, hs, hs),
                             dtype=torch.float32, device=device),
    }
