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

from ..distributed.sharding import (at_use, is_dtensor, local_apply,
                                    merge_dims, moved, placed_as, replicate,
                                    split_dim, whole)
from ..kernels import ops as kops
from .layers import P, acts, rms_norm

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
    """x: (B, T, d); x_prev: (B, d) last token of the previous segment
    (zeros if None).  Returns the previous-token tensor aligned with x.
    On a mesh the sequence is whole (gathered first if x splits it) and
    the shift runs on each rank's rows and channels: x_prev takes x's
    split of them."""
    if x_prev is None:
        x_prev = torch.zeros((x.shape[0], x.shape[2]), dtype=x.dtype,
                             device=x.device)
    xw = whole(x, 1)
    sx = local_apply(lambda x, xp: torch.cat([xp[:, None], x[:, :-1]],
                                             dim=1), "like", xw,
                     at_use(x_prev, xw, {0: 0, 2: 1}))
    return placed_as(sx, x)


def _use(p, x):
    """The (d,) or (d, n) / (n, d) params of a layer where they meet x
    (B, T, d): each split as x splits d (``at_use``)."""
    return {k: at_use(v, x, {2: v.ndim - 1 if k.startswith("lora_b")
                             else 0}) for k, v in p.items()}


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
    """x: (B, T, d).  Returns (out, (new_x_prev, new_state)).  On a mesh
    each param meets x at x's split of d (``at_use``: gathered over
    "data" only), as GSPMD places them for the reference: the low-rank
    mixes reduce their (B, T, 32) partial sums, each projection gathers
    its input's d over "model" and comes out split by heads, the
    recurrence runs on each rank's own rows and heads (``local_apply``:
    u and the state take r's sharding of its heads), and the output
    projection's partial sums are reduced straight to x's split."""
    B, T, d = x.shape
    hs = cfg.rwkv_head_size
    H = d // hs
    sx = _token_shift(x, x_prev)
    pu = _use({k: v for k, v in p.items()
               if k.startswith(("mu_", "lora_")) or k in ("w0", "ln_x")}, x)

    xw = _ddlerp(pu, x, sx, "w")
    xk = _ddlerp(pu, x, sx, "k")
    xv = _ddlerp(pu, x, sx, "v")
    xr = _ddlerp(pu, x, sx, "r")
    xg = _ddlerp(pu, x, sx, "g")

    def proj(xz, name):
        xz = whole(xz, 2)
        return xz @ at_use(p[name], xz, {2: 0})
    r = split_dim(proj(xr, "w_r"), 2, (H, hs))
    k = split_dim(proj(xk, "w_k"), 2, (H, hs))
    v = split_dim(proj(xv, "w_v"), 2, (H, hs))
    g = F.silu(proj(xg, "w_g"))
    dec = pu["w0"] + torch.tanh(xw @ pu["lora_a_w"]) @ pu["lora_b_w"]
    w = split_dim(torch.exp(-torch.exp(dec.float())), 2, (H, hs))
    u = split_dim(p["u"], 0, (H, hs))

    s_plc = None
    if is_dtensor(r):
        k, v, w = (t.redistribute(placements=r.placements)
                   for t in (k, v, w))
        u = u.redistribute(placements=moved(r.placements, {2: 0}))
        s_plc = moved(r.placements, {0: 0, 2: 1})
        if state is not None:
            state = state.redistribute(placements=s_plc)
    if state is not None:
        # segment continuation: fold the initial state in via the scan
        o, new_state = local_apply(_wkv_with_state, (r.placements, s_plc)
                                   if s_plc else None, r, k, v, w, u, state)
    else:
        scan = kops.wkv6 if use_pallas else wkv6_scan_ref
        o, new_state = local_apply(scan, (r.placements, s_plc)
                                   if s_plc else None, r, k, v, w, u)

    o = o.to(x.dtype)
    o = merge_dims(rms_norm(o, replicate(torch.ones(
        (hs,), dtype=x.dtype, device=x.device), o)), 2, 2) * pu["ln_x"]
    og = o * g
    out = og @ at_use(p["w_out"], og, {2: 0})
    out = acts(policy, placed_as(out, x), "embeds")
    return out, (x[:, -1], new_state)


def rwkv6_channel_mix(p, x, cfg, *, x_prev=None):
    """Squared-ReLU channel mix with simple token-shift lerp.  On a mesh
    the weights are gathered over "data" only: the (d → d_ff) product
    gathers its input's d over "model" and comes out split by d_ff; the
    two products into d contract a split dim, and their partial sums
    are reduced straight to x's split."""
    sx = _token_shift(x, x_prev)
    xx = sx - x
    xk = whole(x + xx * at_use(p["mu_k"], x, {2: 0}), 2)
    xr = x + xx * at_use(p["mu_r"], x, {2: 0})
    kk = torch.square(F.relu(xk @ at_use(p["w_k"], xk, {2: 0})))
    kv = placed_as(kk @ at_use(p["w_v"], kk, {2: 0}), x)
    r = placed_as(xr @ at_use(p["w_r"], xr, {2: 0}), x)
    return torch.sigmoid(r) * kv, x[:, -1]


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
