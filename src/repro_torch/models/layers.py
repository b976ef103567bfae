"""Shared NN layers: param specs, norms, RoPE, FFN variants, the loss.

The port of ``src/repro/models/layers.py``.  Params are plain nested dicts
of tensors, made from a tree of ``P`` specs.  ``P`` keeps the reference's
logical axes, which ``distributed/sharding.py`` maps onto a mesh.  A
``policy`` (``distributed.MeshPolicy``) redistributes DTensor activations
and weights at the reference's tagged points (``acts``); ``policy=None``,
or plain tensors, leave them as they are.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

__all__ = ["P", "init_tree", "axes_tree", "acts", "rms_norm", "gelu",
           "apply_rope", "rope_freqs", "ffn_apply", "ffn_spec",
           "cross_entropy"]


@dataclasses.dataclass(frozen=True)
class P:
    """Param spec leaf: shape + logical axes + initializer."""
    shape: Tuple[int, ...]
    axes: Tuple[Optional[str], ...]
    init: str = "normal"      # normal | zeros | ones
    scale: float = 1.0

    def __post_init__(self):
        if len(self.shape) != len(self.axes):
            raise ValueError(f"shape {self.shape} and axes {self.axes} "
                             "differ in length")


def init_tree(spec: Dict[str, Any], generator: torch.Generator, device,
              dtype: torch.dtype) -> Dict[str, Any]:
    """Materialize a spec tree on ``device``: normal x scale/sqrt(fan_in),
    zeros or ones, as the reference draws them (its values differ: the
    generators differ).  ``generator`` lives on ``device``; leaves are
    drawn in sorted key order, the order ``jax.tree`` flattens a dict in."""
    def make(leaf: P) -> torch.Tensor:
        if leaf.init == "zeros":
            return torch.zeros(leaf.shape, dtype=dtype, device=device)
        if leaf.init == "ones":
            return torch.ones(leaf.shape, dtype=dtype, device=device)
        fan_in = leaf.shape[-2] if len(leaf.shape) >= 2 else leaf.shape[-1]
        std = leaf.scale / math.sqrt(max(fan_in, 1))
        t = torch.empty(leaf.shape, dtype=torch.float32, device=device)
        return t.normal_(0.0, std, generator=generator).to(dtype)

    def walk(tree):
        return {k: walk(tree[k]) if isinstance(tree[k], dict)
                else make(tree[k]) for k in sorted(tree)}
    return walk(spec)


def axes_tree(spec: Dict[str, Any]) -> Dict[str, Any]:
    """The logical-axis tuples of a spec tree, parallel to its params."""
    return {k: axes_tree(v) if isinstance(v, dict) else v.axes
            for k, v in spec.items()}


def acts(policy, x, kind: str):
    """``policy.acts(x, kind)``, or ``x`` when there is no policy."""
    return x if policy is None else policy.acts(x, kind)


# ---------------------------------------------------------------------------
# Norms / RoPE / FFN / losses
# ---------------------------------------------------------------------------

def rms_norm(x, weight, eps: float = 1e-6):
    """x·rsqrt(mean x² + eps)·weight over the last dim.  On a mesh each
    rank normalizes its own shard: ``weight`` meets x at x's split of the
    last dim (``at_use``), and where that dim is split the sums of
    squares are summed over the ranks that split it (an all-reduce of
    (..., 1) per row, forward and backward)."""
    from ..distributed.sharding import at_use, is_dtensor, local_apply, psum
    if not is_dtensor(x):
        return _rms_norm(x, weight, eps)
    from torch.distributed.tensor import Shard
    last = x.ndim - 1
    split = [i for i, p in enumerate(x.placements) if p == Shard(last)]
    mesh, n = x.device_mesh, x.shape[-1]

    def body(x, w):
        if not split:
            return _rms_norm(x, w, eps)
        return _rms_norm(x, w, eps, lambda t: psum(t, mesh, split) / n)
    return local_apply(body, "like", x, at_use(weight, x, {last: 0}))


def _rms_norm(x, weight, eps, mean=None):
    """The norm of whole rows; ``mean`` (given the per-row sums of
    squares, (..., 1)) takes the mean over a split row."""
    if x.dtype == torch.float32:
        var = (torch.mean(x * x, dim=-1, keepdim=True) if mean is None
               else mean((x * x).sum(dim=-1, keepdim=True)))
        return x * torch.rsqrt(var + eps) * weight
    # low-precision path: the sum of squares accumulates in fp32 and inv
    # is cast to x's type BEFORE the multiply, as the reference does
    x32 = x.float()
    var = ((x32 * x32).sum(dim=-1) / x.shape[-1] if mean is None
           else mean((x32 * x32).sum(dim=-1, keepdim=True))[..., 0])
    inv = torch.rsqrt(var + eps)
    return (x * inv[..., None].to(x.dtype)) * weight


def gelu(x):
    """``jax.nn.gelu``'s default: the tanh approximation."""
    return F.gelu(x, approximate="tanh")


def rope_freqs(d_head: int, theta: float, device=None):
    return 1.0 / (theta ** (torch.arange(0, d_head, 2, dtype=torch.float32,
                                         device=device) / d_head))


def apply_rope(x, positions, theta: float):
    """x: (..., S, H, D); positions: (..., S) integer.  On DTensors it
    runs on each rank's shards (heads and batch rows are independent),
    with ``positions`` sharded as ``x``'s leading dims."""
    from ..distributed.sharding import local_apply
    return local_apply(lambda x, p: _rope(x, p, theta), "like", x, positions)


def _rope(x, positions, theta: float):
    d = x.shape[-1]
    freqs = rope_freqs(d, theta, device=x.device)            # (D/2,)
    ang = positions[..., None].float() * freqs               # (..., S, D/2)
    cos, sin = torch.cos(ang)[..., None, :], torch.sin(ang)[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def ffn_spec(d_model: int, d_ff: int, activation: str,
             prefix_axes: Tuple[int, ...] = (),
             prefix_names: Tuple[str, ...] = ()) -> Dict[str, P]:
    """FFN params; ``prefix_axes/names`` prepend stacking dims (layers)."""
    pa, pn = tuple(prefix_axes), tuple(prefix_names)
    if activation in ("swiglu", "geglu"):
        return {
            "w_gate": P(pa + (d_model, d_ff), pn + ("embed", "ffn")),
            "w_up":   P(pa + (d_model, d_ff), pn + ("embed", "ffn")),
            "w_down": P(pa + (d_ff, d_model), pn + ("ffn", "embed")),
        }
    # sq_relu (Primer / Nemotron-4) and friends: two matrices
    return {
        "w_up":   P(pa + (d_model, d_ff), pn + ("embed", "ffn")),
        "w_down": P(pa + (d_ff, d_model), pn + ("ffn", "embed")),
    }


def ffn_apply(params, x, activation: str, policy=None):
    """On a mesh x's d is gathered once for both input projections
    (``whole``), which come out split by d_ff as their weights are."""
    from ..distributed.sharding import whole
    x = whole(x, -1)
    w_up = acts(policy, params["w_up"], "w_ffn_in")
    w_down = acts(policy, params["w_down"], "w_ffn_out")
    if activation in ("swiglu", "geglu"):
        act = F.silu if activation == "swiglu" else gelu
        w_gate = acts(policy, params["w_gate"], "w_ffn_in")
        h = act(x @ w_gate) * (x @ w_up)
    elif activation == "sq_relu":
        h = torch.square(F.relu(x @ w_up))
    else:
        raise ValueError(activation)
    h = acts(policy, h, "ffn_hidden")
    return h @ w_down


def cross_entropy(logits, labels, ignore_label: int = -1):
    """Mean CE in fp32; labels == ignore_label are masked out."""
    logits = logits.float()
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1,
                        labels.clamp(min=0)[..., None].long())[..., 0]
    mask = (labels != ignore_label).float()
    loss = (logz - gold) * mask
    return loss.sum() / torch.clamp(mask.sum(), min=1.0)
