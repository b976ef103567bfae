"""Pieces both reference models use."""
from __future__ import annotations

import torch


def rms(x, w, eps: float):
    """x·rsqrt(mean x² + eps)·w over the last dim."""
    return x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps) * w


def fp32(tree):
    """A tree's leaves in float32: a copy of each leaf in another type (from
    bfloat16 exact), the leaf itself where it is float32 already."""
    return {k: fp32(v) if isinstance(v, dict) else v.float()
            for k, v in tree.items()}


def _unstack(tree, n: int):
    split = {k: _unstack(v, n) if isinstance(v, dict) else v.unbind(0)
             for k, v in tree.items()}
    return [{k: split[k][i] for k in tree} for i in range(n)]


def per_layer(tree, n: int):
    """The n per-layer trees of a tree of layer-stacked leaves (one
    ``unbind`` per leaf, so a gradient reaches the stacked leaf once),
    each in float32 as it is reached: a tree in the served type is never
    held whole in float32."""
    for lp in _unstack(tree, n):
        yield fp32(lp)


def cross_entropy(logits, labels):
    """Mean over the positions whose label is not -1."""
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels.clamp(min=0)[..., None].long())
    keep = (labels != -1).to(logits.dtype)
    return ((logz - gold[..., 0]) * keep).sum() / keep.sum().clamp(min=1.0)
