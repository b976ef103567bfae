"""Distributed-optimization collectives: hierarchical gradient sync with
int8 compression and error feedback for the slow cross-pod hop.

The port of ``src/repro/distributed/collectives.py``.  On a (pod, data,
model) mesh the gradient all-reduce decomposes as
    reduce within pod (fast link)  →  all-reduce across pods (slow link).
``hierarchical_psum_compressed`` keeps the intra-pod reduction exact and
quantizes only the cross-pod leg to int8 with one shared scale;
``ErrorFeedback`` carries the quantization residual into the next step
(the 1-bit SGD lineage), which restores convergence to uncompressed
quality.  Where the reference calls ``psum``/``pmax`` inside
``shard_map``, these take a process group (``DeviceMesh.get_group``) and
run on the rank's own tensor.
"""
from __future__ import annotations

from typing import Callable, Tuple

import torch
import torch.distributed as dist

from ..tree import tree_map
from .sharding import is_dtensor, wrap_shard

__all__ = ["quantize_int8", "dequantize_int8", "compress_codes",
           "psum_compressed", "hierarchical_psum_compressed",
           "ErrorFeedback", "grad_sync"]


def quantize_int8(x) -> Tuple[torch.Tensor, torch.Tensor]:
    absmax = torch.max(torch.abs(x))
    scale = torch.clamp(absmax, min=1e-12) / 127.0
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q, scale):
    return q.to(torch.float32) * scale


def compress_codes(x, group) -> Tuple[torch.Tensor, torch.Tensor]:
    """This rank's int8 codes of ``x`` against the scale shared by
    ``group``: the MAX all-reduce of ``max |x|`` over the group, / 127."""
    m = torch.max(torch.abs(x)).to(torch.float32).reshape(1)
    dist.all_reduce(m, op=dist.ReduceOp.MAX, group=group)
    shared_scale = torch.clamp(m[0] / 127.0, min=1e-12)
    q = torch.clamp(torch.round(x / shared_scale), -127, 127).to(torch.int8)
    return q, shared_scale


def psum_compressed(x, group):
    """int8-compressed sum of ``x`` over ``group``: codes against the
    shared max scale, summed as int32 (exact for ≤ 2^23 summands), times
    the scale."""
    q, shared_scale = compress_codes(x, group)
    total = q.to(torch.int32)
    dist.all_reduce(total, op=dist.ReduceOp.SUM, group=group)
    return total.to(torch.float32) * shared_scale


def hierarchical_psum_compressed(x, *, pod_group, data_group):
    """Exact sum within the pod, int8-compressed sum across pods."""
    within = x.clone()
    dist.all_reduce(within, op=dist.ReduceOp.SUM, group=data_group)
    return psum_compressed(within, pod_group)


class ErrorFeedback:
    """Residual carry for compressed gradients:  g̃ = C(g + e);
    e' = (g + e) − g̃.  The state is a tree like the grads."""

    @staticmethod
    def init(grads):
        return tree_map(lambda g: torch.zeros(g.shape, dtype=torch.float32,
                                              device=g.device), grads)

    @staticmethod
    def apply(grads, error, compress_fn: Callable):
        corrected = tree_map(lambda g, e: g.to(torch.float32) + e,
                             grads, error)
        compressed = tree_map(compress_fn, corrected)
        new_error = tree_map(lambda c, comp: c - comp, corrected, compressed)
        return compressed, new_error


def grad_sync(mesh, *, compressed: bool = True):
    """A function averaging a tree of gradients, replicated within each
    pod, across the "pod" axis of ``mesh`` (the cross-pod hop of the
    hierarchical scheme, when the pod axis runs pure data parallelism):
    int8-compressed by default.  The identity on a mesh without "pod".
    A DTensor leaf is synced on its local tensor and keeps its
    placements."""
    if "pod" not in (mesh.mesh_dim_names or ()):
        return lambda g: g
    group = mesh.get_group("pod")
    n = mesh.size(mesh.mesh_dim_names.index("pod"))

    def sync_leaf(g):
        local = g.to_local() if is_dtensor(g) else g
        if compressed:
            out = psum_compressed(local, group) / n
        else:
            out = local.to(torch.float32).clone()
            dist.all_reduce(out, op=dist.ReduceOp.SUM, group=group)
            out = out / n
        if is_dtensor(g):
            return wrap_shard(out, g.device_mesh, g.placements, g.shape)
        return out

    return lambda grads: tree_map(sync_leaf, grads)
