"""AdamW with fp32 state over params of any type.

The port of ``src/repro/optim/adamw.py``, with its formula term for term:
fp32 ``m``/``v``, a global-norm clip taken in fp32 over all leaves, bias
correction with the step as fp32, the update computed in fp32 and cast
back to the param's type.  The state tree is ``{"m", "v", "step"}``, with
``step`` a 0-d int32 tensor.

Where the reference donates its buffers to a jitted step, the port
updates in place under ``torch.no_grad()``: ``update`` writes the new
values into ``params`` and ``state`` and returns those trees.  Each leaf's
update and its share of the clip norm are ``kernels.adamw``'s: on a card
one hand-written CUDA pass over the whole leaf each, which keeps no fp32
temporary; on the CPU the plain loop over slices of ``CHUNK`` elements, so
its temporaries never exceed two slices (one fp32 copy of qwen2.5-14b's
778 M-element ``embed`` alone would be 3.1 GB).  The arithmetic is
elementwise, so slicing changes no value.

An ``Optimizer`` also carries its update as a ``LeafRule``: the global
terms once (``begin``), then one param at a time (``leaf``) with that
param's state tensors (``slots``).  ``update`` runs the rule over the
tree; ``offload.offloaded_optimizer`` runs the same rule while it streams
each param's state in from pinned host memory and back.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

from ..distributed.sharding import is_dtensor, local_shard
from ..kernels import adamw as kadamw
from ..trace import UPDATE_RANGE
from ..tree import leaves, tree_map

__all__ = ["adamw", "Optimizer", "LeafRule", "apply_rule", "synced",
           "local_ctx", "CHUNK", "UPDATE_RANGE"]

CHUNK = 1 << 26   # elements of a leaf the CPU updates at a time (256 MB fp32)


@dataclasses.dataclass(frozen=True)
class LeafRule:
    """An update split leaf by leaf.

    ``slots(state)``: each param's state tensors, a dict per param in leaf
    order; ``begin(grads, state)``: the terms shared by all leaves (the
    clip scale, the new step), after advancing ``state["step"]`` in place;
    ``leaf(ctx, g, slot, p)``: one param's update, written into ``slot``
    and ``p`` in place; ``elementwise``: whether ``leaf`` may be given any
    slice of a leaf (with the matching slices of its state)."""
    slots: Callable[[Any], List[Dict[str, torch.Tensor]]]
    begin: Callable[[List[torch.Tensor], Any], Any]
    leaf: Callable[[Any, torch.Tensor, Dict[str, torch.Tensor],
                    torch.Tensor], None]
    elementwise: bool = False


@dataclasses.dataclass(frozen=True)
class Optimizer:
    init: Callable[[Any], Any]
    update: Callable[[Any, Any, Any], Tuple[Any, Any]]
    name: str = "optimizer"
    rule: Optional[LeafRule] = None


def synced(flat_g: List[torch.Tensor], flat_p: List[torch.Tensor]
           ) -> List[torch.Tensor]:
    """On a mesh, each gradient at its param's placements: partial sums
    reduced (the data-parallel gradient sync: an all-reduce for a
    replicated param, a reduce-scatter for a sharded one)."""
    return [g.redistribute(placements=p.placements)
            if is_dtensor(g) and tuple(g.placements) != tuple(p.placements)
            else g for g, p in zip(flat_g, flat_p)]


def local_ctx(ctx):
    """``begin``'s terms as this rank's tensors (replicated DTensors are
    whole on every rank)."""
    return {k: local_shard(v) for k, v in ctx.items()}


@torch.no_grad()
def apply_rule(rule: LeafRule, grads, state, params):
    """Run ``rule`` over the whole tree, in place; returns (params,
    state).  On a mesh the gradients are first synced to their params'
    placements; an elementwise rule then updates each rank's own shards,
    any other rule runs on the DTensors."""
    with torch.profiler.record_function(UPDATE_RANGE):
        flat_p = leaves(params)
        flat_g = synced(leaves(grads), flat_p)
        ctx = rule.begin(flat_g, state)
        slots = rule.slots(state)
        if rule.elementwise and flat_p and is_dtensor(flat_p[0]):
            ctx = local_ctx(ctx)
            flat_g, flat_p = [local_shard(g).contiguous() for g in flat_g], \
                [local_shard(p) for p in flat_p]
            slots = [{k: local_shard(t) for k, t in s.items()} for s in slots]
        for g, slot, p in zip(flat_g, slots, flat_p):
            rule.leaf(ctx, g, slot, p)
    return params, state


def _square_sum(g) -> torch.Tensor:
    """Σ g² in fp32 (``kernels.adamw.square_sum``: one launch on a card,
    slice by slice on the CPU).  A DTensor sums its local shard the same
    way, then across the mesh dims it is sharded over (a replicated dim
    holds the same elements on every rank and is counted once), so a 1×1
    mesh gives the unmeshed sum bit for bit."""
    total = kadamw.square_sum(_flat(local_shard(g).contiguous()),
                              chunk=CHUNK)
    if not is_dtensor(g):
        return total
    plc = [Partial() if isinstance(p, Shard) else Replicate()
           for p in g.placements]
    return DTensor.from_local(total, g.device_mesh, plc,
                              run_check=False).full_tensor()


def _flat(t: torch.Tensor) -> torch.Tensor:
    """A 1-d view of a contiguous tensor (writes go through)."""
    if not t.is_contiguous():
        raise ValueError("the optimizer updates contiguous tensors in "
                         "place; got a strided one")
    return t.view(-1)


def adamw(lr: float = 1e-4, b1: float = 0.9, b2: float = 0.95,
          eps: float = 1e-8, weight_decay: float = 0.0,
          grad_clip: float = 1.0) -> Optimizer:
    def init(params):
        def zeros(p):
            return torch.zeros(p.shape, dtype=torch.float32, device=p.device)
        step_device = leaves(params)[0].device
        return {"m": tree_map(zeros, params), "v": tree_map(zeros, params),
                "step": torch.zeros((), dtype=torch.int32,
                                    device=step_device)}

    def slots(state):
        return [{"m": m, "v": v} for m, v in zip(leaves(state["m"]),
                                                 leaves(state["v"]))]

    def begin(flat_g, state):
        state["step"].add_(1)
        step = state["step"].float()
        if grad_clip:
            total = torch.zeros((), dtype=torch.float32,
                                device=flat_g[0].device)
            for g in flat_g:
                total = total + _square_sum(g)
            gnorm = torch.sqrt(total)
            scale = torch.clamp(grad_clip / (gnorm + 1e-9), max=1.0)
        else:
            scale = torch.ones((), dtype=torch.float32,
                               device=flat_g[0].device)
        return {"scale": scale, "bc1": 1 - torch.pow(b1, step),
                "bc2": 1 - torch.pow(b2, step)}

    def leaf(ctx, g, slot, p):
        kadamw.adamw_leaf(*(_flat(t) for t in (g, slot["m"], slot["v"], p)),
                          ctx["scale"], ctx["bc1"], ctx["bc2"], b1=b1, b2=b2,
                          eps=eps, lr=lr, weight_decay=weight_decay,
                          chunk=CHUNK)

    rule = LeafRule(slots=slots, begin=begin, leaf=leaf, elementwise=True)
    return Optimizer(init=init,
                     update=lambda g, s, p: apply_rule(rule, g, s, p),
                     name="adamw", rule=rule)
