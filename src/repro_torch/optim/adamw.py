"""AdamW with fp32 state over params of any type.

The port of ``src/repro/optim/adamw.py``, with its formula term for term:
fp32 ``m``/``v``, a global-norm clip taken in fp32 over all leaves, bias
correction with the step as fp32, the update computed in fp32 and cast
back to the param's type.  The state tree is ``{"m", "v", "step"}``, with
``step`` a 0-d int32 tensor.

Where the reference donates its buffers to a jitted step, the port
updates in place under ``torch.no_grad()``: ``update`` writes the new
values into ``params`` and ``state`` and returns those trees.  It walks
each leaf in slices of ``CHUNK`` elements, so the fp32 temporaries of an
update never exceed two slices (one fp32 copy of qwen2.5-14b's 778 M-
element ``embed`` alone would be 3.1 GB); the arithmetic is elementwise,
so slicing changes no value.

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

from ..tree import leaves, tree_map

__all__ = ["adamw", "Optimizer", "LeafRule", "apply_rule", "CHUNK",
           "UPDATE_RANGE"]

CHUNK = 1 << 26          # elements of a leaf updated at a time (256 MB fp32)
UPDATE_RANGE = "optimizer.update"      # the profiler range of an update


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


@torch.no_grad()
def apply_rule(rule: LeafRule, grads, state, params):
    """Run ``rule`` over the whole tree, in place; returns (params,
    state)."""
    with torch.profiler.record_function(UPDATE_RANGE):
        flat_g = leaves(grads)
        ctx = rule.begin(flat_g, state)
        for g, slot, p in zip(flat_g, rule.slots(state), leaves(params)):
            rule.leaf(ctx, g, slot, p)
    return params, state


def _slices(n: int):
    for lo in range(0, n, CHUNK):
        yield lo, min(lo + CHUNK, n)


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
                gf = _flat(g)
                for lo, hi in _slices(gf.numel()):
                    total = total + torch.square(
                        gf[lo:hi].to(torch.float32)).sum()
            gnorm = torch.sqrt(total)
            scale = torch.clamp(grad_clip / (gnorm + 1e-9), max=1.0)
        else:
            scale = torch.ones((), dtype=torch.float32,
                               device=flat_g[0].device)
        return {"scale": scale, "bc1": 1 - torch.pow(b1, step),
                "bc2": 1 - torch.pow(b2, step)}

    def leaf(ctx, g, slot, p):
        gf, mf, vf, pf = (_flat(t) for t in (g, slot["m"], slot["v"], p))
        for lo, hi in _slices(pf.numel()):
            m, v, pc = mf[lo:hi], vf[lo:hi], pf[lo:hi]
            gs = gf[lo:hi].to(torch.float32) * ctx["scale"]
            t = gs * (1 - b1)
            m.mul_(b1).add_(t)                       # b1 m + (1 - b1) g
            torch.square(gs, out=t)
            v.mul_(b2).add_(t.mul_(1 - b2))          # b2 v + (1 - b2) g²
            torch.div(v, ctx["bc2"], out=t)
            t.sqrt_().add_(eps)                      # sqrt(v̂) + eps
            torch.div(m, ctx["bc1"], out=gs)
            gs.div_(t)                               # m̂ / (sqrt(v̂) + eps)
            if weight_decay:
                torch.mul(pc.to(torch.float32), weight_decay, out=t)
                gs.add_(t)
            torch.sub(pc, gs.mul_(lr), out=t)        # p - lr · delta, fp32
            pc.copy_(t)

    rule = LeafRule(slots=slots, begin=begin, leaf=leaf, elementwise=True)
    return Optimizer(init=init,
                     update=lambda g, s, p: apply_rule(rule, g, s, p),
                     name="adamw", rule=rule)
