"""Adafactor (Shazeer & Stern, 2018): factored second moments, the default
for arctic-480b, whose full Adam fp32 state would not fit one pod's HBM.

The port of ``src/repro/optim/adafactor.py``, with its ``beta``, ``eps``
and RMS clip.  Params with ndim >= 2 keep row/column factor vectors
``vr``/``vc`` over their two trailing dims (leading stack dims ride
along) instead of a full second moment; the others keep a full ``v``.
The state tree is ``{"factors", "step"}``.  Updates are in place under
``torch.no_grad()``, as AdamW's (``adamw.py``); the RMS clip reads a
whole leaf, so a leaf is updated whole.
"""
from __future__ import annotations

import torch

from ..tree import leaves, tree_map
from .adamw import LeafRule, Optimizer, apply_rule

__all__ = ["adafactor"]


def _is_factor(x) -> bool:
    return isinstance(x, dict) and ("v" in x or "vr" in x)


def adafactor(lr: float = 1e-3, decay: float = 0.8, eps: float = 1e-30,
              clip_threshold: float = 1.0) -> Optimizer:
    def init(params):
        def state_for(p):
            z = dict(dtype=torch.float32, device=p.device)
            if p.ndim >= 2:
                return {"vr": torch.zeros(p.shape[:-1], **z),
                        "vc": torch.zeros(p.shape[:-2] + p.shape[-1:], **z)}
            return {"v": torch.zeros(p.shape, **z)}
        return {"factors": tree_map(state_for, params),
                "step": torch.zeros((), dtype=torch.int32,
                                    device=leaves(params)[0].device)}

    def slots(state):
        return leaves(state["factors"], is_leaf=_is_factor)

    def begin(flat_g, state):
        state["step"].add_(1)
        return {"beta": 1.0 - (state["step"].float() + 1.0) ** (-decay)}

    def leaf(ctx, g, s, p):
        beta = ctx["beta"]
        g = g.to(torch.float32)
        g2 = torch.square(g) + eps
        if p.ndim >= 2:
            s["vr"].copy_(beta * s["vr"] + (1 - beta) * g2.mean(dim=-1))
            s["vc"].copy_(beta * s["vc"] + (1 - beta) * g2.mean(dim=-2))
            vr, vc = s["vr"], s["vc"]
            denom = torch.sqrt(
                vr[..., None] * vc[..., None, :] /
                torch.clamp(vr.mean(dim=-1, keepdim=True)[..., None],
                            min=eps))
        else:
            s["v"].copy_(beta * s["v"] + (1 - beta) * g2)
            denom = torch.sqrt(s["v"])
        del g2
        u = g / torch.clamp(denom, min=eps)
        del denom
        rms = torch.sqrt(torch.mean(torch.square(u)) + eps)
        u = u / torch.clamp(rms / clip_threshold, min=1.0)
        p.copy_(p.to(torch.float32) - lr * u)

    rule = LeafRule(slots=slots, begin=begin, leaf=leaf)
    return Optimizer(init=init,
                     update=lambda g, s, p: apply_rule(rule, g, s, p),
                     name="adafactor", rule=rule)
