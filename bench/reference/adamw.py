"""AdamW with float32 moments over parameters held in the configured type:
a global-norm clip over all gradients, bias-corrected moments, the update
in float32, each new parameter rounded to ``param_dtype``."""
from __future__ import annotations

import torch


class AdamW:
    def __init__(self, lr=1e-4, b1=0.9, b2=0.95, eps=1e-8, weight_decay=0.0,
                 grad_clip=1.0, param_dtype=torch.bfloat16):
        self.lr, self.b1, self.b2, self.eps = lr, b1, b2, eps
        self.wd, self.clip, self.param_dtype = weight_decay, grad_clip, \
            param_dtype
        self.t = 0

    def init(self, params):
        return [torch.zeros_like(p) for p in params], \
            [torch.zeros_like(p) for p in params]

    @torch.no_grad()
    def step(self, params, grads, m, v):
        """One update of the float32 lists, in place."""
        self.t += 1
        scale = 1.0
        if self.clip:
            gnorm = torch.sqrt(sum(torch.sum(g * g) for g in grads))
            scale = torch.clamp(self.clip / (gnorm + 1e-9), max=1.0)
        bc1, bc2 = 1 - self.b1 ** self.t, 1 - self.b2 ** self.t
        for p, g, mi, vi in zip(params, grads, m, v):
            gs = g * scale
            mi.mul_(self.b1).add_((1 - self.b1) * gs)
            vi.mul_(self.b2).add_((1 - self.b2) * gs * gs)
            delta = (mi / bc1) / (torch.sqrt(vi / bc2) + self.eps)
            if self.wd:
                delta = delta + self.wd * p
            p.copy_((p - self.lr * delta).to(self.param_dtype).float())
