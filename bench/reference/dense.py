"""A dense decoder with grouped-query attention (InternLM2, arXiv:2403.17297):
pre-norm blocks of RMSNorm, causal attention with rotary positions
(rotate-half over the two halves of each head), and a SwiGLU FFN; a final
RMSNorm and an untied head.  Query head h reads key/value head h // G,
G = n_heads / n_kv_heads.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from .common import cross_entropy, per_layer, rms

Q_CHUNK = 1024      # query rows of attention's scores held at a time


class Dense:
    def __init__(self, cfg: dict, mat):
        self.c, self.mat = cfg, mat

    def _rope(self, x, pos):
        D = x.shape[-1]
        freqs = 1.0 / (self.c["rope_theta"] ** (torch.arange(
            0, D, 2, dtype=torch.float32, device=x.device) / D))
        ang = pos[:, None].float() * freqs                   # (S, D/2)
        cos, sin = torch.cos(ang)[:, None], torch.sin(ang)[:, None]
        x1, x2 = x.chunk(2, dim=-1)
        return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)

    def _attention(self, q, k, v):
        """q (B, S, H, D), k and v (B, S, K, D): causal softmax attention,
        a chunk of query rows at a time against the keys it may see."""
        B, S, H, D = q.shape
        G = H // k.shape[2]
        k = k.repeat_interleave(G, dim=2)
        v = v.repeat_interleave(G, dim=2)
        outs = []
        for q0 in range(0, S, Q_CHUNK):
            q1 = min(q0 + Q_CHUNK, S)
            s = self.mat("bqhd,bthd->bhqt", q[:, q0:q1], k[:, :q1]) / D ** 0.5
            qi = torch.arange(q0, q1, device=q.device)[:, None]
            ti = torch.arange(q1, device=q.device)[None, :]
            s = s.masked_fill(ti > qi, float("-inf"))
            outs.append(self.mat("bhqt,bthd->bqhd", torch.softmax(s, -1),
                                 v[:, :q1]))
        return torch.cat(outs, dim=1)

    def _layer(self, lp, x, pos):
        c, mat = self.c, self.mat
        a = lp["attn"]
        h = rms(x, lp["ln1"], c["norm_eps"])
        q = self._rope(mat("bsd,dhk->bshk", h, a["w_q"]), pos)
        k = self._rope(mat("bsd,dhk->bshk", h, a["w_k"]), pos)
        v = mat("bsd,dhk->bshk", h, a["w_v"])
        x = x + mat("bshk,hkd->bsd", self._attention(q, k, v), a["w_o"])
        f = lp["ffn"]
        h = rms(x, lp["ln2"], c["norm_eps"])
        u = F.silu(mat("bsd,df->bsf", h, f["w_gate"])) * \
            mat("bsd,df->bsf", h, f["w_up"])
        return x + mat("bsf,fd->bsd", u, f["w_down"])

    def hidden(self, p, tokens, remat: bool = False):
        """The final-normed states (B, S, d) of tokens (B, S); ``remat``
        recomputes each layer in the backward (``torch.utils.checkpoint``)
        so a training step holds one layer's activations at a time.  ``p``
        may be in the served type: each leaf is taken in float32 as it is
        used."""
        x = F.embedding(tokens.long(), p["embed"]).float()
        pos = torch.arange(tokens.shape[1], device=tokens.device)
        for lp in per_layer(p["layers"], self.c["n_layers"]):
            if remat:
                x = checkpoint(self._layer, lp, x, pos, use_reentrant=False)
            else:
                x = self._layer(lp, x, pos)
        return rms(x, p["final_norm"].float(), self.c["norm_eps"])

    def logits(self, p, tokens):
        return self.mat("bsd,dv->bsv", self.hidden(p, tokens),
                        p["head"].float())

    def loss(self, p, tokens, labels):
        h = self.hidden(p, tokens, remat=True)
        return cross_entropy(self.mat("bsd,dv->bsv", h, p["head"]), labels)
