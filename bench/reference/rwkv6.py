"""RWKV-6 "Finch" (arXiv:2404.05892) as the program states it.  Per layer:
x + TimeMix(RMSNorm(x)), then + ChannelMix(RMSNorm(·)).  TimeMix mixes
each token with the previous one through data-dependent lerps (a low-rank
tanh adapter of rank 32 per input), projects r, k, v and a SiLU gate g,
takes the decay w_t = exp(-exp(w0 + lora_w(x))), and runs per head of
size hs, from a zero state S,

    o_t = r_t · (S + u ⊙ k_t ⊗ v_t),    S ← diag(w_t) S + k_t ⊗ v_t,

then an RMSNorm per head (weight 1, eps 1e-6) times ln_x, times g, and
the output projection.  ChannelMix: sigmoid(r) · (relu(k)² W_v) over a
plain token-shift lerp.  A final RMSNorm and an untied head.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .common import per_layer, rms

MIX = ("w", "k", "v", "r", "g")


def _shift(x):
    """The previous token's row (zeros before the first)."""
    return torch.cat([torch.zeros_like(x[:, :1]), x[:, :-1]], dim=1)


class RWKV6:
    def __init__(self, cfg: dict, mat):
        self.c, self.mat = cfg, mat

    def _time_mix(self, p, x):
        mat, hs = self.mat, self.c["rwkv_head_size"]
        B, T, d = x.shape
        H = d // hs
        xx = _shift(x) - x
        inner = x + xx * p["mu_x"]

        def lerp(z):
            lora = mat("btr,rd->btd", torch.tanh(mat(
                "btd,dr->btr", inner, p[f"lora_a_{z}"])), p[f"lora_b_{z}"])
            return x + xx * (p[f"mu_{z}"] + lora)
        xs = {z: lerp(z) for z in MIX}
        r, k, v = (mat("btd,de->bte", xs[z], p[f"w_{z}"]).reshape(B, T, H, hs)
                   for z in ("r", "k", "v"))
        g = F.silu(mat("btd,de->bte", xs["g"], p["w_g"]))
        dec = p["w0"] + mat("btr,rd->btd", torch.tanh(mat(
            "btd,dr->btr", xs["w"], p["lora_a_w"])), p["lora_b_w"])
        w = torch.exp(-torch.exp(dec)).reshape(B, T, H, hs)
        u = p["u"].reshape(H, hs)[..., None]
        s = torch.zeros((B, H, hs, hs), dtype=x.dtype, device=x.device)
        o = []
        for t in range(T):
            kv = k[:, t, :, :, None] * v[:, t, :, None, :]
            o.append(torch.einsum("bhi,bhij->bhj", r[:, t], s + u * kv))
            s = w[:, t, :, :, None] * s + kv
        o = torch.stack(o, dim=1)                         # (B, T, H, hs)
        o = rms(o, 1.0, 1e-6).reshape(B, T, d) * p["ln_x"]
        return mat("btd,de->bte", o * g, p["w_out"])

    def _channel_mix(self, p, x):
        mat = self.mat
        xx = _shift(x) - x
        kk = torch.square(F.relu(mat("btd,df->btf", x + xx * p["mu_k"],
                                     p["w_k"])))
        kv = mat("btf,fd->btd", kk, p["w_v"])
        return torch.sigmoid(mat("btd,de->bte", x + xx * p["mu_r"],
                                 p["w_r"])) * kv

    def logits(self, p, tokens):
        eps = self.c["norm_eps"]
        x = F.embedding(tokens.long(), p["embed"]).float()
        for lp in per_layer(p["layers"], self.c["n_layers"]):
            h = x + self._time_mix(lp["rwkv"]["tm"], rms(x, lp["ln1"], eps))
            x = h + self._channel_mix(lp["rwkv"]["cm"],
                                      rms(h, lp["ln2"], eps))
        return self.mat("btd,dv->btv", rms(x, p["final_norm"].float(), eps),
                        p["head"].float())
