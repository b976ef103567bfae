"""The parameter tree both sides are handed, and its seeded values.

The tree's keys and stacked shapes are the layout the program takes
(one leaf per kind of weight, layers stacked on the first axis).  Values
come from ``--seed`` alone: one ``torch.Generator`` on the device, one
``normal_`` call per stacked leaf in sorted key order, in the type the
model is served in, then an affine map per leaf.  The same seed, device
type and dtype give the same tensors, so the reference regenerates the
program's starting weights instead of copying them.

Scales: a matrix is N(0, 1/fan_in) over its true input features, so
projections keep unit scale and the head's logits spread about 1; the
projections that write into the residual stream (attention's w_o, the
FFN's w_down, RWKV-6's w_out and channel-mix w_v) take a further
1/sqrt(2·n_layers), the scaled init of GPT-2 and Megatron, so the stream
grows as a trained model's does and not as a random walk of unit steps;
norm weights are 1 + 0.1·N; RWKV-6's token-shift mixes 0.5 + 0.1·N, its
decay bias w0 = -1 + 0.3·N (decays near exp(-exp(-1)) = 0.69), its bonus
u 0.1·N and its low-rank up-projections 0.1/sqrt(32)·N.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Tuple

import torch

LORA_R = 32
MIX = ("w", "k", "v", "r", "g")

# (shape, kind, fan_in): kind picks the affine map in ``_init``
Leaf = Tuple[Tuple[int, ...], str, int]


def _dense(c) -> Dict[str, Any]:
    n, d, H, K, D, f, V = (c[k] for k in ("n_layers", "d_model", "n_heads",
                                          "n_kv_heads", "d_head", "d_ff",
                                          "vocab"))
    return {
        "embed": ((V, d), "matrix", d),
        "head": ((d, V), "matrix", d),
        "final_norm": ((d,), "norm", 0),
        "layers": {
            "ln1": ((n, d), "norm", 0),
            "ln2": ((n, d), "norm", 0),
            "attn": {"w_q": ((n, d, H, D), "matrix", d),
                     "w_k": ((n, d, K, D), "matrix", d),
                     "w_v": ((n, d, K, D), "matrix", d),
                     "w_o": ((n, H, D, d), "out", H * D)},
            "ffn": {"w_gate": ((n, d, f), "matrix", d),
                    "w_up": ((n, d, f), "matrix", d),
                    "w_down": ((n, f, d), "out", f)},
        },
    }


def _rwkv6(c) -> Dict[str, Any]:
    n, d, f, V = (c[k] for k in ("n_layers", "d_model", "d_ff", "vocab"))
    tm: Dict[str, Any] = {
        "mu_x": ((n, d), "mix", 0), "w0": ((n, d), "decay", 0),
        "u": ((n, d), "bonus", 0), "ln_x": ((n, d), "norm", 0),
        "w_out": ((n, d, d), "out", d),
    }
    for z in MIX:
        tm[f"mu_{z}"] = ((n, d), "mix", 0)
        tm[f"lora_a_{z}"] = ((n, d, LORA_R), "matrix", d)
        tm[f"lora_b_{z}"] = ((n, LORA_R, d), "lora_up", 0)
        if z != "w":
            tm[f"w_{z}"] = ((n, d, d), "matrix", d)
    cm = {"mu_k": ((n, d), "mix", 0), "mu_r": ((n, d), "mix", 0),
          "w_k": ((n, d, f), "matrix", d), "w_v": ((n, f, d), "out", f),
          "w_r": ((n, d, d), "matrix", d)}
    return {
        "embed": ((V, d), "matrix", d),
        "head": ((d, V), "matrix", d),
        "final_norm": ((d,), "norm", 0),
        "layers": {"ln1": ((n, d), "norm", 0), "ln2": ((n, d), "norm", 0),
                   "rwkv": {"tm": tm, "cm": cm}},
    }


def layout(cfg: dict) -> Dict[str, Any]:
    """The tree of (shape, kind, fan_in) of a configuration file."""
    if cfg["family"] == "dense":
        return _dense(cfg)
    if cfg["family"] == "rwkv6":
        return _rwkv6(cfg)
    raise ValueError(f"no layout for family {cfg['family']!r}")


def _init(t: torch.Tensor, kind: str, fan_in: int, n_layers: int):
    if kind == "matrix":
        return t.mul_(1.0 / math.sqrt(fan_in))
    if kind == "out":
        return t.mul_(1.0 / math.sqrt(fan_in * 2 * n_layers))
    scale, shift = {"norm": (0.1, 1.0), "mix": (0.1, 0.5),
                    "decay": (0.3, -1.0), "bonus": (0.1, 0.0),
                    "lora_up": (0.1 / math.sqrt(LORA_R), 0.0)}[kind]
    return t.mul_(scale).add_(shift)


def make_params(cfg: dict, seed: int, device, dtype=torch.bfloat16):
    """The seeded parameters of ``cfg`` on ``device`` in ``dtype``."""
    gen = torch.Generator(device).manual_seed(int(seed))

    def walk(tree):
        out = {}
        for k in sorted(tree):
            v = tree[k]
            if isinstance(v, dict):
                out[k] = walk(v)
            else:
                shape, kind, fan_in = v
                t = torch.empty(shape, dtype=dtype, device=device)
                out[k] = _init(t.normal_(generator=gen), kind, fan_in,
                               cfg["n_layers"])
        return out
    return walk(layout(cfg))

