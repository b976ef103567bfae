"""Decoder assembly: the forward of the rwkv, griffin and dense patterns.

The port of ``src/repro/models/transformer.py``'s ``loss`` path.  The
reference's ``lax.scan`` over stacked layer params (with per-layer
``jax.checkpoint``) is a Python loop over the stacked layer axis here; the
stacked trees keep the reference's layout (``layers``; griffin's
``periods`` of (R, R, A) plus a ``tail`` of R layers: 26 layers are 8
periods and 2 tail layers), so weights carry across unchanged
(``models.convert.params_from_numpy``).

``loss`` is the forward only, under ``torch.no_grad()``: the reference has
no gradient through its kernels either.  With ``use_pallas`` the wkv6,
rglru_scan and flash-attention CUDA kernels run (their plain versions for
CPU tensors).  ``prefill``, ``decode_step`` and ``init_cache`` wait for
the serving slice; MoE, ``moe_ep`` and ``kv_quant`` for later slices.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict

import torch

from .attention import attn_apply, attn_spec
from .layers import (P, cross_entropy, ffn_apply, ffn_spec, init_tree,
                     no_policy, rms_norm)
from .rglru import rglru_apply, rglru_spec
from .rwkv6 import rwkv6_channel_mix, rwkv6_spec, rwkv6_time_mix

__all__ = ["Transformer", "model_spec", "LOSS_CHUNK"]

LOSS_CHUNK = 512


# ---------------------------------------------------------------------------
# Param specs
# ---------------------------------------------------------------------------

def _attn_layer_spec(cfg, n: int) -> Dict[str, Any]:
    return {
        "ln1": P((n, cfg.d_model), ("layers", "embed"), init="ones"),
        "ln2": P((n, cfg.d_model), ("layers", "embed"), init="ones"),
        "attn": attn_spec(cfg, (n,), ("layers",)),
        "ffn": ffn_spec(cfg.d_model, cfg.d_ff, cfg.activation,
                        (n,), ("layers",)),
    }


def _rec_layer_spec(cfg, shape_prefix, name_prefix) -> Dict[str, Any]:
    pa, pn = tuple(shape_prefix), tuple(name_prefix)
    return {
        "ln1": P(pa + (cfg.d_model,), pn + ("embed",), init="ones"),
        "ln2": P(pa + (cfg.d_model,), pn + ("embed",), init="ones"),
        "rglru": rglru_spec(cfg, pa, pn),
        "ffn": ffn_spec(cfg.d_model, cfg.d_ff, cfg.activation, pa, pn),
    }


def _rwkv_layer_spec(cfg, n: int) -> Dict[str, Any]:
    return {
        "ln1": P((n, cfg.d_model), ("layers", "embed"), init="ones"),
        "ln2": P((n, cfg.d_model), ("layers", "embed"), init="ones"),
        "rwkv": rwkv6_spec(cfg, (n,), ("layers",)),
    }


def _unsupported(cfg) -> None:
    if cfg.is_moe:
        raise NotImplementedError(f"{cfg.name}: MoE layers come with a later "
                                  "slice of the port")
    if cfg.input_embeds or cfg.n_codebooks:
        raise NotImplementedError(f"{cfg.name}: embedding inputs and "
                                  "codebook heads come with a later slice "
                                  "of the port")


def model_spec(cfg) -> Dict[str, Any]:
    _unsupported(cfg)
    d, v = cfg.d_model, cfg.vocab
    spec: Dict[str, Any] = {
        "final_norm": P((d,), ("embed",), init="ones"),
        "embed": P((v, d), ("vocab", "embed")),
        "head": P((d, v), ("embed", "vocab")),
    }
    if cfg.layer_pattern == "rwkv":
        spec["layers"] = _rwkv_layer_spec(cfg, cfg.n_layers)
    elif cfg.layer_pattern == "griffin":
        n_periods, tail = divmod(cfg.n_layers, 3)
        spec["periods"] = {
            "rec": _rec_layer_spec(cfg, (n_periods, 2), ("layers", None)),
            "attn": _attn_layer_spec(cfg, n_periods),
        }
        if tail:
            spec["tail"] = _rec_layer_spec(cfg, (tail,), ("layers",))
    else:
        spec["layers"] = _attn_layer_spec(cfg, cfg.n_layers)
    return spec


# ---------------------------------------------------------------------------
# Layer bodies
# ---------------------------------------------------------------------------

def _index(tree: Dict[str, Any], i: int) -> Dict[str, Any]:
    """Layer i of a tree of stacked params (a view, no copy)."""
    return {k: _index(v, i) if isinstance(v, dict) else v[i]
            for k, v in tree.items()}


def _attn_block(lp, x, cfg, positions, window, use_pallas):
    xn = rms_norm(x, lp["ln1"], cfg.norm_eps)
    h = x + attn_apply(lp["attn"], xn, cfg, positions, window=window,
                       use_pallas=use_pallas)
    return h + ffn_apply(lp["ffn"], rms_norm(h, lp["ln2"], cfg.norm_eps),
                         cfg.activation)


def _rec_block(lp, x, cfg, use_pallas):
    xn = rms_norm(x, lp["ln1"], cfg.norm_eps)
    h = x + rglru_apply(lp["rglru"], xn, cfg, use_pallas=use_pallas)
    return h + ffn_apply(lp["ffn"], rms_norm(h, lp["ln2"], cfg.norm_eps),
                         cfg.activation)


def _rwkv_block(lp, x, cfg, use_pallas):
    o, _ = rwkv6_time_mix(lp["rwkv"]["tm"],
                          rms_norm(x, lp["ln1"], cfg.norm_eps), cfg,
                          use_pallas=use_pallas)
    h = x + o
    o2, _ = rwkv6_channel_mix(lp["rwkv"]["cm"],
                              rms_norm(h, lp["ln2"], cfg.norm_eps), cfg)
    return h + o2


# ---------------------------------------------------------------------------
# The model
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class Transformer:
    cfg: Any
    use_pallas: bool = False
    moe_ep: bool = False
    kv_quant: bool = False

    def __post_init__(self):
        _unsupported(self.cfg)
        if self.moe_ep:
            raise NotImplementedError("moe_ep (expert-parallel MoE) comes "
                                      "with the mesh slice of the port")
        if self.kv_quant:
            raise NotImplementedError("kv_quant (int8 KV cache) comes with "
                                      "the serving slice of the port")

    # ---- params ----------------------------------------------------------
    def spec(self):
        return model_spec(self.cfg)

    def init(self, generator: torch.Generator, device=None, dtype=None):
        """Random params from ``generator`` (which lives on ``device``).
        ``device`` defaults to ``cuda`` and raises without a card; pass
        ``device="cpu"`` to build them on the host."""
        device = torch.device("cuda" if device is None else device)
        if device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("Transformer.init: no CUDA device is "
                               "available (pass device='cpu' to build the "
                               "params on the host explicitly)")
        dt = dtype or getattr(torch, self.cfg.dtype)
        return init_tree(self.spec(), generator, device, dt)

    # ---- forward ---------------------------------------------------------
    def _backbone(self, params, x, positions):
        cfg, use_pallas = self.cfg, self.use_pallas
        if cfg.layer_pattern == "rwkv":
            for i in range(cfg.n_layers):
                x = _rwkv_block(_index(params["layers"], i), x, cfg,
                                use_pallas)
        elif cfg.layer_pattern == "griffin":
            n_periods = cfg.n_layers // 3
            for i in range(n_periods):
                period = _index(params["periods"], i)
                for j in range(2):
                    x = _rec_block(_index(period["rec"], j), x, cfg,
                                   use_pallas)
                x = _attn_block(period["attn"], x, cfg, positions,
                                cfg.local_window, use_pallas)
            for i in range(cfg.n_layers % 3):
                x = _rec_block(_index(params["tail"], i), x, cfg, use_pallas)
        else:
            for i in range(cfg.n_layers):
                x = _attn_block(_index(params["layers"], i), x, cfg,
                                positions, 0, use_pallas)
        return x

    @torch.no_grad()
    def hidden(self, params, batch):
        """The final-normed hidden states (B, S, d_model) of batch's tokens
        (B, S): what ``loss`` feeds the head."""
        x = params["embed"][batch["tokens"]]
        B, S, _ = x.shape
        positions = torch.arange(S, device=x.device).expand(B, S)
        h = self._backbone(params, x, positions)
        return rms_norm(h, params["final_norm"], self.cfg.norm_eps)

    @torch.no_grad()
    def loss(self, params, batch, policy=None):
        """batch: tokens (B, S) + labels (B, S).  Returns (loss, metrics).
        The CE is taken over chunks of ``LOSS_CHUNK`` tokens, so
        (B, S, vocab) logits are never built."""
        no_policy(policy)
        h = self.hidden(params, batch)
        S = h.shape[1]
        labels = batch["labels"]
        n_chunks = max(S // LOSS_CHUNK, 1)
        if S % n_chunks:
            raise ValueError(f"S={S} does not split into {n_chunks} loss "
                             "chunks")
        C = S // n_chunks
        total = 0.0
        for c in range(n_chunks):
            logits = (h[:, c * C:(c + 1) * C] @ params["head"]).float()
            total = total + cross_entropy(logits, labels[:, c * C:(c + 1) * C])
        ce = total / n_chunks
        return ce, {"ce": ce, "aux": 0.0}

    def prefill(self, *args, **kwargs):
        raise NotImplementedError("prefill comes with the serving slice of "
                                  "the port")

    def decode_step(self, *args, **kwargs):
        raise NotImplementedError("decode_step comes with the serving slice "
                                  "of the port")

    def init_cache(self, *args, **kwargs):
        raise NotImplementedError("init_cache comes with the serving slice "
                                  "of the port")
