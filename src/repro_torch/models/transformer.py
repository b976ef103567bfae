"""Decoder assembly for all assigned architectures: the rwkv, griffin and
full-attention patterns, dense or MoE, over tokens or embeddings.

The port of ``src/repro/models/transformer.py``.  The reference's
``lax.scan`` over stacked layer params (with per-layer
``jax.checkpoint``) is a Python loop over the stacked layer axis here; the
stacked trees keep the reference's layout (``layers``; griffin's
``periods`` of (R, R, A) plus a ``tail`` of R layers: 26 layers are 8
periods and 2 tail layers), so weights carry across unchanged
(``models.convert.params_from_numpy``).

Three entry points, as in the reference:
  * ``loss`` — differentiable, as the reference's, which
    ``jax.value_and_grad`` trains on.  When autograd records (grad
    enabled and a param that requires grad), each layer runs under
    ``torch.utils.checkpoint`` — griffin's per period of (R, R, A) and
    per tail layer — so the backward recomputes it, as the reference's
    per-layer ``jax.checkpoint`` does; params that require no grad build
    no graph.  With ``use_pallas`` the wkv6, rglru_scan and flash-attention
    CUDA kernels run (their plain versions for CPU tensors): flash has a
    backward (``kernels/ops.py``), wkv6 and rglru_scan raise under grad,
    as the reference's ``jax.grad`` does.  MoE layers add the router's
    aux loss, summed over the layers in fp32 as the reference's scan
    carry sums it.  ``hidden`` is the forward only, under
    ``torch.no_grad()``;
  * ``prefill`` — the forward over a prompt that also builds the serving
    cache (KV / ring buffer / recurrent state per layer kind).  It runs
    no kernel, as the reference's collect mode: ``blockwise_attention``
    and the sequential scans;
  * ``decode_step`` — one token for the whole stack against the cache,
    which it writes IN PLACE (the serving engine's pool is allocated once
    and never replaced) and returns.

The cache trees keep the reference's keys, layer-stacked layouts and
dtypes, so they compare leaf by leaf.  ``input_embeds`` archs (musicgen)
take ``{"embeds": (B, S, d)}`` through ``in_proj`` instead of tokens, and
their head returns ``n_codebooks`` logits a position, (..., n_codebooks,
vocab).

On a mesh the params, the batch and the cache are DTensors
(``distributed/sharding.py``) and every entry point takes a ``policy``
(``MeshPolicy``) that redistributes at the reference's tagged points;
the kernels and the scans run on each rank's shards (``local_map``).
``moe_ep`` takes the expert-parallel MoE (``moe_apply_ep``) in ``loss``
and ``prefill`` when a policy is given, as the reference does.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict

import torch
import torch.nn.functional as F
from torch.distributed.tensor import Replicate, Shard
from torch.utils.checkpoint import checkpoint

from ..tree import leaves
from .attention import (attn_apply, attn_decode, attn_spec, init_kv_cache,
                        quantize_kv_cache)
from ..distributed.sharding import (assign, at_use, from_global,
                                    is_dtensor, like, local_apply, moved,
                                    pmax, psum, reduced, split_dim, whole)
from .layers import (P, acts, axes_tree, cross_entropy, ffn_apply, ffn_spec,
                     init_tree, rms_norm)
from .moe import moe_apply, moe_apply_ep, moe_spec
from .rglru import (init_rglru_cache, rglru_apply, rglru_decode,
                    rglru_spec)
from .rwkv6 import (init_rwkv_cache, rwkv6_channel_mix, rwkv6_spec,
                    rwkv6_time_mix)

__all__ = ["Transformer", "model_spec", "LOSS_CHUNK"]

LOSS_CHUNK = 512


# ---------------------------------------------------------------------------
# Param specs
# ---------------------------------------------------------------------------

def _attn_layer_spec(cfg, n: int) -> Dict[str, Any]:
    spec = {
        "ln1": P((n, cfg.d_model), ("layers", "embed"), init="ones"),
        "ln2": P((n, cfg.d_model), ("layers", "embed"), init="ones"),
        "attn": attn_spec(cfg, (n,), ("layers",)),
    }
    if cfg.is_moe:
        spec["moe"] = moe_spec(cfg, (n,), ("layers",))
    else:
        spec["ffn"] = ffn_spec(cfg.d_model, cfg.d_ff, cfg.activation,
                               (n,), ("layers",))
    return spec


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


def model_spec(cfg) -> Dict[str, Any]:
    d, v = cfg.d_model, cfg.vocab
    spec: Dict[str, Any] = {
        "final_norm": P((d,), ("embed",), init="ones"),
    }
    if cfg.input_embeds:
        spec["in_proj"] = P((d, d), ("embed", "embed_out"))
    else:
        spec["embed"] = P((v, d), ("vocab", "embed"))
    spec["head"] = P((d, max(cfg.n_codebooks, 1) * v), ("embed", "vocab"))
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


def _layers(tree: Dict[str, Any], n: int):
    """The n per-layer trees of a tree of stacked params: views from one
    ``unbind`` per leaf, whose backward stacks the layers' gradients once
    (indexing layer by layer would give each layer a zero gradient of the
    whole stack to add up)."""
    per_leaf = {k: _layers(v, n) if isinstance(v, dict) else v.unbind(0)
                for k, v in tree.items()}
    return [{k: per_leaf[k][i] for k in tree} for i in range(n)]


def _stack(caches):
    """Stack a list of per-layer cache trees along a new leading axis."""
    return {k: _stack([c[k] for c in caches]) if isinstance(caches[0][k], dict)
            else torch.stack([c[k] for c in caches]) for k in caches[0]}


def _ring_cache_from_kv(k, v, window: int):
    """Pack the last ``window`` (roped) k/v into a ring buffer laid out by
    absolute position % window (the decode-side slot rule)."""
    B, S, K, D = k.shape
    W = min(window, S)
    pos = torch.arange(S - W, S, device=k.device)
    slot = pos % window if S >= window else pos
    ck = torch.zeros((B, window, K, D), dtype=k.dtype, device=k.device)
    cv = torch.zeros((B, window, K, D), dtype=v.dtype, device=v.device)
    cpos = torch.full((B, window), -1, dtype=torch.int32, device=k.device)
    ck[:, slot] = k[:, -W:]
    cv[:, slot] = v[:, -W:]
    cpos[:, slot] = pos.to(torch.int32)
    return {"k": ck, "v": cv, "pos": cpos}


def _full_cache_from_kv(k, v, max_seq: int):
    B, S, K, D = k.shape
    ck = torch.zeros((B, max_seq, K, D), dtype=k.dtype, device=k.device)
    cv = torch.zeros((B, max_seq, K, D), dtype=v.dtype, device=v.device)
    cpos = torch.full((B, max_seq), -1, dtype=torch.int32, device=k.device)
    ck[:, :S] = k
    cv[:, :S] = v
    cpos[:, :S] = torch.arange(S, dtype=torch.int32, device=k.device)
    return {"k": ck, "v": cv, "pos": cpos}


def _ffn_or_moe(lp, x, cfg, policy=None, moe_ep=False):
    """The block's FFN: (out, aux), aux the router's loss (0.0 if dense).
    ``moe_ep`` with a policy, on a mesh, takes the expert-parallel MoE."""
    if cfg.is_moe:
        if moe_ep and policy is not None and is_dtensor(x):
            return moe_apply_ep(lp["moe"], x, cfg, policy.mesh,
                                policy=policy)
        return moe_apply(lp["moe"], x, cfg, policy=policy)
    return ffn_apply(lp["ffn"], x, cfg.activation, policy=policy), 0.0


def _attn_block(lp, x, cfg, positions, window, use_pallas, collect=False,
                max_seq=0, policy=None, moe_ep=False):
    """Returns (x, aux, cache); cache is {} unless ``collect`` (prefill),
    which runs ``blockwise_attention`` as the reference's collect mode
    does."""
    xn = acts(policy, rms_norm(x, lp["ln1"], cfg.norm_eps), "block_in")
    attn_out, (k, v) = attn_apply(
        lp["attn"], xn, cfg, positions, window=window,
        use_pallas=use_pallas and not collect,
        policy=None if collect else policy)
    if not collect:
        cache = {}
    else:
        # per row and head: on a mesh each rank packs its own shards
        plc = None if not is_dtensor(k) else (
            k.placements, k.placements, moved(k.placements, {0: 0}))
        cache = local_apply(
            lambda k, v: _ring_cache_from_kv(k, v, window) if window
            else _full_cache_from_kv(k, v, max_seq), plc, k, v)
    h = x + attn_out
    hn = acts(policy, rms_norm(h, lp["ln2"], cfg.norm_eps), "block_in")
    f, aux = _ffn_or_moe(lp, hn, cfg, policy, moe_ep)
    return acts(policy, h + f, "embeds"), aux, cache


def _rec_block(lp, x, cfg, use_pallas, collect=False, policy=None):
    o, (h_last, conv) = rglru_apply(
        lp["rglru"], rms_norm(x, lp["ln1"], cfg.norm_eps), cfg,
        use_pallas=use_pallas and not collect)
    cache = {"h": h_last, "conv": conv} if collect else {}
    h = x + o
    h = h + ffn_apply(lp["ffn"], rms_norm(h, lp["ln2"], cfg.norm_eps),
                      cfg.activation, policy=policy)
    return acts(policy, h, "embeds"), cache


def _rwkv_block(lp, x, cfg, use_pallas, collect=False, policy=None):
    o, (tm_x, state) = rwkv6_time_mix(
        lp["rwkv"]["tm"], rms_norm(x, lp["ln1"], cfg.norm_eps), cfg,
        policy=policy, use_pallas=use_pallas and not collect)
    h = x + o
    o2, cm_x = rwkv6_channel_mix(lp["rwkv"]["cm"],
                                 rms_norm(h, lp["ln2"], cfg.norm_eps), cfg)
    cache = ({"tm_x": tm_x, "cm_x": cm_x, "state": state} if collect
             else {})
    return acts(policy, h + o2, "embeds"), cache


def _embedding(tokens, table):
    """``F.embedding(tokens, table)``.  On a mesh the table is gathered
    over its FSDP axes and stays split by vocab rows over "model": each
    rank looks up the tokens its rows hold (zeros elsewhere), and the
    partial results sum over "model" where they are next used."""
    if not is_dtensor(table):
        return F.embedding(tokens, table)
    from torch.distributed.tensor import Partial
    from torch.distributed.tensor.experimental import local_map
    mesh = table.device_mesh
    t_plc = tuple(p if p == Shard(0) else Replicate()
                  for p in table.placements)
    table = table.redistribute(placements=t_plc)
    tokens = like(tokens, table) if not is_dtensor(tokens) else tokens
    k_plc = tuple(tokens.placements)
    if any(a == Shard(0) and not isinstance(b, Replicate)
           for a, b in zip(t_plc, k_plc)):
        raise ValueError("tokens and vocab rows sharded over one mesh axis")
    V = table.shape[0]
    base = from_global(torch.arange(V, device=tokens.device), mesh, t_plc)
    out_plc = tuple(Partial() if a == Shard(0) else b
                    for a, b in zip(t_plc, k_plc))
    grad_plc = tuple(a if a == Shard(0) else
                     (Partial() if isinstance(b, Shard) else Replicate())
                     for a, b in zip(t_plc, k_plc))

    def body(tok, tab, rows):
        idx = tok.long() - rows[0]
        hit = (idx >= 0) & (idx < tab.shape[0])
        out = F.embedding(torch.where(hit, idx, torch.zeros_like(idx)), tab)
        return out * hit[..., None].to(out.dtype)
    out = local_map(body, out_placements=list(out_plc),
                    in_placements=(k_plc, t_plc, t_plc),
                    in_grad_placements=(k_plc, grad_plc, t_plc),
                    device_mesh=mesh)(tokens, table, base)
    # summed at once: a partial output must not meet a sharded gradient
    return out.redistribute(placements=tuple(
        Replicate() if isinstance(p, Partial) else p for p in out_plc))


def _cross_entropy(logits, labels):
    """``cross_entropy``.  On a mesh each rank takes the rows it holds:
    partial logits (a head that contracted a split d) are summed first,
    and where the vocab dim is split the row statistics (the max, the
    sum of exponentials, the gold logit, picked by a one-hot over the
    rank's vocab ids) are summed over the ranks that split it, so the
    loss rows leave replicated over them and the scalar loss is partial
    over the batch axes alone (one all-reduce)."""
    if not is_dtensor(logits):
        return cross_entropy(logits, labels)
    logits = reduced(logits)
    mesh, last = logits.device_mesh, logits.ndim - 1
    split = [i for i, p in enumerate(logits.placements) if p == Shard(last)]
    ids = from_global(torch.arange(logits.shape[-1], device=logits.device),
                      mesh, tuple(Shard(0) if i in split else Replicate()
                                  for i in range(mesh.ndim)))
    rows = tuple(Replicate() if i in split else p
                 for i, p in enumerate(logits.placements))

    def body(lg, lab, ids):
        m = pmax(lg.amax(dim=-1, keepdim=True), mesh, split)
        s = psum(torch.exp(lg - m).sum(dim=-1, keepdim=True), mesh, split,
                 replicated=True)
        logz = (m + torch.log(s))[..., 0]
        onehot = (lab.long()[..., None] == ids).to(lg.dtype)
        gold = psum((lg * onehot).sum(dim=-1), mesh, split, replicated=True)
        mask = (lab != -1).to(lg.dtype)
        return (logz - gold) * mask, mask
    loss, mask = local_apply(body, (list(rows), list(rows)), logits,
                             like(labels, logits), ids)
    return loss.sum() / torch.clamp(mask.sum(), min=1.0)


# ---------------------------------------------------------------------------
# The model
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class Transformer:
    cfg: Any
    use_pallas: bool = False
    moe_ep: bool = False
    kv_quant: bool = False

    # ---- params ----------------------------------------------------------
    def spec(self):
        return model_spec(self.cfg)

    def logical_axes(self):
        """The logical-axis tuples of every param, parallel to them."""
        return axes_tree(self.spec())

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

    def abstract_params(self, dtype=None):
        """The params as ``meta`` tensors: shapes and types, no storage."""
        dt = dtype or getattr(torch, self.cfg.dtype)
        return init_tree(self.spec(), None, "meta", dt)

    # ---- forward ---------------------------------------------------------
    def _embed(self, params, batch, policy=None, kind="embeds"):
        """(B, S, d) inputs: the token embeddings, or ``embeds`` cast to the
        config's type through ``in_proj`` for ``input_embeds`` archs."""
        if self.cfg.input_embeds:
            x = batch["embeds"].to(getattr(torch, self.cfg.dtype)) \
                @ params["in_proj"]
        else:
            # F.embedding, not indexing: its backward sums a token's rows
            # in a fixed order on the CPU and the card, where indexing's
            # accumulating scatter adds them in parallel, in any order,
            # and a resumed run would not be bitwise the straight one
            x = _embedding(batch["tokens"], params["embed"])
        return acts(policy, x, kind)

    def _head(self, params, h):
        """Logits of final-normed states: (..., vocab), or (...,
        n_codebooks, vocab) for codebook archs.  On a mesh a head split by
        vocab rows gathers h's d and gives logits split by vocab; any
        other head contracts h's d where h splits it, and its logits are
        partial sums (reduced where they are next used)."""
        head = params["head"]
        if is_dtensor(head) and any(p == Shard(1) for p in head.placements):
            h = whole(h, -1)
        logits = h @ at_use(head, h, {h.ndim - 1: 0})
        if self.cfg.n_codebooks:
            logits = split_dim(logits, -1, (self.cfg.n_codebooks,
                                            self.cfg.vocab))
        return logits

    def _backbone(self, params, x, positions, *, collect=False, max_seq=0,
                  policy=None):
        """Run all layers.  Returns (hidden, aux, caches): aux is the MoE
        router loss summed over the layers (0.0 without MoE); caches is {}
        unless ``collect``, else the stacked cache tree ``init_cache`` lays
        out.  When autograd records, each ``jax.checkpoint`` body of the
        reference (a layer; griffin's period and tail layer) runs under
        ``torch.utils.checkpoint``."""
        cfg, use_pallas = self.cfg, self.use_pallas
        remat = torch.is_grad_enabled() and any(
            t.requires_grad for t in leaves(params))

        def run(body, *args):
            if not remat:
                return body(*args)
            return checkpoint(body, *args, use_reentrant=False,
                              preserve_rng_state=False)

        aux = 0.0
        if cfg.layer_pattern == "rwkv":
            caches = []
            for lp in _layers(params["layers"], cfg.n_layers):
                x, c = run(lambda x, lp=lp: _rwkv_block(
                    lp, x, cfg, use_pallas, collect, policy), x)
                caches.append(c)
            return x, aux, _stack(caches) if collect else {}
        if cfg.layer_pattern == "griffin":
            def period_body(x, period):
                pair = []
                for lp in _layers(period["rec"], 2):
                    x, c = _rec_block(lp, x, cfg, use_pallas, collect,
                                      policy)
                    pair.append(c)
                x, a, c = _attn_block(period["attn"], x, cfg, positions,
                                      cfg.local_window, use_pallas, collect,
                                      max_seq, policy)
                return x, a, (_stack(pair) if collect else {}), c

            rec, attn, tail = [], [], []
            for period in _layers(params["periods"], cfg.n_layers // 3):
                x, a, rc, ac = run(lambda x, p=period: period_body(x, p), x)
                aux = aux + a
                rec.append(rc)
                attn.append(ac)
            n_tail = cfg.n_layers % 3
            for lp in _layers(params["tail"], n_tail) if n_tail else ():
                x, c = run(lambda x, lp=lp: _rec_block(
                    lp, x, cfg, use_pallas, collect, policy), x)
                tail.append(c)
            if not collect:
                return x, aux, {}
            caches = {"rec": _stack(rec), "attn": _stack(attn)}
            if tail:
                caches["tail"] = _stack(tail)
            return x, aux, caches
        caches = []
        for lp in _layers(params["layers"], cfg.n_layers):
            x, a, c = run(lambda x, lp=lp: _attn_block(
                lp, x, cfg, positions, 0, use_pallas, collect, max_seq,
                policy, self.moe_ep), x)
            aux = aux + a
            caches.append(c)
        return x, aux, _stack(caches) if collect else {}

    def _forward(self, params, batch, policy=None):
        """(final-normed hidden states (B, S, d_model), aux loss)."""
        x = self._embed(params, batch, policy)
        B, S, _ = x.shape
        positions = like(torch.arange(S, device=x.device).expand(B, S), x)
        h, aux, _ = self._backbone(params, x, positions, policy=policy)
        return rms_norm(h, params["final_norm"], self.cfg.norm_eps), aux

    @torch.no_grad()
    def hidden(self, params, batch, policy=None):
        """The final-normed hidden states (B, S, d_model) of batch's tokens
        (B, S) or embeds (B, S, d_model): what ``loss`` feeds the head."""
        return self._forward(params, batch, policy)[0]

    def loss(self, params, batch, policy=None):
        """batch: tokens (B, S) [or embeds (B, S, d)] + labels (B, S) [or
        (B, S, n_codebooks)].  Returns (loss, metrics): the CE, plus
        ``router_aux_weight`` x the router loss for MoE.  The CE is taken
        over chunks of ``LOSS_CHUNK`` tokens, so (B, S, vocab) logits are
        never built.  Differentiable (see the module docstring)."""
        cfg = self.cfg
        h, aux = self._forward(params, batch, policy)
        S = h.shape[1]
        labels = batch["labels"]
        n_chunks = max(S // LOSS_CHUNK, 1)
        if S % n_chunks:
            raise ValueError(f"S={S} does not split into {n_chunks} loss "
                             "chunks")
        C = S // n_chunks
        total = 0.0
        for c in range(n_chunks):
            logits = self._head(params, h[:, c * C:(c + 1) * C]).float()
            total = total + _cross_entropy(logits,
                                           labels[:, c * C:(c + 1) * C])
        ce = total / n_chunks
        loss = ce + cfg.router_aux_weight * aux if cfg.is_moe else ce
        return loss, {"ce": ce, "aux": aux}

    # ---- serving ---------------------------------------------------------
    @torch.no_grad()
    def prefill(self, params, batch, max_seq: int, policy=None,
                last_pos=None):
        """Forward over the prompt; returns (last-token logits, caches).

        ``last_pos`` ((B,) int, optional) selects the position whose
        logits are returned instead of ``S - 1``: the serving engine
        right-pads prompts to a shape bucket and needs the logits of each
        request's REAL last token.  Causality keeps hidden states at
        positions ``<= last_pos`` independent of the padding suffix, and
        the decode-side validity mask (``cache_pos <= pos``) hides the
        padded KV entries until decode overwrites them in place."""
        cfg = self.cfg
        x = self._embed(params, batch, policy)
        B, S, _ = x.shape
        positions = like(torch.arange(S, device=x.device).expand(B, S), x)
        h, _, caches = self._backbone(params, x, positions, collect=True,
                                      max_seq=max_seq, policy=policy)
        hl = (h[:, -1] if last_pos is None
              else h[torch.arange(B, device=h.device), last_pos])
        return self._head(params, rms_norm(hl, params["final_norm"],
                                           cfg.norm_eps)), caches

    def init_cache(self, batch: int, max_seq: int, dtype=None, device=None):
        """The zero cache of ``batch`` rows.  ``device`` defaults to
        ``cuda`` and raises without a card (``"meta"`` builds shapes
        only)."""
        cfg = self.cfg
        device = torch.device("cuda" if device is None else device)
        if device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("Transformer.init_cache: no CUDA device is "
                               "available (pass device='cpu' to build the "
                               "cache on the host explicitly)")
        dt = dtype or getattr(torch, cfg.dtype)
        if cfg.layer_pattern == "rwkv":
            return init_rwkv_cache(cfg, cfg.n_layers, batch, dt, device)
        if cfg.layer_pattern == "griffin":
            n_periods, tail = divmod(cfg.n_layers, 3)
            rec = init_rglru_cache(cfg, n_periods * 2, batch, dt, device)
            cache = {
                "rec": {k: t.reshape((n_periods, 2) + t.shape[1:])
                        for k, t in rec.items()},
                "attn": init_kv_cache(cfg, batch, max_seq, n_periods, dt,
                                      window=cfg.local_window,
                                      quant=self.kv_quant, device=device),
            }
            if tail:
                cache["tail"] = init_rglru_cache(cfg, tail, batch, dt,
                                                 device)
            return cache
        return init_kv_cache(cfg, batch, max_seq, cfg.n_layers, dt,
                             quant=self.kv_quant, device=device)

    def quantize_cache(self, cache):
        """A prefill's ``cache`` in the layout ``init_cache`` gives: with
        ``kv_quant`` the KV leaves become int8 with per-(token, head)
        scales, as ``decode_step`` writes each token; otherwise ``cache``
        itself.  ``prefill`` builds float KV whatever ``kv_quant`` says,
        as the reference's does (whose engine has no int8 pool: its insert
        finds two trees); the serving engine and a standalone int8 decode
        go through this."""
        if not self.kv_quant or self.cfg.layer_pattern == "rwkv":
            return cache
        if self.cfg.layer_pattern == "griffin":
            return {**cache, "attn": quantize_kv_cache(cache["attn"])}
        return quantize_kv_cache(cache)

    @torch.no_grad()
    def decode_step(self, params, cache, batch, pos, policy=None):
        """One token for the whole stack.  batch: tokens (B,) [or embeds
        (B, d)]; pos: (B,) int32.  Writes the step into ``cache`` in place
        and returns (logits (B, vocab), or (B, n_codebooks, vocab) for a
        codebook arch, and cache)."""
        cfg = self.cfg
        x = self._embed(params, {k: v[:, None] for k, v in batch.items()},
                        policy, "embeds_dec")

        def rec_step(lp, x, c):
            o, _ = rglru_decode(lp["rglru"],
                                rms_norm(x, lp["ln1"], cfg.norm_eps), cfg, c,
                                policy=policy)
            x = x + o
            return x + ffn_apply(lp["ffn"], rms_norm(x, lp["ln2"],
                                                     cfg.norm_eps),
                                 cfg.activation, policy=policy)

        def attn_step(lp, x, c, window):
            o, _ = attn_decode(lp["attn"],
                               rms_norm(x, lp["ln1"], cfg.norm_eps), cfg, c,
                               pos, window=window, policy=policy)
            h = x + o
            return h + _ffn_or_moe(lp, rms_norm(h, lp["ln2"], cfg.norm_eps),
                                   cfg, policy)[0]

        if cfg.layer_pattern == "rwkv":
            for i in range(cfg.n_layers):
                lp, c = _index(params["layers"], i), _index(cache, i)
                o, (tm_x, state) = rwkv6_time_mix(
                    lp["rwkv"]["tm"], rms_norm(x, lp["ln1"], cfg.norm_eps),
                    cfg, x_prev=c["tm_x"], state=c["state"], policy=policy)
                h = x + o
                o2, cm_x = rwkv6_channel_mix(
                    lp["rwkv"]["cm"], rms_norm(h, lp["ln2"], cfg.norm_eps),
                    cfg, x_prev=c["cm_x"])
                x = h + o2
                assign(c["tm_x"], tm_x)
                assign(c["cm_x"], cm_x)
                assign(c["state"], state)
        elif cfg.layer_pattern == "griffin":
            for i in range(cfg.n_layers // 3):
                lp = _index(params["periods"], i)
                c = {"rec": _index(cache["rec"], i),
                     "attn": _index(cache["attn"], i)}
                for j in range(2):
                    x = rec_step(_index(lp["rec"], j), x,
                                 _index(c["rec"], j))
                x = attn_step(lp["attn"], x, c["attn"], cfg.local_window)
            for i in range(cfg.n_layers % 3):
                x = rec_step(_index(params["tail"], i), x,
                             _index(cache["tail"], i))
        else:
            for i in range(cfg.n_layers):
                x = attn_step(_index(params["layers"], i), x,
                              _index(cache, i), 0)
        h = rms_norm(x[:, 0], params["final_norm"], cfg.norm_eps)
        return self._head(params, h), cache
