"""Mixture-of-Experts FFN: top-k routing, sort-based capacity dispatch,
a grouped expert FFN over stacked weights, optional dense-residual branch
(Arctic).

The port of ``src/repro/models/moe.py``.  Dispatch is the static-shape
"dropping" formulation (GShard/Switch style, sort-based like MaxText):
tokens are sorted by assigned expert, ranked within the expert, and
tokens beyond ``capacity`` are dropped (their combine weight is zero, the
residual passes through).  Expert weights are stacked with a leading
``experts`` axis; the expert products are batched matmuls over it, as the
reference computes them outside any Pallas kernel.

Where a line-by-line copy of the reference would differ, and what this
one does instead:

- ``lax.top_k`` puts the lower index first on ties and ``jnp.argsort``
  is stable; ``torch.topk`` promises no order and ``torch.argsort`` is
  unstable by default.  The top k come from a stable descending sort of
  the router's probabilities, and the dispatch order from a stable
  argsort, so the tokens kept under capacity (the lowest flat indices of
  each expert's run) are the reference's.
- The reference scatters dropped tokens to the out-of-range row ``E*C``
  with ``mode="drop"``.  Here the buffer has one more row, the sink, which
  takes every dropped token and is cut off before the products.
- The reference's combine is a scatter-add over the sorted slots; on a
  card that is ``index_add_``, whose atomics sum in no fixed order.  Here
  each slot's weighted output is gathered back to its (token, choice)
  place through the inverse permutation and summed over the k choices,
  so repeated calls give the same bits.
- ``counts`` and the Switch loss's expert fractions come from
  ``bincount``.  The reference adds ``1/(T*k)`` once per assignment in
  fp32; ``bincount / (T*k)`` is exact where ``T*k`` is a power of two and
  otherwise within about ``n**2 * 2**-25 / (T*k)`` of that sum for an expert
  that takes ``n`` assignments (each of the ``n`` adds rounds by at most
  half an ulp of a partial sum below ``n/(T*k)``).

``moe_apply_ep`` (the reference's expert-parallel ``shard_map``) waits
for the mesh slice of the port.
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import torch
import torch.nn.functional as F

from .layers import P, ffn_apply, ffn_spec, gelu, no_policy

__all__ = ["moe_spec", "moe_apply", "moe_apply_ep"]


def moe_spec(cfg, prefix_shape=(), prefix_names=()) -> Dict[str, Any]:
    pa, pn = tuple(prefix_shape), tuple(prefix_names)
    spec: Dict[str, Any] = {
        "router": P(pa + (cfg.d_model, cfg.n_experts),
                    pn + ("embed", "experts")),
        "experts": ffn_spec(cfg.d_model, cfg.d_ff, cfg.activation,
                            pa + (cfg.n_experts,), pn + ("experts",)),
    }
    if cfg.moe_dense_residual:
        spec["dense"] = ffn_spec(cfg.d_model, cfg.d_ff, cfg.activation,
                                 pa, pn)
    return spec


def _capacity(n_tokens: int, n_experts: int, top_k: int,
              capacity_factor: float) -> int:
    cap = int(n_tokens * top_k * capacity_factor / n_experts)
    return max(8, (cap + 7) // 8 * 8)   # pad to 8 for tiling friendliness


def _route(router, xf, top_k: int):
    """Router probabilities (T, E) in fp32, and each token's top k: gate
    values renormalized to sum to 1, and expert ids, ties to the lower
    id (``lax.top_k``'s order)."""
    probs = torch.softmax(xf.float() @ router.float(), dim=-1)
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate, expert = vals[:, :top_k], idx[:, :top_k]
    gate = gate / torch.clamp(gate.sum(-1, keepdim=True), min=1e-9)
    return probs, gate, expert


def _dispatch(flat_e, counts, capacity: int):
    """Sort the T*k assignments by expert (stably) and rank each within
    its expert's run.  Returns, in sorted order: the permutation
    ``order`` (sorted position -> flat assignment index t*k + j),
    ``keep`` (rank < capacity) and each assignment's buffer ``slot``,
    ``e*C + rank`` if kept, else the sink row ``E*C``."""
    E = counts.shape[0]
    order = torch.argsort(flat_e, stable=True)
    se = flat_e[order]
    offsets = torch.cumsum(counts, 0) - counts
    rank = torch.arange(flat_e.shape[0], device=flat_e.device) - offsets[se]
    keep = rank < capacity
    return order, keep, torch.where(keep, se * capacity + rank,
                                    E * capacity)


def _experts(ew, buf, activation: str):
    """The grouped FFN: (E, C, d) -> (E, C, d) over stacked weights."""
    if activation in ("swiglu", "geglu"):
        act = F.silu if activation == "swiglu" else gelu
        h = act(torch.bmm(buf, ew["w_gate"])) * torch.bmm(buf, ew["w_up"])
    elif activation == "sq_relu":
        h = torch.square(F.relu(torch.bmm(buf, ew["w_up"])))
    else:
        raise ValueError(activation)
    return torch.bmm(h, ew["w_down"])


def moe_apply(params, x, cfg, *, policy=None) -> Tuple[torch.Tensor,
                                                        torch.Tensor]:
    """x: (B, S, d).  Returns (out (B, S, d), router aux loss (fp32))."""
    no_policy(policy)
    B, S, d = x.shape
    E, k = cfg.n_experts, cfg.top_k
    T = B * S
    C = _capacity(T, E, k, cfg.capacity_factor)
    xf = x.reshape(T, d)
    dev = x.device

    # --- routing ----------------------------------------------------------
    probs, gate, expert = _route(params["router"], xf, k)      # (T, k)
    flat_e = expert.reshape(-1)                               # (T*k,)
    counts = torch.bincount(flat_e, minlength=E)
    # load-balancing aux loss (Switch):  E * sum_e f_e * p_e
    aux = E * torch.sum(probs.mean(dim=0) * (counts.float() / (T * k)))

    # --- sort-based dispatch (static shapes) ------------------------------
    order, keep, slot = _dispatch(flat_e, counts, C)
    buf = torch.zeros((E * C + 1, d), dtype=x.dtype, device=dev)
    buf[slot] = xf[order // k]          # kept slots are distinct
    y = _experts(params["experts"], buf[:E * C].reshape(E, C, d),
                 cfg.activation).reshape(E * C, d)

    # --- combine: back to (token, choice) order, summed over the k choices
    inv = torch.empty_like(order)
    inv[order] = torch.arange(T * k, device=dev)
    keep_u, slot_u = keep[inv], slot[inv]
    w = torch.where(keep_u, gate.reshape(-1), 0.0)
    gathered = y[torch.where(keep_u, slot_u, 0)].float() * w[:, None]
    out = gathered.reshape(T, k, d).sum(dim=1).to(x.dtype)

    if cfg.moe_dense_residual:
        out = out + ffn_apply(params["dense"], xf, cfg.activation)
    return out.reshape(B, S, d), aux


def moe_apply_ep(params, x, cfg, mesh, *, policy=None):
    """The reference's expert-parallel MoE (``shard_map`` over a mesh)."""
    raise NotImplementedError("moe_apply_ep (expert-parallel MoE) comes with "
                              "the mesh slice of the port")
