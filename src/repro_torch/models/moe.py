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

On a mesh (DTensor inputs) ``moe_apply`` places its work as the
reference's GSPMD does under the ``moe_buf`` / ``moe_hidden`` specs:
every rank routes the whole batch (the routing and the capacity are the
unsharded ones), fills and runs only its own experts' rows of the
dispatch buffer against the expert weights at their own placements, and
one reduction sums the ranks' partial outputs.  ``moe_apply_ep``
is the reference's expert-parallel ``shard_map`` as a ``local_map``:
each "model" rank owns ``E / n_model`` experts and its batch rows, the
FSDP gather of its expert weights over "data" is an all-gather, and the
combine is one all-reduce over "model" in the activations' type.
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import torch
import torch.nn.functional as F

from ..distributed.sharding import (batch_axes, is_dtensor, local_apply,
                                    placements)
from .layers import P, acts, ffn_apply, ffn_spec, gelu

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


def _counts(flat_e, E: int):
    """Assignments per expert: ``bincount`` (which has no ``meta``
    kernel; there an ``index_add_`` of ones gives the shape)."""
    if flat_e.is_meta:
        return torch.zeros(E, dtype=torch.int64, device="meta").index_add_(
            0, flat_e, torch.ones_like(flat_e))
    return torch.bincount(flat_e, minlength=E)


def _dispatch(flat_e, counts, capacity: int, lo: int = 0,
              n_loc: int = 0):
    """Sort the T*k assignments by expert (stably) and rank each within
    its expert's run.  Returns, in sorted order: the permutation
    ``order`` (sorted position -> flat assignment index t*k + j),
    ``keep`` (rank < capacity, and the expert one of ``lo .. lo+n_loc-1``)
    and each assignment's row in the buffer of those experts,
    ``(e-lo)*C + rank`` if kept, else the sink row ``n_loc*C``.
    ``n_loc`` 0 means every expert."""
    E = counts.shape[0]
    n_loc = n_loc or E
    order = torch.argsort(flat_e, stable=True)
    se = flat_e[order]
    offsets = torch.cumsum(counts, 0) - counts
    rank = torch.arange(flat_e.shape[0], device=flat_e.device) - offsets[se]
    keep = (rank < capacity) & (se >= lo) & (se < lo + n_loc)
    return order, keep, torch.where(keep, (se - lo) * capacity + rank,
                                    n_loc * capacity)


def _fill(xf, order, slot, rows: int, k: int):
    """The dispatch buffer: row ``slot[i]`` holds token ``order[i] // k``
    (kept slots are distinct); the sink row ``rows`` is cut off."""
    buf = torch.zeros((rows + 1, xf.shape[-1]), dtype=xf.dtype,
                      device=xf.device)
    buf[slot] = xf[order // k]
    return buf[:rows]


def _combine(y, order, keep, slot, gate):
    """Each (token, choice)'s expert output, weighted by its gate and
    summed over the k choices, in fp32: (T, d).  ``y`` (rows, d) holds
    the buffer's outputs; the sorted slots go back to (token, choice)
    order through the inverse permutation, so no scatter-add sums in a
    varying order."""
    T, k = gate.shape
    inv = torch.empty_like(order)
    inv[order] = torch.arange(order.shape[0], device=order.device)
    keep_u, slot_u = keep[inv], slot[inv]
    w = torch.where(keep_u, gate.reshape(-1), 0.0)
    gathered = y[torch.where(keep_u, slot_u, 0)].float() * w[:, None]
    return gathered.reshape(T, k, -1).sum(dim=1)


def _experts(ew, buf, activation: str, policy=None):
    """The grouped FFN: (E, C, d) -> (E, C, d) over stacked weights; on a
    mesh its hidden takes the ``moe_hidden`` spec, as the reference's."""
    if activation in ("swiglu", "geglu"):
        act = F.silu if activation == "swiglu" else gelu
        h = act(torch.bmm(buf, ew["w_gate"])) * torch.bmm(buf, ew["w_up"])
    elif activation == "sq_relu":
        h = torch.square(F.relu(torch.bmm(buf, ew["w_up"])))
    else:
        raise ValueError(activation)
    return torch.bmm(acts(policy, h, "moe_hidden"), ew["w_down"])


def _aux(probs, counts, T: int, k: int):
    """The Switch load-balancing loss ``E * sum_e f_e * p_e``."""
    E = counts.shape[0]
    return E * torch.sum(probs.mean(dim=0) * (counts.float() / (T * k)))


def moe_apply(params, x, cfg, *, policy=None) -> Tuple[torch.Tensor,
                                                        torch.Tensor]:
    """x: (B, S, d).  Returns (out (B, S, d), router aux loss (fp32))."""
    if is_dtensor(x):
        return _moe_apply_mesh(params, x, cfg, policy)
    B, S, d = x.shape
    E, k = cfg.n_experts, cfg.top_k
    T = B * S
    C = _capacity(T, E, k, cfg.capacity_factor)
    xf = x.reshape(T, d)

    # --- routing ----------------------------------------------------------
    probs, gate, expert = _route(params["router"], xf, k)      # (T, k)
    flat_e = expert.reshape(-1)                               # (T*k,)
    counts = _counts(flat_e, E)
    aux = _aux(probs, counts, T, k)

    # --- sort-based dispatch (static shapes), the grouped FFN, combine ----
    order, keep, slot = _dispatch(flat_e, counts, C)
    buf = _fill(xf, order, slot, E * C, k).reshape(E, C, d)
    y = _experts(params["experts"], buf, cfg.activation).reshape(E * C, d)
    out = _combine(y, order, keep, slot, gate).to(x.dtype)

    if cfg.moe_dense_residual:
        out = out + ffn_apply(params["dense"], xf, cfg.activation)
    return out.reshape(B, S, d), aux


def _moe_apply_mesh(params, x, cfg, policy):
    """``moe_apply`` on DTensors, placed as the reference's GSPMD places
    it.  The routing, the capacity and the sort are the unsharded ones:
    every rank routes all T tokens (the input gathered, the router
    whole).  The dispatch buffer (E, C, d) takes the ``moe_buf`` spec,
    its experts split over "model" where they divide it: each rank fills
    only the rows of its own experts.  The expert products run on the
    buffer's shards and the expert weights at their own placements,
    never gathered whole; the hidden takes ``moe_hidden``.  Each rank
    combines its experts' outputs into a partial (T, d) in fp32, and one
    reduction sums them into x's placements."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    mesh = x.device_mesh
    rep = (Replicate(),) * mesh.ndim
    B, S, d = x.shape
    E, k = cfg.n_experts, cfg.top_k
    T = B * S
    C = _capacity(T, E, k, cfg.capacity_factor)
    # without a policy nothing is pinned: the buffer is whole on each rank
    buf_plc = placements(mesh, policy.spec("moe_buf", 3)
                         if policy is not None else None)
    # this rank's experts: lo .. lo + n_loc - 1
    n_loc, lo = E, 0
    for i, p in enumerate(buf_plc):
        if p == Shard(0):
            n_loc //= mesh.size(i)
            lo += mesh.get_local_rank(i) * n_loc
    tok = x.redistribute(placements=rep)
    router = params["router"].redistribute(placements=rep)

    def route(xl, r):
        probs, gate, expert = _route(r, xl.reshape(T, d), k)
        return gate, expert, _aux(probs, _counts(expert.reshape(-1), E),
                                  T, k)
    gate, expert, aux = local_apply(route, (rep, rep, rep), tok, router)

    def slots(e):
        flat_e = e.reshape(-1)
        return _dispatch(flat_e, _counts(flat_e, E), C, lo, n_loc)

    def dispatch(xl, e):
        order, _, slot = slots(e)
        return _fill(xl.reshape(T, d), order, slot, n_loc * C, k).reshape(
            n_loc, C, d)
    buf = acts(policy, local_apply(dispatch, list(buf_plc), tok, expert),
               "moe_buf")
    y = acts(policy, _experts(params["experts"], buf, cfg.activation,
                              policy), "moe_buf")
    if tuple(y.placements) != buf_plc:
        y = y.redistribute(placements=buf_plc)

    def combine(yl, g, e):
        order, keep, slot = slots(e)
        return _combine(yl.reshape(n_loc * C, d), order, keep, slot,
                        g).reshape(B, S, d)
    part = tuple(Partial() if p == Shard(0) else Replicate()
                 for p in buf_plc)
    out = local_apply(combine, list(part), y, gate, expert)
    out = out.redistribute(placements=x.placements).to(x.dtype)
    if cfg.moe_dense_residual:
        out = out + ffn_apply(params["dense"], x, cfg.activation,
                              policy=policy)
    return out, aux


def moe_apply_ep(params, x, cfg, mesh, *, policy=None):
    """Expert-parallel MoE on ``mesh`` (a ``DeviceMesh`` with a "model"
    axis); x and params are DTensors.  Returns (out (B, S, d), aux).

    Tokens stay sharded over the batch axes and whole over "model"; each
    "model" rank j routes its rows, dispatches only to its experts
    ``[j*E_loc, (j+1)*E_loc)`` and returns partial outputs that one
    all-reduce over "model" sums.  ``aux`` is the batch shards' mean,
    counted once across "model"."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    E = cfg.n_experts
    names = mesh.mesh_dim_names
    n_model = mesh.size(names.index("model"))
    if E % n_model:
        raise ValueError(f"{E} experts do not split over {n_model} "
                         "model ranks")
    E_loc = E // n_model
    j = mesh.get_local_rank("model")
    b_axes = batch_axes(mesh) or ()
    n_batch = 1
    for a in b_axes:
        n_batch *= mesh.size(names.index(a))

    def plc(batch, model, other=Replicate()):
        return tuple(batch if a in b_axes else model if a == "model"
                     else other for a in names)
    x_plc = plc(Shard(0), Replicate())
    # the FSDP gather over "data": expert weights whole over the batch
    # axes, their experts split over "model"
    w_plc = plc(Replicate(), Shard(0))
    ew = {n: w.redistribute(placements=w_plc)
          for n, w in params["experts"].items()}
    ew_names = sorted(ew)
    router = params["router"].redistribute(placements=plc(Replicate(),
                                                          Replicate()))
    x = x.redistribute(placements=x_plc)

    def body(xl, rl, *ws):
        return _ep_body(xl, rl, dict(zip(ew_names, ws)), cfg, j, E_loc,
                        n_batch)
    from torch.distributed.tensor.experimental import local_map
    out, aux = local_map(
        body,
        out_placements=(plc(Shard(0), Partial()), plc(Partial(), Partial())),
        in_placements=(x_plc, router.placements) + (w_plc,) * len(ew),
        in_grad_placements=(plc(Shard(0), Partial()),
                            plc(Partial(), Partial()))
        + (plc(Partial(), Shard(0)),) * len(ew),
        device_mesh=mesh)(x, router, *(ew[n] for n in ew_names))
    out = out.redistribute(placements=x_plc)
    aux = aux.redistribute(placements=plc(Replicate(), Replicate()))
    if cfg.moe_dense_residual:
        B, S, d = x.shape
        out = out + ffn_apply(params["dense"], x.reshape(-1, d),
                              cfg.activation, policy=policy
                              ).reshape(B, S, d)
    return out, aux


def _ep_body(xl, router, ew, cfg, j: int, E_loc: int, n_batch: int):
    """One rank's share of ``moe_apply_ep``: its rows, its experts.
    Returns its partial outputs and its share of the aux loss (the batch
    mean's term on "model" rank 0, zero elsewhere)."""
    E, k = cfg.n_experts, cfg.top_k
    Bl, Sl, d = xl.shape
    T = Bl * Sl
    C = _capacity(T, E, k, cfg.capacity_factor)
    xf = xl.reshape(T, d)
    probs, gate, expert = _route(router, xf, k)
    flat_e = expert.reshape(-1)
    counts = _counts(flat_e, E)
    aux = _aux(probs, counts, T, k)
    order, keep, slot = _dispatch(flat_e, counts, C, j * E_loc, E_loc)
    buf = _fill(xf, order, slot, E_loc * C, k).reshape(E_loc, C, d)
    y = _experts(ew, buf, cfg.activation).reshape(E_loc * C, d)
    out = _combine(y, order, keep, slot, gate).to(xl.dtype)
    return out.reshape(Bl, Sl, d), aux * (float(j == 0) / n_batch)
