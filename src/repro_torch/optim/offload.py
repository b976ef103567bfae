"""Optimizer-state host offload (the paper's technique at training scale),
and the training-step block programs for the offload planner.

HMPP's ``advancedload``/``delegatestore`` become stream-ordered copies:
``offloaded_optimizer`` keeps the optimizer state in pinned host memory
and, inside the update, copies each piece of it to the card on a load
stream one piece ahead of the piece being updated (advancedload), then
copies the new values back into the same pinned buffers on a store stream
once the update of that piece is done (delegatestore); events order the
three streams.  A piece is a slice of at most ``adamw.CHUNK`` elements of
a leaf when the rule is elementwise (AdamW), else a whole leaf
(Adafactor, whose clip reads the leaf whole), so the state on the card
at any time is about three pieces.  Where there is no host memory kind
(a CPU device) the wrapper is the identity, as the reference's is.

On a mesh each rank's state is its own shards, ``PinnedShard``s that
carry their global shape and sharding.  An elementwise rule updates the
local shards as they are; any other rule gets each piece's device copies
back as DTensors at the state's placements, so its means and its clip
reduce over the sharded mesh dims exactly as the on-card sharded step
does.  The same pieces also run on a CPU mesh with host-memory shards
(plain copies in place of the streams), which is how the multi-rank
path is held on gloo.

``plan_step_program`` is a miniature training loop (host update blocks +
device compute blocks) whose offload schedule can be inspected with the
paper's emitter and counted by the executor; ``attention_step_program``
is the same shape of program around a kernel-tagged flash-attention
block, the tuner's ``attn_step`` gate.

Both are the reference package's builders, written so the bodies run
under numpy and torch alike (``xp.ones(64, dtype=...)`` and
``.sum().reshape(1, 1)`` where the reference relied on numpy-only
keywords); the values and shapes are the same.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch.core import Program

from .. import trace
from ..tree import leaves, tree_map, unflatten
from ..distributed.sharding import (NamedSharding, PinnedShard, is_dtensor,
                                    local_shard, mesh_device_type,
                                    place_leaf, spec_of, wrap_shard)
from .adamw import CHUNK, UPDATE_RANGE, Optimizer, local_ctx, synced

__all__ = ["plan_step_program", "attention_step_program",
           "host_memory_kind", "supports_pinned_host", "offload_shardings",
           "opt_state_shardings", "offloaded_optimizer", "offloaded_state"]

_HOST_KIND = "pinned_host"


def host_memory_kind(device=None) -> Optional[str]:
    """The host memory usable for offload from ``device``:
    ``"pinned_host"`` for a CUDA device, ``None`` for the CPU, whose
    memory is the host's (the default device is the card where there is
    one)."""
    if device is None:
        device = "cuda" if torch.cuda.is_available() else "cpu"
    return _HOST_KIND if torch.device(device).type == "cuda" else None


def supports_pinned_host(device=None) -> bool:
    return host_memory_kind(device) is not None


def offload_shardings(sharding_tree):
    """The same placements with host-pinned local shards: each
    ``NamedSharding`` of the tree moved to the host memory kind of its
    mesh's device; the identity where that device has none (a CPU mesh:
    the state stays where it is).  ``sharding.place`` puts an array there
    as this rank's own shard, a ``PinnedShard`` (a DTensor keeps its
    shard on the mesh's device); the update streams it in and back as it
    does off a mesh."""
    def move(s):
        kind = host_memory_kind(mesh_device_type(s.mesh))
        return s if kind is None else dataclasses.replace(
            s, memory_kind=kind)
    return tree_map(move, sharding_tree,
                    is_leaf=lambda x: isinstance(x, NamedSharding))


def opt_state_shardings(mesh, aparams, p_sh, opt_name: str):
    """Optimizer-state shardings mirroring the param shardings ``p_sh``:
    AdamW's ``m``/``v`` at their params'; Adafactor's factors at their
    params' on the dims they keep (``vr`` drops the last dim, ``vc`` the
    one before it); the step replicated."""
    rep = NamedSharding(mesh, ())
    if opt_name == "adamw":
        return {"m": p_sh, "v": p_sh, "step": rep}

    def factor_sh(p, s):
        spec = tuple(s.spec) + (None,) * (p.ndim - len(tuple(s.spec)))
        if p.ndim >= 2:
            return {"vr": NamedSharding(mesh, spec[:-1]),
                    "vc": NamedSharding(mesh, spec[:-2] + spec[-1:])}
        return {"v": s}
    flat_p = leaves(aparams)
    flat_s = leaves(p_sh, is_leaf=lambda x: isinstance(x, NamedSharding))
    return {"factors": unflatten(aparams, [factor_sh(p, s) for p, s
                                           in zip(flat_p, flat_s)]),
            "step": rep}


def offloaded_state(shapes, device=None):
    """Zeros of the shapes and types of ``shapes`` (a state tree, ``meta``
    tensors will do), placed for offload from ``device``: arrays in pinned
    host memory, 0-d leaves (the step) on the device.  ``device`` defaults
    to ``cuda`` and raises without a card."""
    device = torch.device("cuda" if device is None else device)
    if device.type != "cuda":
        raise ValueError(f"offloaded_state: {device} has no host memory "
                         "apart from its own")
    if not torch.cuda.is_available():
        raise RuntimeError("offloaded_state: no CUDA device is available "
                           "(on the CPU the optimizer keeps its own state)")

    def place(t):
        if t.ndim == 0:
            return torch.zeros((), dtype=t.dtype, device=device)
        return torch.zeros(t.shape, dtype=t.dtype, pin_memory=True)
    return tree_map(place, shapes)


def _sharded_state(opt: Optimizer, params):
    """Zeros of ``opt``'s state for the DTensor ``params``, placed as the
    sharded state is (``opt_state_shardings`` over the params'
    placements) with each array this rank's ``PinnedShard`` under a
    ``pinned_host`` sharding: no leaf is ever allocated whole.  The
    shards are host memory on a CPU mesh too (pinned on a card)."""
    mesh = leaves(params)[0].device_mesh
    meta = tree_map(lambda p: torch.empty(p.shape, dtype=p.dtype,
                                          device="meta"), params)
    p_sh = tree_map(lambda p: NamedSharding(mesh, spec_of(p)), params)
    o_sh = leaves(opt_state_shardings(mesh, meta, p_sh, opt.name),
                  is_leaf=lambda x: isinstance(x, NamedSharding))
    shapes = opt.init(meta)

    def zeros(t, s):
        s = dataclasses.replace(s, memory_kind=_HOST_KIND)
        if t.ndim == 0:
            return place_leaf(torch.zeros((), dtype=t.dtype), s)
        return PinnedShard.zeros(s, t.shape, t.dtype)
    return unflatten(shapes, [zeros(t, s) for t, s in
                              zip(leaves(shapes), o_sh)])


def _pieces(rule, flat_g, slots, flat_p):
    """(g, slot, p) units of the update, in order: slices of at most
    ``CHUNK`` elements of each leaf for an elementwise rule, else whole
    leaves."""
    for g, slot, p in zip(flat_g, slots, flat_p):
        if not rule.elementwise or p.numel() <= CHUNK:
            yield g, slot, p
            continue
        gf, pf = g.view(-1), p.view(-1)
        sf = {k: local_shard(t).view(-1) for k, t in slot.items()}
        for lo in range(0, pf.numel(), CHUNK):
            hi = min(lo + CHUNK, pf.numel())
            yield gf[lo:hi], {k: t[lo:hi] for k, t in sf.items()}, \
                pf[lo:hi]


def _offloaded(t) -> bool:
    return isinstance(t, PinnedShard) or local_shard(t).is_pinned()


def offloaded_optimizer(opt: Optimizer) -> Optimizer:
    """``opt`` with its state in pinned host memory on a card (see the
    module docstring).  ``init`` allocates the state as
    ``offloaded_state`` does (zeros, what both optimizers start from), on
    a mesh as each rank's ``PinnedShard``s; ``update`` streams it through
    the card piece by piece.  The host reads the state after
    ``torch.cuda.synchronize()`` (the stores run on their own stream).  On
    the CPU ``init`` is ``opt``'s own, and so is ``update`` unless the
    state is host shards (then the pieces run with plain copies)."""
    rule = opt.rule
    if rule is None:
        raise ValueError(f"{opt.name}: offload needs the update as a "
                         "LeafRule")
    streams = {}

    def init(params):
        p0 = leaves(params)[0]
        if host_memory_kind(p0.device) is None:
            return opt.init(params)
        if is_dtensor(p0):
            return _sharded_state(opt, params)
        return offloaded_state(opt.init(tree_map(lambda p: torch.empty(
            p.shape, dtype=p.dtype, device="meta"), params)), p0.device)

    @torch.no_grad()
    def update(grads, state, params):
        slots = rule.slots(state)
        if not any(_offloaded(t) for slot in slots for t in slot.values()):
            return opt.update(grads, state, params)
        device = leaves(params)[0].device
        if device.type == "cuda" and device not in streams:
            streams[device] = (torch.cuda.Stream(device),
                               torch.cuda.Stream(device))
        with torch.profiler.record_function(UPDATE_RANGE):
            _streamed(rule, grads, state, params, slots,
                      streams.get(device))
        return params, state

    return dataclasses.replace(opt, init=init, update=update,
                               name=opt.name + "+offload")


def _as_sharded(dev, slot):
    """A piece's device copies as DTensors at the placements of the host
    shards they were copied from."""
    return {k: wrap_shard(t, slot[k].sharding.mesh, slot[k].placements,
                          slot[k].global_shape) for k, t in dev.items()}


def _streamed(rule, grads, state, params, slots, streams) -> None:
    """The update piece by piece: each piece's state copied in on the
    load stream one piece ahead (advancedload), updated on the current
    stream, copied back into its host buffers on the store stream
    (delegatestore).  ``streams`` is (load, store) on a card; ``None`` on
    the CPU, where the same copies run in order.  Under a profiler the
    update is one ``offload.update`` span: the bytes it loads and, on a
    card, ``wait_ns``, how long the compute stream stood stalled on the
    load stream (timing events around each wait, read lazily)."""
    flat_p = leaves(params)
    device = flat_p[0].device
    flat_g = synced(leaves(grads), flat_p)
    ctx = rule.begin(flat_g, state)
    sharded = bool(flat_p) and is_dtensor(flat_p[0])
    if sharded and rule.elementwise:
        # each rank updates its own shards against its own state
        ctx = local_ctx(ctx)
        flat_g = [local_shard(g).contiguous() for g in flat_g]
        flat_p = [local_shard(p) for p in flat_p]
    elif sharded and not all(isinstance(t, PinnedShard) for s in slots
                             for t in s.values()):
        raise ValueError("an offloaded non-elementwise update on a mesh "
                         "needs its state as PinnedShards (offload_"
                         "shardings, offloaded_optimizer's init)")
    load, store = streams or (None, None)
    if load is not None:
        compute = torch.cuda.current_stream(device)
        load.wait_stream(store)   # the last update's stores land first

    def advancedload(slot):
        if load is None:
            return {k: t.to(device, copy=True)
                    for k, t in slot.items()}, None
        with torch.cuda.stream(load):
            dev = {k: t.to(device, non_blocking=True)
                   for k, t in slot.items()}
            ready = torch.cuda.Event()
            ready.record(load)
        return dev, ready

    def delegatestore(slot, dev):
        if store is None:
            for k, t in dev.items():
                slot[k].copy_(t)
            return
        done = torch.cuda.Event()
        done.record(compute)
        with torch.cuda.stream(store):
            store.wait_event(done)
            for k, t in dev.items():
                slot[k].copy_(t, non_blocking=True)
                t.record_stream(store)

    units = list(_pieces(rule, flat_g, slots, flat_p))
    with trace.span(trace.OFFLOAD_UPDATE) as span:
        waits = []    # (before, after) the compute stream's wait, a piece
        pending = advancedload(units[0][1]) if units else None
        for i, (g, slot, p) in enumerate(units):
            dev, ready = pending
            if i + 1 < len(units):
                pending = advancedload(units[i + 1][1])
            if span:
                span.add("h2d_bytes", sum(t.nbytes for t in dev.values()))
            if ready is not None:
                if span:
                    waits.append(_timed_wait(compute, ready))
                else:
                    compute.wait_event(ready)
                for t in dev.values():
                    t.record_stream(compute)
            rule.leaf(ctx, g, _as_sharded(dev, slot)
                      if sharded and not rule.elementwise else dev, p)
            delegatestore(slot, dev)
        if waits:
            span.later("wait_ns", lambda: _stalled_ns(waits))


def _timed_wait(compute, ready):
    """``compute.wait_event(ready)`` between two timing events on
    ``compute``: the time between them is how long the stream stood."""
    before = torch.cuda.Event(enable_timing=True)
    after = torch.cuda.Event(enable_timing=True)
    before.record(compute)
    compute.wait_event(ready)
    after.record(compute)
    return before, after


def _stalled_ns(waits) -> int:
    """The compute stream's stalls summed, in ns (read once the update
    has run: it waits for the last of them)."""
    waits[-1][1].synchronize()
    return sum(round(a.elapsed_time(b) * 1e6) for a, b in waits)


def plan_step_program(n_steps: int = 4) -> Program:
    """A miniature training loop as a block program: host data producer,
    device fwd/bwd codelet, device optimizer update reading offloaded state,
    host metric logging — the planner hoists the batch upload (prefetch) and
    sinks the metric download (lazy fetch)."""
    p = Program("train_loop")
    p.bind("w", np.zeros((64, 64), np.float32))
    p.bind("opt_m", np.zeros((64, 64), np.float32))
    p.bind("seed", np.zeros((2,), np.float32))

    p.host(lambda xp, seed: {"batch": xp.outer(
               seed + 1.0, xp.ones(64, dtype=xp.float32))},
           reads=("seed",), writes=("batch",), name="next_batch")
    with p.loop(n_steps):
        p.offload(lambda xp, w, batch:
                  {"grad": (w @ batch.T @ batch) / 64.0,
                   "loss": ((batch @ w) ** 2).sum().reshape(1, 1)},
                  reads=("w", "batch"), writes=("grad", "loss"),
                  name="fwd_bwd")
        p.offload(lambda xp, w, grad, opt_m:
                  {"w": w - 0.1 * (0.9 * opt_m + grad),
                   "opt_m": 0.9 * opt_m + grad},
                  reads=("w", "grad", "opt_m"), writes=("w", "opt_m"),
                  name="opt_update")
    p.host(lambda xp, loss: {"final_loss": loss},
           reads=("loss",), writes=("final_loss",), name="log_metrics")
    p.set_outputs("final_loss", "w")
    return p


def attention_step_program(n_steps: int = 2, *,
                           shapes: Optional[Tuple[int, ...]] = None
                           ) -> Program:
    """A flash-attention train step as a block program with a *tagged*
    kernel block: the ``kernel="flash_attention"`` tag lets the tuner
    enumerate tile variants (``block_q``/``block_k``) for the attention
    launch.  ``shapes`` is (B, S, T, K, G, D); the default is the
    reference's small (1, 128, 128, 1, 1, 8), and a caller passes a model's
    attention width (e.g. qwen2.5-14b: K = 8, G = 5, D = 128) to run the
    same four blocks at full size.  Inputs come from ``default_rng(0)``."""
    from repro_torch.kernels import ops

    B, S, T, K, G, D = shapes or (1, 128, 128, 1, 1, 8)
    rng = np.random.default_rng(0)
    p = Program("attention_step")
    p.bind("q", rng.standard_normal((B, S, K, G, D)).astype(np.float32))
    p.bind("k", rng.standard_normal((B, T, K, D)).astype(np.float32))
    p.bind("v", rng.standard_normal((B, T, K, D)).astype(np.float32))
    p.bind("gain", np.ones((1,), np.float32))

    p.host(lambda xp, gain: {"g": gain * 1.001},
           reads=("gain",), writes=("g",), name="next_gain")
    with p.loop(n_steps):
        # reads are the kernel's ops-layer operands, in operand order —
        # the tuner resolves the variant grid from their shapes
        p.offload(lambda xp, q, k, v, *, block_q=128, block_k=128:
                  {"o": ops.flash_attention(q, k, v, causal=True,
                                            block_q=block_q,
                                            block_k=block_k)},
                  reads=("q", "k", "v"), writes=("o",),
                  name="attention", kernel="flash_attention")
        p.offload(lambda xp, o, g:
                  {"loss": (o * o).sum().reshape(1) * g},
                  reads=("o", "g"), writes=("loss",), name="reduce")
    p.host(lambda xp, loss: {"final_loss": loss},
           reads=("loss",), writes=("final_loss",), name="log_metrics")
    p.set_outputs("final_loss",)
    return p
