"""Fixed-capacity KV/state slot pool with in-place inserts.

The engine allocates ONE pooled cache tree up front —
``model.init_cache(capacity, max_seq)`` — and serves every request out
of a *slot*: one index along each leaf's batch axis.  Requests borrow a
slot at admission and hand it back at retirement; the tensors themselves
are never reallocated, which is the paper's ``noupdate`` residency
applied to serving state: the cache buffers are allocated once and stay
device-resident for the engine's lifetime, while per-request traffic is
row-sized.

Inserting a freshly prefilled request copies its row into every pooled
leaf in place (a slice assignment along the leaf's batch axis, cast to
the pool's dtype, with no index tensor to upload): the torch counterpart
of the reference's donated ``dynamic_update_index_in_dim`` scatter, so
slot recycling reuses the same device memory request after request (the
tests hold every leaf's storage fixed across inserts).

The batch axis of each leaf is *inferred*, not assumed: the pool builds
``init_cache`` on the ``meta`` device (shapes only, no memory) at two
batch sizes and takes the unique axis whose extent differs.  That keeps
the pool agnostic to cache layout — full KV ``(layers, B, T, K, D)``,
Griffin's ``(periods, 2, B, ...)`` recurrent stacks, RWKV's
constant-size ``(layers, B, ...)`` state — as long as decode is
row-independent.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import torch

from ..tree import flatten_with_paths

__all__ = ["KVSlotPool", "infer_batch_axes", "cache_bytes_per_slot",
           "tree_flatten"]


def tree_flatten(tree: Dict[str, Any]
                 ) -> Tuple[List[str], List[torch.Tensor]]:
    """(paths, leaves) of a nested dict of tensors, in sorted key order
    (the order ``jax.tree.flatten`` gives a dict)."""
    pairs = flatten_with_paths(tree)
    return [p for p, _ in pairs], [v for _, v in pairs]


def _diff_axis(sa, sb) -> int:
    """The unique axis where two shapes differ (the batch axis)."""
    if len(sa) != len(sb):
        raise ValueError(f"cache leaf rank changed with batch: {sa} vs {sb}")
    diff = [i for i, (a, b) in enumerate(zip(sa, sb)) if a != b]
    if len(diff) != 1:
        raise ValueError(
            f"cannot infer batch axis from shapes {sa} vs {sb}: "
            f"{len(diff)} axes differ")
    return diff[0]


def infer_batch_axes(model, max_seq: int) -> List[int]:
    """Per-leaf batch-axis index of ``model.init_cache``'s tree, in leaf
    order, found by diffing the shapes at two batch sizes (built on the
    ``meta`` device, which allocates nothing)."""
    p2, l2 = tree_flatten(model.init_cache(2, max_seq, device="meta"))
    p3, l3 = tree_flatten(model.init_cache(3, max_seq, device="meta"))
    if p2 != p3:
        raise ValueError("init_cache tree structure depends on batch size")
    return [_diff_axis(tuple(a.shape), tuple(b.shape))
            for a, b in zip(l2, l3)]


def cache_bytes_per_slot(model, max_seq: int) -> int:
    """Device bytes one request's slot owns (all leaves, batch=1) — the
    per-sequence unit of the engine's device-bytes budget."""
    _, leaves = tree_flatten(model.init_cache(1, max_seq, device="meta"))
    return sum(x.numel() * x.element_size() for x in leaves)


class KVSlotPool:
    """Slot allocator + owner of the pooled cache tree.

    Free slots are recycled LIFO so a just-retired slot is the next one
    handed out (the freed row's buffers are hottest).  ``alloc`` returns
    ``None`` when exhausted (the admission queue waits; nothing OOMs),
    ``free`` raises on a double free, and ``assert_no_leaks`` is the
    engine-shutdown check that every borrowed slot came back.  ``device``
    defaults to ``cuda`` and raises without a card.
    """

    def __init__(self, model, capacity: int, max_seq: int, device=None):
        if capacity < 1:
            raise ValueError("pool capacity must be >= 1")
        self.capacity = int(capacity)
        self.max_seq = int(max_seq)
        self.batch_axes = infer_batch_axes(model, max_seq)
        self.cache = model.init_cache(capacity, max_seq, device=device)
        self._paths, self._leaves = tree_flatten(self.cache)
        self._free: List[int] = list(range(capacity - 1, -1, -1))
        self._in_use: set = set()
        self.allocs = 0
        self.frees = 0
        self.peak_in_use = 0
        self.reused_slots = 0          # allocs that recycled a freed slot
        self._ever_used: set = set()

    # -- slot bookkeeping ----------------------------------------------------
    @property
    def in_use(self) -> int:
        return len(self._in_use)

    @property
    def free_count(self) -> int:
        return len(self._free)

    def alloc(self) -> Optional[int]:
        if not self._free:
            return None
        slot = self._free.pop()
        self._in_use.add(slot)
        self.allocs += 1
        if slot in self._ever_used:
            self.reused_slots += 1
        self._ever_used.add(slot)
        self.peak_in_use = max(self.peak_in_use, self.in_use)
        return slot

    def free(self, slot: int) -> None:
        if slot not in self._in_use:
            raise RuntimeError(f"double free / foreign slot {slot}")
        self._in_use.remove(slot)
        self._free.append(slot)       # LIFO: next alloc reuses it
        self.frees += 1

    def assert_no_leaks(self) -> None:
        if self._in_use:
            raise RuntimeError(
                f"KV slot leak: {sorted(self._in_use)} still allocated "
                f"({self.allocs} allocs / {self.frees} frees)")
        if self.free_count != self.capacity:
            raise RuntimeError(f"KV slot pool holds {self.free_count} free "
                               f"slots of {self.capacity}")

    def stats(self) -> dict:
        return {
            "capacity": self.capacity,
            "in_use": self.in_use,
            "peak_in_use": self.peak_in_use,
            "allocs": self.allocs,
            "frees": self.frees,
            "reused_slots": self.reused_slots,
        }

    # -- pooled-cache insert -------------------------------------------------
    def insert(self, new_cache: Any, src_idx: int, slot: int) -> None:
        """Copy row ``src_idx`` of ``new_cache`` (a prefill-produced cache
        tree, any batch size) into pooled row ``slot`` of every leaf, in
        place, on the current stream."""
        if slot not in self._in_use:
            raise RuntimeError(f"insert into unallocated slot {slot}")
        paths, new_leaves = tree_flatten(new_cache)
        if paths != self._paths:
            raise ValueError(
                f"prefill cache tree {paths} != pool tree {self._paths}")
        for path, pl, nl, ax in zip(paths, self._leaves, new_leaves,
                                    self.batch_axes):
            row = nl.narrow(ax, src_idx, 1)
            if row.shape[:ax] + row.shape[ax + 1:] != \
                    pl.shape[:ax] + pl.shape[ax + 1:]:
                raise ValueError(
                    f"cache leaf {path}: prefill row {tuple(row.shape)} does "
                    f"not fit pool leaf {tuple(pl.shape)} on axis {ax}")
            pl.narrow(ax, slot, 1).copy_(row)     # casts to pl's dtype
