"""Placement policies — where transfers/syncs go (the paper's §2 axis).

Each policy is a pass that computes directive insertions against the
skeleton and merges them into ``draft.ops``.  Policies are registered by
name so the tuner can enumerate them and downstream code can add its
own:

    ``optimized``  advancedload ASAP / delegatestore ALAP / async+sync /
                   residency reuse (Figs. 4b/5b — the paper's system)
    ``naive``      every transfer at the callsite, synchronous
                   (Figs. 4a/5a — the paper's baseline)
    ``grouped``    optimized placement with every codelet folded into
                   ONE directive group (single mapbyname space, one
                   release, one transfer stream) — the paper's grouping
                   axis pushed to its endpoint
    ``pipeline``   optimized placement with every codelet in its OWN
                   group — the GPipe stage schedule from
                   ``distributed.pipeline`` expressed as a placement:
                   per-stage transfer streams and releases so stage
                   i+1's uploads overlap stage i's compute

``register_placement`` admits new policies; ``GroupFinalizePass`` emits
the group declarations (head) and releases (tail) from whatever grouping
the policy left in the draft.
"""
from __future__ import annotations

from typing import Callable, Dict, List, Set, Type

from ..analysis import common_prefix
from ..ir import (AdvancedLoad, BlockKind, DelegateStore, GroupDecl, PlanOp,
                  Release, Synchronize, VarIO)
from .base import Pass, PlanDraft
from .linearize import (Insertion, after_hoisted, before_hoisted, merge,
                        pos_of_block)

__all__ = ["PlacementPass", "OptimizedPlacement", "NaivePlacement",
           "GroupedPlacement", "PipelinePlacement", "GroupFinalizePass",
           "register_placement", "get_placement", "placement_names"]


class PlacementPass(Pass):
    """Base: compute insertions, merge them into the skeleton."""

    name = "placement"
    policy = "abstract"
    elide = True      # let SimulateFixPass drop always-redundant transfers

    def run(self, draft: PlanDraft) -> None:
        ins = self.place(draft)
        draft.ops = merge(draft.ops, ins)
        draft.meta["policy"] = self.policy

    def place(self, draft: PlanDraft) -> List[Insertion]:
        raise NotImplementedError


class OptimizedPlacement(PlacementPass):
    """The paper's optimized placement (Figs. 2, 3, 4b, 5b)."""

    name = "place:optimized"
    policy = "optimized"
    elide = True

    def place(self, draft: PlanDraft) -> List[Insertion]:
        an = draft.analysis
        program = draft.program
        ops = draft.ops
        ins: List[Insertion] = []
        order = [0]

        def add(pos: int, directive) -> None:
            ins.append(Insertion(pos, order[0],
                                 PlanOp("directive", directive=directive)))
            order[0] += 1

        seen_loads: Set = set()       # (var, pos) dedupe
        seen_stores: Set = set()

        def straight_load(var, g, blk, lw):
            """ASAP load covering the straight-line (iteration-1) path."""
            if lw is None:
                pos, hoisted = 0, ()
            else:
                target = common_prefix(lw.loop_path, blk.loop_path)
                writer_pos = pos_of_block(ops, lw.block_idx)
                pos = after_hoisted(ops, writer_pos, target)
                hoisted = lw.loop_path[len(target):]
            if (var, pos) not in seen_loads:
                seen_loads.add((var, pos))
                add(pos, AdvancedLoad(var=var, group=g, asynchronous=True,
                                      hoisted_from=hoisted))

        for blk in program.offload_blocks():
            g = draft.group_of[blk.idx]
            blk_pos = pos_of_block(ops, blk.idx)

            # ---- inputs: AdvancedLoad, hoisted ASAP (Fig. 2 / 4b) --------
            # The dynamic last write at the callsite is lw (straight-line,
            # iteration 1) and — when the callsite sits in a loop whose
            # body also writes the var AFTER it — lwc (loop-carried,
            # iterations ≥ 2).
            for var, io in sorted(an.io_table[blk.idx].items()):
                if io is VarIO.OUT:
                    continue  # never read by the codelet: no upload (E)
                lw = an.last_write_before(var, blk.idx)
                lwc = an.last_carried_write(var, blk)
                straight_resident = (lw is not None
                                     and lw.kind is BlockKind.OFFLOAD)
                if lwc is None:
                    if straight_resident:
                        continue          # noupdate (tagged later)
                    straight_load(var, g, blk, lw)
                elif lwc.kind is BlockKind.OFFLOAD:
                    # iterations ≥ 2 are device-resident; cover iteration 1
                    if not straight_resident:
                        straight_load(var, g, blk, lw)
                else:
                    # carried HOST write: iterations ≥ 2 need a fresh load
                    if straight_resident:
                        # iter 1 resident → ASAP after the carried writer
                        # (end of body i covers body i+1's read)
                        target = common_prefix(lwc.loop_path, blk.loop_path)
                        wpos = pos_of_block(ops, lwc.block_idx)
                        pos = after_hoisted(ops, wpos, target)
                        hoisted = lwc.loop_path[len(target):]
                    else:
                        # host-fresh on every path → one load just before
                        # the callsite (count-optimal; matches naive here)
                        pos, hoisted = blk_pos, ()
                    if (var, pos) not in seen_loads:
                        seen_loads.add((var, pos))
                        add(pos, AdvancedLoad(var=var, group=g,
                                              asynchronous=True,
                                              hoisted_from=hoisted))

            # ---- outputs: DelegateStore, sunk ALAP (Fig. 3 / 5b) ---------
            for var, io in sorted(an.io_table[blk.idx].items()):
                if io is VarIO.IN:
                    continue
                carried_r = an.carried_host_read(var, blk)
                if carried_r is not None:
                    # a host block EARLIER in the shared loop reads next
                    # iteration's value → store right after the callsite
                    pos = blk_pos + 1
                    if (var, pos) not in seen_stores:
                        seen_stores.add((var, pos))
                        add(pos, Synchronize(block_idx=blk.idx, group=g))
                        add(pos, DelegateStore(var=var, group=g))
                reader = an.first_host_read_after(var, blk.idx)
                if reader is None:
                    if var in getattr(program, "outputs", ()):  # end read
                        killed = any(
                            ev.is_write and ev.block_idx > blk.idx
                            for ev in an.events.get(var, ()))
                        if killed:
                            continue
                        pos = len(ops)
                        add(pos, Synchronize(block_idx=blk.idx, group=g))
                        add(pos, DelegateStore(var=var, group=g))
                    continue  # dead on host: no download (paper: A)
                target = common_prefix(blk.loop_path, reader.loop_path)
                reader_pos = pos_of_block(ops, reader.block_idx)
                pos = before_hoisted(ops, reader_pos, target)
                if (var, pos) in seen_stores:
                    continue
                seen_stores.add((var, pos))
                hoisted = reader.loop_path[len(target):]
                # synchronize the async callsite before its first host use
                add(pos, Synchronize(block_idx=blk.idx, group=g))
                add(pos, DelegateStore(var=var, group=g,
                                       hoisted_from=hoisted))

        return ins


class NaivePlacement(PlacementPass):
    """Paper Figs. 4a/5a: all transfers at the callsite, synchronous."""

    name = "place:naive"
    policy = "naive"
    elide = False     # the baseline keeps its redundant transfers

    def place(self, draft: PlanDraft) -> List[Insertion]:
        an = draft.analysis
        ops = draft.ops
        ins: List[Insertion] = []
        order = [0]

        def add(pos, directive):
            ins.append(Insertion(pos, order[0],
                                 PlanOp("directive", directive=directive)))
            order[0] += 1

        for blk in draft.program.offload_blocks():
            g = draft.group_of[blk.idx]
            pos = pos_of_block(ops, blk.idx)
            for var, io in sorted(an.io_table[blk.idx].items()):
                if io is not VarIO.OUT:
                    add(pos, AdvancedLoad(var=var, group=g,
                                          asynchronous=False))
            outs = [var for var, io in sorted(an.io_table[blk.idx].items())
                    if io is not VarIO.IN]
            if outs:
                # one wait point per callsite (Fig. 5a), then every
                # download — not a sync per output
                add(pos + 1, Synchronize(block_idx=blk.idx, group=g))
                for var in outs:
                    add(pos + 1, DelegateStore(var=var, group=g))
        return ins


class GroupedPlacement(OptimizedPlacement):
    """Optimized placement with all codelets folded into one group."""

    name = "place:grouped"
    policy = "grouped"
    elide = True

    def place(self, draft: PlanDraft) -> List[Insertion]:
        blocks = tuple(b.idx for b in draft.program.offload_blocks())
        draft.groups = {0: blocks} if blocks else {}
        draft.group_of = {bi: 0 for bi in blocks}
        return super().place(draft)


class PipelinePlacement(OptimizedPlacement):
    """Optimized placement with every codelet in its own group — the
    ``distributed.pipeline`` GPipe stage schedule as a placement policy.

    One group per offload block means one mapbyname space, one release
    and (under ``n_transfer_streams > 1``) one transfer stream per
    *stage*, so stage i+1's advancedloads overlap stage i's codelet the
    way GPipe overlaps micro-batch (i+1)'s weights with micro-batch i's
    forward.  The inverse of ``grouped``: that folds all stages into one
    group, this splits them maximally."""

    name = "place:pipeline"
    policy = "pipeline"
    elide = True

    def place(self, draft: PlanDraft) -> List[Insertion]:
        blocks = tuple(b.idx for b in draft.program.offload_blocks())
        draft.groups = {i: (bi,) for i, bi in enumerate(blocks)}
        draft.group_of = {bi: i for i, bi in enumerate(blocks)}
        return super().place(draft)


class GroupFinalizePass(Pass):
    """Group declarations up front, releases at the end (paper Table 2)."""

    name = "groups"

    def run(self, draft: PlanDraft) -> None:
        program = draft.program
        if any(op.kind == "directive" and isinstance(op.directive, GroupDecl)
               for op in draft.ops):
            return        # head/tail already emitted (idempotent)
        head: List[PlanOp] = []
        for g, blks in sorted(draft.groups.items()):
            shared: Set[str] = set()
            seen: Set[str] = set()
            for bi in blks:
                for v in set(program.blocks[bi].effective_reads()) | \
                        set(program.blocks[bi].writes):
                    if v in seen:
                        shared.add(v)
                    seen.add(v)
            head.append(PlanOp("directive", directive=GroupDecl(
                group=g, mapbyname=tuple(sorted(shared)), target="TPU")))
        tail = [PlanOp("directive", directive=Release(group=g))
                for g in sorted(draft.groups)]
        draft.ops = head + draft.ops + tail


# --------------------------------------------------------------------------
# Policy registry — the tuner's placement axis.
# --------------------------------------------------------------------------

_PLACEMENTS: Dict[str, Type[PlacementPass]] = {
    "optimized": OptimizedPlacement,
    "naive": NaivePlacement,
    "grouped": GroupedPlacement,
}




def register_placement(name: str,
                       cls: Callable[[], PlacementPass]) -> None:
    """Add a placement policy; it becomes plannable via
    ``plan(p, policy=name)`` and enumerable by the tuner."""
    _PLACEMENTS[name] = cls


# the GPipe-derived stage schedule registers through the same admission
# path any external policy would
register_placement("pipeline", PipelinePlacement)


def get_placement(name: str) -> Type[PlacementPass]:
    try:
        return _PLACEMENTS[name]
    except KeyError:
        raise ValueError(f"unknown placement policy {name!r}; have "
                         f"{sorted(_PLACEMENTS)}") from None


def placement_names() -> List[str]:
    return sorted(_PLACEMENTS)
