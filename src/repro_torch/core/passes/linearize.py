"""Linearize pass: program blocks + loop markers → the plan skeleton.

Also hosts the skeleton-position helpers every placement policy uses
(ASAP/ALAP insertion points, Figs. 2-3 of the paper) and the merge of
computed insertions back into the op stream.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Tuple

from ..analysis import common_prefix
from ..ir import PlanOp, Program
from .base import Pass, PlanDraft

__all__ = ["LinearizePass", "Insertion", "linearize", "pos_of_block",
           "depth_at", "after_hoisted", "before_hoisted", "merge"]


def linearize(program: Program) -> List[PlanOp]:
    ops: List[PlanOp] = []
    open_path: Tuple[int, ...] = ()
    for blk in program.blocks:
        path = blk.loop_path
        keep = common_prefix(open_path, path)
        for lid in reversed(open_path[len(keep):]):
            ops.append(PlanOp(kind="loop_end", loop_id=lid))
        for lid in path[len(keep):]:
            ops.append(PlanOp(kind="loop_begin", loop_id=lid))
        open_path = path
        ops.append(PlanOp(kind="block", block_idx=blk.idx))
    for lid in reversed(open_path):
        ops.append(PlanOp(kind="loop_end", loop_id=lid))
    return ops


class LinearizePass(Pass):
    """Build the skeleton.  Idempotent: only runs on an empty draft."""

    name = "linearize"

    def run(self, draft: PlanDraft) -> None:
        if not draft.ops:
            draft.ops = linearize(draft.program)


# --------------------------------------------------------------------------
# Skeleton-position helpers (shared by placement policies).
# --------------------------------------------------------------------------

def pos_of_block(ops: List[PlanOp], idx: int) -> int:
    for i, op in enumerate(ops):
        if op.kind == "block" and op.block_idx == idx:
            return i
    raise KeyError(idx)


def depth_at(ops: List[PlanOp], pos: int) -> Tuple[int, ...]:
    path: List[int] = []
    for op in ops[:pos]:
        if op.kind == "loop_begin":
            path.append(op.loop_id)
        elif op.kind == "loop_end":
            path.pop()
    return tuple(path)


def after_hoisted(ops: List[PlanOp], blk_pos: int,
                  target_path: Tuple[int, ...]) -> int:
    """Insertion index just after ``blk_pos`` once all loops deeper than
    ``target_path`` have closed (ASAP placement, Fig. 2)."""
    path = list(depth_at(ops, blk_pos))
    i = blk_pos + 1
    while tuple(path) != tuple(target_path) and i < len(ops):
        op = ops[i]
        if op.kind == "loop_begin":
            path.append(op.loop_id)
        elif op.kind == "loop_end":
            path.pop()
        i += 1
    return i


def before_hoisted(ops: List[PlanOp], blk_pos: int,
                   target_path: Tuple[int, ...]) -> int:
    """Insertion index just before ``blk_pos``, lifted before any
    loop_begin opening loops deeper than ``target_path`` (ALAP
    placement, Fig. 3)."""
    path = list(depth_at(ops, blk_pos))
    i = blk_pos
    while tuple(path) != tuple(target_path) and i > 0:
        op = ops[i - 1]
        if op.kind == "loop_begin":
            path.pop()
        elif op.kind == "loop_end":
            path.append(op.loop_id)
        i -= 1
    return i


@dataclasses.dataclass
class Insertion:
    pos: int           # index into skeleton ops; inserted before ops[pos]
    order: int         # tie-break: stable order of creation
    op: PlanOp


def merge(ops: List[PlanOp], ins: List[Insertion]) -> List[PlanOp]:
    out: List[PlanOp] = []
    by_pos: Dict[int, List[Insertion]] = {}
    for i in ins:
        by_pos.setdefault(i.pos, []).append(i)
    for pos in by_pos:
        by_pos[pos].sort(key=lambda x: x.order)
    for idx in range(len(ops) + 1):
        for i in by_pos.get(idx, ()):
            out.append(i.op)
        if idx < len(ops):
            out.append(ops[idx])
    return out
