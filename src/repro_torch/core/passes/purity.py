"""Purity marking pass — the proof the compiler relies on for whole-loop
lowering (one dispatch for the whole body, possibly nested).

A loop id is pure iff its body in THIS plan holds only offload blocks
and metadata/sync directives — no host blocks and no
``AdvancedLoad``/``DelegateStore``/``Release``.  The compiled path may
roll such a loop (or a nest of such loops) whole into one fused launch,
because no per-iteration op needs the host.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

from ..ir import (AdvancedLoad, BlockKind, DelegateStore, PlanOp, Program,
                  Release)
from .base import Pass, PlanDraft

__all__ = ["PurityPass", "pure_device_loops"]


def pure_device_loops(program: Program,
                      ops: List[PlanOp]) -> Tuple[int, ...]:
    pure: Dict[int, bool] = {}
    stack: List[int] = []
    for op in ops:
        if op.kind == "loop_begin":
            stack.append(op.loop_id)
            pure.setdefault(op.loop_id, True)
        elif op.kind == "loop_end":
            stack.pop()
        elif stack:
            ok = True
            if op.kind == "block":
                ok = program.blocks[op.block_idx].kind is BlockKind.OFFLOAD
            elif op.kind == "directive":
                ok = not isinstance(
                    op.directive, (AdvancedLoad, DelegateStore, Release))
            if not ok:
                for lid in stack:
                    pure[lid] = False
    return tuple(sorted(lid for lid, v in pure.items() if v))


class PurityPass(Pass):
    name = "purity"

    def run(self, draft: PlanDraft) -> None:
        draft.meta["pure_device_loops"] = pure_device_loops(
            draft.program, draft.ops)
