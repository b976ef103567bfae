"""Stream assignment pass — logical transfer queues per group.

Stream 0 is the compute stream; transfer/sync directives get streams
1..n so a stream-aware backend double-buffers uploads of independent
groups and ``Synchronize`` waits only its own queue.

Determinism contract (ISSUE 4 satellite): stream ids are derived from
the order in which groups FIRST APPEAR among the plan's transfer
directives, not from the group id itself.  Group ids come from
union-find root numbering and may be renumbered between otherwise
identical plans (e.g. by a policy that rewrites the grouping); deriving
streams from appearance order keeps two plans of the same program
op-for-op identical, so the executor's compiled-plan fingerprint
(``hash(tuple(plan.ops))``) matches and cached ``launch_loop``/segment
lowerings stay valid.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List

from ..ir import AdvancedLoad, DelegateStore, PlanOp, Synchronize
from .base import Pass, PlanDraft

__all__ = ["StreamAssignPass", "assign_streams"]

_TRANSFER = (AdvancedLoad, DelegateStore, Synchronize)


def assign_streams(ops: List[PlanOp], n_streams: int = 2) -> List[PlanOp]:
    """Rewrite transfer/sync directives with appearance-ordered streams."""
    n = max(1, int(n_streams))
    first_seen: Dict[int, int] = {}
    for op in ops:
        if op.kind == "directive" and isinstance(op.directive, _TRANSFER):
            g = op.directive.group
            if g not in first_seen:
                first_seen[g] = len(first_seen)

    def stream_of(group: int) -> int:
        return 1 + first_seen.get(group, group) % n

    out: List[PlanOp] = []
    for op in ops:
        d = op.directive
        if op.kind == "directive" and isinstance(d, _TRANSFER):
            d = dataclasses.replace(d, stream=stream_of(d.group))
            op = PlanOp("directive", directive=d)
        out.append(op)
    return out


class StreamAssignPass(Pass):
    """Parameterized on the transfer-stream count (the tuner's axis)."""

    name = "streams"

    def __init__(self, n_streams: int = 2):
        self.n_streams = n_streams

    def run(self, draft: PlanDraft) -> None:
        draft.ops = assign_streams(draft.ops, self.n_streams)
        draft.meta["n_transfer_streams"] = max(1, int(self.n_streams))
