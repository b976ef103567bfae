"""Pass-pipeline skeleton for the planner (ISSUE 4 tentpole).

The monolithic ``plan()`` is decomposed into independent passes over a
shared mutable ``PlanDraft``: linearize → placement policy →
simulate-and-fix → noupdate tagging → stream assignment → group
head/tail → purity marking.  Each pass reads and rewrites
``draft.ops``/``draft.meta`` only; the ``Pipeline`` runs them in order
and finalizes the draft into an immutable-ish ``Plan``.

The contract every pass honors:

* passes never touch ``draft.program`` or ``draft.analysis`` (read-only
  facts); mutable plan state lives in ``ops``, ``groups``/``group_of``
  and ``meta``;
* structural passes (linearize, noupdate, group head/tail) are no-ops
  when their postcondition already holds; placement passes expect the
  bare skeleton and may not be re-run on a placed draft;
* validity is owned by ``SimulateFixPass`` — any pipeline that includes
  it produces a plan the checking executor accepts, or raises.

This is what makes plan generation *enumerable*: the tuner
(``repro_torch.core.tuner``) swaps the placement pass and re-parameterizes the
stream pass to sweep the plan space the paper explores by hand.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from ..analysis import ProgramAnalysis, analyze
from ..ir import Plan, PlanOp, Program

__all__ = ["PlanDraft", "Pass", "Pipeline"]


@dataclasses.dataclass
class PlanDraft:
    """Shared mutable state the passes operate on.

    ``groups``/``group_of`` start as the analysis' connected-component
    grouping; a placement policy may rewrite them (e.g. the grouped
    policy folds every codelet into one group) and all downstream
    passes must read the draft's copy, never the analysis'.
    """
    program: Program
    analysis: ProgramAnalysis
    ops: List[PlanOp] = dataclasses.field(default_factory=list)
    groups: Dict[int, Tuple[int, ...]] = dataclasses.field(
        default_factory=dict)
    group_of: Dict[int, int] = dataclasses.field(default_factory=dict)
    meta: Dict[str, Any] = dataclasses.field(default_factory=dict)

    @classmethod
    def from_program(cls, program: Program,
                     analysis: Optional[ProgramAnalysis] = None
                     ) -> "PlanDraft":
        an = analysis or analyze(program)
        return cls(program=program, analysis=an,
                   groups=dict(an.groups), group_of=dict(an.group_of))

    def var_nbytes(self) -> Dict[str, int]:
        """Concrete byte size of every program variable (from the
        analysis' abstract shapes) — the cost model's raw material."""
        out = {}
        for v, sd in self.analysis.shapes.items():
            out[v] = int(np.prod(sd.shape, dtype=np.int64)
                         ) * np.dtype(sd.dtype).itemsize
        return out


class Pass:
    """One reorderable planner stage.  Subclasses override ``run``."""

    name: str = "pass"

    def run(self, draft: PlanDraft) -> None:
        raise NotImplementedError

    def __repr__(self) -> str:
        return f"<{type(self).__name__}>"


class Pipeline:
    """Ordered pass list → ``Plan`` factory.

    >>> Pipeline.default("optimized").run(program)
    """

    def __init__(self, passes):
        self.passes = list(passes)

    @classmethod
    def default(cls, policy: str = "optimized", *,
                n_streams: int = 2) -> "Pipeline":
        # imported here so pass modules stay independently importable
        from .linearize import LinearizePass
        from .placement import GroupFinalizePass, get_placement
        from .purity import PurityPass
        from .simulate import NoupdatePass, SimulateFixPass
        from .streams import StreamAssignPass
        placement = get_placement(policy)()
        return cls([
            LinearizePass(),
            placement,
            SimulateFixPass(elide=placement.elide),
            NoupdatePass(),
            StreamAssignPass(n_streams=n_streams),
            GroupFinalizePass(),
            PurityPass(),
        ])

    def run(self, program: Program,
            analysis: Optional[ProgramAnalysis] = None) -> Plan:
        draft = PlanDraft.from_program(program, analysis)
        for p in self.passes:
            p.run(draft)
        return self.finalize(draft)

    @staticmethod
    def finalize(draft: PlanDraft) -> Plan:
        meta = dict(draft.meta)
        meta.setdefault("var_nbytes", draft.var_nbytes())
        return Plan(program=draft.program, ops=list(draft.ops),
                    groups=dict(draft.groups),
                    io_table=draft.analysis.io_table, meta=meta)
