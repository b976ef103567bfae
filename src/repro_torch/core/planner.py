"""Transfer-directive placement — the paper's §2 optimization.

Given a ``Program``, produce a ``Plan`` through the composable pass
pipeline in ``repro_torch.core.passes`` (linearize → placement policy →
simulate-and-fix → noupdate → stream assignment → group head/tail →
purity marking).  The monolithic planner of PRs 0-2 survives as the
individual passes; this module is the thin policy-selection entry point:

``plan(program)`` / ``plan(program, policy="optimized")``
    The paper's optimized placement: ``AdvancedLoad`` hoisted ASAP
    (Figs. 2/4b), ``DelegateStore`` sunk ALAP (Figs. 3/5b), ``noupdate``
    elision for device-resident values (Table 2), async callsites with
    ``Synchronize`` before first host use, per-component groups.

``plan(program, optimize=False)`` / ``policy="naive"``
    The paper's baseline (Figs. 4a/5a): every transfer at the callsite,
    synchronous, no residency reuse.

``plan(program, policy="grouped")``
    Optimized placement with every codelet in ONE directive group.

``plan(program, policy="auto", backend=...)``
    The plan-space explorer (``repro_torch.core.tuner``): enumerate
    candidate plans across placement/stream/fusion/donation/kernel-tile
    axes, rank them with the roofline-backed cost model, measure, and
    return the winner with the full ranked table in
    ``plan.meta["tuning"]``.

Correctness of every policy is enforced by the shared
``SimulateFixPass`` (see ``repro_torch.core.passes.simulate``).
"""
from __future__ import annotations

from typing import Dict, Optional

from .analysis import ProgramAnalysis
from .ir import (AdvancedLoad, Callsite, DelegateStore, Plan, Program,
                 Synchronize)
from .passes import Pipeline

__all__ = ["plan", "naive_plan", "transfer_summary"]


def plan(program: Program, *, optimize: bool = True,
         policy: Optional[str] = None,
         analysis: Optional[ProgramAnalysis] = None,
         n_streams: Optional[int] = None, backend=None,
         verify: bool = True, **tune_kwargs) -> Plan:
    """Plan ``program`` under a placement policy (see module docstring).

    ``optimize`` is the legacy switch (True → "optimized", False →
    "naive"); ``policy`` overrides it.  ``backend`` and ``tune_kwargs``
    are only legal with ``policy="auto"`` (see
    ``repro_torch.core.tuner.tune`` for the knobs: axes, ``top_k``,
    ``reps``, ``measure``, ``objective="time"|"energy"|"memory"`` or a
    weight mapping, and the persistence knobs
    ``cache``/``refresh``/``calibrate``/``use_calibration``); an explicit
    ``n_streams`` pins the auto policy's stream axis to that value.

    Every returned plan is vetted by the static verifier
    (``repro_torch.core.verify``): a plan with race / transfer-consistency /
    donation-safety errors raises ``PlanVerificationError`` instead of
    being returned, and the verdict is recorded in ``meta["verify"]``.
    ``verify=False`` skips the check (the tuner verifies its candidates
    itself; hand-driven pipelines can opt out).
    """
    if policy is None:
        policy = "optimized" if optimize else "naive"
    if policy == "auto":
        from .tuner import tune
        if n_streams is not None:
            tune_kwargs.setdefault("streams", (n_streams,))
        return tune(program, backend=backend, analysis=analysis,
                    **tune_kwargs)
    if tune_kwargs or backend is not None:
        extra = sorted(tune_kwargs) + (["backend"]
                                       if backend is not None else [])
        raise TypeError(
            f"plan() got tuner-only keyword arguments {extra} with "
            f"policy={policy!r}; they are only valid with policy='auto'")
    pl = Pipeline.default(policy, n_streams=2 if n_streams is None
                          else n_streams).run(program, analysis=analysis)
    pl.meta["optimize"] = policy != "naive"
    if verify:
        from .verify import verify_plan
        shapes = analysis.shapes if analysis is not None else None
        report = verify_plan(pl, shapes=shapes)
        pl.meta["verify"] = report.meta_record()
        report.raise_if_failed()
    return pl


def naive_plan(program: Program,
               analysis: Optional[ProgramAnalysis] = None) -> Plan:
    return plan(program, policy="naive", analysis=analysis)


def transfer_summary(p: Plan) -> Dict[str, int]:
    return {
        "loads": p.count(AdvancedLoad),
        "stores": p.count(DelegateStore),
        "syncs": p.count(Synchronize),
        "callsites": p.count(Callsite),
        "noupdate_args": sum(
            len(d.noupdate) for d in p.directives(Callsite)),
    }
