"""Plans as plain records, so a plan can cross between packages.

A record is one dict per ``PlanOp``: ``dataclasses.asdict`` of the op
(``kind``, ``directive``, ``block_idx``, ``loop_id``) plus
``directive_type``, the class name of its directive (None for blocks and
loop markers).  Records hold only str/int/bool/None and tuples, so the
reference package's plans, whose directive dataclasses have the same
names and fields, give the same records; JSON lists are read back as
tuples.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional

from . import ir
from .analysis import analyze
from .ir import Plan, PlanOp, Program
from .passes.base import PlanDraft
from .passes.purity import pure_device_loops

__all__ = ["plan_records", "plan_from_records"]

_DIRECTIVES = {cls.__name__: cls for cls in (
    ir.AdvancedLoad, ir.DelegateStore, ir.Callsite, ir.Synchronize,
    ir.Release, ir.GroupDecl)}


def plan_records(plan) -> List[Dict[str, Any]]:
    """``plan.ops`` as plain records (works on any plan whose ops are
    dataclasses of this shape)."""
    out = []
    for op in plan.ops:
        rec = dataclasses.asdict(op)
        rec["directive_type"] = (None if op.directive is None
                                 else type(op.directive).__name__)
        out.append(rec)
    return out


def _tuples(x):
    if isinstance(x, (list, tuple)):
        return tuple(_tuples(v) for v in x)
    return x


def plan_from_records(records: List[Dict[str, Any]], program: Program, *,
                      meta: Optional[Dict[str, Any]] = None) -> Plan:
    """Rebuild a ``Plan`` of ``program`` from ``plan_records`` output.

    Groups come from the records' callsites; the io table, byte sizes and
    the pure-device loops are derived here from ``program`` and the ops.
    ``meta`` entries (e.g. ``kernel_variants``, ``n_transfer_streams``,
    ``policy``) are copied over the derived ones unchanged."""
    ops = []
    for rec in records:
        d = None
        if rec.get("directive_type") is not None:
            cls = _DIRECTIVES[rec["directive_type"]]
            d = cls(**{k: _tuples(v) for k, v in rec["directive"].items()})
        ops.append(PlanOp(kind=rec["kind"], directive=d,
                          block_idx=rec.get("block_idx"),
                          loop_id=rec.get("loop_id")))
    members: Dict[int, List[int]] = {}
    for op in ops:
        if isinstance(op.directive, ir.Callsite):
            members.setdefault(op.directive.group, []).append(
                op.directive.block_idx)
    groups = {g: tuple(sorted(set(bs))) for g, bs in sorted(members.items())}
    draft = PlanDraft.from_program(program, analyze(program))
    full_meta = {"pure_device_loops": pure_device_loops(program, ops),
                 "var_nbytes": draft.var_nbytes()}
    full_meta.update(meta or {})
    return Plan(program=program, ops=ops, groups=groups,
                io_table=draft.analysis.io_table, meta=full_meta)
