"""Simulate-and-fix + noupdate tagging passes.

``SimulateFixPass`` is the validity authority: an abstract interpretation
of the plan (loop bodies twice — the standard 2-iteration trick) tracks
per-variable host/device validity, drops loads/stores that are redundant
on *every* execution (optimized policy only) and inserts emergency
transfers if a placement gap is found.  A plan whose gap cannot be fixed
(no valid copy anywhere) raises — the tuner uses this to reject invalid
candidate plans instead of ranking them.

``NoupdatePass`` annotates each callsite with the inputs that arrive
device-resident — the paper's ``args[x].noupdate=true``.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Set, Tuple

from ..ir import (AdvancedLoad, BlockKind, Callsite, DelegateStore, PlanOp,
                  Program, Synchronize, VarIO)
from .base import Pass, PlanDraft

__all__ = ["SimulateFixPass", "NoupdatePass", "PlanGap", "simulate"]


class PlanGap(Exception):
    """An unfixable placement hole: a read with no valid copy anywhere."""


@dataclasses.dataclass
class _VState:
    valid_host: bool
    valid_device: bool


def simulate(program: Program, ops: List[PlanOp]):
    """Walk the plan; loop bodies are interpreted twice so cross-iteration
    residency is exact for programs whose bodies don't change behaviour
    after iteration 2 (ours don't: block read/write sets are static).

    Returns (always_redundant positions, gaps) where gaps is a list of
    (pos, emergency PlanOps) needed for correctness — an emergency
    download arrives with its own preceding ``Synchronize`` so the fixed
    plan passes the static verifier's async-race check.  Raises
    ``PlanGap`` when no emergency transfer can fix a hole.
    """
    state: Dict[str, _VState] = {
        v: _VState(True, False) for v in program.inputs
    }
    load_hits: Dict[int, List[bool]] = {}   # op position -> redundancy
    store_hits: Dict[int, List[bool]] = {}
    gaps: Dict[Tuple[int, str, str], Tuple[int, Tuple[PlanOp, ...]]] = {}

    # pre-index loop spans
    spans: Dict[int, Tuple[int, int]] = {}
    stack: List[Tuple[int, int]] = []
    for i, op in enumerate(ops):
        if op.kind == "loop_begin":
            stack.append((op.loop_id, i))
        elif op.kind == "loop_end":
            lid, start = stack.pop()
            spans[lid] = (start, i)

    def exec_range(lo: int, hi: int):
        i = lo
        while i < hi:
            op = ops[i]
            if op.kind == "loop_begin":
                start, end = spans[op.loop_id]
                for _ in range(2):           # 2-iteration abstraction
                    exec_range(start + 1, end)
                i = end + 1
                continue
            if op.kind == "directive":
                d = op.directive
                if isinstance(d, AdvancedLoad):
                    st = state.setdefault(d.var, _VState(False, False))
                    if not st.valid_host:
                        # a host copy is required; upstream store missing
                        raise PlanGap(
                            f"load of {d.var!r} with no valid host copy")
                    load_hits.setdefault(i, []).append(st.valid_device)
                    st.valid_device = True
                elif isinstance(d, DelegateStore):
                    st = state.setdefault(d.var, _VState(False, False))
                    if not st.valid_device:
                        raise PlanGap(
                            f"store of {d.var!r} with no valid device copy")
                    store_hits.setdefault(i, []).append(st.valid_host)
                    st.valid_host = True
            elif op.kind == "block":
                blk = program.blocks[op.block_idx]
                on_device = blk.kind is BlockKind.OFFLOAD
                for v in blk.effective_reads():
                    st = state.setdefault(v, _VState(False, False))
                    ok = st.valid_device if on_device else st.valid_host
                    if not ok:
                        src_ok = st.valid_host if on_device else \
                            st.valid_device
                        if not src_ok:
                            raise PlanGap(
                                f"{blk.name!r} reads {v!r} but no valid "
                                "copy exists anywhere")
                        if on_device:
                            fix = (PlanOp("directive",
                                          directive=AdvancedLoad(
                                              v, group=0,
                                              asynchronous=False)),)
                        else:
                            # the emergency download must be preceded by
                            # a wait point: the device value may come
                            # from an asynchronous callsite, and an
                            # unsynchronized d2h of it is the async race
                            # the plan verifier rejects
                            fix = (PlanOp("directive",
                                          directive=Synchronize(
                                              block_idx=-1, group=0)),
                                   PlanOp("directive",
                                          directive=DelegateStore(
                                              v, group=0)))
                        key = (i, v, type(fix[-1].directive).__name__)
                        gaps.setdefault(key, (i, fix))
                        if on_device:
                            st.valid_device = True
                        else:
                            st.valid_host = True
                for v in blk.writes:
                    st = state.setdefault(v, _VState(False, False))
                    if on_device:
                        st.valid_device, st.valid_host = True, False
                    else:
                        st.valid_host, st.valid_device = True, False
            i += 1

    exec_range(0, len(ops))
    always_redundant = {
        pos for pos, flags in load_hits.items() if flags and all(flags)
    }
    always_redundant |= {
        pos for pos, flags in store_hits.items() if flags and all(flags)
    }
    return always_redundant, list(gaps.values())


class SimulateFixPass(Pass):
    """Validate, elide redundant transfers, insert emergency fixes."""

    name = "simulate_fix"

    def __init__(self, *, elide: bool = True, max_rounds: int = 8):
        self.elide = elide
        self.max_rounds = max_rounds

    def run(self, draft: PlanDraft) -> None:
        ops = draft.ops
        for _round in range(self.max_rounds):
            try:
                redundant, gaps = simulate(draft.program, ops)
            except PlanGap as e:
                raise RuntimeError(
                    f"planner produced an invalid plan: {e}")
            if gaps:
                # insert emergency transfers (kept rare by construction)
                for pos, fix_ops in sorted(gaps, key=lambda t: -t[0]):
                    ops = ops[:pos] + list(fix_ops) + ops[pos:]
                continue
            if self.elide and redundant:
                ops = [op for i, op in enumerate(ops)
                       if i not in redundant]
                continue
            draft.ops = ops
            return
        raise RuntimeError("planner failed to converge")


class NoupdatePass(Pass):
    """Annotate callsites with device-resident inputs (no AdvancedLoad
    between the last producer and the callsite)."""

    name = "noupdate"

    def run(self, draft: PlanDraft) -> None:
        program, an = draft.program, draft.analysis
        if any(op.kind == "directive" and isinstance(op.directive, Callsite)
               for op in draft.ops):
            return        # already tagged (idempotent)
        loaded_since_host_write: Set[str] = set()
        out: List[PlanOp] = []
        for op in draft.ops:
            if op.kind == "block":
                blk = program.blocks[op.block_idx]
                if blk.kind is BlockKind.OFFLOAD:
                    io = an.io_table[blk.idx]
                    noup = tuple(
                        v for v, d in sorted(io.items())
                        if d is not VarIO.OUT and v not in
                        loaded_since_host_write
                    )
                    out.append(PlanOp("directive", directive=Callsite(
                        block_idx=blk.idx, group=draft.group_of[blk.idx],
                        io=tuple(sorted((v, d.value)
                                        for v, d in io.items())),
                        noupdate=noup, asynchronous=True)))
                    out.append(op)
                    for v in blk.writes:
                        loaded_since_host_write.discard(v)
                    continue
                else:
                    for v in blk.writes:
                        loaded_since_host_write.discard(v)
            if op.kind == "directive" and isinstance(op.directive,
                                                     AdvancedLoad):
                loaded_since_host_write.add(op.directive.var)
            out.append(op)
        draft.ops = out
