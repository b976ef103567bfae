"""Render a Plan as HMPP-style annotated pseudo-source (paper Table 2).

This is the S2S "generated code" artifact: the program's blocks interleaved
with the planner's directives, in HMPP's pragma syntax (with TPU as the
target).  ``emit(plan)`` returns the text; the 3MM example reproduces the
structure of the paper's Table 2 (group + mapbyname up front, codelet decls,
advancedload hoisted next to the producing loop, async callsites,
synchronize before first use, delegatestore ALAP, release at the end).
"""
from __future__ import annotations

from typing import List

from .ir import (AdvancedLoad, Callsite, DelegateStore, GroupDecl, Plan,
                 Release, Synchronize)

__all__ = ["emit"]


def _fmt_args(pairs) -> str:
    by_io = {}
    for var, io in pairs:
        by_io.setdefault(io, []).append(var)
    parts = []
    for io in ("in", "out", "inout"):
        if io in by_io:
            parts.append(f"args[{', '.join(by_io[io])}].io={io}")
    return ", ".join(parts)


def emit(plan: Plan) -> str:
    prog = plan.program
    lines: List[str] = []
    indent = 0

    def w(s: str) -> None:
        lines.append("    " * indent + s)

    # plan-space autotuner verdict (ISSUE 4): which candidate this source
    # is, and what the cost model predicted/measured for it
    tuning = plan.meta.get("tuning")
    if tuning:
        cands = [c for c in tuning["candidates"] if c.get("valid")]
        chosen = next((c for c in cands
                       if c["label"] == tuning["chosen"]), None)
        w(f"#pragma omp2hmpp tuned, variant={tuning['chosen']}, "
          f"explored={len(cands)} candidates, "
          f"backend={tuning['backend']}")
        if chosen is not None:
            meas = ("" if chosen.get("measured_s") is None else
                    f", measured={chosen['measured_s'] * 1e3:.3f}ms")
            w("#pragma omp2hmpp cost, "
              f"predicted={chosen['predicted_s'] * 1e3:.3f}ms"
              f" (transfer={chosen['transfer_s'] * 1e3:.3f}"
              f" + dispatch={chosen['dispatch_s'] * 1e3:.3f}"
              f" + kernel={chosen['kernel_s'] * 1e3:.3f}){meas}")
        w("")

    # static-verifier verdict (ISSUE 7): this source was vetted for
    # races, transfer consistency and donation safety before emission
    verdict = plan.meta.get("verify")
    if verdict:
        w(f"#pragma omp2hmpp verified, ok={str(verdict['ok']).lower()}, "
          f"errors={verdict['n_errors']}, lints={verdict['n_lints']}, "
          f"ops={verdict['checked_ops']}")
        w("")

    # codelet declarations (outlined kernels), paper Table 2 lines 1-27
    for blk in prog.offload_blocks():
        g = None
        for d in plan.directives(Callsite):
            if d.block_idx == blk.idx:
                g = d.group
                break
        io = plan.io_table[blk.idx]
        w(f"#pragma hmpp <group{g}> {blk.label} codelet, "
          f"{_fmt_args(sorted((v, d.value) for v, d in io.items()))}")
        ins = ", ".join(blk.effective_reads())
        w(f"void {blk.label}({ins})  /* outlined from block "
          f"{blk.idx}: {blk.name} */")
        w("")

    w(f"int main()  /* program: {prog.name} */")
    w("{")
    indent += 1

    fused_loops = set(plan.pure_device_loops())
    for op in plan.ops:
        if op.kind == "loop_begin":
            info = prog.loops[op.loop_id]
            if op.loop_id in fused_loops:
                # planner intent: the compiled path re-verifies the body
                # structurally before actually fusing (see core.compile)
                w("#pragma hmpp region, target=TPU  /* whole-loop "
                  f"lowering: planner proved the {info.n_iters}-iteration "
                  "body device-pure; eligible for ONE fused launch */")
            w(f"for (int it{op.loop_id} = 0; it{op.loop_id} < "
              f"{info.n_iters}; ++it{op.loop_id}) {{")
            indent += 1
        elif op.kind == "loop_end":
            indent -= 1
            w("}")
        elif op.kind == "block":
            blk = prog.blocks[op.block_idx]
            if blk.kind.value == "host":
                w(f"{', '.join(blk.writes)} = {blk.name}"
                  f"({', '.join(blk.effective_reads())});   /* host */")
        elif op.kind == "directive":
            d = op.directive
            if isinstance(d, GroupDecl):
                w(f"#pragma hmpp <group{d.group}> group, target={d.target}")
                if d.mapbyname:
                    w(f"#pragma hmpp <group{d.group}> mapbyname, "
                      f"{', '.join(d.mapbyname)}")
            elif isinstance(d, AdvancedLoad):
                note = ""
                if d.hoisted_from:
                    note = ("  /* hoisted out of loop(s) "
                            f"{list(d.hoisted_from)} — ASAP after last "
                            "CPU write */")
                w(f"#pragma hmpp <group{d.group}> advancedload, "
                  f"args[{d.var}]"
                  + (", asynchronous" if d.asynchronous else "")
                  + (f", stream={d.stream}" if d.stream else "") + note)
            elif isinstance(d, DelegateStore):
                note = ""
                if d.hoisted_from:
                    note = ("  /* sunk before loop(s) "
                            f"{list(d.hoisted_from)} — ALAP before first "
                            "CPU read */")
                w(f"#pragma hmpp <group{d.group}> delegatedstore, "
                  f"args[{d.var}]"
                  + (f", stream={d.stream}" if d.stream else "") + note)
            elif isinstance(d, Callsite):
                blk = prog.blocks[d.block_idx]
                extra = ""
                if d.noupdate:
                    extra = (", args[" + ", ".join(d.noupdate)
                             + "].noupdate=true")
                if d.asynchronous:
                    extra += ", asynchronous"
                w(f"#pragma hmpp <group{d.group}> {blk.label} callsite"
                  f"{extra}")
                w(f"{blk.label}({', '.join(blk.effective_reads())});")
            elif isinstance(d, Synchronize):
                blk = prog.blocks[d.block_idx] if d.block_idx >= 0 else None
                lbl = blk.label if blk else "<emergency>"
                w(f"#pragma hmpp <group{d.group}> {lbl} synchronize"
                  + (f", stream={d.stream}" if d.stream else ""))
            elif isinstance(d, Release):
                w(f"#pragma hmpp <group{d.group}> release")

    w("return 0;")
    indent -= 1
    w("}")
    return "\n".join(lines)
