"""Dataflow analysis over a ``Program`` — the paper's AST analysis, on FX
graphs.

OMP2HMPP walks Mercurium's AST to find, for every variable used by a codelet:
its io direction (``in``/``out``/``inout``), the *last CPU write* before the
callsite and the *first CPU read* after it, with loop-nesting context
(paper §2, Figs. 1-3).  Here each block body is traced to an FX graph on
fake CPU tensors (``make_fx(..., tracing_mode="fake")``), which gives us
exact def/use: declared reads whose placeholder has no users are pruned —
the analogue of the paper noticing that 3MM's kernel never *reads* E before
writing it, so E needs no upload.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
from torch.fx.experimental.proxy_tensor import make_fx

from .dtypes import numpy_dtype, torch_dtype
from .ir import Block, BlockKind, Program, VarIO

__all__ = [
    "ProgramAnalysis", "ShapeDtype", "analyze", "common_prefix",
    "hoist_target", "abstractify",
]


@dataclasses.dataclass(frozen=True)
class ShapeDtype:
    """Abstract value of a program variable.  ``dtype`` is a numpy dtype:
    byte sizes (``PlanDraft.var_nbytes``), the verifier's operand shapes
    and the emitted text all read numpy dtypes."""
    shape: Tuple[int, ...]
    dtype: np.dtype


def abstractify(x: Any) -> ShapeDtype:
    if isinstance(x, ShapeDtype):
        return x
    if isinstance(x, torch.Tensor):
        return ShapeDtype(tuple(x.shape), numpy_dtype(x.dtype))
    arr = np.asarray(x)
    return ShapeDtype(tuple(arr.shape), arr.dtype)


def common_prefix(a: Tuple[int, ...], b: Tuple[int, ...]) -> Tuple[int, ...]:
    out = []
    for x, y in zip(a, b):
        if x != y:
            break
        out.append(x)
    return tuple(out)


def hoist_target(src_path: Tuple[int, ...], dst_path: Tuple[int, ...]
                 ) -> Tuple[Tuple[int, ...], Tuple[int, ...]]:
    """Where a directive tied to a block at ``src_path`` must sit so that it is
    visible to a block at ``dst_path`` exactly once per shared iteration.

    Returns (placement_path, hoisted_loops): the loop path the directive
    should live at (the common prefix of the two paths — paper Fig. 2/3) and
    the loops of ``src_path`` it was hoisted out of.
    """
    shared = common_prefix(src_path, dst_path)
    return shared, src_path[len(shared):]


@dataclasses.dataclass
class VarEvent:
    """One def or use of a variable by a block."""
    block_idx: int
    is_write: bool
    kind: BlockKind
    loop_path: Tuple[int, ...]


@dataclasses.dataclass
class ProgramAnalysis:
    program: Program
    shapes: Dict[str, ShapeDtype]                     # var -> abstract value
    events: Dict[str, List[VarEvent]]                 # var -> ordered events
    io_table: Dict[int, Dict[str, VarIO]]             # offload blk -> var io
    groups: Dict[int, Tuple[int, ...]]                # group -> blk idxs
    group_of: Dict[int, int]                          # offload blk -> group

    # -- the queries the planner asks (paper §2) ---------------------------
    def last_host_write_before(self, var: str, idx: int) -> Optional[VarEvent]:
        best = None
        for ev in self.events.get(var, ()):
            if ev.block_idx >= idx:
                break
            if ev.is_write and ev.kind is BlockKind.HOST:
                best = ev
        return best

    def last_write_before(self, var: str, idx: int) -> Optional[VarEvent]:
        best = None
        for ev in self.events.get(var, ()):
            if ev.block_idx >= idx:
                break
            if ev.is_write:
                best = ev
        return best

    def first_host_read_after(self, var: str, idx: int) -> Optional[VarEvent]:
        """First host READ of ``var`` after block ``idx``, or None if the
        value is overwritten first (write events for inout blocks are emitted
        *after* the matching read event, so ordering handles inout)."""
        for ev in self.events.get(var, ()):
            if ev.block_idx <= idx:
                continue
            if not ev.is_write and ev.kind is BlockKind.HOST:
                return ev
            if ev.is_write:
                # value produced at `idx` is dead past this point
                return None
        return None

    def last_carried_write(self, var: str, blk) -> Optional[VarEvent]:
        """The loop-carried dynamic predecessor write: the max-idx write of
        ``var`` textually AFTER ``blk`` that shares an enclosing loop with
        it — in iterations ≥ 2 this write (from the previous iteration) is
        the freshest value at ``blk``.  None if no such write."""
        if not blk.loop_path:
            return None
        enclosing = set(blk.loop_path)
        best = None
        for ev in self.events.get(var, ()):
            if ev.block_idx > blk.idx and ev.is_write \
                    and enclosing & set(ev.loop_path):
                best = ev
        return best

    def carried_host_read(self, var: str, blk) -> Optional[VarEvent]:
        """A host read of ``var`` textually BEFORE ``blk`` sharing a loop —
        in iterations ≥ 2 it consumes the value ``blk`` wrote in the
        previous iteration (unless another write intervenes at the start of
        the body, which the plan simulation then handles)."""
        if not blk.loop_path:
            return None
        enclosing = set(blk.loop_path)
        for ev in self.events.get(var, ()):
            if ev.block_idx >= blk.idx:
                break
            if not ev.is_write and ev.kind is BlockKind.HOST \
                    and enclosing & set(ev.loop_path):
                return ev
        return None

    def reads_between(self, var: str, lo: int, hi: int,
                      kind: Optional[BlockKind] = None) -> List[VarEvent]:
        out = []
        for ev in self.events.get(var, ()):
            if lo < ev.block_idx < hi and not ev.is_write:
                if kind is None or ev.kind is kind:
                    out.append(ev)
        return out

    def host_write_between(self, var: str, lo: int, hi: int) -> bool:
        for ev in self.events.get(var, ()):
            if lo < ev.block_idx < hi and ev.is_write \
                    and ev.kind is BlockKind.HOST:
                return True
        return False


def _traced_reads(block: Block, env_shapes: Dict[str, ShapeDtype]
                  ) -> Tuple[Tuple[str, ...], Dict[str, ShapeDtype]]:
    """Trace the block body; return (vars actually read, shapes written).

    The body runs under ``torch`` on fake CPU tensors, so tracing moves no
    data and never launches a device kernel (kernel wrappers take their
    plain path for CPU tensors)."""
    names = [v for v in block.reads if v in env_shapes]
    missing = [v for v in block.reads if v not in env_shapes]
    if missing:
        raise ValueError(
            f"block {block.name!r} reads undefined vars {missing}")

    def wrapped(*arrays):
        out = block.fn(torch, **dict(zip(names, arrays)))
        if not isinstance(out, dict):
            raise TypeError(
                f"block {block.name!r} must return a dict of writes")
        return tuple(out[w] for w in block.writes)

    # torch.empty allocates without touching memory; make_fx swaps these
    # examples for fake tensors of the same shape and dtype
    examples = [torch.empty(env_shapes[v].shape,
                            dtype=torch_dtype(env_shapes[v].dtype))
                for v in names]
    graph = make_fx(wrapped, tracing_mode="fake")(*examples).graph
    placeholders = [n for n in graph.nodes if n.op == "placeholder"]
    # an input is actually read iff its placeholder feeds an op or the
    # output (the output node is a user too)
    actual = tuple(name for name, node in zip(names, placeholders)
                   if node.users)
    outvals = next(n for n in graph.nodes if n.op == "output").args[0]
    out_shapes = {w: abstractify(node.meta["val"])
                  for w, node in zip(block.writes, outvals)}
    return actual, out_shapes


def analyze(program: Program) -> ProgramAnalysis:
    """Run the paper's §2 analysis: io classification + def/use timeline."""
    shapes: Dict[str, ShapeDtype] = {
        k: abstractify(v) for k, v in program.inputs.items()
    }
    events: Dict[str, List[VarEvent]] = {}

    def add_event(var, blk, is_write):
        events.setdefault(var, []).append(
            VarEvent(blk.idx, is_write, blk.kind, blk.loop_path))

    for blk in program.blocks:
        actual, out_shapes = _traced_reads(blk, shapes)
        blk.actual_reads = actual
        for v in actual:
            add_event(v, blk, is_write=False)
        for v in blk.writes:
            add_event(v, blk, is_write=True)
        shapes.update(out_shapes)

    # io classification per offload block (paper: args[x].io=...)
    io_table: Dict[int, Dict[str, VarIO]] = {}
    for blk in program.offload_blocks():
        table: Dict[str, VarIO] = {}
        reads, writes = set(blk.effective_reads()), set(blk.writes)
        for v in reads | writes:
            if v in reads and v in writes:
                table[v] = VarIO.INOUT
            elif v in writes:
                table[v] = VarIO.OUT
            else:
                table[v] = VarIO.IN
        io_table[blk.idx] = table

    # grouping: union-find over offload blocks sharing any variable
    parent: Dict[int, int] = {b.idx: b.idx for b in program.offload_blocks()}

    def find(x):
        while parent[x] != x:
            parent[x] = parent[parent[x]]
            x = parent[x]
        return x

    def union(a, b):
        ra, rb = find(a), find(b)
        if ra != rb:
            parent[max(ra, rb)] = min(ra, rb)

    touched: Dict[str, int] = {}
    for blk in program.offload_blocks():
        for v in set(blk.effective_reads()) | set(blk.writes):
            if v in touched:
                union(touched[v], blk.idx)
            else:
                touched[v] = blk.idx

    roots = sorted({find(b.idx) for b in program.offload_blocks()})
    root_to_group = {r: g for g, r in enumerate(roots)}
    group_of = {b.idx: root_to_group[find(b.idx)]
                for b in program.offload_blocks()}
    groups = {
        g: tuple(b.idx for b in program.offload_blocks()
                 if group_of[b.idx] == g)
        for g in root_to_group.values()
    }

    return ProgramAnalysis(
        program=program, shapes=shapes, events=events,
        io_table=io_table, groups=groups, group_of=group_of,
    )
