"""Static plan verifier — an independent checker for generated plans.

OMP2HMPP's core guarantee is that the directives it *generates* are
correct: the paper's AST analysis (§2) proves every ``advancedload`` /
``delegatedstore`` placement preserves the source program's semantics.
Our plans now come from four sources (pass pipeline, tuner candidate
enumeration, tunecache round-trips, hand-built tests) but until this
module the only validity authority was ``SimulateFixPass`` — which both
*fixes* and *judges* plans, so a planner bug, a stale cache entry or a
bad mutation would execute silently wrong.

``verify_plan(plan)`` re-derives correctness from nothing but the plan:
it walks the linearized ops (loop bodies twice — the same 2-iteration
abstraction ``simulate`` uses) against a per-variable memory-state
abstract interpretation and a happens-before model of the runtime's
streams:

    host / device        which spaces hold a valid copy of the var
    dirty                the device copy is newer than the host copy
                         (set by offload writes, cleared by stores)
    in-flight (s, g)     an asynchronous upload enqueued on logical
                         stream ``s`` for group ``g`` that no wait
                         point has completed yet
    async producer       the op index of an asynchronous callsite whose
                         write to the var has not been synchronized
    released             the device copy was freed by ``Release``

Happens-before edges mirror the executor/backends exactly: transfers on
one logical stream are FIFO; ``Synchronize(stream=s)`` completes every
upload whose stream folds onto the same physical queue as ``s`` *and*
all stream-0 compute (``do_sync`` waits both); a callsite completes its
OWN group's in-flight transfers (HMPP: codelet arguments are group
buffers — the launch depends on them), which is why a pipelined plan
with asynchronous loads and no pre-callsite sync is race-free while a
cross-group or re-streamed mutant is not; downloads are synchronous
wait points (``np.asarray`` forces the value).

Violation taxonomy (``Violation.kind``):

    ``async-race``        error — a device read of an upload still in
                          flight on another group's stream, or a
                          download of an async callsite's result with
                          no intervening ``Synchronize``
    ``stale-host-read``   error — a host block (or the program's
                          declared outputs) reads a var whose only
                          up-to-date copy is device-dirty (missing
                          ``DelegateStore``)
    ``use-after-release`` error — a device read/download of a var whose
                          device copy ``Release`` freed
    ``use-after-donation``error — with donation in effect, an offload
                          block rewrites a buffer whose upload is still
                          in flight: the fused launch recycles the
                          buffer under an active DMA
    ``placement-gap``     error — a read with no valid copy anywhere
                          (a deleted/misplaced transfer)
    ``illegal-kernel-tile``error — a kernel-tagged block launched with
                          a tile the registry (``kernels/variants``)
                          rejects for its operand shapes, or an unknown
                          kernel name
    ``mesh-placement``    error — a sharded plan whose placement record
                          is inconsistent: a spec naming a variable the
                          program does not have, a mesh axis the mesh
                          does not declare, a sharded dim the axis size
                          does not divide (the divisibility guard
                          should have dropped it), or a
                          divisibility-guard drop whose variable then
                          has no spec at all (a drop must leave the
                          var explicitly replicated, never a placement
                          gap)
    ``redundant-directive``LINT — duplicate uploads, dead stores,
                          uploads of never-device-read vars (the
                          paper's 3MM "E needs no upload" insight,
                          enforced).  Lints never fail verification:
                          the naive policy keeps its redundant
                          transfers by design.
    ``malformed``         error — structural corruption (unbalanced
                          loops, out-of-range block indices, empty
                          directive slots)

Every violation is op-indexed (``Violation.op_index`` is the position
in ``plan.ops``; ``len(plan.ops)`` means "at program end").  The walk
is best-effort: a violation is recorded, the abstract state repaired,
and checking continues, so one missing transfer reports once instead
of cascading.

This module is deliberately light on imports (no torch): kernel-tile
checks go through the stdlib-only ``repro_torch.kernels.variants`` registry
and operand shapes come from the caller (``shapes=`` — the analyzer's
var → ShapeDtype map) or from the program's bound inputs.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Tuple

from .ir import (AdvancedLoad, BlockKind, Callsite, DelegateStore, GroupDecl,
                 Plan, PlanExecutionError, Release, Synchronize)

__all__ = ["Violation", "VerifyReport", "PlanVerificationError",
           "verify_plan", "VIOLATION_KINDS"]

VIOLATION_KINDS = (
    "async-race", "stale-host-read", "use-after-release",
    "use-after-donation", "placement-gap", "illegal-kernel-tile",
    "mesh-placement", "redundant-directive", "malformed",
)


@dataclasses.dataclass(frozen=True)
class Violation:
    """One finding: ``kind`` from ``VIOLATION_KINDS``, ``severity`` is
    "error" or "lint", ``op_index`` the position in ``plan.ops`` the
    finding anchors to (``len(plan.ops)`` = program end)."""
    kind: str
    severity: str
    op_index: int
    var: Optional[str]
    message: str

    def __str__(self) -> str:
        return (f"[{self.severity}] {self.kind} @op{self.op_index}"
                + (f" var={self.var!r}" if self.var else "")
                + f": {self.message}")


class PlanVerificationError(PlanExecutionError):
    """Raised by ``VerifyReport.raise_if_failed`` — carries the report.

    Subclasses ``PlanExecutionError``: a plan the verifier rejects is a
    plan that cannot execute, so callers guarding ``execute()`` with
    ``except PlanExecutionError`` behave identically whether the failure
    is caught statically (``REPRO_VERIFY=1``) or at runtime.
    """

    def __init__(self, report: "VerifyReport"):
        self.report = report
        super().__init__(report.summary())


@dataclasses.dataclass
class VerifyReport:
    """Outcome of ``verify_plan``: all findings, error/lint split, and a
    JSON-safe ``meta_record()`` for ``plan.meta["verify"]``."""
    plan_name: str
    checked_ops: int
    violations: List[Violation] = dataclasses.field(default_factory=list)

    @property
    def errors(self) -> List[Violation]:
        return [v for v in self.violations if v.severity == "error"]

    @property
    def lints(self) -> List[Violation]:
        return [v for v in self.violations if v.severity == "lint"]

    @property
    def ok(self) -> bool:
        return not self.errors

    def counts(self) -> Dict[str, int]:
        out: Dict[str, int] = {}
        for v in self.violations:
            out[v.kind] = out.get(v.kind, 0) + 1
        return out

    def kinds(self) -> Tuple[str, ...]:
        return tuple(sorted({v.kind for v in self.violations}))

    def summary(self) -> str:
        if not self.violations:
            return (f"plan {self.plan_name!r} verified: "
                    f"{self.checked_ops} ops, no findings")
        head = (f"plan {self.plan_name!r}: {len(self.errors)} error(s), "
                f"{len(self.lints)} lint(s) over {self.checked_ops} ops")
        return "\n".join([head] + [f"  {v}" for v in self.violations])

    def meta_record(self) -> Dict[str, Any]:
        """The compact record planners attach as ``plan.meta["verify"]``
        (see ``ir.Plan``): counts only — the full diagnostics stay on
        the report object."""
        return {"ok": self.ok, "checked_ops": self.checked_ops,
                "n_errors": len(self.errors), "n_lints": len(self.lints),
                "counts": self.counts()}

    def raise_if_failed(self) -> "VerifyReport":
        if not self.ok:
            raise PlanVerificationError(self)
        return self


# --------------------------------------------------------------------------
# Abstract machine.
# --------------------------------------------------------------------------

@dataclasses.dataclass
class _VarState:
    host: bool = False
    device: bool = False
    dirty: bool = False                 # device copy newer than host copy
    inflight: Optional[Tuple[int, int]] = None   # (stream, group) upload
    async_producer: Optional[int] = None         # op idx of unsynced write
    released: bool = False              # device copy freed by Release


def _phys_stream(stream: int, n_streams: int) -> int:
    """Logical → physical stream folding, mirroring
    ``Backend._stream_of``: stream 0 is the compute stream, transfer
    streams 1..∞ fold onto 1..n_streams."""
    if stream == 0:
        return 0
    return 1 + (stream - 1) % max(n_streams, 1)


def _group_vars_of(p: Plan) -> Dict[int, set]:
    """group id → vars it owns (mapbyname + member codelet reads/writes)
    — what a ``Release`` of that group frees (``executor.group_vars``)."""
    out: Dict[int, set] = {}
    for d in p.directives(GroupDecl):
        out.setdefault(d.group, set()).update(d.mapbyname)
    for g, idxs in p.groups.items():
        names = out.setdefault(g, set())
        for bi in idxs:
            blk = p.program.blocks[bi]
            names.update(blk.reads)
            names.update(blk.writes)
    return out


def _input_shapes(p: Plan) -> Dict[str, Any]:
    """Fallback operand shapes from the program's bound inputs (concrete
    arrays or ShapeDtype records both expose .shape/.dtype)."""
    out = {}
    for k, v in p.program.inputs.items():
        if hasattr(v, "shape") and hasattr(v, "dtype"):
            out[k] = v
    return out


def _check_kernel_tiles(p: Plan, kernel_variants, shapes, emit) -> None:
    """Kernel-tile legality for every kernel-tagged block against the
    ``kernels/variants`` registry, at the block's op index.  Blocks whose
    operand shapes are unknown are skipped (nothing to validate against)."""
    from repro_torch.kernels.variants import KERNELS, validate_variant
    kv = {str(k): dict(v) for k, v in dict(kernel_variants or {}).items()}
    shapes = dict(shapes or {})
    for i, op in enumerate(p.ops):
        if op.kind != "block":
            continue
        blk = p.program.blocks[op.block_idx]
        kernel = getattr(blk, "kernel", None)
        if not kernel:
            continue
        if kernel not in KERNELS:
            emit("illegal-kernel-tile", "error", i, None,
                 f"block {blk.name!r} is tagged with unknown kernel "
                 f"{kernel!r} (registry: {sorted(KERNELS)})")
            continue
        try:
            op_shapes = [tuple(shapes[v].shape) for v in blk.reads]
        except (KeyError, AttributeError, TypeError):
            continue             # operand shapes unknown — cannot judge
        params = kv.get(kernel) or dict(KERNELS[kernel]["defaults"])
        missing = [n for n in KERNELS[kernel]["defaults"] if n not in params]
        if missing:
            emit("illegal-kernel-tile", "error", i, None,
                 f"kernel {kernel!r} variant {params} is missing tile "
                 f"parameter(s) {missing}")
            continue
        try:
            v = validate_variant(kernel, op_shapes, params)
        except Exception as e:
            emit("illegal-kernel-tile", "error", i, None,
                 f"kernel {kernel!r} variant {params} rejected: {e}")
            continue
        if v is None:
            emit("illegal-kernel-tile", "error", i, None,
                 f"kernel {kernel!r} tile {params} is illegal for operand "
                 f"shapes {op_shapes} (non-dividing after clamping)")


def _check_mesh_placement(p: Plan, mesh: Dict[str, Any],
                          shapes: Optional[Dict[str, Any]], emit) -> set:
    """Validate a sharded plan's placement record (``meta["mesh"]``).

    The record is the plain-JSON dict ``tuner._mesh_record`` writes —
    ``shape``/``axes`` (the mesh), ``specs`` (var → PartitionSpec
    entries) and ``dropped`` (the divisibility-guard log) — so this
    stays dependency-free.  Returns the set of *sharded* variables (any
    non-None spec entry): the state walk treats consuming a sharded
    operand as a cross-device sync point.
    """
    end = len(p.ops)
    sizes = dict(zip(tuple(mesh.get("axes") or ()),
                     tuple(mesh.get("shape") or ())))
    specs = mesh.get("specs") or {}
    program = p.program
    known = set(program.inputs)
    for blk in program.blocks:
        known.update(blk.reads)
        known.update(blk.writes)
    if shapes:
        known.update(shapes)
    sharded: set = set()
    for var, entries in sorted(specs.items()):
        if var not in known:
            emit("mesh-placement", "error", end, var,
                 f"placement spec names {var!r}, which no program block "
                 "reads or writes and no input binds")
            continue
        dims = None
        sv = (shapes or {}).get(var)
        if sv is not None and hasattr(sv, "shape"):
            dims = tuple(sv.shape)
        entries = tuple(entries or ())
        if dims is not None and len(entries) > len(dims):
            emit("mesh-placement", "error", end, var,
                 f"spec {entries!r} has more entries than {var!r}'s "
                 f"rank {len(dims)}")
            continue
        for d, e in enumerate(entries):
            if e is None:
                continue
            names = tuple(e) if isinstance(e, (list, tuple)) else (e,)
            factor, bad = 1, False
            for a in names:
                if a not in sizes:
                    emit("mesh-placement", "error", end, var,
                         f"spec shards {var!r} dim {d} over mesh axis "
                         f"{a!r}, which mesh {sizes!r} does not declare")
                    bad = True
                    break
                factor *= int(sizes[a])
            if bad:
                continue
            sharded.add(var)
            if dims is not None and factor and dims[d] % factor != 0:
                emit("mesh-placement", "error", end, var,
                     f"spec shards {var!r} dim {d} (size {dims[d]}) over "
                     f"{names!r} ({factor} shards), which does not divide "
                     "it — the divisibility guard should have dropped "
                     "this entry")
    for rec in (mesh.get("dropped") or ()):
        ctx = rec[0] if rec else None
        if ctx is not None and str(ctx) not in specs:
            emit("mesh-placement", "error", end, str(ctx),
                 f"divisibility guard dropped an axis of {ctx!r} but the "
                 "placement carries no spec for it at all — a drop must "
                 "leave the var explicitly replicated, not a gap")
    return sharded


# --------------------------------------------------------------------------
# The verifier walk.
# --------------------------------------------------------------------------

def verify_plan(p: Plan, *, donate: Optional[bool] = None,
                kernel_variants: Optional[Dict[str, Dict[str, int]]] = None,
                shapes: Optional[Dict[str, Any]] = None,
                collect_lints: bool = True,
                mesh: Optional[Dict[str, Any]] = None) -> VerifyReport:
    """Statically verify ``p``; returns a ``VerifyReport`` (never raises
    for plan defects — call ``.raise_if_failed()`` for the hard-error
    contract).

    ``donate``            whether buffer donation is in effect for the
                          execution being vetted (None → the plan's own
                          ``meta["donate"]``)
    ``kernel_variants``   {kernel: {param: value}} tile choice for
                          kernel-tagged blocks (None → the plan's
                          ``meta["kernel_variants"]``, else registry
                          defaults)
    ``shapes``            var → shaped value (the analyzer's
                          ShapeDtype map); falls back to the
                          program's bound inputs
    ``collect_lints``     False skips the redundancy lints (the tuner
                          verifies many candidates and only needs the
                          error verdict)
    ``mesh``              a sharded plan's placement record (the
                          ``meta["mesh"]`` dict written by the tuner:
                          shape/axes/specs/dropped); None → the plan's
                          own ``meta["mesh"]``.  When present, specs
                          are validated (``mesh-placement``) and a
                          sharded operand's consumption counts as a
                          cross-device sync point in the race walk
    """
    program = p.program
    ops = p.ops
    report = VerifyReport(plan_name=program.name, checked_ops=len(ops))
    seen: set = set()

    def emit(kind: str, severity: str, idx: int, var: Optional[str],
             message: str) -> None:
        key = (kind, idx, var)
        if key in seen:
            return
        seen.add(key)
        report.violations.append(Violation(kind, severity, idx, var,
                                           message))

    if donate is None:
        donate = bool(p.meta.get("donate", False))
    if kernel_variants is None:
        kernel_variants = p.meta.get("kernel_variants") or {}
    if mesh is None:
        mesh = p.meta.get("mesh")
    n_streams = int(p.meta.get("n_transfer_streams", 0) or 0)

    # -- structural pass (malformed plans do not get a state walk) ----------
    spans: Dict[int, Tuple[int, int]] = {}
    stack: List[Tuple[int, int]] = []
    malformed = False
    for i, op in enumerate(ops):
        if op.kind == "loop_begin":
            if op.loop_id not in program.loops:
                emit("malformed", "error", i, None,
                     f"loop_begin references unknown loop {op.loop_id}")
                malformed = True
                continue
            stack.append((op.loop_id, i))
        elif op.kind == "loop_end":
            if not stack or stack[-1][0] != op.loop_id:
                emit("malformed", "error", i, None,
                     f"loop_end({op.loop_id}) does not match the open "
                     f"loop nest {[lid for lid, _ in stack]}")
                malformed = True
                continue
            lid, start = stack.pop()
            spans[lid] = (start, i)
        elif op.kind == "block":
            if op.block_idx is None or not (
                    0 <= op.block_idx < len(program.blocks)):
                emit("malformed", "error", i, None,
                     "block op references out-of-range block "
                     f"{op.block_idx}")
                malformed = True
        elif op.kind == "directive":
            if op.directive is None:
                emit("malformed", "error", i, None,
                     "directive op carries no directive")
                malformed = True
        else:
            emit("malformed", "error", i, None,
                 f"unknown plan-op kind {op.kind!r}")
            malformed = True
    for lid, start in stack:
        emit("malformed", "error", start, None,
             f"loop_begin({lid}) is never closed")
        malformed = True
    if malformed:
        return report

    shapes = shapes or _input_shapes(p)
    _check_kernel_tiles(p, kernel_variants, shapes, emit)
    sharded_vars: set = set()
    if mesh:
        sharded_vars = _check_mesh_placement(p, mesh, shapes, emit)

    # -- abstract state -----------------------------------------------------
    state: Dict[str, _VarState] = {
        v: _VarState(host=True) for v in program.inputs
    }
    group_of_block: Dict[int, int] = {}
    for g, idxs in p.groups.items():
        for bi in idxs:
            group_of_block[bi] = g
    pending_callsite: Dict[int, Callsite] = {}
    release_vars = _group_vars_of(p)

    # lint bookkeeping: per-op redundancy flags (loop bodies run twice, a
    # lint fires only when EVERY execution of the op was redundant — the
    # same all-executions rule ``simulate`` uses for elision)
    load_hits: Dict[int, List[bool]] = {}
    store_hits: Dict[int, List[bool]] = {}
    load_was_read: Dict[int, bool] = {}      # upload op -> value device-read
    store_was_used: Dict[int, bool] = {}     # store op -> host value used
    last_load_op: Dict[str, Optional[int]] = {}
    last_store_op: Dict[str, Optional[int]] = {}

    def vstate(v: str) -> _VarState:
        return state.setdefault(v, _VarState())

    def note_device_read(v: str) -> None:
        li = last_load_op.get(v)
        if li is not None:
            load_was_read[li] = True

    def note_host_read(v: str) -> None:
        si = last_store_op.get(v)
        if si is not None:
            store_was_used[si] = True

    def do_directive(i: int, d) -> None:
        if isinstance(d, AdvancedLoad):
            st = vstate(d.var)
            if not st.host:
                emit("placement-gap", "error", i, d.var,
                     f"advancedload of {d.var!r} but no valid host copy "
                     "exists (missing upstream delegatedstore or "
                     "producer)")
                st.host = True           # repair and continue
            if collect_lints:
                load_hits.setdefault(i, []).append(
                    st.device and not st.dirty)
                load_was_read.setdefault(i, False)
            st.device, st.dirty, st.released = True, False, False
            st.inflight = ((d.stream, d.group) if d.asynchronous else None)
            last_load_op[d.var] = i
        elif isinstance(d, DelegateStore):
            st = vstate(d.var)
            if st.released and not st.device:
                emit("use-after-release", "error", i, d.var,
                     f"delegatedstore of {d.var!r} after its group's "
                     "release freed the device copy")
                st.device = True
            elif not st.device:
                emit("placement-gap", "error", i, d.var,
                     f"delegatedstore of {d.var!r} but no valid device "
                     "copy exists")
                st.device = True
            # d2h is a wait point for the stored handle itself
            # (``Backend.download`` blocks until the value is ready), so a
            # pending async upload or callsite of *this* var is completed
            # here, not raced — HMPP would want an explicit synchronize,
            # which the planner always emits, but its absence is safe
            # under this runtime and must not fail hand-mutated plans
            st.inflight = None
            st.async_producer = None
            if collect_lints:
                store_hits.setdefault(i, []).append(
                    st.host and not st.dirty)
                store_was_used.setdefault(i, False)
            note_device_read(d.var)
            st.host, st.dirty = True, False
            last_store_op[d.var] = i
        elif isinstance(d, Synchronize):
            ph = _phys_stream(d.stream, n_streams or 1)
            for st in state.values():
                if st.inflight is not None:
                    s_ph = (_phys_stream(st.inflight[0], n_streams)
                            if n_streams else st.inflight[0])
                    d_ph = (ph if n_streams else d.stream)
                    if s_ph == d_ph:
                        st.inflight = None
                st.async_producer = None     # do_sync also waits stream 0
        elif isinstance(d, Release):
            freed = release_vars.get(d.group, set())
            for v in freed:
                st = vstate(v)
                # the runtime frees only vars with a valid host copy
                # (do_release never drops the sole copy of a value)
                if st.host and st.device:
                    st.device, st.dirty = False, False
                    st.inflight = None
                    st.released = True
        elif isinstance(d, Callsite):
            pending_callsite[d.block_idx] = d

    def do_block(i: int, bidx: int) -> None:
        blk = program.blocks[bidx]
        if blk.kind is BlockKind.OFFLOAD:
            cs = pending_callsite.pop(bidx, None)
            group = (cs.group if cs is not None
                     else group_of_block.get(bidx, 0))
            asynchronous = cs.asynchronous if cs is not None else True
            # the launch depends on its own group's buffers: HMPP
            # completes that group's in-flight transfers here
            for st in state.values():
                if st.inflight is not None and st.inflight[1] == group:
                    st.inflight = None
            reads = set(blk.effective_reads())
            # snapshot uploads still in flight at launch entry: the reads
            # walk below clears ``inflight`` as it reports races, but the
            # donation check needs to know the DMA was live when the
            # donated buffer gets recycled
            dma_live = {v: vstate(v).inflight for v in blk.writes
                        if vstate(v).inflight is not None}
            for v in sorted(reads):
                st = vstate(v)
                # a sharded operand's dispatch waits on every shard of
                # the distributed upload before the SPMD computation
                # (and its collectives) can run: the collective is a
                # cross-device sync point, so the in-flight DMA cannot
                # race the read
                if v in sharded_vars:
                    st.inflight = None
                if st.inflight is not None:
                    emit("async-race", "error", i, v,
                         f"codelet {blk.name!r} reads {v!r} while its "
                         "upload is still in flight on stream "
                         f"{st.inflight[0]} (group {st.inflight[1]} != "
                         f"callsite group {group}) with no synchronize "
                         "on that stream")
                    st.inflight = None
                if not st.device:
                    if st.released:
                        emit("use-after-release", "error", i, v,
                             f"codelet {blk.name!r} reads {v!r} after "
                             "its group's release freed the device copy")
                    elif st.host:
                        emit("placement-gap", "error", i, v,
                             f"codelet {blk.name!r} reads {v!r}: not on "
                             "device (missing advancedload)")
                    else:
                        emit("placement-gap", "error", i, v,
                             f"codelet {blk.name!r} reads {v!r} but no "
                             "valid copy exists anywhere")
                    st.device = True
                note_device_read(v)
            for v in blk.writes:
                st = vstate(v)
                if donate and v in reads and v in dma_live:
                    emit("use-after-donation", "error", i, v,
                         f"donation rewrites {v!r} while its upload is "
                         f"still in flight on stream {dma_live[v][0]}: "
                         "the donated buffer is recycled under an "
                         "active DMA")
                st.device, st.dirty, st.host = True, True, False
                st.released = False
                st.inflight = None
                st.async_producer = i if asynchronous else None
                last_load_op[v] = None   # upload value overwritten
        else:
            for v in sorted(set(blk.effective_reads())):
                st = vstate(v)
                if not st.host:
                    if st.device:
                        emit("stale-host-read", "error", i, v,
                             f"host block {blk.name!r} reads {v!r} but "
                             "the only up-to-date copy is device-dirty "
                             "(missing delegatedstore)")
                    else:
                        emit("placement-gap", "error", i, v,
                             f"host block {blk.name!r} reads {v!r} but "
                             "no valid copy exists anywhere")
                    st.host = True
                note_host_read(v)
            for v in blk.writes:
                st = vstate(v)
                st.host, st.device, st.dirty = True, False, False
                st.inflight = None       # uploaded value now obsolete
                st.async_producer = None
                last_load_op[v] = None

    def exec_range(lo: int, hi: int) -> None:
        i = lo
        while i < hi:
            op = ops[i]
            if op.kind == "loop_begin":
                start, end = spans[op.loop_id]
                for _ in range(2):       # 2-iteration loop abstraction
                    exec_range(start + 1, end)
                i = end + 1
                continue
            if op.kind == "directive":
                do_directive(i, op.directive)
            elif op.kind == "block":
                do_block(i, op.block_idx)
            i += 1

    exec_range(0, len(ops))

    # -- program exit: declared outputs must be host-valid ------------------
    end = len(ops)
    for v in (program.outputs or ()):
        st = state.get(v)
        if st is None or not (st.host or st.device):
            emit("placement-gap", "error", end, v,
                 f"declared output {v!r} is never produced")
        elif not st.host:
            emit("stale-host-read", "error", end, v,
                 f"declared output {v!r} is not on the host at program "
                 "end (missing delegatedstore)")
        else:
            note_host_read(v)

    # -- redundancy lints ----------------------------------------------------
    if collect_lints:
        for i, flags in sorted(load_hits.items()):
            d = ops[i].directive
            if flags and all(flags):
                emit("redundant-directive", "lint", i, d.var,
                     f"duplicate upload: {d.var!r} is already "
                     "device-resident and unchanged on every execution "
                     "of this advancedload")
            elif not load_was_read.get(i, True):
                emit("redundant-directive", "lint", i, d.var,
                     "upload of never-read var: no codelet reads "
                     f"{d.var!r}'s uploaded value before it is "
                     f"overwritten ({d.var!r} needs no advancedload)")
        for i, flags in sorted(store_hits.items()):
            d = ops[i].directive
            if flags and all(flags):
                emit("redundant-directive", "lint", i, d.var,
                     f"duplicate store: the host copy of {d.var!r} is "
                     "already current on every execution of this "
                     "delegatedstore")
            elif not store_was_used.get(i, True):
                emit("redundant-directive", "lint", i, d.var,
                     "dead store: no host read or declared output "
                     f"consumes {d.var!r}'s downloaded value")
    return report
