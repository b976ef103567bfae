"""Plan → compiled schedule lowering.

The interpreter in ``executor.py`` re-dispatches every directive and block
through Python each time it is reached — a loop body with three codelets
costs three launch boundaries plus directive dispatch *per iteration*.
This module lowers a ``Plan`` once into a **compiled schedule**:

* Maximal runs of offload blocks and their transfer directives (no host
  blocks, no loop boundaries, no ``Release``) become a ``_Segment``.
* Each segment's blocks are replayed together by ONE fused function,
  handed to the backend's ``compile_fused`` once (eager on the backends
  here: one call runs the segment's blocks back to back); loop
  iterations re-enter it.  Uploads stay outside
  the trace (they are real h2d transfers, counted per execution, enqueued
  async on the directive's stream); the values a ``DelegateStore``
  captures mid-segment are threaded out as extra fused outputs so the
  download sees exactly the value at the store's program point.
* A loop whose body lowers to a SINGLE pure-device segment (offload
  blocks and syncs only — no host blocks, no ``AdvancedLoad``/
  ``DelegateStore``/``Release`` inside the body) and that the planner
  has marked loop-invariant (``plan.meta["pure_device_loops"]``) is
  rolled whole into ONE backend dispatch (``Backend.launch_loop``, a
  Python loop inside one dispatch), carrying the segment's device values
  as loop state.  Iterations then run back-to-back on the device with
  no per-iteration Python re-entry at all.
* Host blocks, remaining loops and ``Release`` fall back to the
  interpreter's primitives.

Contract (tested): for any plan, ``execute(p, mode="compiled")`` returns
bitwise-identical outputs to ``execute(p, mode="interpreted")`` on the
same backend, with identical *logical* ``ExecStats`` transfer counts —
``kernel_calls``/``syncs`` still count per iteration inside a fused
loop while ``fused_launches`` counts 1; only wall-time fields (and
``fused_launches``) differ.

A segment is split before an ``AdvancedLoad`` whose variable an earlier
op in the same segment dirtied — stored (the upload must observe the
host value the download produced) or block-wrote (the interpreter
rejects the now-stale host copy, and so must we) — since the driver
issues every upload before the fused launch.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

from .backend import Backend
from .executor import (ExecStats, PlanExecutionError, _nest, _run_block,
                       _Slot, do_load, do_release, do_store, do_sync,
                       dummy_arg, kernel_fn)
from .ir import (AdvancedLoad, BlockKind, Callsite, DelegateStore, GroupDecl,
                 Plan, PlanOp, Program, Release, Synchronize)

__all__ = ["compile_plan", "CompiledPlan", "fusable_loops"]


# --------------------------------------------------------------------------
# Segment representation.
# --------------------------------------------------------------------------

@dataclasses.dataclass
class _Segment:
    """A fused run of directives + offload blocks.

    ``items`` is the ordered lowering of the run:
        ('load',  AdvancedLoad, load_index)
        ('store', DelegateStore, store_index)
        ('sync',  Synchronize)
        ('block', block_idx)
    ``arg_spec`` describes the fused function's positional arguments:
        ('entry', var)   device value resident at segment entry
        ('load',  i)     the handle uploaded by load #i this execution
        ('dummy', var)   zeros for a pruned (dead) declared read
    """
    items: List[Tuple]
    arg_spec: List[Tuple[str, Any]]
    blocks: List[int]
    n_stores: int
    final_writes: Tuple[str, ...]
    fused: Optional[Callable[..., Tuple[Any, ...]]] = None


def _build_segment(run: List[PlanOp], program: Program) -> _Segment:
    items: List[Tuple] = []
    arg_spec: List[Tuple[str, Any]] = []
    arg_index: Dict[Tuple[str, Any], int] = {}
    defined: set = set()          # vars bound inside the trace
    blocks: List[int] = []
    writes_order: List[str] = []
    n_loads = n_stores = 0

    def argpos(key: Tuple[str, Any]) -> int:
        if key not in arg_index:
            arg_index[key] = len(arg_spec)
            arg_spec.append(key)
        return arg_index[key]

    def need(var: str) -> None:
        if var not in defined:
            argpos(("entry", var))
            defined.add(var)

    for op in run:
        if op.kind == "directive":
            d = op.directive
            if isinstance(d, AdvancedLoad):
                argpos(("load", n_loads))
                items.append(("load", d, n_loads))
                defined.add(d.var)
                n_loads += 1
            elif isinstance(d, DelegateStore):
                need(d.var)
                items.append(("store", d, n_stores))
                n_stores += 1
            elif isinstance(d, Synchronize):
                items.append(("sync", d))
            # GroupDecl / Callsite are metadata: dropped from the lowering
        else:
            blk = program.blocks[op.block_idx]
            actual = set(blk.effective_reads())
            for v in blk.reads:
                if v in actual:
                    need(v)
                else:
                    argpos(("dummy", v))
            items.append(("block", blk.idx))
            blocks.append(blk.idx)
            for w in blk.writes:
                defined.add(w)
                if w not in writes_order:
                    writes_order.append(w)

    return _Segment(items=items, arg_spec=arg_spec, blocks=blocks,
                    n_stores=n_stores, final_writes=tuple(writes_order))


def _replay_block(blk, xp, env: Dict[str, Any], get_dummy,
                  variants=None) -> None:
    """The single shared per-block replay both compiled paths trace:
    actual reads come from ``env``, pruned (dead) declared reads from
    ``get_dummy(var)``, and every write lands back in ``env``.  Keeping
    this in one place is what keeps segment mode and fused-loop mode
    bitwise-interchangeable (and is the one spot kernel tile variants
    bind into compiled traces)."""
    actual = set(blk.effective_reads())
    kwargs = {v: (env[v] if v in actual else get_dummy(v))
              for v in blk.reads}
    out = kernel_fn(blk, variants)(xp, **kwargs)
    for w in blk.writes:
        env[w] = out[w]


def _make_fused(seg: _Segment, program: Program, xp, variants=None):
    """The traced body: replays the segment symbolically; returns the
    store-captured values followed by the final device value of every
    block-written variable."""
    entry_pos = {k[1]: i for i, k in enumerate(seg.arg_spec)
                 if k[0] == "entry"}
    load_pos = {k[1]: i for i, k in enumerate(seg.arg_spec)
                if k[0] == "load"}
    dummy_pos = {k[1]: i for i, k in enumerate(seg.arg_spec)
                 if k[0] == "dummy"}

    def fused(*args):
        env = {v: args[i] for v, i in entry_pos.items()}
        stores: List[Any] = [None] * seg.n_stores
        for it in seg.items:
            if it[0] == "load":
                env[it[1].var] = args[load_pos[it[2]]]
            elif it[0] == "block":
                _replay_block(program.blocks[it[1]], xp, env,
                              lambda v: args[dummy_pos[v]], variants)
            elif it[0] == "store":
                stores[it[2]] = env[it[1].var]
        return tuple(stores) + tuple(env[v] for v in seg.final_writes)

    return fused


_DUMMY = "__dummy__"    # carry-key prefix for pruned (dead) declared reads


@dataclasses.dataclass
class _FusedLoop:
    """A whole loop (or a nest of pure loops) rolled into one dispatch.

    ``seg`` is the innermost body's (single, pure-device) segment; the
    carry is a dict over the segment's entry variables (+
    ``_DUMMY``-prefixed placeholders for pruned reads), and after the
    launch the final device value of every body-written variable is read
    back out of the carry.  For a nested fusion ``body_fn`` is the outer
    body (an in-trace loop over the inner body via
    ``Backend.loop_in_body``) and ``logical_iters`` is the total
    per-launch iteration multiplier (product of the nest's trip counts)
    used for logical stats parity.
    """
    loop_id: int
    n_iters: int
    seg: _Segment
    body_fn: Any            # carry dict -> carry dict, over backend.xp
    logical_iters: int = 0  # == n_iters unless nested

    def __post_init__(self):
        if not self.logical_iters:
            self.logical_iters = self.n_iters


def _make_loop_body(seg: _Segment, program: Program, xp, variants=None):
    """The per-iteration body replayed over a carry dict: blocks run in
    program order reading/writing the carry (via the same ``_replay_block``
    the segment path traces); sync items are wait points handled by the
    driver, a no-op inside the trace."""
    def body(env):
        env = dict(env)
        for it in seg.items:
            if it[0] == "block":
                _replay_block(program.blocks[it[1]], xp, env,
                              lambda v: env[_DUMMY + v], variants)
        return env
    return body


def fusable_loops(p: Plan) -> set:
    """Loop ids the compiled path will actually roll whole — the STATIC
    twin of ``_try_fuse_loop`` below (kept adjacent so the two rules
    change together; the tuner's cost model prices dispatches with it).
    A loop qualifies iff it is planner-pure AND its body is either
    blocks/syncs only (lowers to one segment) or exactly one fusable
    inner loop with nothing beside it (lowers to one nested node)."""
    pure = set(p.meta.get("pure_device_loops", ()))
    children: Dict[int, List[int]] = {}
    content: Dict[int, int] = {}
    stack: List[int] = []
    for op in p.ops:
        if op.kind == "loop_begin":
            if stack:
                children.setdefault(stack[-1], []).append(op.loop_id)
            stack.append(op.loop_id)
            children.setdefault(op.loop_id, [])
            content.setdefault(op.loop_id, 0)
        elif op.kind == "loop_end":
            stack.pop()
        elif stack and op.kind == "block":
            content[stack[-1]] += 1

    def ok(lid: int) -> bool:
        if lid not in pure:
            return False
        kids = children.get(lid, [])
        if not kids:
            return content.get(lid, 0) > 0
        return (len(kids) == 1 and content.get(lid, 0) == 0
                and ok(kids[0]))

    return {lid for lid in pure if ok(lid)}


def _make_nested_body(child: _FusedLoop, be: Backend):
    """Outer-loop body for a nested fusion: one sweep of the inner fused
    loop inside the launch (``Backend.loop_in_body``)."""
    def body(env):
        return be.loop_in_body(child.body_fn, child.n_iters, env)
    return body


def _try_fuse_loop(loop_id: int, inner: List[Tuple], p: Plan,
                   be: Backend, variants=None) -> Optional[Tuple]:
    """Return a ``("fused_loop", _FusedLoop)`` node when the loop body is
    provably pure-device: the planner marked the loop invariant AND the
    body lowered to exactly one segment with blocks but no transfers —
    or to exactly one already-fused inner loop, in which case the nest
    rolls into a single nested launch.  (The structural
    check keeps hand-mutated plans safe: a load spliced into the body
    disqualifies it regardless of the stale meta.)"""
    if loop_id not in p.meta.get("pure_device_loops", ()):
        return None
    if len(inner) != 1:
        return None
    n_iters = p.program.loops[loop_id].n_iters
    if n_iters < 1:
        return None
    if inner[0][0] == "fused_loop":
        child: _FusedLoop = inner[0][1]
        return ("fused_loop", _FusedLoop(
            loop_id=loop_id, n_iters=n_iters, seg=child.seg,
            body_fn=_make_nested_body(child, be),
            logical_iters=n_iters * child.logical_iters))
    if inner[0][0] != "seg":
        return None
    seg: _Segment = inner[0][1]
    if not seg.blocks:
        return None
    if any(it[0] in ("load", "store") for it in seg.items):
        return None
    return ("fused_loop", _FusedLoop(
        loop_id=loop_id, n_iters=n_iters, seg=seg,
        body_fn=_make_loop_body(seg, p.program, be.xp, variants)))


def _donatable(seg: _Segment) -> Tuple[int, ...]:
    """Args safe to donate: device inputs whose variable the segment
    rewrites — after the fused call the driver only keeps the new value."""
    rewritten = set(seg.final_writes)
    out = []
    for i, (tag, v) in enumerate(seg.arg_spec):
        if tag == "entry" and v in rewritten:
            out.append(i)
    return tuple(out)


# --------------------------------------------------------------------------
# Lowering: plan tree -> schedule of host blocks / segments / loops.
# --------------------------------------------------------------------------

def _lower(tree, p: Plan, be: Backend, fuse_loops: bool,
           variants=None) -> List[Tuple]:
    program = p.program
    schedule: List[Tuple] = []
    run: List[PlanOp] = []
    # vars whose host copy an in-segment op has changed (DelegateStore) or
    # invalidated (a block write): a later AdvancedLoad of such a var must
    # start a new segment, because the driver issues every upload before
    # the fused launch and would otherwise read the pre-segment host value
    # (or silently accept a host copy the interpreter rejects as stale)
    dirty_vars: set = set()

    def flush() -> None:
        nonlocal run, dirty_vars
        if run:
            seg = _build_segment(run, program)
            if seg.blocks:
                fused = _make_fused(seg, program, be.xp, variants)
                seg.fused = be.compile_fused(fused, _donatable(seg))
            schedule.append(("seg", seg))
        run, dirty_vars = [], set()

    for item in tree:
        if item[0] == "loop":
            flush()
            _, loop_id, body = item
            inner = _lower(body, p, be, fuse_loops, variants)
            node = _try_fuse_loop(loop_id, inner, p, be, variants) \
                if fuse_loops else None
            schedule.append(node or ("loop", loop_id, inner))
            continue
        op: PlanOp = item[1]
        if op.kind == "block":
            blk = program.blocks[op.block_idx]
            if blk.kind is BlockKind.HOST:
                flush()
                schedule.append(("host", blk.idx))
            else:
                run.append(op)
                dirty_vars.update(blk.writes)
            continue
        d = op.directive
        if isinstance(d, Release):
            flush()
            schedule.append(("release", d))
        elif isinstance(d, (GroupDecl, Callsite)):
            continue
        elif isinstance(d, AdvancedLoad) and d.var in dirty_vars:
            flush()          # upload must see the in-segment host state
            run.append(op)
        else:
            if isinstance(d, DelegateStore):
                dirty_vars.add(d.var)
            run.append(op)
    flush()
    return schedule


# --------------------------------------------------------------------------
# Compiled plan driver.
# --------------------------------------------------------------------------

@dataclasses.dataclass
class CompiledPlan:
    plan: Plan
    backend: Backend
    schedule: List[Tuple]

    def run(self, env: Dict[str, _Slot], stats: ExecStats,
            check: bool) -> None:
        self._run_schedule(self.schedule, env, stats, check)

    def _run_schedule(self, schedule, env, stats, check) -> None:
        program = self.plan.program
        be = self.backend
        for item in schedule:
            kind = item[0]
            if kind == "loop":
                for _ in range(program.loops[item[1]].n_iters):
                    self._run_schedule(item[2], env, stats, check)
            elif kind == "fused_loop":
                self._run_fused_loop(item[1], env, stats, check)
            elif kind == "host":
                _run_block(program, item[1], env, stats, check, be)
            elif kind == "release":
                do_release(item[1], env, be, self.plan)
            else:
                self._run_segment(item[1], env, stats, check)

    def _run_fused_loop(self, node: _FusedLoop, env, stats: ExecStats,
                        check: bool) -> None:
        """One backend dispatch for the whole loop; logical stats still
        count every iteration (``kernel_calls``/``syncs`` scale with the
        trip count, ``fused_launches`` counts 1)."""
        be = self.backend
        seg = node.seg
        carry: Dict[str, Any] = {}
        for tag, v in seg.arg_spec:
            slot = env.setdefault(v, _Slot())
            if tag == "dummy":
                carry[_DUMMY + v] = dummy_arg(slot, be)
                continue
            if not slot.valid_device:
                if check:
                    raise PlanExecutionError(
                        f"fused loop reads {v!r}: not on device "
                        "(missing advancedload)")
                slot.device = be.upload(slot.host, name=v)
                slot.valid_device = True
            carry[v] = slot.device

        # rewritten entry vars are safe to donate: after the launch the
        # driver only keeps the carry's new value (opt-in per backend)
        donate = tuple(v for tag, v in seg.arg_spec
                       if tag == "entry" and v in seg.final_writes)
        t = time.perf_counter()
        out = be.launch_loop(node.body_fn, node.n_iters, carry,
                             donate_keys=donate)
        stats.kernel_time += time.perf_counter() - t
        stats.kernel_calls += len(seg.blocks) * node.logical_iters
        stats.fused_launches += 1

        for w in seg.final_writes:
            slot = env.setdefault(w, _Slot())
            slot.device = out[w]
            slot.valid_device, slot.valid_host = True, False

        # syncs inside the body: one real wait after the launch, counted
        # once per iteration for parity with the interpreter
        for it in seg.items:
            if it[0] == "sync":
                d = it[1]
                t = time.perf_counter()
                be.sync(d.stream)
                be.sync(0)
                stats.sync_time += time.perf_counter() - t
                stats.syncs += node.logical_iters

    def _run_segment(self, seg: _Segment, env, stats: ExecStats,
                     check: bool) -> None:
        be = self.backend
        # 1. issue every upload (async, on its directive's stream) --------
        load_handles: Dict[int, Any] = {}
        for it in seg.items:
            if it[0] == "load":
                load_handles[it[2]] = do_load(it[1], env, stats, be)

        if not seg.blocks:
            # pure transfer/sync segment: no compute to fuse
            for it in seg.items:
                if it[0] == "sync":
                    do_sync(it[1], stats, be)
                elif it[0] == "store":
                    do_store(it[1], env, stats, be)
            return

        # 2. gather fused args --------------------------------------------
        args: List[Any] = []
        for tag, v in seg.arg_spec:
            if tag == "load":
                args.append(load_handles[v])
                continue
            slot = env.setdefault(v, _Slot())
            if tag == "dummy":
                args.append(dummy_arg(slot, be))
                continue
            if not slot.valid_device:
                if check:
                    raise PlanExecutionError(
                        f"compiled segment reads {v!r}: not on device "
                        "(missing advancedload)")
                slot.device = be.upload(slot.host, name=v)
                slot.valid_device = True
            args.append(slot.device)

        # 3. one fused launch for the whole segment -----------------------
        t = time.perf_counter()
        outs = seg.fused(*args)
        stats.kernel_time += time.perf_counter() - t
        stats.kernel_calls += len(seg.blocks)   # logical count parity
        stats.fused_launches += 1
        for o in outs:
            be.track(o, stream=0)
        store_vals = outs[:seg.n_stores]
        final_map = dict(zip(seg.final_writes, outs[seg.n_stores:]))

        # 4. replay directives/flags in program order ---------------------
        for it in seg.items:
            if it[0] == "sync":
                do_sync(it[1], stats, be)
            elif it[0] == "store":
                do_store(it[1], env, stats, be, handle=store_vals[it[2]])
            elif it[0] == "block":
                blk = self.plan.program.blocks[it[1]]
                for w in blk.writes:
                    slot = env.setdefault(w, _Slot())
                    slot.device = final_map[w]
                    slot.valid_device, slot.valid_host = True, False


def compile_plan(p: Plan, backend: Backend, *,
                 fuse_loops: bool = True,
                 kernel_variants=None,
                 verify: bool = False) -> CompiledPlan:
    """Lower ``p`` for ``backend``; each segment's fused function goes
    through the backend's ``compile_fused`` once.
    ``fuse_loops=False`` keeps eligible loops as per-iteration segment
    dispatches (the PR-1 behaviour) — useful for benchmarking the
    whole-loop lowering win in isolation.  ``kernel_variants`` binds tile
    parameters onto kernel-tagged blocks inside the traced bodies (see
    ``execute``).  ``verify=True`` statically vets the plan
    (``repro_torch.core.verify``) before lowering — donation safety is judged
    against this backend's donation flag — and raises
    ``PlanVerificationError`` instead of compiling a broken schedule."""
    if verify:
        from .verify import verify_plan
        donating = (bool(getattr(backend, "supports_donation", False))
                    and bool(getattr(backend, "donate", False)))
        verify_plan(p, donate=donating,
                    kernel_variants=kernel_variants or None,
                    collect_lints=False).raise_if_failed()
    tree = _nest(p.ops, p.program)
    schedule = _lower(tree, p, backend, fuse_loops, kernel_variants)
    return CompiledPlan(plan=p, backend=backend, schedule=schedule)
