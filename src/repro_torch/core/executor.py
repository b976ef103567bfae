"""Plan executor: a thin driver over pluggable backends.

The paper's generated HMPP code runs on CPU+GPU; here "host" is numpy and
"device" is whatever ``Backend`` the caller picks (``repro_torch.core.backend``):
a torch device (``cuda:0`` by default) or a pure numpy simulation.  The driver walks a ``Plan``, runs host blocks with
numpy, dispatches offload blocks and transfers through the backend ONLY
where the plan says so — transfer counts/bytes/wall times are recorded,
which is exactly what the paper's Figs. 4-6 measure.

Two execution modes:

``mode="interpreted"``
    Walk the plan tree op by op (the original semantics; every directive
    is dispatched through Python each time it is reached).

``mode="compiled"``
    Lower the plan once via ``repro_torch.core.compile``: runs of offload blocks
    and their directives become fused segments launched as one backend
    call each, and pure-device loops roll into one dispatch.  Outputs are bitwise-identical to
    interpreted mode and the *logical* transfer counts in ``ExecStats``
    match; only the wall-time fields change (that is the point).

The driver also *verifies* the plan: reading a variable from a space with
no valid copy raises ``PlanExecutionError`` (the property tests drive
random programs through this).
"""
from __future__ import annotations

import dataclasses
import functools
import os
import time
from typing import Any, Dict, List, Optional, Set, Tuple

import numpy as np
import torch
from torch.distributed.tensor import DTensor, Replicate

from ..distributed.sharding import is_dtensor
from .backend import Backend, get_backend
from .dtypes import numpy_dtype
from .ir import (AdvancedLoad, BlockKind, Callsite, DelegateStore, GroupDecl,
                 Plan, PlanExecutionError, PlanOp, Program, Release,
                 Synchronize)

__all__ = ["execute", "run_host_oracle", "ExecStats", "PlanExecutionError",
           "group_vars", "kernel_fn"]


@dataclasses.dataclass
class ExecStats:
    h2d_transfers: int = 0
    h2d_bytes: int = 0
    d2h_transfers: int = 0
    d2h_bytes: int = 0
    kernel_calls: int = 0       # logical block launches (also in compiled)
    host_calls: int = 0
    syncs: int = 0
    fused_launches: int = 0     # compiled mode: actual fused dispatches
    h2d_time: float = 0.0
    d2h_time: float = 0.0
    kernel_time: float = 0.0    # compute launches: device time (CUDA
                                # events) on a card, else the host clock
    host_time: float = 0.0
    sync_time: float = 0.0
    wall_time: float = 0.0
    compile_time: float = 0.0   # one-time plan lowering (compiled mode);
                                # NOT folded into wall_time

    def as_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)

    def transfer_counts(self) -> Dict[str, int]:
        """The mode-invariant logical schedule: what the plan *did*."""
        return {"h2d_transfers": self.h2d_transfers,
                "h2d_bytes": self.h2d_bytes,
                "d2h_transfers": self.d2h_transfers,
                "d2h_bytes": self.d2h_bytes,
                "kernel_calls": self.kernel_calls,
                "host_calls": self.host_calls,
                "syncs": self.syncs}


@dataclasses.dataclass
class _Slot:
    host: Optional[np.ndarray] = None
    device: Optional[Any] = None          # backend-opaque handle
    valid_host: bool = False
    valid_device: bool = False


def _nbytes(x) -> int:
    return int(np.prod(np.shape(x))) * numpy_dtype(x.dtype).itemsize


def _kv_norm(kv) -> Dict[str, Dict[str, int]]:
    """Canonical {kernel: {param: int}} view of a kernel-variants mapping
    (accepts the tuple-of-pairs form KernelVariant/JSON round-trips use)."""
    if not kv:
        return {}
    return {str(k): {str(n): int(v) for n, v in dict(params).items()}
            for k, params in dict(kv).items()}


def _kv_key(kv: Dict[str, Dict[str, int]]):
    """Hashable identity of a variant choice (compiled-plan cache key)."""
    return tuple(sorted((k, tuple(sorted(p.items())))
                        for k, p in kv.items()))


def kernel_fn(blk, variants: Optional[Dict[str, Dict[str, int]]] = None):
    """The callable to launch for ``blk``: kernel-tagged blocks get their
    chosen tile parameters bound as keyword arguments and run whole on a
    mesh (``_unsharded``); both are memoized, so caches keyed on fn
    identity still hit.  Every other block launches ``blk.fn``
    unchanged."""
    if not getattr(blk, "kernel", None):
        return blk.fn
    fn = blk.fn
    params = (variants or {}).get(blk.kernel)
    if params:
        from ..kernels.variants import bind_variant
        fn = bind_variant(fn, tuple(sorted(params.items())))
    return _unsharded(fn)


@functools.lru_cache(maxsize=None)
def _unsharded(fn):
    """A kernel-tagged body as the mesh runs it: kernels are not sharded,
    so its DTensor inputs are made whole (``Replicate()``) on every rank,
    the kernel runs on those local tensors, and its outputs come back
    replicated.  Plain inputs pass through untouched."""
    def run(xp, **kw):
        mesh = next((v.device_mesh for v in kw.values() if is_dtensor(v)),
                    None)
        if mesh is None:
            return fn(xp, **kw)
        rep = (Replicate(),) * mesh.ndim
        out = fn(xp, **{k: v.redistribute(placements=rep).to_local()
                        if is_dtensor(v) else v for k, v in kw.items()})
        return {k: DTensor.from_local(v, mesh, rep, run_check=False)
                if torch.is_tensor(v) else v for k, v in out.items()}
    return run


def _verify_default() -> bool:
    """``execute(..., verify=None)`` resolves through the ``REPRO_VERIFY``
    env gate (CI sets it to 1 so every executed plan is statically vetted
    first)."""
    return os.environ.get("REPRO_VERIFY", "").strip().lower() in (
        "1", "true", "on", "yes")


def execute(p: Plan, inputs: Optional[Dict[str, np.ndarray]] = None,
            *, check: bool = True, mode: str = "interpreted",
            backend: Any = None, fuse_loops: Optional[bool] = None,
            kernel_variants: Optional[Dict[str, Dict[str, int]]] = None,
            verify: Optional[bool] = None
            ) -> Tuple[Dict[str, np.ndarray], ExecStats]:
    """Run the plan; return (program outputs on host, stats).

    ``mode`` is "interpreted" or "compiled"; ``backend`` is a
    ``Backend`` instance, a registered name ("torch", "pinned", "numpy"),
    or None for the default torch backend on ``cuda:0``.  ``fuse_loops`` (compiled
    mode only) rolls eligible pure-device loops into a single backend
    dispatch (``Backend.launch_loop``); disable it to benchmark the
    per-iteration segment path.  When left None it follows the plan:
    a tuned winner carries its chosen flag in ``meta["fuse_loops"]``
    (default True), so executing a ``policy="auto"`` plan directly runs
    the variant the tuner measured (donation still needs the matching
    backend — use ``winner_exec_kwargs``).

    ``kernel_variants`` maps kernel names to tile parameters
    ({"flash_attention": {"block_q": 128, "block_k": 64}}) for
    kernel-tagged blocks; when left None it follows the plan
    (``meta["kernel_variants"]``, set by the tuner's winner), so a tuned
    plan launches the winning tile sizes by default.

    ``verify`` runs the static plan verifier (``repro_torch.core.verify``)
    before executing and raises ``PlanVerificationError`` on any race /
    transfer-consistency / donation-safety error; ``None`` follows the
    ``REPRO_VERIFY=1`` environment gate (set in CI).

    One-time plan-lowering cost is reported as ``stats.compile_time`` and
    excluded from ``stats.wall_time``, so first-call and steady-state runs
    report comparable wall times.  ``stats.wall_time`` ends after the
    backend's last launch has completed (``Backend.finish``); on a CUDA
    backend ``stats.kernel_time`` is the device time of the compute
    launches, read from CUDA events after that point.
    """
    if mode not in ("interpreted", "compiled"):
        raise ValueError(f"unknown execution mode {mode!r}")
    if fuse_loops is None:
        fuse_loops = bool(p.meta.get("fuse_loops", True))
    if kernel_variants is None:
        kernel_variants = p.meta.get("kernel_variants")
    kernel_variants = _kv_norm(kernel_variants)
    be = get_backend(backend)
    # a mesh-tuned plan carries its winning per-variable placement in
    # meta["mesh"]; re-apply it on any placement-capable backend so
    # executing the winner directly shards exactly as measured
    mesh_meta = p.meta.get("mesh")
    if mesh_meta and hasattr(be, "with_placement"):
        be = be.with_placement(mesh_meta.get("specs") or {})
    if verify is None:
        verify = _verify_default()
    if verify:
        from .verify import verify_plan
        donating = (mode == "compiled"
                    and bool(getattr(be, "supports_donation", False))
                    and bool(getattr(be, "donate", False)))
        verify_plan(p, donate=donating,
                    kernel_variants=kernel_variants or None,
                    collect_lints=False).raise_if_failed()
    program = p.program
    env: Dict[str, _Slot] = {}
    stats = ExecStats()
    bound = dict(program.inputs)
    if inputs:
        bound.update(inputs)
    for k, v in bound.items():
        if type(v).__name__ == "ShapeDtype":
            raise PlanExecutionError(
                f"program input {k!r} is abstract; pass a concrete array")
        env[k] = _Slot(host=np.asarray(v), valid_host=True)

    be.time_kernels()
    try:
        if mode == "compiled":
            from .compile import compile_plan
            cache = p.meta.setdefault("_compiled", {})
            key = be.name if fuse_loops else be.name + ":nofuse"
            if kernel_variants:
                key += f"|kv={_kv_key(kernel_variants)}"
            fingerprint = hash(tuple(p.ops))   # ops may be mutated by callers
            compiled, fp = cache.get(key, (None, None))
            if compiled is None or compiled.backend is not be \
                    or fp != fingerprint:
                tc = time.perf_counter()
                compiled = compile_plan(p, be, fuse_loops=fuse_loops,
                                        kernel_variants=kernel_variants)
                stats.compile_time = time.perf_counter() - tc
                cache[key] = (compiled, fingerprint)
            t0 = time.perf_counter()
            compiled.run(env, stats, check)
        else:
            # _nest runs per call (unlike the cached compiled lowering), so
            # it stays inside wall_time: it IS part of interpreted dispatch
            t0 = time.perf_counter()
            tree = _nest(p.ops, program)
            _run(tree, p, env, stats, check, be, kernel_variants)
        be.finish()
        stats.wall_time = time.perf_counter() - t0
    finally:
        kernel_s = be.kernel_seconds()
    if kernel_s is not None:
        stats.kernel_time = kernel_s

    outs = {}
    for name in (program.outputs or ()):
        slot = env.get(name)
        if slot is None:
            raise PlanExecutionError(f"output {name!r} never produced")
        if not slot.valid_host:
            if check:
                raise PlanExecutionError(
                    f"output {name!r} not on host at program end "
                    "(missing delegatestore)")
            slot.host = be.download(slot.device)
            slot.valid_host = True
        outs[name] = slot.host
    return outs, stats


def _nest(ops: List[PlanOp], program: Program):
    """linear ops -> list of ('op', PlanOp) | ('loop', loop_id, body)."""
    def parse(i: int, stop_loop: Optional[int]):
        body = []
        while i < len(ops):
            op = ops[i]
            if op.kind == "loop_begin":
                inner, i = parse(i + 1, op.loop_id)
                body.append(("loop", op.loop_id, inner))
            elif op.kind == "loop_end":
                if op.loop_id != stop_loop:
                    raise PlanExecutionError("malformed loop nesting")
                return body, i
            else:
                body.append(("op", op))
            i += 1
        return body, i
    tree, _ = parse(0, None)
    return tree


def _run(tree, p: Plan, env: Dict[str, _Slot], stats: ExecStats,
         check: bool, be: Backend, variants=None) -> None:
    program = p.program
    for item in tree:
        if item[0] == "loop":
            _, loop_id, body = item
            for _ in range(program.loops[loop_id].n_iters):
                _run(body, p, env, stats, check, be, variants)
            continue
        op: PlanOp = item[1]
        if op.kind == "directive":
            run_directive(op.directive, env, stats, check, be, p)
        elif op.kind == "block":
            _run_block(program, op.block_idx, env, stats, check, be,
                       variants)


# -- directive primitives (shared with the compiled driver) -----------------

def do_load(d: AdvancedLoad, env, stats: ExecStats, be: Backend) -> Any:
    slot = env.setdefault(d.var, _Slot())
    if not slot.valid_host:
        raise PlanExecutionError(
            f"advancedload {d.var!r}: no valid host copy")
    t = time.perf_counter()
    slot.device = be.upload(slot.host, stream=d.stream, name=d.var)
    stats.h2d_time += time.perf_counter() - t
    stats.h2d_transfers += 1
    stats.h2d_bytes += _nbytes(slot.host)
    slot.valid_device = True
    return slot.device


def do_store(d: DelegateStore, env, stats: ExecStats, be: Backend,
             handle: Any = None) -> None:
    """Download; ``handle`` overrides the slot's device value (the compiled
    driver passes the value captured at the store's program point)."""
    slot = env.setdefault(d.var, _Slot())
    if handle is None:
        if not slot.valid_device:
            raise PlanExecutionError(
                f"delegatestore {d.var!r}: no valid device copy")
        handle = slot.device
    t = time.perf_counter()
    slot.host = be.download(handle, stream=d.stream)
    stats.d2h_time += time.perf_counter() - t
    stats.d2h_transfers += 1
    stats.d2h_bytes += _nbytes(slot.host)
    slot.valid_host = True


def do_sync(d: Synchronize, stats: ExecStats, be: Backend) -> None:
    t = time.perf_counter()
    be.sync(d.stream)     # the transfer queue this callsite's group uses
    be.sync(0)            # and the compute stream the callsite ran on
    stats.sync_time += time.perf_counter() - t
    stats.syncs += 1


def group_vars(p: Plan, group: int) -> Set[str]:
    """Variables owned by ``group``: its ``mapbyname`` declaration plus
    everything its member codelets read or write (HMPP: the buffers a
    ``release`` of that group frees)."""
    names: Set[str] = set()
    for d in p.directives(GroupDecl):
        if d.group == group:
            names.update(d.mapbyname)
    for bi in p.groups.get(group, ()):
        blk = p.program.blocks[bi]
        names.update(blk.reads)
        names.update(blk.writes)
    return names


def do_release(d: Optional[Release], env, be: Backend,
               p: Optional[Plan] = None) -> None:
    """Free device buffers for ``d``'s group only (HMPP ``release`` is
    per-group).  Without a directive/plan (hand-driven callers) every
    group's buffers are freed — the pre-group legacy behaviour."""
    if d is not None and p is not None:
        names = group_vars(p, d.group)
        slots = [env[v] for v in names if v in env]
    else:
        slots = list(env.values())
    for slot in slots:
        if slot.valid_host:
            if slot.device is not None:
                be.free(slot.device)
            slot.device = None
            slot.valid_device = False


def run_directive(d, env, stats: ExecStats, check: bool,
                  be: Backend, p: Optional[Plan] = None) -> None:
    if isinstance(d, AdvancedLoad):
        do_load(d, env, stats, be)
    elif isinstance(d, DelegateStore):
        do_store(d, env, stats, be)
    elif isinstance(d, Synchronize):
        do_sync(d, stats, be)
    elif isinstance(d, Release):
        do_release(d, env, be, p)
    elif isinstance(d, (GroupDecl, Callsite)):
        pass  # metadata; the following block op performs the call


def dummy_arg(slot: _Slot, be: Backend):
    """Placeholder for a declared-but-unread input (pruned by the analyzer);
    it is provably dead inside the block, so a zeros array of the right
    shape/dtype is passed without charging a transfer."""
    src = slot.device if slot.device is not None else slot.host
    return be.alloc(tuple(np.shape(src)), src.dtype)


def _run_block(program: Program, idx: int, env: Dict[str, _Slot],
               stats: ExecStats, check: bool, be: Backend,
               variants=None) -> None:
    blk = program.blocks[idx]
    actual = set(blk.effective_reads())
    if blk.kind is BlockKind.OFFLOAD:
        args = []
        for v in blk.reads:
            slot = env.setdefault(v, _Slot())
            if v not in actual:
                args.append(dummy_arg(slot, be))
                continue
            if not slot.valid_device:
                if check:
                    raise PlanExecutionError(
                        f"codelet {blk.name!r} reads {v!r}: not on device "
                        "(missing advancedload)")
                slot.device = be.upload(slot.host, name=v)
                slot.valid_device = True
            args.append(slot.device)
        t = time.perf_counter()
        outs = be.launch(kernel_fn(blk, variants), blk.reads, blk.writes,
                         args)
        stats.kernel_time += time.perf_counter() - t
        stats.kernel_calls += 1
        for w, val in zip(blk.writes, outs):
            slot = env.setdefault(w, _Slot())
            slot.device = val
            slot.valid_device, slot.valid_host = True, False
    else:
        kwargs = {}
        for v in blk.reads:
            slot = env.setdefault(v, _Slot())
            if v not in actual:
                src = slot.host if slot.host is not None else slot.device
                kwargs[v] = np.zeros(np.shape(src), numpy_dtype(src.dtype))
                continue
            if not slot.valid_host:
                if check:
                    raise PlanExecutionError(
                        f"host block {blk.name!r} reads {v!r}: not on host "
                        "(missing delegatestore)")
                slot.host = be.download(slot.device)
                slot.valid_host = True
            kwargs[v] = slot.host
        t = time.perf_counter()
        outs = blk.fn(np, **kwargs)
        stats.host_time += time.perf_counter() - t
        stats.host_calls += 1
        for w in blk.writes:
            slot = env.setdefault(w, _Slot())
            slot.host = np.asarray(outs[w])
            slot.valid_host, slot.valid_device = True, False


def run_host_oracle(program: Program,
                    inputs: Optional[Dict[str, np.ndarray]] = None
                    ) -> Dict[str, np.ndarray]:
    """Reference semantics: run every block on the host with numpy, loops
    executed for real, no device, no transfers.  The property tests assert
    ``execute(plan(p)) == execute(naive_plan(p)) == run_host_oracle(p)``."""
    env: Dict[str, np.ndarray] = {}
    bound = dict(program.inputs)
    if inputs:
        bound.update(inputs)
    for k, v in bound.items():
        env[k] = np.asarray(v)

    def run_span(blocks_iter, path):
        # execute blocks honoring loop trip counts via recursive grouping
        i = 0
        while i < len(blocks_iter):
            blk = blocks_iter[i]
            rel = blk.loop_path[len(path):]
            if not rel:
                out = blk.fn(np, **{v: env[v] for v in blk.reads})
                for w in blk.writes:
                    env[w] = np.asarray(out[w])
                i += 1
            else:
                lid = rel[0]
                j = i
                while j < len(blocks_iter) and \
                        len(blocks_iter[j].loop_path) > len(path) and \
                        blocks_iter[j].loop_path[len(path)] == lid:
                    j += 1
                for _ in range(program.loops[lid].n_iters):
                    run_span(blocks_iter[i:j], path + (lid,))
                i = j

    run_span(program.blocks, ())
    # same output contract as ``execute``: exactly ``program.outputs``
    # (in particular {} when no outputs are declared), never the raw env
    return {name: env[name] for name in program.outputs}
