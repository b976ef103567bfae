"""Program IR for the OMP2HMPP-style offload planner.

The paper's input is C source with OpenMP pragmas; ours is a ``Program``: an
ordered list of ``Block``s (host or offload), optionally nested in counted
loops, operating on a shared environment of named arrays.  This is the
analogue of the paper's AST view of the program: enough structure for the
def/use + loop-nesting analysis of Section 2 of the paper, while the block
bodies stay ordinary (traceable) array code.

Block body convention
---------------------
Every block function has the signature ``fn(xp, **arrays) -> dict``:
``xp`` is ``numpy`` when the block runs on the host and ``torch`` when it
runs on the device (or is traced for analysis).  It must return a dict
mapping written variable names to arrays.  This single-source convention is
what lets the analyzer trace *both* host and offload blocks to FX graphs.
"""
from __future__ import annotations

import dataclasses
import enum
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

__all__ = [
    "BlockKind", "VarIO", "Block", "LoopInfo", "Program",
    "Directive", "AdvancedLoad", "DelegateStore", "Callsite", "Synchronize",
    "Release", "GroupDecl", "Plan", "PlanOp", "PlanExecutionError",
]


class PlanExecutionError(RuntimeError):
    """A plan could not be executed (or, for the static-verifier subclass
    ``repro_torch.core.verify.PlanVerificationError``, was proven un-executable
    before running).  Lives here rather than in ``executor`` so the
    dependency-free verifier can subclass it without importing the backend stack.
    """


class BlockKind(enum.Enum):
    HOST = "host"
    OFFLOAD = "offload"


class VarIO(enum.Enum):
    """HMPP ``args[x].io=`` classification for a variable w.r.t. a codelet."""
    IN = "in"
    OUT = "out"
    INOUT = "inout"


@dataclasses.dataclass(frozen=True)
class LoopInfo:
    loop_id: int
    n_iters: int
    parent_path: Tuple[int, ...]  # enclosing loop ids, outermost first

    @property
    def path(self) -> Tuple[int, ...]:
        return self.parent_path + (self.loop_id,)


@dataclasses.dataclass
class Block:
    idx: int
    kind: BlockKind
    fn: Callable[..., Dict[str, Any]]
    reads: Tuple[str, ...]          # declared inputs (superset of actual)
    writes: Tuple[str, ...]
    loop_path: Tuple[int, ...]      # enclosing loop ids, outermost first
    name: str
    # Filled in by analysis:
    actual_reads: Optional[Tuple[str, ...]] = None
    # Kernel name (repro_torch.kernels.variants registry) when this block
    # is a tunable kernel launch; its declared ``reads`` are then, in
    # order, the kernel's array operands.  The tuner crosses the plan grid
    # with the kernel's tile variants and the executor binds the chosen
    # tile kwargs onto ``fn`` at launch.
    kernel: Optional[str] = None

    @property
    def label(self) -> str:
        return f"_instr_{self.name}_ol_{self.idx}"

    def effective_reads(self) -> Tuple[str, ...]:
        return self.actual_reads if self.actual_reads is not None else self.reads


class Program:
    """Builder for block programs.

    >>> p = Program()
    >>> p.bind("A", np.zeros((4, 4)))
    >>> p.host(init_fn, reads=(), writes=("A",), name="init")
    >>> with p.loop(10):
    ...     p.offload(kernel_fn, reads=("A",), writes=("C",), name="k0")
    >>> p.host(use_fn, reads=("C",), writes=("out",), name="use")
    """

    def __init__(self, name: str = "main"):
        self.name = name
        self.blocks: List[Block] = []
        self.loops: Dict[int, LoopInfo] = {}
        self.inputs: Dict[str, Any] = {}      # name -> concrete array or SDS
        self.outputs: Tuple[str, ...] = ()    # vars wanted on host at exit
        self._loop_stack: List[int] = []
        self._next_loop_id = 0

    # -- builder -----------------------------------------------------------
    def bind(self, name: str, value: Any) -> None:
        """Declare a program input (concrete array or ShapeDtype record)."""
        self.inputs[name] = value

    def set_outputs(self, *names: str) -> None:
        """Vars the caller wants back on the host when the program ends."""
        self.outputs = tuple(names)

    def _add_block(self, kind: BlockKind, fn, reads, writes, name,
                   kernel=None) -> Block:
        blk = Block(
            idx=len(self.blocks), kind=kind, fn=fn,
            reads=tuple(reads), writes=tuple(writes),
            loop_path=tuple(self._loop_stack),
            name=name or fn.__name__,
            kernel=kernel,
        )
        self.blocks.append(blk)
        return blk

    def host(self, fn, *, reads: Sequence[str], writes: Sequence[str],
             name: str = "") -> Block:
        return self._add_block(BlockKind.HOST, fn, reads, writes, name)

    def offload(self, fn, *, reads: Sequence[str], writes: Sequence[str],
                name: str = "", kernel: Optional[str] = None) -> Block:
        """The analogue of ``#pragma omp parallel for target cuda``.

        ``kernel`` tags the block as a tunable kernel launch (a name
        from ``repro_torch.kernels.variants.KERNELS``); ``fn`` must then accept
        that kernel's tile parameters as keyword arguments (e.g.
        ``block_q=``/``block_k=``) and ``reads`` must list the kernel's
        array operands in the registry's order.
        """
        return self._add_block(BlockKind.OFFLOAD, fn, reads, writes, name,
                               kernel=kernel)

    def loop(self, n_iters: int) -> "_LoopCtx":
        return _LoopCtx(self, n_iters)

    # -- queries used by the analyzer/planner ------------------------------
    def loop_path_of(self, idx: int) -> Tuple[int, ...]:
        return self.blocks[idx].loop_path

    def offload_blocks(self) -> List[Block]:
        return [b for b in self.blocks if b.kind is BlockKind.OFFLOAD]

    def host_blocks(self) -> List[Block]:
        return [b for b in self.blocks if b.kind is BlockKind.HOST]


class _LoopCtx:
    def __init__(self, prog: Program, n_iters: int):
        self.prog, self.n_iters = prog, n_iters

    def __enter__(self):
        info = LoopInfo(
            loop_id=self.prog._next_loop_id,
            n_iters=self.n_iters,
            parent_path=tuple(self.prog._loop_stack),
        )
        self.prog._next_loop_id += 1
        self.prog.loops[info.loop_id] = info
        self.prog._loop_stack.append(info.loop_id)
        self.info = info
        return info

    def __exit__(self, *exc):
        self.prog._loop_stack.pop()
        return False


# ---------------------------------------------------------------------------
# Directives — the HMPP vocabulary the planner emits (paper §1.1).
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Directive:
    pass


@dataclasses.dataclass(frozen=True)
class AdvancedLoad(Directive):
    """Upload ``var`` host→device.  Placed as early as possible (Fig. 4b).

    ``stream`` is the logical transfer queue the upload is enqueued on
    (assigned per group by the planner; 0 = the compute stream).  Backends
    map logical streams onto their physical ones.
    """
    var: str
    group: int
    asynchronous: bool = True
    hoisted_from: Tuple[int, ...] = ()   # loop ids it was hoisted out of
    stream: int = 0


@dataclasses.dataclass(frozen=True)
class DelegateStore(Directive):
    """Download ``var`` device→host.  Placed as late as possible (Fig. 5b)."""
    var: str
    group: int
    hoisted_from: Tuple[int, ...] = ()
    stream: int = 0


@dataclasses.dataclass(frozen=True)
class Callsite(Directive):
    block_idx: int
    group: int
    io: Tuple[Tuple[str, str], ...]        # (var, "in"/"out"/"inout")
    noupdate: Tuple[str, ...] = ()         # vars already device-resident
    asynchronous: bool = True


@dataclasses.dataclass(frozen=True)
class Synchronize(Directive):
    """Wait for async work on ``stream`` issued for callsite ``block_idx``
    (placed before first use).  With a stream-aware backend this is a real
    wait point, not a no-op."""
    block_idx: int
    group: int
    stream: int = 0


@dataclasses.dataclass(frozen=True)
class Release(Directive):
    group: int


@dataclasses.dataclass(frozen=True)
class GroupDecl(Directive):
    group: int
    mapbyname: Tuple[str, ...]
    target: str = "CUDA"  # kept for fidelity with the paper; ours is "TPU"


# ---------------------------------------------------------------------------
# Plan — the "generated source": program items interleaved with directives.
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class PlanOp:
    """One entry of the linearized plan.

    kind: 'directive' | 'block' | 'loop_begin' | 'loop_end'
    """
    kind: str
    directive: Optional[Directive] = None
    block_idx: Optional[int] = None
    loop_id: Optional[int] = None


@dataclasses.dataclass
class Plan:
    program: Program
    ops: List[PlanOp]
    groups: Dict[int, Tuple[int, ...]]       # group id -> offload block idxs
    io_table: Dict[int, Dict[str, VarIO]]    # block idx -> var -> io
    # meta keys set by the planner pass pipeline (repro_torch.core.passes):
    #   "optimize"           — True for any non-naive policy (legacy)
    #   "policy"             — placement policy name that produced this
    #       plan ("optimized" / "naive" / "grouped" / registered ones)
    #   "n_transfer_streams" — stream count the StreamAssignPass used
    #   "pure_device_loops"  — loop ids whose body holds only offload
    #       blocks and metadata/sync directives (no host blocks, no
    #       AdvancedLoad/DelegateStore/Release).  Together with
    #       ``program.loops[lid].n_iters`` this is what the compiled path
    #       needs to roll the whole loop (or nest) into one fused launch.
    #   "var_nbytes"         — concrete byte size of every program var
    #       (the cost model's raw material)
    # and by the plan-space tuner (repro_torch.core.tuner):
    #   "tuning"             — {"chosen", "objective", "winners",
    #       "pareto", "backend", "hw", "calibration", "predictor",
    #       "candidates"}: the ranked candidate table, each entry
    #       carrying the cost breakdown (transfer_s/dispatch_s/kernel_s/
    #       predicted_s) plus the ISSUE-10 objective columns (energy_j —
    #       modeled joules; peak_bytes — static residency-walk peak;
    #       analytic_s — default-constant predicted seconds),
    #       measured_s when its execution class was run,
    #       calibrated_s when a fit was made, predictor_s when a
    #       cross-program model priced the grid, and alias_of naming the
    #       class survivor for dominance-pruned (execution-identical)
    #       configs.  "hw" is the pricing constants actually used
    #       (calibrated when a fit was cached); "calibration" records
    #       the fit: {"n_rows", "fitted", "accepted",
    #       "rank_corr_before", "rank_corr_after"}.
    #       "objective" (inside "tuning") — what the chosen candidate
    #       minimizes: "time" | "energy" | "memory" | {objective:
    #       weight}; "winners" maps each objective to its frontier-
    #       guaranteed winner label; "pareto" is the mutually
    #       non-dominated surface of the table, fastest-first:
    #       [{"label", "time_s", "energy_j", "peak_bytes"}, ...]
    #       (time_s is measured when the run measured, predicted
    #       otherwise).
    #       "predictor" (inside "tuning") — the cross-program cold-start
    #       model's outcome for this run: {"n_rows", "n_programs",
    #       "source" ("fit" | "cache" | None), "accepted",
    #       "rank_corr_analytic", "rank_corr_predictor",
    #       "used_for_ranking"}; None when tuning ran cache-less.
    #       Accepted means the learned ranking of this program's
    #       measured survivors was no worse than the uncalibrated
    #       analytic model's (the PR-5 no-regression gate).
    #       "kernel_variants" (inside "tuning") — the winner's tile
    #       choice per kernel-tagged block:
    #       {kernel_name: {param: value}}, e.g.
    #       {"flash_attention": {"block_q": 128, "block_k": 64}};
    #       empty dict when the program has no kernel blocks
    #       "pruned_invalid" (inside "tuning") — how many candidate
    #       configs the static verifier (repro_torch.core.verify) rejected
    #       before pricing/measuring; 0 for a healthy pipeline (the
    #       verifier prunes nothing the simulator approved)
    #   "kernel_variants"    — the same mapping hoisted to the top level
    #       so ``execute()`` (and winner_exec_kwargs) launch the winning
    #       tile sizes by default
    #   "tuning_cache"       — {"hit", "measurements", "path",
    #       "fingerprint"}: whether the persistent cache
    #       (repro_torch.core.tunecache) answered, and how many execution
    #       classes were measured this call (0 on a hit)
    #   "fuse_loops"/"donate" — how the winning plan wants executing
    #   "mesh"               — present only when the tuner ran on a
    #       mesh-capable backend AND a sharded placement won:
    #       {"shape": [2, 4], "axes": ["data", "model"],
    #        "placement": "fsdp" | "tp" | "pipeline-registered policy",
    #        "n_devices": 8,
    #        "specs": {var: [entry, ...]},   # PartitionSpec entries per
    #            var; entry is a mesh-axis name, a list of axis names,
    #            or null (replicated dim); [] = fully replicated
    #        "dropped": [[var, axis, dim], ...]}  # divisibility-guard
    #            drops — sharding requests that stayed replicated
    #       ``execute()`` re-applies it via backend.with_placement();
    #       ``verify_plan`` validates it (kind "mesh-placement") and
    #       treats sharded operands as cross-device sync points.  The
    #       same record also sits at meta["tuning"]["mesh"] for every
    #       tuned-on-mesh plan (including replicate winners, where the
    #       top-level key is absent).
    # and by the static plan verifier (repro_torch.core.verify):
    #   "verify"             — {"ok", "checked_ops", "n_errors",
    #       "n_lints", "counts"}: the verifier's verdict for this plan
    #       (counts maps violation kind -> occurrences; lints — e.g.
    #       the naive policy's redundant transfers — never fail a
    #       plan).  Set by plan(), tune() and cache-hit rebuilds; the
    #       full op-indexed diagnostics live on the VerifyReport the
    #       verifier returns, not in meta.
    meta: Dict[str, Any] = dataclasses.field(default_factory=dict)

    def directives(self, cls=None) -> List[Directive]:
        out = [op.directive for op in self.ops if op.kind == "directive"]
        if cls is not None:
            out = [d for d in out if isinstance(d, cls)]
        return out

    def count(self, cls) -> int:
        return len(self.directives(cls))

    def pure_device_loops(self) -> Tuple[int, ...]:
        """Loop ids the planner proved transfer-free (fusable whole)."""
        return tuple(self.meta.get("pure_device_loops", ()))

    def predicted_cost(self) -> Optional[Dict[str, Any]]:
        """The tuner's cost record for this plan (None if not tuned)."""
        tuning = self.meta.get("tuning")
        if not tuning:
            return None
        for c in tuning["candidates"]:
            if c["label"] == tuning["chosen"]:
                return c
        return None

    def tuning_table(self) -> List[Dict[str, Any]]:
        """Ranked candidate records from the plan-space exploration
        (empty if this plan was not produced by ``policy="auto"``)."""
        tuning = self.meta.get("tuning")
        return list(tuning["candidates"]) if tuning else []

    def tuning_calibration(self) -> Optional[Dict[str, Any]]:
        """The measured-calibration record from the tuning run (None if
        not tuned, not measured, or calibration was disabled)."""
        tuning = self.meta.get("tuning")
        return tuning.get("calibration") if tuning else None

    def tuning_cache_info(self) -> Optional[Dict[str, Any]]:
        """Cache outcome of the tuning run: {"hit", "measurements",
        "path", "fingerprint"} (None if this plan was not tuned)."""
        return self.meta.get("tuning_cache")
