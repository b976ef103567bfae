"""Plan-space explorer — the search the paper actually describes.

OMP2HMPP's headline result (§3) comes from *exploring the space of
directive combinations*: the tool emits many candidate HMPP versions and
picks the best.  This module does that over the pass pipeline
(``repro_torch.core.passes``): enumerate candidate plans across the axes
the paper explores —

    placement policy     naive / optimized / grouped / pipeline
                         (registry-extensible)
    transfer streams     1–4 logical upload/download queues
    loop fusion          whole-loop lowering (one dispatch) on/off
    buffer donation      fused launches donate rewritten inputs on/off
    kernel variants      per-kernel tile/block sizes: each kernel-tagged
                         block's registry grid
                         (``repro_torch.kernels.variants``), priced by a
                         per-kernel roofline cutout so ``kernel_s``
                         differs across tile candidates
    mesh placement       replicate / fsdp / tp per-variable sharding on
                         placement-capable backends
                         (``distributed.mesh_backend``): priced from one
                         traced run of each block on ``meta`` DTensors
                         (per-device FLOPs + collective wire bytes against
                         ``ici_bw``), measured on a ``with_placement``
                         twin, recorded in ``meta["mesh"]``; "" (absent)
                         on single-device backends, whose grid is
                         unchanged

— rank them with a static cost model that reuses the roofline machinery
(``repro_torch.roofline.analysis``: per-block FLOPs counted by
``FlopCounterMode``, PCIe/HBM bandwidths, launch overhead × dispatch
count), measure the distinct candidates, and return the winner with the
full ranked table in ``plan.meta["tuning"]``.  On a multi-rank mesh
only rank 0 reads and writes the tune cache, and what it read (a cached
table, the calibration, the cross-program predictor) is broadcast, so
every rank prices and ranks the candidates alike; every rank then
measures the same candidates in the same order, each measured time is
the MAX over the ranks, and every rank reaches the same winner.

*Dominance pruning* — configs that are execution-identical (a streams
axis with < 2 groups, donate on a backend without donation, fuse on a
plan with no fusable loops) are merged into one *execution class*: the
class survivor is measured ONCE and the merged configs inherit its
numbers, carrying ``alias_of`` so the table still enumerates the full
axis grid the paper explores.  Candidates that ARE measured run on a
physically matching backend (``Backend.variant``: a streams-3 config on
a 3-queue backend, donate on a donating twin).  On a backend whose
kernels do not read the tile (``Backend.reads_kernel_tiles`` false: the
torch backend) the classes that differ only in their tile keep their
own prices but are measured once: the best-ranked of them runs, and the
others carry its numbers with ``measured_as`` naming it.

*Persistent cache* — measured results are keyed on a content
fingerprint of (program ops, backend identity, candidate grid + protocol,
cost-model version) in ``repro_torch.core.tunecache``; a repeated
``policy="auto"`` call returns the cached winner with zero measurements
and a byte-identical table.  ``refresh=True`` re-measures.

*Measured calibration* — after measuring, the offload constants are
re-fitted by least squares from the (predicted-terms, measured-time)
table (``fit_offload_constants``); the fit is kept only when it does not
lower the predicted-vs-measured rank correlation (both correlations are
recorded in ``meta["tuning"]["calibration"]``), persisted per device
class in the cache, and used to price subsequent programs.

*Three objectives* — every candidate is scored on measured/predicted
seconds, modeled joules (``energy_j``: PCIe/HBM/interconnect bytes ×
per-byte constants + flops × ``flop_j``) and peak device bytes
(``peak_bytes``: the static residency walk in ``core.residency``,
moved by donation and kernel tile size).  The non-dominated surface is
returned in ``meta["tuning"]["pareto"]`` with per-objective winners in
``["winners"]``; ``tune(..., objective=)`` — and therefore
``plan(p, policy="auto", objective=)`` — selects which axis the chosen
plan minimizes ("time" | "energy" | "memory" | a weight mapping).

*Cross-program predictor* — measured candidate rows accumulate in the
tunecache per DEVICE CLASS; with rows from ≥ 2 other programs a
featurized linear model (``fit_candidate_predictor``) prices a
never-measured program's grid, gated by the same
rank-correlation-no-regression rule as the calibration and recorded in
``meta["tuning"]["predictor"]``.

On a CUDA backend every measured candidate's kernel leg
(``measured_kernel_s``) is device time from CUDA events
(``ExecStats.kernel_time``), so ``kernel_residual_s`` compares the
roofline's ``kernel_s`` with what the card did.

Entry point: ``tune(program, backend=...)``, or equivalently
``plan(program, policy="auto", backend=...)``.

Candidates that fail the pipeline's ``SimulateFixPass`` (an invalid
placement) are recorded with ``valid=False`` and are never ranked or
measured — the explorer only ever returns a simulator-approved plan.
"""
from __future__ import annotations

import dataclasses
import itertools
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

from ..roofline.analysis import (HW, block_flops, candidate_features,
                                 fit_candidate_predictor,
                                 fit_offload_constants, kernel_roofline_terms,
                                 offload_cost_terms, predict_candidate_s,
                                 rank_correlation)
from .analysis import ProgramAnalysis, analyze
from .backend import Backend, get_backend
from .ir import (AdvancedLoad, BlockKind, DelegateStore, Plan, Program,
                 Synchronize)
from .passes import Pipeline
from .residency import plan_peak_device_bytes
from .tunecache import (TuneCache, backend_fingerprint, default_cache,
                        device_class_key, grid_fingerprint,
                        program_fingerprint, tuning_fingerprint)
from .verify import PlanVerificationError, verify_plan

__all__ = ["PlanConfig", "enumerate_configs", "predict_cost", "tune",
           "winner_exec_kwargs", "pareto_front", "OBJECTIVES"]

# one kernel's tile choice: (kernel_name, ((param, value), ...)) — the
# params half is KernelVariant.params (canonical sorted pairs)
KernelChoice = Tuple[str, Tuple[Tuple[str, int], ...]]


@dataclasses.dataclass(frozen=True)
class PlanConfig:
    """One point of the plan space."""
    policy: str = "optimized"
    n_streams: int = 2
    fuse_loops: bool = True
    donate: bool = False
    # per-kernel tile choice, sorted by kernel name; () = registry
    # defaults (also the only value for kernel-free programs, keeping
    # labels/fingerprints of the pre-kernel-axis grid unchanged)
    kernel_variants: Tuple[KernelChoice, ...] = ()
    # mesh placement policy: "" on single-device backends (keeping their
    # labels and fingerprints unchanged), else one of
    # ``distributed.mesh_backend.DEFAULT_PLACEMENTS``
    mesh_placement: str = ""

    @property
    def label(self) -> str:
        base = (f"{self.policy}/streams{self.n_streams}"
                f"/{'fuse' if self.fuse_loops else 'nofuse'}"
                f"/{'donate' if self.donate else 'nodonate'}")
        if self.kernel_variants:
            kv = "+".join(
                f"{k}[{','.join(f'{n}={v}' for n, v in params)}]"
                for k, params in self.kernel_variants)
            base += "/" + kv
        if self.mesh_placement:
            base += "/" + self.mesh_placement
        return base

    def as_dict(self) -> Dict[str, Any]:
        d = dataclasses.asdict(self)
        # JSON-stable form: a cache-hit table must compare equal to the
        # fresh run that stored it, so serialize the variant tuples the
        # way json will echo them back (nested lists)
        d["kernel_variants"] = [[k, [list(p) for p in params]]
                                for k, params in self.kernel_variants]
        return d

    def variants_map(self) -> Dict[str, Dict[str, int]]:
        """{kernel: {param: value}} view (what ``execute`` consumes)."""
        return {k: dict(params) for k, params in self.kernel_variants}


def _cfg_from_dict(d: Dict[str, Any]) -> PlanConfig:
    """Rebuild a PlanConfig from ``as_dict()`` output, including after a
    JSON round-trip (which turns the kernel_variants tuples into lists —
    unhashable in a frozen dataclass)."""
    d = dict(d)
    kv = d.get("kernel_variants") or ()
    d["kernel_variants"] = tuple(
        (str(k), tuple((str(n), int(v)) for n, v in params))
        for k, params in kv)
    return PlanConfig(**d)


DEFAULT_POLICIES: Tuple[str, ...] = ("naive", "optimized", "grouped",
                                     "pipeline")
DEFAULT_STREAMS: Tuple[int, ...] = (1, 2, 3, 4)

# the hw constants snapshotted into plan.meta["tuning"]["hw"]
_HW_KEYS = ("pcie_bw", "hbm_bw", "peak_flops_bf16", "ici_bw",
            "launch_overhead_s", "sync_overhead_s",
            "pcie_j_per_byte", "hbm_j_per_byte", "ici_j_per_byte", "flop_j")

# every field predict_cost() contributes to a candidate record (what an
# alias copies from its execution-class survivor).  energy_j / analytic_s
# / peak_bytes are the objective columns: class-level quantities (an
# alias executes identically), so aliases inherit them too.
_COST_FIELDS = ("h2d_bytes", "d2h_bytes", "loads", "stores", "syncs",
                "kernel_launches", "dispatches", "flops", "kernel_bytes",
                "coll_bytes", "transfer_s", "dispatch_s", "kernel_s",
                "collective_s", "predicted_s", "energy_j", "analytic_s",
                "peak_bytes")

# measurement-derived fields an alias inherits beside measured_s
_MEASURE_FIELDS = ("measured_kernel_s", "kernel_residual_s", "measured_as")


def enumerate_configs(policies: Sequence[str] = DEFAULT_POLICIES,
                      streams: Sequence[int] = DEFAULT_STREAMS,
                      fuse: Sequence[bool] = (True, False),
                      donate: Sequence[bool] = (False, True),
                      placements: Sequence[str] = ("",)
                      ) -> List[PlanConfig]:
    return [PlanConfig(policy=p, n_streams=s, fuse_loops=f, donate=d,
                       mesh_placement=mp)
            for p, s, f, d, mp in itertools.product(policies, streams,
                                                    fuse, donate,
                                                    placements)]


# --------------------------------------------------------------------------
# Static cost model.
# --------------------------------------------------------------------------

def _kernel_block_terms(blk, params, shapes,
                        hw) -> Optional[Dict[str, float]]:
    """Analytic (flops, kernel_bytes) for a kernel-tagged block priced at
    tile choice ``params`` (None → the registry defaults) on the block's
    declared-read operand shapes.  None when the registry cannot price it
    (unknown kernel, missing shapes, invalid tile) — the caller then
    falls back to the generic FLOPs/nbytes pricing."""
    import numpy as np
    try:
        sds = [shapes[v] for v in blk.reads]
        op_shapes = [tuple(s.shape) for s in sds]
        itemsizes = [int(np.dtype(s.dtype).itemsize) for s in sds]
        if params is None:
            from ..kernels.variants import KERNELS
            params = KERNELS[blk.kernel]["defaults"]
        return kernel_roofline_terms(blk.kernel, dict(params), op_shapes,
                                     itemsizes, hw=hw)
    except Exception:
        return None


def predict_cost(pl: Plan, cfg: PlanConfig,
                 block_flops: Optional[Dict[int, float]] = None,
                 hw: Optional[Dict[str, float]] = None,
                 shapes: Optional[Dict[str, Any]] = None,
                 mesh: Optional[Dict[str, Any]] = None) -> Dict[str, Any]:
    """Walk the plan with loop-trip multipliers and price it:

    * transfer bytes  — Σ nbytes(var) × trip multiplier per load/store,
    * dispatches      — physical launches: per-iteration blocks and
      transfers, but a fusable pure-device loop nest counts ONCE per
      entry when ``cfg.fuse_loops`` (the whole-loop lowering's
      amortization, mirroring the compiler's structural eligibility),
    * kernel terms    — logical block launches × per-block flops and
      touched bytes.  A kernel-tagged block is priced analytically per
      tile variant (``cfg.kernel_variants`` via
      ``kernel_roofline_terms``, needs ``shapes``) so kernel_s differs
      across kernel-axis candidates; other blocks use their own FLOPs
      (``block_flops``, from ``roofline.analysis.block_flops``) + env
      nbytes.

    ``hw`` overrides the pricing constants (the tuner passes the
    calibrated set when one is cached for the device class); ``shapes``
    is the analyzer's var → ShapeDtype map.  ``mesh`` is one
    placement's pricing context (``mesh_cost_terms``): per-device block
    FLOPs replace the single-device ones, each load's bytes scale by the
    variable's h2d factor (a replicated upload copies to every device),
    and the blocks' collective wire bytes accumulate into ``coll_bytes``
    priced against ``ici_bw``.  Returns the counters plus
    ``offload_cost_terms`` (transfer_s / dispatch_s / kernel_s /
    collective_s / predicted_s / energy_j); ``coll_bytes`` is 0 on one
    device.
    """
    from .compile import fusable_loops
    program = pl.program
    nb = pl.meta.get("var_nbytes", {})
    flops_of = block_flops or {}
    kv_map = cfg.variants_map()
    pure = fusable_loops(pl) if cfg.fuse_loops else set()

    h2d_bytes = d2h_bytes = 0
    loads = stores = syncs = 0
    kernel_launches = 0          # logical
    dispatches = 0.0             # physical (fused nests count once)
    flops = 0.0
    kernel_bytes = 0.0
    coll_bytes = 0.0
    mesh_flops = (mesh or {}).get("flops_by_block", {})
    mesh_coll = (mesh or {}).get("coll_by_block", {})
    h2d_factor = (mesh or {}).get("h2d_factor", {})
    n_dev = (mesh or {}).get("n_devices", 1)

    mult_stack: List[int] = []
    fused_depth = 0

    def mult() -> int:
        m = 1
        for n in mult_stack:
            m *= n
        return m

    for op in pl.ops:
        if op.kind == "loop_begin":
            if fused_depth or op.loop_id in pure:
                if fused_depth == 0:
                    # one launch per entry of the nest — times the trip
                    # count of any enclosing UNFUSED loops (a pure inner
                    # loop under an impure outer re-launches per outer
                    # iteration; mult_stack has not pushed this loop yet)
                    dispatches += mult()
                fused_depth += 1
            mult_stack.append(program.loops[op.loop_id].n_iters)
        elif op.kind == "loop_end":
            mult_stack.pop()
            if fused_depth:
                fused_depth -= 1
        elif op.kind == "block":
            blk = program.blocks[op.block_idx]
            if blk.kind is not BlockKind.OFFLOAD:
                continue
            m = mult()
            kernel_launches += m
            if fused_depth == 0:
                dispatches += m
            kterms = None
            if blk.kernel and shapes is not None:
                kterms = _kernel_block_terms(blk, kv_map.get(blk.kernel),
                                             shapes, hw)
            if kterms is not None:
                flops += kterms["flops"] * m
                kernel_bytes += kterms["kernel_bytes"] * m
            else:
                flops += mesh_flops.get(blk.idx,
                                        flops_of.get(blk.idx, 0.0)) * m
                touched = set(blk.effective_reads()) | set(blk.writes)
                kernel_bytes += sum(nb.get(v, 0) for v in touched) * m
            coll_bytes += mesh_coll.get(blk.idx, 0.0) * m
        elif op.kind == "directive":
            d = op.directive
            m = mult()
            if isinstance(d, AdvancedLoad):
                loads += m
                h2d_bytes += nb.get(d.var, 0) * h2d_factor.get(d.var,
                                                               n_dev) * m
                dispatches += m
            elif isinstance(d, DelegateStore):
                stores += m
                d2h_bytes += nb.get(d.var, 0) * m
                dispatches += m
            elif isinstance(d, Synchronize):
                syncs += m

    terms = offload_cost_terms(h2d_bytes, d2h_bytes, dispatches, syncs,
                               flops, kernel_bytes, coll_bytes, hw=hw)
    return {
        "h2d_bytes": int(h2d_bytes), "d2h_bytes": int(d2h_bytes),
        "loads": int(loads), "stores": int(stores), "syncs": int(syncs),
        "kernel_launches": int(kernel_launches),
        "dispatches": float(dispatches), "flops": float(flops),
        "kernel_bytes": float(kernel_bytes),
        "coll_bytes": float(coll_bytes), **terms,
    }


# --------------------------------------------------------------------------
# Multi-objective selection: time × energy × memory.
# --------------------------------------------------------------------------

OBJECTIVES: Tuple[str, ...] = ("time", "energy", "memory")

# lexicographic tie-break order per primary objective: a winner must sit
# on the Pareto frontier, and the lexicographic minimum always does
_LEXI_ORDER = {"time": ("time", "energy", "memory"),
               "energy": ("energy", "time", "memory"),
               "memory": ("memory", "time", "energy")}


def pareto_front(points: Sequence[Sequence[float]]) -> List[int]:
    """Indices of the non-dominated points (minimization, every axis).
    ``a`` dominates ``b`` iff a ≤ b on all axes and a < b on at least
    one; duplicated points are all kept (neither dominates)."""
    pts = [tuple(float(v) for v in p) for p in points]
    front = []
    for i, a in enumerate(pts):
        dominated = False
        for j, b in enumerate(pts):
            if j != i and all(bv <= av for bv, av in zip(b, a)) \
                    and any(bv < av for bv, av in zip(b, a)):
                dominated = True
                break
        if not dominated:
            front.append(i)
    return front


def _objective_value(r: Dict[str, Any], obj: str) -> float:
    """One candidate record's score on one objective.  Time prefers the
    measurement; an unmeasured table falls back to the analytic
    prediction (``predictor_s``, when a cold-start model priced the
    grid, is recorded beside it but never silently replaces the
    objective column — see ``used_for_ranking``)."""
    if obj == "time":
        m = r.get("measured_s")
        return float(m if m is not None else r.get("predicted_s", 0.0))
    if obj == "energy":
        return float(r.get("energy_j", 0.0) or 0.0)
    if obj == "memory":
        return float(r.get("peak_bytes", 0.0) or 0.0)
    raise ValueError(f"unknown objective {obj!r}")


def _objective_pool(cands: Sequence[Dict[str, Any]]) -> List[Dict[str, Any]]:
    """Records the frontier/winners are computed over: the valid class
    survivors (aliases are the same execution — duplicate points), the
    measured ones when any measurement happened."""
    survivors = [r for r in cands
                 if r.get("valid") and r.get("alias_of") is None]
    measured = [r for r in survivors if r.get("measured_s") is not None]
    return measured or survivors


def _pareto_records(cands: Sequence[Dict[str, Any]]) -> List[Dict[str, Any]]:
    """``meta["tuning"]["pareto"]``: the non-dominated surface of the
    candidate table as (label, time_s, energy_j, peak_bytes) points,
    sorted fastest-first.  Coordinate-identical survivors (distinct
    policies whose plans happen to price the same) collapse to one point
    — the best-ranked label — so the surface stays readable."""
    pool = _objective_pool(cands)
    pts = [tuple(_objective_value(r, o) for o in OBJECTIVES) for r in pool]
    best_at: Dict[Tuple[float, ...], Dict[str, Any]] = {}
    for i in pareto_front(pts):
        seen = best_at.get(pts[i])
        if seen is None or (pool[i].get("rank") or 0) < (seen.get("rank")
                                                         or 0):
            best_at[pts[i]] = pool[i]
    front = [{"label": r["label"], "time_s": pt[0], "energy_j": pt[1],
              "peak_bytes": pt[2]} for pt, r in best_at.items()]
    front.sort(key=lambda e: (e["time_s"], e["label"]))
    return front


def _objective_winners(cands: Sequence[Dict[str, Any]]) -> Dict[str, str]:
    """Per-objective winner labels.  Each is the LEXICOGRAPHIC minimum
    (primary objective, then the others, then predicted rank), which is
    provably on the Pareto frontier — a plain per-axis argmin could pick
    a dominated point on a tie."""
    pool = _objective_pool(cands)
    winners = {}
    for obj in OBJECTIVES:
        order = _LEXI_ORDER[obj]
        winners[obj] = min(
            pool, key=lambda r: tuple(_objective_value(r, o) for o in order)
            + (r.get("rank") or 0,))["label"]
    return winners


def _check_objective(objective: Any) -> Any:
    """Validate/normalize the ``objective=`` argument: one of
    ``OBJECTIVES`` or a non-empty {objective: weight} mapping."""
    if isinstance(objective, str):
        if objective not in OBJECTIVES:
            raise ValueError(
                f"objective must be one of {OBJECTIVES} or a weight "
                f"mapping, got {objective!r}")
        return objective
    if isinstance(objective, dict):
        bad = set(objective) - set(OBJECTIVES)
        if bad or not objective:
            raise ValueError(
                f"objective weight keys must be among {OBJECTIVES}, "
                f"got {sorted(objective)}")
        return {k: float(v) for k, v in objective.items()}
    raise ValueError(f"unsupported objective {objective!r}")


def _weighted_choice(cands: Sequence[Dict[str, Any]],
                     weights: Dict[str, float]) -> Dict[str, Any]:
    """Scalarized selection: each objective min-normalized over the pool
    (so weights compare dimensionless ratios-to-best, not seconds against
    joules), then the weighted sum is minimized."""
    pool = _objective_pool(cands)
    mins = {o: min(_objective_value(r, o) for r in pool) or 1.0
            for o in OBJECTIVES}

    def score(r):
        return sum(w * _objective_value(r, o) / mins[o]
                   for o, w in weights.items())
    return min(pool, key=lambda r: (score(r), r.get("rank") or 0))


def _select_chosen(cands: Sequence[Dict[str, Any]], objective: Any,
                   winners: Dict[str, str]) -> Dict[str, Any]:
    """The chosen record for a non-default objective (``"time"`` keeps
    the tuner's historical rule and never routes through here)."""
    if isinstance(objective, dict):
        return _weighted_choice(cands, objective)
    label = winners[objective]
    return next(r for r in cands if r["label"] == label)


# --------------------------------------------------------------------------
# Measurement.
# --------------------------------------------------------------------------

def _donation_variant(be: Backend, donate: bool) -> Backend:
    """``be`` with donation switched to ``donate`` (a memoized twin when
    they differ, in EITHER direction — a donate=True backend passed by
    the caller must not leak donation into nodonate candidates).
    Backends without a donation concept measure both as themselves."""
    return be.variant(donate=donate)


def _measurable(program: Program) -> bool:
    return all(type(v).__name__ != "ShapeDtype"
               for v in program.inputs.values())


def _measure(pl: Plan, cfg: PlanConfig, be: Backend, reps: int,
             placement: Any = None) -> Tuple[float, float]:
    from .executor import execute
    # measure on a physically matching backend: cfg.n_streams real
    # queues (streams 3/4 must not fold onto a 2-queue instance) and the
    # candidate's donation flag, launching the candidate's kernel tile
    # sizes, and on a mesh backend the candidate's per-variable placement
    # twin.  Returns (wall_time, kernel_time) of the best rep: the
    # kernel leg (device time on a card) feeds the measured-vs-predicted
    # residual that makes roofline drift visible in the tuning table.
    # On several ranks both are the MAX over the ranks, so every rank
    # ranks the same numbers.
    mbe = be.variant(n_streams=cfg.n_streams, donate=cfg.donate)
    if placement is not None and hasattr(mbe, "with_placement"):
        mbe = mbe.with_placement(placement)
    kw = dict(mode="compiled", fuse_loops=cfg.fuse_loops,
              kernel_variants=cfg.variants_map() or None,
              backend=mbe)
    execute(pl, **kw)                       # warm-up: plan lowering, kernel builds
    best = float("inf")
    best_kernel = 0.0
    for _ in range(max(1, reps)):
        _, s = execute(pl, **kw)
        if s.wall_time < best:              # steady-state, compile excluded
            best = s.wall_time
            best_kernel = s.kernel_time
    agree = getattr(be, "agree_max", None)
    if agree is not None:
        best, best_kernel = agree([best, best_kernel])
    return best, best_kernel


def _is_writer(be: Backend) -> bool:
    """Whether this process reads and writes the tune cache: rank 0 of
    a mesh backend's group, any single-process backend."""
    return bool(getattr(be, "is_writer", True))


def _from_writer(be: Backend, read: Callable[[], Any]) -> Any:
    """``read()`` (of the tune cache) on the writer, and its result on
    every rank: ranks whose caches differ still price alike."""
    share = getattr(be, "from_writer", None)
    if share is None:
        return read()
    return share(read() if _is_writer(be) else None)


def winner_exec_kwargs(pl: Plan, backend: Any = None) -> Dict[str, Any]:
    """``execute()`` kwargs that honor a tuned plan's chosen variant:
    compiled mode with the winner's fusion flag and kernel tile sizes,
    on a donate-enabled twin of ``backend`` when the winner wants
    donation.  Without this a caller re-running the winner on the plain
    backend measures the nodonate timing under a donate label.  The
    flags come from the plan's CHOSEN candidate, so tuning with
    ``objective="energy"``/``"memory"`` flows through here unchanged —
    the executor simply gets that objective's winner."""
    be = _donation_variant(get_backend(backend),
                           bool(pl.meta.get("donate")))
    return dict(mode="compiled",
                fuse_loops=bool(pl.meta.get("fuse_loops", True)),
                kernel_variants=pl.meta.get("kernel_variants") or None,
                backend=be)


# --------------------------------------------------------------------------
# Calibration.
# --------------------------------------------------------------------------

def _calibrate(rows: List[Dict[str, Any]],
               pricing_hw: Dict[str, float]) -> Dict[str, Any]:
    """Fit the offload constants from the measured class survivors and
    judge the fit by predicted-vs-measured rank correlation.  The fit is
    ``accepted`` only when it does not lower the correlation on the
    observed table — a declined calibration is still recorded (both
    correlations), it just isn't persisted or used for pricing."""
    before = rank_correlation([r["predicted_s"] for r in rows],
                              [r["measured_s"] for r in rows])
    record = {"n_rows": len(rows), "fitted": None, "accepted": False,
              "rank_corr_before": before, "rank_corr_after": None}
    fitted = fit_offload_constants(rows, hw=pricing_hw)
    if fitted is None:
        return record
    hw2 = dict(pricing_hw)
    hw2.update(fitted)
    for r in rows:
        r["calibrated_s"] = offload_cost_terms(
            r["h2d_bytes"], r["d2h_bytes"], r["dispatches"], r["syncs"],
            r["flops"], r["kernel_bytes"], r.get("coll_bytes", 0.0),
            hw=hw2)["predicted_s"]
    after = rank_correlation([r["calibrated_s"] for r in rows],
                             [r["measured_s"] for r in rows])
    record.update(fitted=fitted, rank_corr_after=after,
                  accepted=after >= before)
    return record


# --------------------------------------------------------------------------
# The explorer.
# --------------------------------------------------------------------------

def _resolve_cache(cache: Any) -> Optional[TuneCache]:
    if cache is None:
        return default_cache()
    if cache is False:
        return None
    return cache


def _cached_plan(program: Program, an: ProgramAnalysis, tuning: Dict,
                 fp: str, tc: TuneCache, be: Backend,
                 objective: Any = "time") -> Plan:
    """Rebuild the winning plan from a cache hit: the pass pipeline is
    deterministic, so re-running it for the chosen config reproduces the
    measured winner's ops exactly; the serialized table is attached
    verbatim (identical to the fresh run that stored it).

    The requested ``objective`` is NOT part of the fingerprint — the
    measured table is objective-independent, so one entry answers every
    objective.  A request that differs from the stored selection
    re-selects the chosen label from the stored per-objective winners
    (or re-scalarizes, for weight mappings) without re-measuring.

    The rebuilt winner is re-vetted by the static verifier — a corrupt
    payload (malformed keys raise ``KeyError``/``StopIteration`` here)
    or a stale one that no longer verifies against the current pipeline
    raises, and the caller evicts the entry instead of executing it."""
    if objective != tuning.get("objective", "time"):
        tuning = dict(tuning)
        tuning["objective"] = objective
        if objective == "time":
            measured = [r for r in tuning["candidates"]
                        if r.get("valid") and r.get("measured_s") is not None]
            tuning["chosen"] = (
                min(measured,
                    key=lambda r: (r["measured_s"], r.get("rank") or 0))
                if measured else tuning["candidates"][0])["label"]
        else:
            tuning["chosen"] = _select_chosen(
                tuning["candidates"], objective,
                tuning.get("winners") or {})["label"]
    chosen = next(c for c in tuning["candidates"]
                  if c["label"] == tuning["chosen"])
    cfg = _cfg_from_dict(chosen["config"])
    pl = Pipeline.default(cfg.policy, n_streams=cfg.n_streams
                          ).run(program, analysis=an)
    mesh_rec = tuning.get("mesh")
    report = verify_plan(pl, donate=cfg.donate and be.supports_donation,
                         kernel_variants=cfg.variants_map() or None,
                         shapes=an.shapes, mesh=mesh_rec)
    pl.meta["verify"] = report.meta_record()
    report.raise_if_failed()
    if mesh_rec is not None:
        pl.meta["mesh"] = mesh_rec
    pl.meta["tuning"] = tuning
    pl.meta["fuse_loops"] = cfg.fuse_loops
    pl.meta["donate"] = cfg.donate
    pl.meta["kernel_variants"] = cfg.variants_map()
    pl.meta["optimize"] = cfg.policy != "naive"
    pl.meta["tuning_cache"] = {"hit": True, "measurements": 0,
                               "path": str(tc.path), "fingerprint": fp}
    return pl


def _mesh_record(be: Backend, ctx: Dict[str, Any]) -> Dict[str, Any]:
    """JSON-safe ``meta["mesh"]`` record for one placement context (what
    the verifier checks, ``execute()`` re-applies via ``with_placement``,
    and the tune cache round-trips)."""
    shape, axes = be.mesh_desc
    return {
        "shape": list(shape),
        "axes": list(axes),
        "placement": ctx["placement"],
        "n_devices": int(ctx["n_devices"]),
        "specs": {v: list(e) for v, e in ctx["specs"].items()},
        "dropped": [list(d) for d in ctx["dropped"]],
    }


def _kernel_variant_combos(program: Program,
                           an: ProgramAnalysis) -> List[Tuple]:
    """The kernel axis of the grid: the cross product of tile variants
    over the program's kernel-tagged blocks (blocks sharing a kernel name
    share the choice).  ``[()]`` for kernel-free programs, keeping their
    grid exactly the pre-kernel-axis one."""
    import numpy as np
    kernels: Dict[str, Any] = {}
    for blk in program.offload_blocks():
        if blk.kernel and blk.kernel not in kernels:
            kernels[blk.kernel] = blk
    if not kernels:
        return [()]
    from ..kernels.variants import variants_for
    per_kernel = []
    for name in sorted(kernels):
        blk = kernels[name]
        try:
            sds = [an.shapes[v] for v in blk.reads]
            shapes = [tuple(s.shape) for s in sds]
            itemsizes = [int(np.dtype(s.dtype).itemsize) for s in sds]
            vs = variants_for(name, shapes, itemsizes)
        except Exception:
            vs = ()
        if vs:
            per_kernel.append([(name, v.params) for v in vs])
    if not per_kernel:
        return [()]
    return [tuple(combo) for combo in itertools.product(*per_kernel)]


def tune(program: Program, *, backend: Any = None,
         analysis: Optional[ProgramAnalysis] = None,
         policies: Sequence[str] = DEFAULT_POLICIES,
         streams: Sequence[int] = DEFAULT_STREAMS,
         fuse: Sequence[bool] = (True, False),
         donate: Sequence[bool] = (False, True),
         placements: Optional[Sequence[str]] = None,
         configs: Optional[Sequence[PlanConfig]] = None,
         measure: bool = True, top_k: Optional[int] = None,
         reps: int = 2, cache: Any = None, refresh: bool = False,
         calibrate: bool = True, use_calibration: bool = True,
         objective: Any = "time") -> Plan:
    """Explore the plan space; return the winning ``Plan``.

    Candidates are grouped into *execution classes* (identical ops +
    effective fusion + effective donation): each class is priced and
    measured once through its first-enumerated survivor, and the merged
    configs appear in the table with ``alias_of`` pointing at it — the
    table still enumerates the full config grid the paper explores,
    measurement cost scales with the DISTINCT executions.  Measured
    classes run ``reps`` times compiled on a physically matching
    ``backend.variant`` (all of them, or only the predicted
    top-``top_k`` classes).  The winner is the best *measured* candidate
    (predicted order breaks ties / decides when measurement is off).

    ``cache`` is a ``TuneCache`` (None → the ``REPRO_TORCH_TUNE_CACHE``
    default, False → disabled): when the content fingerprint of
    (program, backend, grid, protocol, cost-model version) hits, the
    stored winner + table are returned with ZERO measurements;
    ``refresh=True`` re-measures and overwrites.  ``measure=False``
    bypasses the cache entirely (predictions are cheap and a cached
    measured table would not be the requested artifact).

    ``calibrate``/``use_calibration`` control the measured calibration:
    fitted ``pcie_bw``/``launch_overhead_s``/``sync_overhead_s`` are
    stored per DEVICE CLASS (``tunecache.device_class_key`` — shared
    across stream-count/donation twins of the same device) and used to
    price subsequent tuning calls (see ``meta["tuning"]["calibration"]``
    for the fit and the before/after rank correlations).

    ``objective`` selects which axis the winner minimizes:
    ``"time"`` (default, the historical behaviour), ``"energy"``
    (modeled joules: transfer + HBM + interconnect bytes × per-byte
    constants, flops × ``flop_j``), ``"memory"`` (peak device bytes from
    the static residency walk, ``plan_peak_device_bytes`` — donation and
    kernel tile size both move it), or a ``{objective: weight}`` mapping
    scalarized over min-normalized columns.  Every candidate carries all
    three columns and the non-dominated surface is returned regardless
    of the objective, so switching objectives re-selects from the same
    (cached) table without re-measuring.

    When the tunecache holds measured rows from ≥ 2 OTHER programs of
    the same device class, a cross-program predictor
    (``fit_candidate_predictor``) prices this grid too
    (``predictor_s``): accepted — and persisted — only when it does not
    lower the predicted-vs-measured rank correlation against the
    uncalibrated analytic model on this program's measurements; on a
    zero-measurement cold start (``measure=False`` or abstract inputs)
    an available model picks the winner (``used_for_ranking``).

    Returned meta:

        plan.meta["tuning"]   {"chosen", "objective", "backend", "hw",
                              "calibration", "predictor", "winners",
                              "pareto", "candidates"} — candidates
                              ranked by predicted cost, each with
                              predicted AND measured seconds plus the
                              energy_j / peak_bytes objective columns
        plan.meta["tuning_cache"]
                              {"hit", "measurements", "path",
                              "fingerprint"} — cache outcome + how many
                              configs were actually measured
        plan.meta["fuse_loops"] / ["donate"]
                              — how the winner wants to be executed

    ``placements`` is the mesh placement axis: ``None`` takes
    ``DEFAULT_PLACEMENTS`` on a placement-capable backend
    (``MeshBackend``) and ``("",)`` elsewhere.
    """
    from .compile import fusable_loops
    an = analysis or analyze(program)
    be = get_backend(backend)
    # -- mesh placement axis: only on placement-capable backends ----------
    mesh_capable = (hasattr(be, "with_placement")
                    and getattr(be, "mesh_desc", None) is not None)
    if placements is None:
        if mesh_capable:
            from ..distributed.mesh_backend import DEFAULT_PLACEMENTS
            placements = DEFAULT_PLACEMENTS
        else:
            placements = ("",)   # single-device grid: unchanged labels/fps
    cfg_list = list(configs) if configs is not None else enumerate_configs(
        policies, streams, fuse, donate, placements)
    if not cfg_list:
        raise ValueError("tune() needs at least one candidate config")

    # per-placement pricing context: specs through the divisibility-
    # guarded sharding rules, per-device flops + collective wire bytes
    # from one traced run on meta DTensors, PCIe replication factors
    mesh_ctx: Dict[str, Dict[str, Any]] = {}
    if mesh_capable:
        from ..distributed.mesh_backend import (mesh_cost_terms,
                                                placement_specs)
        for pol in sorted({c.mesh_placement for c in cfg_list
                           if c.mesh_placement}):
            specs, dropped = placement_specs(an.shapes, be.mesh, pol)
            ctx = mesh_cost_terms(program, an.shapes, be, specs)
            ctx["placement"] = pol
            ctx["dropped"] = dropped
            mesh_ctx[pol] = ctx

    # -- kernel axis: cross the grid with per-kernel tile variants ----------
    combos = _kernel_variant_combos(program, an)
    if combos != [()]:
        expanded: List[PlanConfig] = []
        for cfg in cfg_list:
            if cfg.kernel_variants:
                expanded.append(cfg)       # caller pinned a tile choice
            else:
                expanded.extend(
                    dataclasses.replace(cfg, kernel_variants=c)
                    for c in combos)
        cfg_list = expanded

    objective = _check_objective(objective)

    # -- cache: the measured-table slot is measure-only, but the device-
    # class store (calibration / measured rows / predictor) also serves
    # prediction-only runs — that is the whole point of a cold start
    tc = _resolve_cache(cache)
    fp = slot = None
    be_key = backend_fingerprint(be)
    dc_key = device_class_key(be)
    prog_fp = program_fingerprint(program)
    if tc is not None and measure:
        protocol = {"measure": True, "top_k": top_k, "reps": int(reps),
                    "calibrate": bool(calibrate),
                    "use_calibration": bool(use_calibration)}
        fp = tuning_fingerprint(program, be, cfg_list, protocol, HW)
        # the grid/protocol is part of the SLOT (coexisting entries),
        # not just the fingerprint (which would evict-thrash between
        # alternating protocol variants of the same program); the
        # OBJECTIVE is deliberately absent from both — the table is
        # objective-independent and re-selection is free
        slot = (f"{program.name}--{be_key}"
                f"--{grid_fingerprint(cfg_list, protocol)[:16]}")
        if not refresh:
            payload = _from_writer(be, lambda: tc.lookup(slot, fp))
            if payload is not None:
                try:
                    return _cached_plan(program, an, payload["tuning"],
                                        fp, tc, be, objective)
                except (PlanVerificationError, KeyError, StopIteration,
                        TypeError, ValueError):
                    # corrupt payload or a winner that no longer passes
                    # the verifier: evict and fall through to a fresh run
                    if _is_writer(be):
                        tc.evict(slot)

    # -- pricing constants: calibrated when a fit is cached -----------------
    pricing_hw = dict(HW)
    if use_calibration and tc is not None:
        fitted = _from_writer(be, lambda: tc.load_calibration(dc_key, HW))
        if fitted:
            pricing_hw.update(fitted)

    # -- cross-program cold-start predictor: fit from OTHER
    # programs' measured rows accumulated for this device class; fall
    # back to the last persisted (previously accepted) model
    predictor_model = None
    predictor_source = None
    n_train_rows = 0
    if tc is not None:
        def read_predictor():
            rows = tc.load_measured_rows(dc_key, HW, exclude_fp=prog_fp)
            model = fit_candidate_predictor(rows)
            if model is not None:
                return model, "fit", len(rows)
            model = tc.load_predictor(dc_key, HW)
            return model, (None if model is None else "cache"), len(rows)
        predictor_model, predictor_source, n_train_rows = _from_writer(
            be, read_predictor)

    # -- enumerate + dominance-prune into execution classes -----------------
    flops_cache: Optional[Dict[int, float]] = None
    records: List[Dict[str, Any]] = []
    plans: Dict[str, Plan] = {}
    classes: Dict[Tuple, Dict[str, Any]] = {}
    # the pipeline is deterministic in (policy, n_streams): kernel-axis
    # expansion re-visits each placement many times, so memoize the runs
    pipe_cache: Dict[Tuple[str, int], Plan] = {}
    launch_keys: Dict[str, Tuple] = {}

    for cfg in cfg_list:
        base = {"label": cfg.label, "config": cfg.as_dict(),
                "aliases": [], "alias_of": None, "valid": True,
                "error": None, "measured_s": None, "calibrated_s": None,
                "rank": None}
        try:
            pipe_key = (cfg.policy, cfg.n_streams)
            pl = pipe_cache.get(pipe_key)
            if pl is None:
                pl = Pipeline.default(cfg.policy, n_streams=cfg.n_streams
                                      ).run(program, analysis=an)
                pipe_cache[pipe_key] = pl
        except (RuntimeError, ValueError) as e:
            base.update(valid=False, error=str(e))
            records.append(base)
            continue
        # execution class: the ops tuple itself (frozen dataclasses —
        # exact, unlike its hash) + the flags as the EXECUTOR sees them
        # + the kernel tile choice (already canonical: clamped/deduped by
        # the registry, so declared tiles that launch identically merged
        # during enumeration).  fuse without fusable loops, or donate on
        # a backend without donation, cannot change execution: such
        # configs merge here instead of being measured separately
        # (dominance pruning).
        eff_fuse = cfg.fuse_loops and bool(fusable_loops(pl))
        eff_donate = cfg.donate and be.supports_donation
        key = (tuple(pl.ops), eff_fuse, eff_donate, cfg.kernel_variants,
               cfg.mesh_placement)
        cfg_mesh = mesh_ctx.get(cfg.mesh_placement)
        survivor = classes.get(key)
        if survivor is None:
            # every execution class is statically vetted BEFORE it is
            # priced or measured: a candidate the verifier rejects is
            # recorded invalid (never ranked, never run) and counted in
            # meta["tuning"]["pruned_invalid"].  Verification depends
            # exactly on the class key (ops, donation, kernel tiles; the
            # registry enumerates only legal tiles, so merged tiles
            # share one verdict), and aliases inherit the survivor's.
            vrep = verify_plan(pl, donate=eff_donate,
                               kernel_variants=cfg.variants_map() or None,
                               shapes=an.shapes, collect_lints=False,
                               mesh=(_mesh_record(be, cfg_mesh)
                                     if cfg_mesh else None))
            if not vrep.ok:
                base.update(valid=False, error="verifier: " + "; ".join(
                    str(v) for v in vrep.errors[:3]))
                classes[key] = base
                records.append(base)
                continue
            if flops_cache is None:
                flops_cache = block_flops(program, an.shapes)
            base.update(predict_cost(pl, cfg, flops_cache, hw=pricing_hw,
                                     shapes=an.shapes, mesh=cfg_mesh))
            # remaining objective columns (energy_j already arrived with
            # the cost terms): analytic_s re-prices the counters with the
            # DEFAULT constants — the predictor's anchor feature and the
            # no-regression baseline its acceptance is judged against —
            # and peak_bytes walks the plan's residency under this
            # class's donation flag and kernel tile choice
            base["analytic_s"] = offload_cost_terms(
                base["h2d_bytes"], base["d2h_bytes"], base["dispatches"],
                base["syncs"], base["flops"], base["kernel_bytes"],
                base["coll_bytes"])["predicted_s"]
            base["peak_bytes"] = plan_peak_device_bytes(
                pl, donate=eff_donate,
                kernel_variants=cfg.variants_map() or None,
                shapes=an.shapes)
            classes[key] = base
            plans[cfg.label] = pl
            # a backend whose kernels do not read the tile launches the
            # same work for every tile: such classes are priced apart
            # but measured once
            launch_keys[cfg.label] = (key if be.reads_kernel_tiles
                                      else key[:3] + key[4:])
        else:
            survivor["aliases"].append(cfg.label)
            base["alias_of"] = survivor["label"]
            if not survivor["valid"]:
                base.update(valid=False, error=survivor["error"])
            else:
                base.update({k: survivor[k] for k in _COST_FIELDS})
        records.append(base)

    valid = [r for r in records if r["valid"]]
    if not valid:
        raise RuntimeError(
            "plan-space exploration found no valid candidate: "
            + "; ".join(f"{r['label']}: {r['error']}" for r in records))
    valid.sort(key=lambda r: r["predicted_s"])
    for i, r in enumerate(valid):
        r["rank"] = i + 1

    # price the grid with the cross-program model — per candidate,
    # aliases included: the stream count is a knob the analytic model
    # cannot always separate (classes merge when streams don't change
    # the ops), but it IS a predictor feature, so merged configs carry
    # distinct learned prices
    if predictor_model is not None:
        for r in valid:
            r["predictor_s"] = predict_candidate_s(predictor_model, r)

    # -- measure one survivor per class -------------------------------------
    n_measured = 0
    if measure and _measurable(program):
        survivors = [r for r in valid if r["alias_of"] is None]
        to_measure = (survivors if top_k is None
                      else survivors[:max(1, top_k)])
        first: Dict[Tuple, Dict[str, Any]] = {}
        for r in to_measure:
            same = first.setdefault(launch_keys[r["label"]], r)
            if same is r:
                cfg = _cfg_from_dict(r["config"])
                ctx = mesh_ctx.get(cfg.mesh_placement)
                wall, kern = _measure(plans[r["label"]], cfg, be, reps,
                                      placement=(ctx["specs"] if ctx
                                                 else None))
                n_measured += 1
            else:
                # the best-ranked class of the same launches was measured
                r["measured_as"] = same["label"]
                wall, kern = same["measured_s"], same["measured_kernel_s"]
            r["measured_s"] = wall
            # roofline drift per variant: measured kernel leg vs the
            # analytic kernel_s the ranking used (0 residual on backends
            # that don't time kernels, e.g. interpreted numpy)
            r["measured_kernel_s"] = kern
            r["kernel_residual_s"] = kern - r["kernel_s"]

    # -- calibration (on the measured survivors, before alias fan-out) ------
    calibration = None
    measured_survivors = [r for r in valid if r["alias_of"] is None
                          and r["measured_s"] is not None
                          and "measured_as" not in r]
    if calibrate and measured_survivors:
        calibration = _calibrate(measured_survivors, pricing_hw)
        if calibration["accepted"] and calibration["fitted"] and tc:
            if _is_writer(be):
                tc.store_calibration(dc_key, HW, calibration["fitted"])

    # accumulate this program's measured rows into the device-class
    # store — the training set future programs' cold starts fit from.
    # Survivors only: an alias shares its survivor's measurement, and
    # labeling a different stream count with the same seconds would
    # teach the model the knob is free when it merely wasn't separable
    # here.
    if tc is not None and measured_survivors and _is_writer(be):
        tc.add_measured_rows(
            dc_key, HW, prog_fp, program.name,
            [dict(candidate_features(r), measured_s=r["measured_s"],
                  program=program.name)
             for r in measured_survivors])

    # predictor acceptance: same no-regression gate as the calibration —
    # kept (and persisted for true cold starts) only when its ranking of
    # THIS program's measured survivors is at least as good as the
    # uncalibrated analytic model's
    predictor = None
    if tc is not None:
        predictor = {"n_rows": n_train_rows,
                     "n_programs": (predictor_model or {}).get("n_programs"),
                     "source": predictor_source, "accepted": None,
                     "rank_corr_analytic": None,
                     "rank_corr_predictor": None,
                     "used_for_ranking": False}
        if predictor_model is not None and len(measured_survivors) >= 2:
            corr_a = rank_correlation(
                [r["analytic_s"] for r in measured_survivors],
                [r["measured_s"] for r in measured_survivors])
            corr_p = rank_correlation(
                [r["predictor_s"] for r in measured_survivors],
                [r["measured_s"] for r in measured_survivors])
            predictor.update(rank_corr_analytic=corr_a,
                             rank_corr_predictor=corr_p,
                             accepted=corr_p >= corr_a)
            if predictor["accepted"] and predictor_source == "fit":
                if _is_writer(be):
                    tc.store_predictor(dc_key, HW, predictor_model)

    # merged configs inherit their survivor's measurements
    by_label = {r["label"]: r for r in valid}
    for r in valid:
        if r["alias_of"] is not None:
            survivor = by_label[r["alias_of"]]
            r["measured_s"] = survivor["measured_s"]
            r["calibrated_s"] = survivor["calibrated_s"]
            for k in _MEASURE_FIELDS:
                if k in survivor:
                    r[k] = survivor[k]

    measured = [r for r in valid if r["measured_s"] is not None]
    winners = _objective_winners(valid)
    pareto = _pareto_records(valid)
    if objective == "time":
        # the historical rule: best measured seconds, ties (merged
        # classes share a value) resolve to the best rank, which is
        # always a class survivor.  On a zero-measurement cold start an
        # available cross-program model outranks the analytic order.
        if measured:
            chosen = min(measured,
                         key=lambda r: (r["measured_s"], r["rank"]))
        elif predictor_model is not None:
            chosen = min(valid,
                         key=lambda r: (r["predictor_s"], r["rank"]))
            predictor["used_for_ranking"] = True
        else:
            chosen = valid[0]
    else:
        chosen = _select_chosen(valid, objective, winners)

    chosen_cfg = _cfg_from_dict(chosen["config"])
    best = plans[chosen["alias_of"] or chosen["label"]]
    chosen_mesh = (
        _mesh_record(be, mesh_ctx[chosen_cfg.mesh_placement])
        if chosen_cfg.mesh_placement in mesh_ctx else None)
    best.meta["tuning"] = {
        "chosen": chosen["label"],
        "objective": objective,
        "winners": winners,
        "pareto": pareto,
        "backend": be.name,
        "hw": {k: pricing_hw[k] for k in _HW_KEYS},
        "calibration": calibration,
        "predictor": predictor,
        "kernel_variants": chosen_cfg.variants_map(),
        "mesh": chosen_mesh,
        "pruned_invalid": sum(
            1 for r in records
            if not r["valid"] and str(r["error"]).startswith("verifier:")),
        "candidates": valid + [r for r in records if not r["valid"]],
    }
    if chosen_mesh is not None:
        best.meta["mesh"] = chosen_mesh
    # the winner's full verdict (lints included) — the per-class vet
    # above ran error-only
    vrep = verify_plan(
        best, donate=chosen["config"]["donate"] and be.supports_donation,
        kernel_variants=chosen_cfg.variants_map() or None,
        shapes=an.shapes, mesh=chosen_mesh)
    best.meta["verify"] = vrep.meta_record()
    best.meta["fuse_loops"] = chosen["config"]["fuse_loops"]
    best.meta["donate"] = chosen["config"]["donate"]
    best.meta["kernel_variants"] = chosen_cfg.variants_map()
    best.meta["optimize"] = chosen["config"]["policy"] != "naive"
    best.meta["tuning_cache"] = {
        "hit": False, "measurements": n_measured,
        "path": str(tc.path) if tc is not None else None,
        "fingerprint": fp,
    }

    if tc is not None and n_measured and _is_writer(be):
        tc.store(slot, fp, {"tuning": best.meta["tuning"]})
    barrier = getattr(be, "barrier", None)
    if barrier is not None:
        barrier()           # no rank reads the cache before it is written
    return best
