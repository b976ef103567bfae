"""Roofline pricing for the plan-space tuner, on an H100.

The reference prices each offload block by lowering it with XLA and
parsing the optimized HLO for its dot FLOPs.  Here ``block_flops`` runs
each block body once under ``torch.utils.flop_counter.FlopCounterMode``
on meta tensors (nothing is allocated and no kernel is launched), with
formulas registered for the matrix-vector and vector-vector products the
counter leaves at 0 (``aten.mv``: 2·m·n, ``aten.dot``: 2·n), so a
polybench block's count equals the reference's HLO count exactly.  Like
the reference, only products are counted (elementwise work is not), a
kernel-tagged block counts 0 (it is priced per tile variant by
``kernel_roofline_terms``), and a block that fails to trace counts 0.

The rest is the reference's model: ``offload_cost_terms`` (PCIe transfer,
dispatch/sync overheads, per-block roofline, interconnect, energy),
``kernel_roofline_terms`` on the port's tile registry, the calibration fit
``fit_offload_constants``, ``rank_correlation``, the cross-program
candidate predictor, and the analytic model FLOPs / HBM bytes on the
port's configs.

There is no HLO to read a sharded program's collectives from.
``trace_step`` runs a step once (on ``meta`` DTensors, so nothing is
allocated) under ``CollectiveTrace``, a ``CommDebugMode`` that records
each collective's op, group size and tensor bytes and counts the
per-device FLOPs of the local (non-DTensor) products.
``collective_bytes`` prices those records with the reference's
ring-volume formulas under its keys, and ``roofline_terms`` takes them
with the per-device FLOPs where the reference takes ``hlo_text``.

``HW`` describes one NVIDIA H100 SXM5 80GB from NVIDIA's published
figures.  The table is UNCALIBRATED: the launch and sync overheads and
every energy constant are estimates, and the tuner's measured calibration
(``fit_offload_constants``, stored per device class by
``repro_torch.core.tunecache``) replaces the time constants once it has
measured the card.
"""
from __future__ import annotations

from typing import Dict, List, Optional

__all__ = ["HW", "CALIBRATABLE", "ENERGY_TERMS", "PREDICTOR_FEATURES",
           "block_flops", "analytic_model_flops", "analytic_hbm_bytes",
           "offload_cost_terms", "kernel_roofline_terms",
           "fit_offload_constants", "rank_correlation",
           "candidate_features", "fit_candidate_predictor",
           "predict_candidate_s", "COLLECTIVES", "collective_trace",
           "trace_step", "collective_bytes", "roofline_terms"]

HW = {
    # dense bf16 tensor-core peak (H100 SXM5 data sheet, 989.4 TFLOP/s;
    # the reference prices every block against this one peak)
    "peak_flops_bf16": 989e12,
    # HBM3 bandwidth (H100 SXM5 data sheet, 3.35 TB/s)
    "hbm_bw": 3.35e12,
    # NVLink 4, one direction (900 GB/s total over both; unused on one card)
    "ici_bw": 450e9,
    # host<->device link for advancedload/delegatestore traffic: PCIe
    # Gen5 x16, one direction (64 GB/s)
    "pcie_bw": 64e9,
    # per physical dispatch: an eager PyTorch launch from Python (host
    # dispatch plus cudaLaunchKernel), estimated at 8 us
    "launch_overhead_s": 8e-6,
    # per wait point: an event synchronize round trip, estimated at 15 us
    "sync_overhead_s": 15e-6,
    # energy per byte / flop for the tuner's energy objective, all
    # estimates (no power meter is read):
    # PCIe Gen5 link plus the host DRAM read, ~10 pJ/bit
    "pcie_j_per_byte": 8.0e-11,
    # HBM3 access, ~3.9 pJ/bit
    "hbm_j_per_byte": 3.1e-11,
    # NVLink 4, ~2.5 pJ/bit
    "ici_j_per_byte": 2.0e-11,
    # board power limit over the dense bf16 peak: 700 W / 989e12 flop/s
    "flop_j": 7.1e-13,
}

# the energy-model constants (a documented subset of HW; override via
# ``hw=`` to recalibrate for a different part)
ENERGY_TERMS = ("pcie_j_per_byte", "hbm_j_per_byte", "ici_j_per_byte",
                "flop_j")


def _mv_flops(a_shape, b_shape, *args, out_shape=None, **kwargs) -> int:
    m, n = a_shape
    return 2 * m * n


def _dot_flops(a_shape, b_shape, *args, out_shape=None, **kwargs) -> int:
    return 2 * a_shape[0]


def block_flops(program, shapes: Dict[str, object]) -> Dict[int, float]:
    """{offload block index: FLOPs of one launch}.  Each non-kernel block
    body runs once under ``FlopCounterMode`` on meta tensors of its read
    shapes (``shapes`` is the analyzer's var -> ShapeDtype map); kernel-
    tagged blocks and blocks that fail to trace count 0."""
    import torch
    from torch.utils.flop_counter import FlopCounterMode

    from ..core.dtypes import torch_dtype
    aten = torch.ops.aten
    mapping = {aten.mv: _mv_flops, aten.dot: _dot_flops}
    out: Dict[int, float] = {}
    for blk in program.offload_blocks():
        if blk.kernel:
            out[blk.idx] = 0.0
            continue
        try:
            args = {v: torch.empty(tuple(shapes[v].shape),
                                   dtype=torch_dtype(shapes[v].dtype),
                                   device="meta")
                    for v in blk.reads}
            counter = FlopCounterMode(display=False, custom_mapping=mapping)
            with counter:
                blk.fn(torch, **args)
            out[blk.idx] = float(counter.get_total_flops())
        except Exception:
            out[blk.idx] = 0.0
    return out


# ---------------------------------------------------------------------------
# Analytic terms
# ---------------------------------------------------------------------------

def analytic_model_flops(cfg, shape) -> float:
    """MODEL_FLOPS per the assignment: 6·N·D (dense) / 6·N_active·D (MoE),
    plus the causal-attention term 6·B·S²·H·d_h per attn layer (halved for
    causality, ×2 window fraction for local attention).  Decode shapes:
    D = one token per sequence, attention reads the full cache."""
    from ..configs import active_param_count
    n_active = active_param_count(cfg)
    B, S = shape.global_batch, shape.seq_len
    if shape.kind == "decode":
        tokens = B          # one new token per sequence
        attn_ctx = S        # attends over the whole cache
    else:
        tokens = B * S
        attn_ctx = S / 2    # causal average context
    flops = 6.0 * n_active * tokens
    if shape.kind != "train":
        flops /= 3.0        # forward only
    # attention score/value FLOPs (not in 6ND)
    kinds = cfg.layer_kinds()
    n_attn = sum(1 for k in kinds if k == "attn")
    if n_attn and cfg.n_heads:
        ctx = attn_ctx
        if cfg.local_window:
            ctx = min(ctx, cfg.local_window)
        per_tok = 2 * 2 * cfg.n_heads * cfg.d_head * ctx  # qk^T + pv
        mult = 3.0 if shape.kind == "train" else 1.0
        flops += mult * n_attn * tokens * per_tok
    return flops


def analytic_hbm_bytes(cfg, shape, n_devices: int, *,
                       grad_accum: int = 1, remat_factor: float = 2.0,
                       kv_bytes: int = 2) -> float:
    """Per-device HBM traffic model (documented in EXPERIMENTS.md):

    train:  params (fwd read + bwd read, bf16) × grad_accum
            + grads (fp32 write+read) + AdamW m,v (fp32 r+w each)
            + activations: layers × local_tokens × d_model × 2B ×
              (fwd w + fwd r + remat recompute + bwd r/w ≈ 6) × remat_factor
    decode: params read once + KV cache read (+ small write) per token.
    """
    from ..configs import param_count
    n = param_count(cfg)
    p_local = n / n_devices
    B, S = shape.global_batch, shape.seq_len
    d = cfg.d_model
    L = cfg.n_layers
    if shape.kind == "decode":
        kinds = cfg.layer_kinds()
        n_attn = sum(1 for k in kinds if k == "attn")
        ctx = min(S, cfg.local_window) if cfg.local_window else S
        kv_traffic = (n_attn * B * ctx * cfg.n_kv_heads * cfg.d_head
                      * 2 * kv_bytes)            # k+v read per step
        state_bytes = 0.0
        if cfg.layer_pattern == "rwkv":
            H = d // cfg.rwkv_head_size
            state_bytes = L * B * H * cfg.rwkv_head_size ** 2 * 4 * 2
        if cfg.layer_pattern == "griffin":
            n_rec = sum(1 for k in kinds if k == "rglru")
            state_bytes = n_rec * B * d * 4 * 2
        return p_local * 2 + (kv_traffic + state_bytes) / n_devices
    tokens_local = B * S / n_devices
    act = L * tokens_local * d * 2 * 6 * remat_factor
    if shape.kind == "prefill":
        return p_local * 2 + act / 3.0
    param_traffic = p_local * (2 * 2 * grad_accum   # fwd+bwd reads / mb
                               + 4 + 4              # grad write+read fp32
                               + 16 + 2)            # m,v r/w fp32 + w write
    return param_traffic + act


def offload_cost_terms(h2d_bytes: float, d2h_bytes: float,
                       dispatches: float, syncs: float,
                       flops: float, kernel_bytes: float,
                       coll_bytes: float = 0.0,
                       hw: Optional[Dict[str, float]] = None
                       ) -> Dict[str, float]:
    """Static cost terms for one offload-plan execution — the roofline
    model applied to the planner's schedule (used by ``repro_torch.core.tuner``
    to rank candidate plans):

        transfer_s   = (h2d + d2h bytes) / pcie_bw
        dispatch_s   = launch_overhead × dispatches + sync_overhead × syncs
        kernel_s     = max(flops / peak, kernel HBM bytes / hbm_bw)
        collective_s = collective wire bytes / ici_bw

    ``predicted_s`` sums the four: transfers on this machine are NOT
    overlapped with the modelled kernel time (the plan's async streams
    overlap them with *host* work), so a sum — not a max — ranks
    correctly.  Since the kernel tuning axis, ``kernel_s`` is
    no longer plan-invariant: kernel-tagged blocks are priced per tile
    variant via ``kernel_roofline_terms``, so the HBM/flops legs of the
    roofline carry cross-candidate signal too.  ``coll_bytes`` carries
    the ring-volume bytes of a sharded placement's collectives, priced
    against the inter-chip interconnect beside the PCIe leg; the
    single-device plans of this port leave it 0 and the term vanishes.

    ``energy_j`` estimates the plan's data-movement + compute
    energy: bytes moved over each link × its per-byte joule constant
    (``ENERGY_TERMS``) plus flops × ``flop_j`` — the second objective of
    the tuner's time × energy × memory Pareto frontier.  The ``.get``
    fallbacks keep partially-specified ``hw`` overrides (the calibration
    fit only produces time constants) working."""
    h = hw or HW
    transfer_s = (h2d_bytes + d2h_bytes) / h["pcie_bw"]
    dispatch_s = (h["launch_overhead_s"] * dispatches
                  + h["sync_overhead_s"] * syncs)
    kernel_s = max(flops / h["peak_flops_bf16"],
                   kernel_bytes / h["hbm_bw"])
    collective_s = coll_bytes / h["ici_bw"]
    energy_j = (
        (h2d_bytes + d2h_bytes)
        * h.get("pcie_j_per_byte", HW["pcie_j_per_byte"])
        + kernel_bytes * h.get("hbm_j_per_byte", HW["hbm_j_per_byte"])
        + coll_bytes * h.get("ici_j_per_byte", HW["ici_j_per_byte"])
        + flops * h.get("flop_j", HW["flop_j"]))
    return {
        "transfer_s": transfer_s,
        "dispatch_s": dispatch_s,
        "kernel_s": kernel_s,
        "collective_s": collective_s,
        "predicted_s": transfer_s + dispatch_s + kernel_s + collective_s,
        "energy_j": energy_j,
    }


def kernel_roofline_terms(kernel: str, variant, shapes,
                          itemsizes=(),
                          hw: Optional[Dict[str, float]] = None
                          ) -> Dict[str, float]:
    """Per-kernel roofline cutout: analytic flops + HBM bytes touched
    for one grid sweep of ``kernel`` launched with the tile parameters in
    ``variant`` (a dict or ``((name, value), ...)`` tuple) on operand
    ``shapes`` — the second level of the two-level (PCIe + HBM) roofline.
    Bytes follow the variant's tile revisit structure, so ``kernel_s``
    genuinely differs across tile candidates."""
    from ..kernels import variants as _kv
    h = hw or HW
    params = dict(variant)
    flops, kbytes = _kv.kernel_roofline(kernel, params, shapes, itemsizes)
    return {
        "flops": float(flops),
        "kernel_bytes": float(kbytes),
        "kernel_s": max(flops / h["peak_flops_bf16"], kbytes / h["hbm_bw"]),
    }


# The offload-cost constants a measured tuning table can re-fit (the
# OpenMP-Advisor observation: calibrated beats fixed for offload
# decisions).  Since the kernel tuning axis, tile variants make
# kernel_s vary across candidates, so the HBM/flops roofline legs are
# identifiable too and join the fit.  Sharded candidates (the
# reference's mesh placement axis) carry collective wire bytes, making
# the interconnect rate identifiable the same way.
CALIBRATABLE = ("pcie_bw", "launch_overhead_s", "sync_overhead_s",
                "hbm_bw", "peak_flops_bf16", "ici_bw")

# clamp ranges keeping a degenerate fit physical: bandwidths within
# [100 MB/s, 100 TB/s], per-event overheads within [0, 100 ms],
# peak compute within [1 GFLOP/s, 1 EFLOP/s]
_FIT_BOUNDS = {
    "pcie_bw": (1e8, 1e14),
    "launch_overhead_s": (0.0, 0.1),
    "sync_overhead_s": (0.0, 0.1),
    "hbm_bw": (1e8, 1e14),
    "peak_flops_bf16": (1e9, 1e18),
    "ici_bw": (1e8, 1e14),
}

# design-matrix column order for the joint fit
_FIT_COLS = ("pcie", "dispatches", "syncs", "flops", "kbytes", "coll")


def _lstsq_cols(cols, y):
    """Scaled least squares over the non-degenerate columns.  Returns
    ({col_name: coefficient}, residual) or None when the system is
    under-determined (fewer rows than active columns)."""
    import numpy as np
    active = [n for n in _FIT_COLS if cols[n].any()]
    if not active or len(y) < len(active):
        return None
    X = np.column_stack([cols[n] for n in active])
    scale = X.max(axis=0)
    scale[scale == 0] = 1.0
    try:
        coef, *_ = np.linalg.lstsq(X / scale, y, rcond=None)
    except np.linalg.LinAlgError:
        return None
    coef = coef / scale
    resid = float(np.square(X @ coef - y).sum())
    return dict(zip(active, coef.tolist())), resid


def fit_offload_constants(rows, hw: Optional[Dict[str, float]] = None
                          ) -> Optional[Dict[str, float]]:
    """Joint least-squares fit of the CALIBRATABLE constants from a
    measured tuning table.

    ``rows`` are candidate records carrying the ``predict_cost``
    decomposition (``h2d_bytes``/``d2h_bytes``/``dispatches``/``syncs``/
    ``flops``/``kernel_bytes``) plus ``measured_s``.  The model is exactly
    ``offload_cost_terms``:

        measured ≈ bytes/pcie_bw + launch·dispatches + sync·syncs
                   + max(flops/peak, kernel_bytes/hbm_bw)

    The max() makes this piecewise linear: a row is compute-bound when its
    arithmetic intensity (flops/kernel_bytes) exceeds the machine balance
    peak/hbm_bw — which we are fitting.  But sorting rows by intensity
    reduces the assignment to ONE threshold position, so we sweep every
    split of the sorted rows, solve the then-linear system (flops column
    active on the compute side, kernel_bytes on the memory side), and keep
    the assignment with the lowest residual.  Columns that are identically
    zero (e.g. no kernel-tagged blocks in the table) drop out and their
    constants keep the incoming defaults.

    Needs ≥ 3 measured rows and at least as many rows as active columns;
    returns None when under-determined.  Fitted values are clamped to
    physical ranges; non-positive rate coefficients fall back to the
    incoming defaults."""
    import numpy as np
    h = dict(hw or HW)
    rows = [r for r in rows if r.get("measured_s") is not None]
    if len(rows) < 3:
        return None
    pcie = np.array([r["h2d_bytes"] + r["d2h_bytes"] for r in rows], float)
    disp = np.array([r["dispatches"] for r in rows], float)
    sync = np.array([r["syncs"] for r in rows], float)
    flops = np.array([r.get("flops", 0.0) or 0.0 for r in rows], float)
    kbytes = np.array([r.get("kernel_bytes", 0.0) or 0.0
                       for r in rows], float)
    coll = np.array([r.get("coll_bytes", 0.0) or 0.0 for r in rows], float)
    y = np.array([r["measured_s"] for r in rows], float)

    # arithmetic intensity; bytes-free compute rows pin to the compute
    # side (+inf), flop-free rows to the memory side (-1)
    ai = np.where(kbytes > 0, flops / np.maximum(kbytes, 1e-300),
                  np.where(flops > 0, np.inf, -1.0))
    order = np.argsort(-ai, kind="stable")    # descending intensity

    best = None
    for t in range(len(rows) + 1):
        # first t rows (by descending intensity) are compute-bound
        compute = np.zeros(len(rows), bool)
        compute[order[:t]] = True
        cols = {
            "pcie": pcie, "dispatches": disp, "syncs": sync,
            "flops": np.where(compute, flops, 0.0),
            "kbytes": np.where(compute, 0.0, kbytes),
            "coll": coll,
        }
        out = _lstsq_cols(cols, y)
        if out is not None and (best is None or out[1] < best[1]):
            best = out
    if best is None:
        return None
    coef, _ = best

    def _rate(col, default):
        c = coef.get(col)
        return 1.0 / c if c is not None and c > 0 else default

    fitted = {
        "pcie_bw": _rate("pcie", h["pcie_bw"]),
        "launch_overhead_s": coef.get("dispatches",
                                      h["launch_overhead_s"]),
        "sync_overhead_s": coef.get("syncs", h["sync_overhead_s"]),
        "peak_flops_bf16": _rate("flops", h["peak_flops_bf16"]),
        "hbm_bw": _rate("kbytes", h["hbm_bw"]),
        "ici_bw": _rate("coll", h["ici_bw"]),
    }
    for k, (lo, hi) in _FIT_BOUNDS.items():
        fitted[k] = float(min(max(fitted[k], lo), hi))
    return fitted


def _average_ranks(values) -> "np.ndarray":  # noqa: F821 - doc type
    import numpy as np
    v = np.asarray(values, float)
    order = np.argsort(v, kind="stable")
    ranks = np.empty(len(v), float)
    sv = v[order]
    i = 0
    while i < len(v):
        j = i
        while j + 1 < len(v) and sv[j + 1] == sv[i]:
            j += 1
        ranks[order[i:j + 1]] = (i + j) / 2.0
        i = j + 1
    return ranks


def rank_correlation(xs, ys) -> float:
    """Spearman rank correlation (average ranks for ties) between two
    equal-length sequences; 0.0 when either side is constant or there
    are fewer than two points.  The tuner's figure of merit: the cost
    model only has to ORDER candidates correctly, so rank correlation —
    not absolute error — is what calibration must improve."""
    if len(xs) != len(ys):
        raise ValueError("rank_correlation needs equal-length sequences")
    if len(xs) < 2:
        return 0.0
    rx, ry = _average_ranks(xs), _average_ranks(ys)
    sx, sy = rx.std(), ry.std()
    if sx == 0.0 or sy == 0.0:
        return 0.0
    return float(((rx - rx.mean()) * (ry - ry.mean())).mean() / (sx * sy))


# ---------------------------------------------------------------------------
# Cross-program candidate predictor.
#
# ``fit_offload_constants`` calibrates the analytic model from ONE
# program's measured table.  The predictor below generalizes ACROSS
# programs (the OpenMP-Advisor observation): featurize every measured
# candidate, fit one linear model on all rows the tunecache accumulated
# for a device class, and use it to price a never-measured program's
# grid — a zero-measurement cold start.
# ---------------------------------------------------------------------------

# per-candidate feature vector: the predict_cost counters, the analytic
# prior (default-constant predicted seconds — anchors the fit where the
# training programs carry no signal), and the execution knobs the
# analytic model cannot see (stream count, fusion, donation).
PREDICTOR_FEATURES = ("h2d_bytes", "d2h_bytes", "dispatches", "syncs",
                      "flops", "kernel_bytes", "coll_bytes", "kernel_s",
                      "analytic_s", "n_streams", "fuse_loops", "donate")


def candidate_features(rec) -> Dict[str, float]:
    """``PREDICTOR_FEATURES`` row for one tuner candidate record (a
    ``meta["tuning"]["candidates"]`` entry or a cached measured row).
    The knob features come from the record's ``config`` when present;
    ``analytic_s`` falls back to ``predicted_s`` for rows priced with
    default constants."""
    cfg = rec.get("config") or {}
    row = {}
    for f in PREDICTOR_FEATURES:
        if f == "n_streams":
            row[f] = float(cfg.get("n_streams", rec.get(f, 1)) or 1)
        elif f in ("fuse_loops", "donate"):
            row[f] = 1.0 if (cfg.get(f, rec.get(f)) or 0) else 0.0
        elif f == "analytic_s":
            row[f] = float(rec.get("analytic_s",
                                   rec.get("predicted_s", 0.0)) or 0.0)
        else:
            row[f] = float(rec.get(f, 0.0) or 0.0)
    return row


def fit_candidate_predictor(rows, l2: float = 1e-3) -> Optional[Dict]:
    """Fit the cross-program candidate-time model from measured rows of
    ≥ 2 distinct programs (each row: ``PREDICTOR_FEATURES`` values +
    ``measured_s`` + ``program``).  Returns ``{"features", "coef",
    "intercept", "n_rows", "n_programs"}`` or ``None`` when
    under-determined.

    Three fit choices matter for rank quality on a held-out program:

    * rows are weighted by 1 / (their program's mean measured time), so
      the fit minimizes RELATIVE error per program and a large program
      cannot drown out a small one;
    * columns are max-abs scaled and ridge-damped (``l2``);
    * coefficients are constrained non-negative by iterative clipping
      (fit, drop negative-coefficient features, refit): every feature is
      a count/size/time whose physical effect is monotone, and an
      unconstrained fit on few programs happily goes negative on a
      confounded column and then misranks the held-out grid.
    """
    import numpy as np
    rows = [r for r in rows if r.get("measured_s")]
    by_prog: Dict[str, List[float]] = {}
    for r in rows:
        by_prog.setdefault(str(r.get("program", "")), []).append(
            float(r["measured_s"]))
    if len(by_prog) < 2 or len(rows) < 4:
        return None
    mean_of = {p: sum(v) / len(v) for p, v in by_prog.items()}
    w = np.array([1.0 / max(mean_of[str(r.get("program", ""))], 1e-30)
                  for r in rows])
    X = np.array([[candidate_features(r)[f] for f in PREDICTOR_FEATURES]
                  for r in rows], float)
    y = np.array([float(r["measured_s"]) for r in rows])
    Xw = X * w[:, None]
    yw = y * w
    scale = np.abs(Xw).max(axis=0)
    scale[scale == 0] = 1.0
    Xs = Xw / scale
    active = [i for i in range(len(PREDICTOR_FEATURES)) if X[:, i].any()]
    coef = None
    while active:
        # fewer rows than columns is fine: the ridge rows below make the
        # stacked system full column rank, damping unsupported
        # coefficients toward 0, and the caller's rank-correlation
        # acceptance gate rejects a fit that still misranks
        A = np.column_stack([Xs[:, active], w])      # last col: intercept
        reg = np.sqrt(l2) * np.eye(A.shape[1])
        reg[-1, -1] = 0.0                            # intercept unpenalized
        try:
            coef, *_ = np.linalg.lstsq(
                np.vstack([A, reg]),
                np.concatenate([yw, np.zeros(A.shape[1])]), rcond=None)
        except np.linalg.LinAlgError:
            return None
        neg = {active[j] for j in range(len(active)) if coef[j] < 0}
        if not neg:
            break
        active = [i for i in active if i not in neg]
    if not active or coef is None:
        return None
    return {
        "features": list(PREDICTOR_FEATURES),
        "coef": {PREDICTOR_FEATURES[i]: float(coef[j] / scale[i])
                 for j, i in enumerate(active)},
        "intercept": float(coef[-1]),
        "n_rows": len(rows),
        "n_programs": len(by_prog),
    }


def predict_candidate_s(model: Dict, rec) -> float:
    """Price one candidate with a ``fit_candidate_predictor`` model
    (clamped at 0 — a learned intercept must not go negative on a tiny
    program)."""
    row = candidate_features(rec)
    s = float(model.get("intercept", 0.0))
    for f, c in model.get("coef", {}).items():
        s += float(c) * row.get(f, 0.0)
    return max(s, 0.0)


# ---------------------------------------------------------------------------
# Collectives of a sharded step, and its roofline terms
# ---------------------------------------------------------------------------

COLLECTIVES = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
               "collective-permute")

# op-name fragment -> the reference's key (functional and c10d ops)
_COLL_OPS = (("reduce_scatter", "reduce-scatter"),
             ("all_gather", "all-gather"), ("allgather", "all-gather"),
             ("all_reduce", "all-reduce"), ("allreduce", "all-reduce"),
             ("all_to_all", "all-to-all"), ("alltoall", "all-to-all"),
             ("send", "collective-permute"), ("broadcast", "all-gather"))


def _group_size(args) -> int:
    from torch.distributed.distributed_c10d import _resolve_process_group
    for a in args:
        if isinstance(a, str):
            try:
                return _resolve_process_group(a).size()
            except Exception:
                continue
        if hasattr(a, "size") and hasattr(a, "rank") and not hasattr(
                a, "shape"):
            return int(a.size())
    return 1


def _nbytes(x) -> int:
    import torch
    from torch.utils._pytree import tree_leaves
    return sum(t.numel() * t.element_size() for t in tree_leaves(x)
               if isinstance(t, torch.Tensor))


def collective_trace():
    """A ``CommDebugMode`` that also keeps, for every collective of the
    local tensors, ``{"op", "n", "bytes"}`` (``bytes``: the full tensor
    the ring formula prices: the gathered result of an all-gather, the
    input of a reduce-scatter, the tensor otherwise), and ``flops``: the
    products of the local tensors (DTensor-level ops are not counted, as
    their local ops are)."""
    import torch
    from torch.distributed.tensor import DTensor
    from torch._subclasses.fake_tensor import FakeTensor
    from torch.distributed.tensor.debug import CommDebugMode
    from torch.utils._pytree import tree_leaves
    from torch.utils.flop_counter import flop_registry
    aten = torch.ops.aten
    extra = {aten.mv: _mv_flops, aten.dot: _dot_flops}

    class CollectiveTrace(CommDebugMode):
        def __init__(self):
            super().__init__()
            self.records: List[Dict[str, float]] = []
            self.flops = 0.0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = super().__torch_dispatch__(func, types, args, kwargs)
            kwargs = kwargs or {}
            # DTensor-level ops are counted through their local ops; fake
            # tensors are DTensor's shape propagation, not work
            if any(isinstance(a, (DTensor, FakeTensor))
                   for a in tree_leaves((args, kwargs))):
                return out
            name = func.__name__
            ns = func.namespace
            if ns in ("_c10d_functional", "_c10d_functional_autograd",
                      "c10d"):
                kind = next((k for frag, k in _COLL_OPS if frag in name),
                            None)
                if kind is not None and not name.startswith("wait"):
                    n = max(_group_size(args), 1)
                    b = _nbytes(args[0])
                    if kind == "all-gather" and "broadcast" not in name:
                        b *= n
                    self.records.append({"op": kind, "n": n, "bytes": b})
                return out
            packet = func.overloadpacket
            fn = extra.get(packet) or flop_registry.get(packet)
            if fn is not None:
                if packet in extra:
                    self.flops += fn(*(tuple(a.shape) for a in args[:2]))
                else:
                    self.flops += fn(*args, **kwargs, out_val=out)
            return out

    return CollectiveTrace()


def trace_step(fn, *args) -> Dict[str, object]:
    """Run ``fn(*args)`` once under ``collective_trace``: returns
    ``{"flops": per-device FLOPs, "collectives": records}``."""
    trace = collective_trace()
    with trace:
        fn(*args)
    return {"flops": float(trace.flops), "collectives": list(trace.records)}


def collective_bytes(records) -> Dict[str, Dict[str, float]]:
    """Per-type collective traffic in RING-VOLUME bytes (the wire cost a
    bidirectional-ring algorithm moves per participant), the reference's
    formulas on a trace's records:

        all-reduce        2·(n−1)/n · tensor
        all-gather        (n−1)/n  · gathered
        reduce-scatter    (n−1)/n  · pre-reduce
        all-to-all        (n−1)/n  · tensor
        collective-permute  1      · tensor

    A group of one rank moves nothing; ``bytes_result`` keeps the
    tensor bytes."""
    stats = {c: {"count": 0.0, "bytes": 0.0, "bytes_result": 0.0}
             for c in COLLECTIVES}
    for rec in records:
        c, n, b = rec["op"], int(rec["n"]), float(rec["bytes"])
        if c == "all-reduce":
            wire = 2.0 * (n - 1) / n * b
        elif c == "collective-permute":
            wire = b if n > 1 else 0.0
        else:
            wire = (n - 1) / n * b
        stats[c]["count"] += 1
        stats[c]["bytes"] += wire
        stats[c]["bytes_result"] += b
    return stats


def roofline_terms(cfg, shape, n_devices: int, trace: Dict[str, object],
                   *, grad_accum: int = 1, kv_bytes: int = 2
                   ) -> Dict[str, object]:
    """The reference's roofline terms of one cell, from a ``trace_step``
    record (per-device FLOPs and collectives) in place of its HLO."""
    colls = collective_bytes(trace["collectives"])
    coll_total = sum(v["bytes"] for v in colls.values())
    dev_f = float(trace["flops"])
    model_f = analytic_model_flops(cfg, shape)
    mem_b = analytic_hbm_bytes(cfg, shape, n_devices,
                               grad_accum=grad_accum, kv_bytes=kv_bytes)
    t_compute = dev_f / HW["peak_flops_bf16"]
    t_memory = mem_b / HW["hbm_bw"]
    t_coll = coll_total / HW["ici_bw"]
    terms = {"compute_s": t_compute, "memory_s": t_memory,
             "collective_s": t_coll}
    bottleneck = max(terms, key=lambda k: terms[k])
    step_time = max(t_compute, t_memory, t_coll)
    ideal = model_f / (n_devices * HW["peak_flops_bf16"])
    return {
        **terms,
        "bottleneck": bottleneck,
        "model_flops": model_f,
        "hlo_flops_per_device": dev_f,
        "useful_ratio": model_f / max(dev_f * n_devices, 1.0),
        "roofline_fraction": ideal / max(step_time, 1e-30),
        "collectives": colls,
        "hbm_bytes_per_device": mem_b,
    }
