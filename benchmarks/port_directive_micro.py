"""Figs. 4 & 5 analogues on the PyTorch port: what the two placement
optimizations buy.

    PYTHONPATH=src python benchmarks/port_directive_micro.py [--quick]
        [--tune] [--backend cuda|cpu|numpy] [--report PATH]
        [--snapshot PATH]

The port's counterpart of ``benchmarks/directive_micro.py``, with the same
programs and the same CSV rows:

bench_advancedload (Fig. 4): a kernel inside a loop consumes a large
matrix written on the host BEFORE the loop.  Naive reloads it at every
callsite (4a); the planner hoists one async upload next to the last host
write (4b) — residency makes iterations transfer-free.

bench_delegatestore (Fig. 5): a kernel's output is host-read only once,
deep after other host work.  Naive downloads at kernel end (5a,
synchronous); the planner sinks the store next to the first host read
(5b), so the device result is fetched once and late.

Each benchmark reports three execution modes: ``interp`` walks the plan
op by op, ``compiled`` runs the fused schedule with per-iteration segment
dispatch, and ``compiled_loop`` additionally rolls pure-device loops into
one launch.  Wall times are steady-state (plans lowered and kernels built
before timing; lowering cost is ``compile_ms``).

``--tune`` runs the plan-space explorer (``plan(p, policy="auto")``) on
each program plus the 3mm worked example and the flash-attention step
(its tile variants are enumerated and measured), prints one row per
program, and writes the ranked predicted-vs-measured tables to
``--report`` (default ``port_tuning_report.json``) and its summary, dated,
to ``--snapshot`` (default ``BENCH_port_<YYYYMMDD>.json`` in the working
directory), which ``port_trajectory.py`` diffs.  ``--quick`` shrinks
the sizes to the tuning gate's (N = 256, 4 iterations).  The backend is
the torch one on ``cuda:0`` unless ``--backend cpu`` (torch on the host)
or ``--backend numpy`` is given.
"""
from __future__ import annotations

import json
import sys
import time
from typing import Dict

import numpy as np

from repro_torch.core import (NumpyHostBackend, Program, TorchDeviceBackend,
                              execute, naive_plan, plan)

N = 1536
ITERS = 8
REPS = 3
BACKEND = None            # set by main(); None is the torch backend on cuda

# (column label, execute kwargs)
MODES = (
    ("interpreted", dict(mode="interpreted")),
    ("compiled", dict(mode="compiled", fuse_loops=False)),
    ("compiled_loop", dict(mode="compiled", fuse_loops=True)),
)


def make_backend(name: str):
    """``cuda`` → ``TorchDeviceBackend("cuda")``, ``cpu`` → the same on the
    host, ``numpy`` → ``NumpyHostBackend``."""
    if name == "numpy":
        return NumpyHostBackend()
    if name in ("cuda", "cpu"):
        return TorchDeviceBackend(name)
    raise ValueError(f"unknown backend {name!r}; want cuda, cpu or numpy")


def _advancedload_prog():
    rng = np.random.default_rng(0)
    p = Program("fig4")
    p.bind("W", rng.standard_normal((N, N)).astype(np.float32))
    p.bind("x", rng.standard_normal((N,)).astype(np.float32))
    with p.loop(ITERS):
        p.offload(lambda xp, W, x: {"x": xp.tanh(W @ x)},
                  reads=("W", "x"), writes=("x",), name="apply")
    p.host(lambda xp, x: {"out": x[:4]}, reads=("x",), writes=("out",),
           name="read")
    p.set_outputs("out")
    return p


def _delegatestore_prog():
    rng = np.random.default_rng(1)
    p = Program("fig5")
    p.bind("A", rng.standard_normal((N, N)).astype(np.float32))
    p.bind("h", rng.standard_normal((N,)).astype(np.float32))
    p.offload(lambda xp, A: {"C": A @ A.T}, reads=("A",), writes=("C",),
              name="produce")
    with p.loop(ITERS):
        p.host(lambda xp, h: {"h": xp.tanh(h * 1.01)}, reads=("h",),
               writes=("h",), name="hostwork")
    p.host(lambda xp, C, h: {"out": C[:2, :2] + h[:2]},
           reads=("C", "h"), writes=("out",), name="readC")
    p.set_outputs("out")
    return p


def _time(fn):
    fn()
    ts = []
    for _ in range(REPS):
        t0 = time.perf_counter()
        fn()
        ts.append(time.perf_counter() - t0)
    return min(ts)


def _grid(p) -> Dict[str, float]:
    """Steady-state min wall time for {naive, opt} x MODES, plus the
    one-time lowering cost per plan (compile_ms)."""
    plans = {"naive": naive_plan(p), "opt": plan(p)}
    out = {}
    for pname, pl in plans.items():
        compile_ms = 0.0
        for label, kw in MODES:
            _, s0 = execute(pl, backend=BACKEND, **kw)
            compile_ms += s0.compile_time * 1e3
            out[f"t_{pname}_{label}_ms"] = _time(
                lambda pl=pl, kw=kw: execute(pl, backend=BACKEND, **kw)) * 1e3
        out[f"compile_{pname}_ms"] = compile_ms
    return out


def _bench(name: str, p, counted: str) -> Dict:
    g = _grid(p)
    _, s_nv = execute(naive_plan(p), backend=BACKEND)
    _, s_opt = execute(plan(p), mode="compiled", backend=BACKEND)
    row = {
        "name": name,
        "t_naive_ms": g["t_naive_interpreted_ms"],
        "t_opt_ms": g["t_opt_interpreted_ms"],
        "t_naive_compiled_ms": g["t_naive_compiled_ms"],
        "t_opt_compiled_ms": g["t_opt_compiled_ms"],
        "t_naive_compiled_loop_ms": g["t_naive_compiled_loop_ms"],
        "t_opt_compiled_loop_ms": g["t_opt_compiled_loop_ms"],
        "compile_opt_ms": g["compile_opt_ms"],
    }
    if counted == "h2d":
        row.update(h2d_naive=s_nv.h2d_transfers, h2d_opt=s_opt.h2d_transfers,
                   h2d_bytes_naive=s_nv.h2d_bytes,
                   h2d_bytes_opt=s_opt.h2d_bytes)
    else:
        row.update(d2h_naive=s_nv.d2h_transfers, d2h_opt=s_opt.d2h_transfers)
    row.update(
        fused_launches_opt=s_opt.fused_launches,
        speedup=g["t_naive_interpreted_ms"] / g["t_opt_interpreted_ms"],
        speedup_compiled=g["t_naive_compiled_ms"] / g["t_opt_compiled_ms"],
        speedup_loop=g["t_opt_compiled_ms"] / g["t_opt_compiled_loop_ms"])
    return row


def bench_advancedload() -> Dict:
    return _bench("fig4_advancedload", _advancedload_prog(), "h2d")


def bench_delegatestore() -> Dict:
    return _bench("fig5_delegatestore", _delegatestore_prog(), "d2h")


def tuning_programs() -> Dict[str, Program]:
    """The tuner's gate programs at the current sizes: both figures, 3mm
    at n = min(N, 256) and the flash-attention step (one step)."""
    from repro_torch.optim.offload import attention_step_program
    from repro_torch.polybench import build_3mm
    return {
        "fig4_advancedload": _advancedload_prog(),
        "fig5_delegatestore": _delegatestore_prog(),
        "table2_3mm": build_3mm(n=min(N, 256))[0],
        "attn_step": attention_step_program(n_steps=1),
    }


def n_kernel_variants(candidates) -> int:
    """Distinct kernel tile-variant assignments enumerated in a tuning
    table (1 for kernel-free programs: the single empty assignment)."""
    return len({json.dumps(c["config"].get("kernel_variants") or [])
                for c in candidates if c["valid"]})


def bench_tuner(out_path: str = "port_tuning_report.json") -> Dict:
    """Plan-space exploration over the programs above: the winner per
    program and the full ranked tables, written to ``out_path``.
    Predictions are priced with the DEFAULT hardware constants
    (``use_calibration=False``) so the predicted ranking is the one
    ``port_check_tuning_baseline.py`` gates; the persistent cache stays
    on (``cache_hit``/``measurements`` say which happened)."""
    from repro_torch.core import COST_MODEL_VERSION
    # the kernel program's interesting axis is the tile grid: pin the
    # plan axes so the run measures kernel VARIANTS, as the reference does
    grid_kw = {"attn_step": dict(policies=("optimized",), streams=(1,),
                                 fuse=(True,), donate=(False,))}
    report: Dict[str, Dict] = {"params": {"N": N, "ITERS": ITERS},
                               "cost_model_version": COST_MODEL_VERSION,
                               "programs": {}, "summary": {}}
    rows = {}
    for name, prog in sorted(tuning_programs().items()):
        pl = plan(prog, policy="auto", backend=BACKEND,
                  reps=max(1, REPS - 1), use_calibration=False,
                  **grid_kw.get(name, {}))
        tuning = pl.meta["tuning"]
        cache_info = pl.meta["tuning_cache"]
        chosen = pl.predicted_cost()
        cal = tuning.get("calibration") or {}
        report["programs"][name] = tuning
        resid = [abs(c.get("kernel_residual_s") or 0.0)
                 for c in tuning["candidates"]
                 if c.get("measured_kernel_s") is not None]
        rows[name] = {
            "chosen": tuning["chosen"],
            "max_kernel_residual_ms": max(resid, default=0.0) * 1e3,
            "n_candidates": sum(1 for c in tuning["candidates"]
                                if c["valid"]),
            "n_kernel_variants": n_kernel_variants(tuning["candidates"]),
            "predicted_ms": chosen["predicted_s"] * 1e3,
            "measured_ms": (chosen["measured_s"] or 0.0) * 1e3,
            "energy_mj": (chosen.get("energy_j") or 0.0) * 1e3,
            "peak_mb": (chosen.get("peak_bytes") or 0.0) / 1e6,
            "n_pareto": len(tuning.get("pareto") or ()),
            "winner_time": (tuning.get("winners") or {}).get("time"),
            "winner_energy": (tuning.get("winners") or {}).get("energy"),
            "winner_memory": (tuning.get("winners") or {}).get("memory"),
            "predictor_accepted": bool(
                (tuning.get("predictor") or {}).get("accepted")),
            "cache_hit": cache_info["hit"],
            "measurements": cache_info["measurements"],
            "calibration_accepted": bool(cal.get("accepted")),
        }
        report["summary"][name] = rows[name]
    with open(out_path, "w") as f:
        json.dump(report, f, indent=2, sort_keys=True, default=float)
    return {"name": "plan_tuner", "report_path": out_path, "rows": rows}


def write_bench_snapshot(rows: Dict, path: str = None) -> str:
    """The dated tuning summary (``BENCH_port_<YYYYMMDD>.json`` unless
    ``path`` is given), with the reference snapshot's keys, so successive
    runs of ``--tune`` can be diffed."""
    from repro_torch.core import COST_MODEL_VERSION
    if path is None:
        path = f"BENCH_port_{time.strftime('%Y%m%d')}.json"
    snap = {
        "date": time.strftime("%Y-%m-%d"),
        "cost_model_version": COST_MODEL_VERSION,
        "params": {"N": N, "ITERS": ITERS, "REPS": REPS},
        "programs": rows,
    }
    with open(path, "w") as f:
        json.dump(snap, f, indent=2, sort_keys=True, default=float)
    return path


def main(argv=None):
    global N, ITERS, REPS, BACKEND
    args = list(sys.argv[1:] if argv is None else argv)
    if "--quick" in args:
        N, ITERS, REPS = 256, 4, 1
    BACKEND = make_backend(args[args.index("--backend") + 1]
                           if "--backend" in args else "cuda")
    if "--tune" in args:
        out = (args[args.index("--report") + 1] if "--report" in args
               else "port_tuning_report.json")
        r = bench_tuner(out)
        for name, row in sorted(r["rows"].items()):
            extra = ";".join(
                f"{k}={v if not isinstance(v, float) else round(v, 3)}"
                for k, v in row.items())
            print(f"tune_{name},{row['measured_ms'] * 1e3:.0f},{extra}")
        print(f"tuning report written to {r['report_path']}")
        snap = write_bench_snapshot(
            r["rows"], args[args.index("--snapshot") + 1]
            if "--snapshot" in args else None)
        print(f"bench snapshot written to {snap}")
        return [r]
    results = []
    for bench in (bench_advancedload, bench_delegatestore):
        r = bench()
        results.append(r)
        extra = ";".join(f"{k}={v}" for k, v in r.items()
                         if k not in ("name", "t_opt_ms"))
        print(f"{r['name']},{r['t_opt_ms'] * 1e3:.0f},{extra}")
    return results


if __name__ == "__main__":
    main()
