"""Beyond-paper: the planner's schedule applied to a real training loop,
on the PyTorch port.

    PYTHONPATH=src python benchmarks/port_train_overlap.py [--quick]
        [--device cuda|cpu]

The port's counterpart of ``benchmarks/train_overlap.py``.  ``run()``
compares the wall time of N training steps under two schedules:

    sync     — batch built and copied to the device inside the loop,
               metrics fetched every step (the naive schedule), vs
    planned  — a prefetch thread copies batch i+1 during step i on its
               own stream (advancedload) and metrics are fetched once at
               the end (delegatestore sunk ALAP).

``run_plan_executor()`` runs the same schedule as an explicit block
``Program`` (``plan_step_program``) through the plan executor in three
modes — interpreted, compiled (per-iteration segment dispatch) and
compiled+loop (the whole step loop as one launch) — for the naive and
optimized plans, plus the plan-space tuner's winner (``policy="auto"``).
Everything runs on ``cuda:0`` (and raises without a card) unless
``--device cpu``; ``--quick`` takes 4 steps and 8 program steps.
"""
from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch.configs import get_config, reduced  # noqa: E402
from repro_torch.core import (TorchDeviceBackend, execute,  # noqa: E402
                              naive_plan, plan, winner_exec_kwargs)
from repro_torch.data import PrefetchIterator, SyntheticLM  # noqa: E402
from repro_torch.launch.train import make_train_step  # noqa: E402
from repro_torch.models import Transformer  # noqa: E402
from repro_torch.optim import default_optimizer, plan_step_program  # noqa

STEPS = 20
BATCH, SEQ = 8, 128


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run(arch: str = "internlm2-20b", device="cuda", steps: int = STEPS):
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("port_train_overlap: no CUDA device is available "
                           "(pass --device cpu)")
    cfg = reduced(get_config(arch))
    model = Transformer(cfg)
    opt = default_optimizer(cfg)
    src = SyntheticLM(cfg, BATCH, SEQ, seed=0)
    step_fn = make_train_step(model, opt)

    def fresh():
        params = model.init(torch.Generator(device).manual_seed(0),
                            device=device)
        return params, opt.init(params)

    def upload(host_batch):
        return {k: torch.from_numpy(v).to(device)
                for k, v in host_batch.items()}

    # --- sync schedule --------------------------------------------------
    params, opt_state = fresh()
    params, opt_state, m = step_fn(params, opt_state,
                                   upload(src.batch_at(0)))   # warm
    float(m["loss"])
    t0 = time.perf_counter()
    for i in range(steps):
        dev_batch = upload(src.batch_at(i))       # produce + upload (sync)
        params, opt_state, metrics = step_fn(params, opt_state, dev_batch)
        float(metrics["loss"])                    # fetch every step
    t_sync = time.perf_counter() - t0

    # --- planned schedule ------------------------------------------------
    params, opt_state = fresh()
    params, opt_state, m = step_fn(params, opt_state,
                                   upload(src.batch_at(0)))
    float(m["loss"])
    it = PrefetchIterator(src, start_index=0, depth=2,
                          device=device)          # advancedload
    t0 = time.perf_counter()
    try:
        for i in range(steps):
            params, opt_state, metrics = step_fn(params, opt_state,
                                                 next(it))
        loss = float(metrics["loss"])             # one late fetch
        _sync(device)
        t_planned = time.perf_counter() - t0
    finally:
        it.close()
    return {"name": "train_overlap", "device": str(device), "steps": steps,
            "t_sync_ms": t_sync * 1e3, "t_planned_ms": t_planned * 1e3,
            "speedup": t_sync / t_planned, "final_loss": loss}


def _min_time(fn, reps):
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        ts.append(time.perf_counter() - t0)
    return min(ts)


def run_plan_executor(n_steps: int = 64, reps: int = 3, device="cuda"):
    """The miniature train loop as a block program, every cell of
    {naive, optimized} x {interpreted, compiled, compiled+loop}, plus the
    plan-space tuner's winner (``policy="auto"``).  Wall times are
    steady-state: each plan runs once before it is timed, and the one-time
    lowering is reported apart (``compile_ms``)."""
    backend = TorchDeviceBackend(device)
    p = plan_step_program(n_steps=n_steps)
    plans = {"naive": naive_plan(p), "opt": plan(p)}
    modes = (("interpreted", dict(mode="interpreted")),
             ("compiled", dict(mode="compiled", fuse_loops=False)),
             ("compiled_loop", dict(mode="compiled", fuse_loops=True)))
    out = {"name": "train_plan_executor", "n_steps": n_steps,
           "device": str(backend.device)}
    compile_ms = 0.0
    for pname, pl in plans.items():
        for label, kw in modes:
            _, s0 = execute(pl, backend=backend, **kw)     # warm
            compile_ms += s0.compile_time * 1e3
            out[f"t_{pname}_{label}_ms"] = _min_time(
                lambda: execute(pl, backend=backend, **kw), reps) * 1e3
    out["compile_ms"] = compile_ms
    out["speedup_interpreted"] = (out["t_naive_interpreted_ms"]
                                  / out["t_opt_interpreted_ms"])
    out["speedup_compiled"] = (out["t_naive_compiled_ms"]
                               / out["t_opt_compiled_ms"])
    out["compile_win_opt"] = (out["t_opt_interpreted_ms"]
                              / out["t_opt_compiled_ms"])
    out["loop_win_opt"] = (out["t_opt_compiled_ms"]
                           / out["t_opt_compiled_loop_ms"])

    # --- plan-space tuner: the winner -------------------------------------
    tuned = plan(p, policy="auto", reps=reps, backend=backend)
    kw = winner_exec_kwargs(tuned, backend)   # honors fuse_loops and donate
    execute(tuned, **kw)
    out["t_auto_ms"] = _min_time(lambda: execute(tuned, **kw), reps) * 1e3
    out["auto_variant"] = tuned.meta["tuning"]["chosen"]
    out["auto_candidates"] = sum(
        1 for c in tuned.meta["tuning"]["candidates"] if c["valid"])
    out["auto_predicted_ms"] = tuned.predicted_cost()["predicted_s"] * 1e3
    cache_info = tuned.tuning_cache_info()
    out["auto_cache_hit"] = cache_info["hit"]
    out["auto_measurements"] = cache_info["measurements"]
    cal = tuned.tuning_calibration() or {}
    out["auto_calibration_accepted"] = bool(cal.get("accepted"))
    return out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default; raises without a card) or cpu")
    ap.add_argument("--quick", action="store_true",
                    help="4 train steps, 8 program steps, 2 reps")
    args = ap.parse_args(argv)
    steps, n_steps, reps = (4, 8, 2) if args.quick else (STEPS, 64, 3)
    r = run(device=args.device, steps=steps)
    print(f"{r['name']},{r['t_planned_ms'] * 1e3 / steps:.0f},"
          f"speedup={r['speedup']:.2f}x;sync_ms={r['t_sync_ms']:.0f};"
          f"planned_ms={r['t_planned_ms']:.0f}")
    e = run_plan_executor(n_steps=n_steps, reps=reps, device=args.device)
    extra = ";".join(f"{k}={v:.2f}" if isinstance(v, float) else f"{k}={v}"
                     for k, v in e.items() if k != "name")
    print(f"{e['name']},{e['t_opt_compiled_ms'] * 1e3:.0f},{extra}")
    return r, e


if __name__ == "__main__":
    main()
