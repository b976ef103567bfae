"""Serving benchmark of the PyTorch port: continuous batching vs the
static-batch baseline (the port of ``benchmarks/serve_bench.py``).

Both modes replay the IDENTICAL seeded open-loop trace (Poisson
arrivals, skewed generation-length mix) through the same ``ServeRuntime``
— same resident params — so the measured gap is purely the scheduling
discipline:

* ``static``    — requests may only join when the decode batch has fully
                  drained, so every group runs to its slowest member;
* ``continuous``— freed rows are backfilled at any step boundary.

A warm-up runs first (excluded from timing): one two-token request per
shape bucket, which measures every bucket once; the timed runs then hit
the persistent bucket cache (``REPRO_TORCH_TUNE_CACHE``) with zero online
measurements.

Invariants checked on every run (``--check`` also gates the speedup):
all requests finish, none dropped, p99 latency finite, zero KV-slot
leaks, no pooled cache leaf reallocated, and — after warm-up — zero
online tune measurements.  Runs on ``cuda:0`` (raising without a card)
unless ``--backend cpu``:

    PYTHONPATH=src python benchmarks/port_serve_bench.py --quick \
        --backend cpu
    PYTHONPATH=src python benchmarks/port_serve_bench.py --check

Writes ``--out`` or ``BENCH_port_serve_<YYYYMMDD>.json``.
"""
from __future__ import annotations

import argparse
import json
import math
import time

import numpy as np

from repro_torch.configs import get_config, reduced
from repro_torch.launch.serve import BACKENDS, make_backend
from repro_torch.serve import Engine, Request, ServeRuntime, make_trace
from repro_torch.serve.kvpool import tree_flatten

# mostly-short with a long tail: the traffic shape where static batching
# pays its head-of-line penalty
GEN_MIX = ((4, 0.50), (8, 0.25), (112, 0.25))
PROMPT_MIX = ((8, 0.70), (16, 0.30))
SPEEDUP_FLOOR = 1.5


def run_mode(rt, reqs, *, join_policy: str, capacity: int):
    eng = Engine(rt, capacity=capacity, join_policy=join_policy,
                 policy="fcfs")
    # fresh copies: Request objects are mutated by the engine
    replay = [r.__class__(rid=r.rid, prompt=r.prompt.copy(),
                          max_new_tokens=r.max_new_tokens,
                          arrival_s=r.arrival_s) for r in reqs]
    pool_ptrs = [t.data_ptr() for t in tree_flatten(eng.pool.cache)[1]]
    rep = eng.run(replay, respect_arrivals=False)
    rep["leaked_slots"] = eng.pool.in_use        # assert_no_leaks already ran
    rep["pool_reallocated"] = pool_ptrs != [
        t.data_ptr() for t in tree_flatten(eng.pool.cache)[1]]
    rep["completed"] = eng.completed
    return rep


def check(rep, n_expected: int) -> None:
    if rep["n_requests"] != n_expected:
        raise AssertionError(f"{rep['n_requests']} of {n_expected} "
                             "requests finished")
    if rep["dropped"] or rep["leaked_slots"]:
        raise AssertionError(f"dropped {rep['dropped']}, leaked "
                             f"{rep['leaked_slots']} slots")
    if not math.isfinite(rep["latency_p99_s"]):
        raise AssertionError(f"p99 latency {rep['latency_p99_s']}")
    if rep["pool_reallocated"]:
        raise AssertionError("a pooled cache leaf moved during the run")


def trace(cfg, *, n_requests: int, max_seq: int, seed: int):
    return make_trace(cfg, n_requests=n_requests, rate_rps=1e6, seed=seed,
                      prompt_mix=PROMPT_MIX, gen_mix=GEN_MIX,
                      max_seq=max_seq)


def bench_runtime(rt, *, n_requests: int, capacity: int, seed: int,
                  gate: bool):
    """Warm-up, then the continuous and the static run of the seeded
    trace on ``rt``; returns the row (with both reports under
    ``_reports``)."""
    cfg = rt.cfg
    reqs = trace(cfg, n_requests=n_requests, max_seq=rt.max_seq, seed=seed)

    # warm-up: one request per distinct shape bucket, two tokens each,
    # which measures every bucket once and runs the decode path.  The
    # reference's warm-up replays the trace's length and longest
    # generation so that its jitted bodies see the timed shapes; the port
    # runs eagerly and compiles nothing per shape, so that would only
    # add uncounted decode steps.
    buckets = {rt.bucket_of(r.prompt_len): r.prompt_len for r in reqs}

    def prompt(L):
        return (np.zeros((L, cfg.d_model), np.float32) if cfg.input_embeds
                else np.zeros((L,), np.int32))
    warm = [Request(rid=1000 + i, prompt=prompt(L), max_new_tokens=2)
            for i, L in enumerate(sorted(buckets.values()))]
    run_mode(rt, warm, join_policy="continuous", capacity=capacity)

    meas_before = rt.tune_measurements
    cont = run_mode(rt, reqs, join_policy="continuous", capacity=capacity)
    stat = run_mode(rt, reqs, join_policy="static", capacity=capacity)
    check(cont, n_requests)
    check(stat, n_requests)
    warm_measurements = rt.tune_measurements - meas_before

    ratio = cont["requests_per_s"] / max(stat["requests_per_s"], 1e-9)
    row = {
        "arch": cfg.name,
        "device": str(rt.device),
        "n_requests": n_requests,
        "capacity": capacity,
        "max_seq": rt.max_seq,
        "seed": seed,
        "speedup_requests_per_s": ratio,
        "warm_tune_measurements": warm_measurements,
        "continuous": {k: cont[k] for k in (
            "requests_per_s", "tokens_per_s", "latency_p50_s",
            "latency_p99_s", "ttft_p50_s", "occupancy", "steps",
            "fetch_batches", "wall_s")},
        "static": {k: stat[k] for k in (
            "requests_per_s", "tokens_per_s", "latency_p50_s",
            "latency_p99_s", "ttft_p50_s", "occupancy", "steps", "wall_s")},
        "tune": cont["tune"],
        "pool": cont["pool"],
        "residency": cont["residency"],
    }
    print(f"[port_serve_bench] {cfg.name} on {rt.device}: continuous "
          f"{cont['requests_per_s']:.1f} req/s (occ {cont['occupancy']:.2f})"
          f" vs static {stat['requests_per_s']:.1f} req/s "
          f"(occ {stat['occupancy']:.2f}) -> {ratio:.2f}x; "
          f"warm tune measurements: {warm_measurements}")

    if warm_measurements:
        raise AssertionError(
            f"warm run still measured {warm_measurements} buckets — the "
            f"shape-bucketed plan cache is not being hit")
    if gate and ratio < SPEEDUP_FLOOR:
        raise AssertionError(f"continuous batching speedup {ratio:.2f}x "
                             f"below the {SPEEDUP_FLOOR}x floor")
    row["_reports"] = {"continuous": cont, "static": stat}
    return row


def bench(*, arch: str, n_requests: int, capacity: int, max_seq: int,
          seed: int, gate: bool, backend=None):
    """One row on the reduced config of ``arch`` (the port's seeded
    weights)."""
    rt = ServeRuntime(reduced(get_config(arch)), max_seq=max_seq, seed=seed,
                      backend=backend)
    row = bench_runtime(rt, n_requests=n_requests, capacity=capacity,
                        seed=seed, gate=gate)
    del row["_reports"]
    return row


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2.5-14b,rwkv6-3b",
                    help="comma-separated arch list (one bench row each)")
    ap.add_argument("--n-requests", type=int, default=48)
    ap.add_argument("--capacity", type=int, default=8)
    ap.add_argument("--max-seq", type=int, default=128)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--quick", action="store_true",
                    help="smoke: 20 requests, no speedup gate")
    ap.add_argument("--check", action="store_true",
                    help="gate: continuous >= 1.5x static requests/s")
    ap.add_argument("--out", default=None)
    ap.add_argument("--backend", default="torch", choices=BACKENDS,
                    help="torch: cuda:0 (raises without a card); cpu: the "
                    "host")
    args = ap.parse_args(argv)
    if args.quick:
        args.n_requests = 20
        args.capacity = min(args.capacity, 4)

    rows = [bench(arch=arch, n_requests=args.n_requests,
                  capacity=args.capacity, max_seq=args.max_seq,
                  seed=args.seed, gate=args.check,
                  backend=make_backend(args.backend))
            for arch in [a.strip() for a in args.arch.split(",")
                         if a.strip()]]
    path = args.out or f"BENCH_port_serve_{time.strftime('%Y%m%d')}.json"
    snap = {"date": time.strftime("%Y-%m-%d"), "bench": "port_serve",
            "rows": rows}
    with open(path, "w") as f:
        json.dump(snap, f, indent=2, sort_keys=True, default=float)
    print(f"[port_serve_bench] snapshot written to {path}")
    return rows


if __name__ == "__main__":
    main()
