"""Benchmark harness on the PyTorch port: one row per paper table/figure.

    PYTHONPATH=src python benchmarks/port_run.py [--device cuda|cpu]

The port's counterpart of ``benchmarks/run.py``, with its rows and their
``derived`` keys.  Output: ``name,us_per_call,derived`` CSV rows.

  table2_3mm          — paper Table 2 (generated 3MM schedule),
                        ``port_table2_3mm.run``
  fig4_advancedload   — paper Fig. 4 (upload hoisting),
                        ``port_directive_micro.bench_advancedload``
  fig5_delegatestore  — paper Fig. 5 (download sinking),
                        ``port_directive_micro.bench_delegatestore``
  fig6_<problem>      — paper Fig. 6 (Polybench suite speedups),
                        ``port_polybench_suite.run_suite``
  train_overlap       — beyond-paper: the planner's schedule on the train
                        loop, ``port_train_overlap.run``

Each piece runs at its own default sizes, as ``run.py`` runs the
reference's.  Everything runs on ``cuda:0`` and raises without a card
unless ``--device cpu``.
"""
from __future__ import annotations

import argparse
import sys
from pathlib import Path
from typing import Dict, List, Tuple

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent))
sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

import port_directive_micro  # noqa: E402
import port_polybench_suite  # noqa: E402
import port_table2_3mm  # noqa: E402
import port_train_overlap  # noqa: E402


def _fmt(v):
    return v if not isinstance(v, float) else round(v, 2)


def rows(device: str = "cuda") -> List[Tuple[str, str, str]]:
    """Every row as (name, us_per_call, derived), in ``run.py``'s order
    and format."""
    if device not in ("cuda", "cpu"):
        raise ValueError(f"unknown device {device!r}; want cuda or cpu")
    if device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("port_run: no CUDA device is available (pass "
                           "--device cpu)")
    be = port_directive_micro.make_backend(device)
    out: List[Tuple[str, str, str]] = []

    row = port_table2_3mm.run(show_source=False, backend=be)
    # the reference's keys (the port's run also reports kernel_opt_ms)
    extra = ";".join(f"{k}={_fmt(v)}" for k, v in row.items()
                     if k not in ("wall_opt_ms", "kernel_opt_ms"))
    out.append(("table2_3mm", f"{row['wall_opt_ms'] * 1e3:.0f}", extra))

    dm = port_directive_micro
    saved, dm.BACKEND = dm.BACKEND, be
    try:
        for bench in (dm.bench_advancedload, dm.bench_delegatestore):
            r = bench()
            extra = ";".join(f"{k}={_fmt(v)}" for k, v in r.items()
                             if k not in ("name", "t_opt_ms"))
            out.append((r["name"], f"{r['t_opt_ms'] * 1e3:.0f}", extra))
    finally:
        dm.BACKEND = saved

    for r in port_polybench_suite.run_suite(be):
        out.append((f"fig6_{r['problem']}",
                    f"{r['t_omp2hmpp_ms'] * 1e3:.0f}",
                    f"speedup_seq={r['speedup_vs_seq']:.2f}x;"
                    f"speedup_naive={r['speedup_vs_naive']:.2f}x;"
                    f"hand_gap={r['hand_vs_omp2hmpp']:.2f}x;"
                    f"transfers={r['transfers_opt']}/{r['transfers_naive']};"
                    f"bytes_saved={r['bytes_saved_vs_naive']}"))

    steps = port_train_overlap.STEPS
    r = port_train_overlap.run(device=device, steps=steps)
    out.append((r["name"], f"{r['t_planned_ms'] * 1e3 / steps:.0f}",
                f"speedup={r['speedup']:.2f}x;sync_ms={r['t_sync_ms']:.0f};"
                f"planned_ms={r['t_planned_ms']:.0f};"
                f"final_loss={r['final_loss']:.3f}"))
    return out


def parse_derived(derived: str) -> Dict[str, str]:
    """A row's ``derived`` field as {key: value}."""
    return dict(kv.split("=", 1) for kv in derived.split(";") if kv)


def main(argv=None) -> List[Tuple[str, str, str]]:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default; raises without a card) or cpu")
    args = ap.parse_args(argv)
    print("name,us_per_call,derived")
    out = rows(args.device)
    for r in out:
        print(",".join(r))
    return out


if __name__ == "__main__":
    main()
