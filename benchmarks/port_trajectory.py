"""Benchmark trajectory of the PyTorch port: diff the last two dated
tuning snapshots.

The port's counterpart of ``benchmarks/trajectory.py``, with its rules.
``port_directive_micro --tune`` writes ``BENCH_port_<YYYYMMDD>.json``
(the reference's pattern ``BENCH_<8 digits>.json`` never matches that
name, and this tool's never matches the reference's snapshots or the
serving ones, ``BENCH_port_serve_*``).  This tool compares the two most
recent port snapshots program-by-program and flags regressions:

* ``measured_ms``  > 10% slower  → regression (the real gate)
* ``predicted_ms`` > 10% higher  → cost-model drift note (only a
  regression when the cost-model version did NOT change between the two
  snapshots — a version bump legitimately reprices everything)
* ``energy_mj`` / ``peak_mb`` (the energy and memory objective columns of the
  chosen plan) > 10% higher → gated like ``predicted_ms``: both are
  model outputs, so an intentional COST_MODEL_VERSION bump downgrades
  their drift to a note instead of flagging it
* a program present before but missing now → coverage regression

    PYTHONPATH=src python benchmarks/port_trajectory.py [--root DIR]
    PYTHONPATH=src python benchmarks/port_trajectory.py --gate

(the second exits 1 on a regression)

With fewer than two snapshots there is nothing to diff: the tool prints
a note and exits 0 (first run on a fresh clone must not fail CI).
"""
from __future__ import annotations

import argparse
import glob
import json
import os
import re
import sys
from typing import Dict, List, Optional, Tuple

REGRESSION_PCT = 10.0
_SNAP_RE = re.compile(r"BENCH_port_(\d{8})\.json$")


def find_snapshots(root: str = ".") -> List[str]:
    """Dated port tune snapshots, oldest → newest (serve snapshots —
    ``BENCH_port_serve_*`` — have their own schema and are excluded)."""
    paths = [p for p in glob.glob(os.path.join(root, "BENCH_port_*.json"))
             if _SNAP_RE.search(os.path.basename(p))]
    return sorted(paths, key=lambda p: _SNAP_RE.search(p).group(1))


def _load(path: str) -> Dict:
    with open(path) as f:
        return json.load(f)


def _pct(new: float, old: float) -> Optional[float]:
    if not old:
        return None
    return (new - old) / old * 100.0


def diff(prev: Dict, curr: Dict) -> Tuple[List[str], List[str]]:
    """(regressions, notes) between two snapshot payloads."""
    regressions: List[str] = []
    notes: List[str] = []
    same_cost_model = (prev.get("cost_model_version")
                       == curr.get("cost_model_version"))
    if not same_cost_model:
        notes.append(
            f"cost model {prev.get('cost_model_version')} -> "
            f"{curr.get('cost_model_version')}: predicted_ms drift is "
            "expected and not gated")
    p_prog = prev.get("programs", {})
    c_prog = curr.get("programs", {})
    for name in sorted(p_prog):
        if name not in c_prog:
            regressions.append(f"{name}: present in previous snapshot but "
                               "missing now (coverage regression)")
            continue
        old, new = p_prog[name], c_prog[name]
        # model-derived columns (predicted/energy/memory) gate only when
        # the cost model did not change; a missing key in the OLD
        # snapshot (pre-multi-objective) yields _pct None and is skipped
        for key, gated in (("measured_ms", True),
                           ("predicted_ms", same_cost_model),
                           ("energy_mj", same_cost_model),
                           ("peak_mb", same_cost_model)):
            d = _pct(float(new.get(key) or 0.0), float(old.get(key) or 0.0))
            if d is None:
                continue
            line = (f"{name}: {key} {old[key]:.3f} -> {new[key]:.3f} "
                    f"({d:+.1f}%)")
            if d > REGRESSION_PCT and gated:
                regressions.append(line)
            elif abs(d) > REGRESSION_PCT:
                notes.append(line)
    for name in sorted(set(c_prog) - set(p_prog)):
        notes.append(f"{name}: new program (no previous measurement)")
    return regressions, notes


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=".",
                    help="where BENCH_port_*.json live")
    ap.add_argument("--gate", action="store_true",
                    help="exit 1 when a >10%% measured regression is found")
    args = ap.parse_args(argv)

    snaps = find_snapshots(args.root)
    if len(snaps) < 2:
        print(f"[trajectory] {len(snaps)} snapshot(s) found — need two to "
              "diff; nothing to do")
        return 0
    prev_path, curr_path = snaps[-2], snaps[-1]
    prev, curr = _load(prev_path), _load(curr_path)
    print(f"[trajectory] {os.path.basename(prev_path)} -> "
          f"{os.path.basename(curr_path)}")
    regressions, notes = diff(prev, curr)
    for n in notes:
        print(f"  note: {n}")
    for r in regressions:
        print(f"  REGRESSION: {r}")
    if not regressions and not notes:
        print("  all programs within the 10% envelope")
    if regressions and args.gate:
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
