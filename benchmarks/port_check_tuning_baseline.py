"""Tuning-regression gate for the PyTorch port.

    PYTHONPATH=src python benchmarks/port_check_tuning_baseline.py [--update]

The port's counterpart of ``check_tuning_baseline.py``.  It tunes the gate
programs (``port_directive_micro``'s two figures at its ``--quick`` sizes,
3mm at n = 256 and the one-step flash-attention program with its kernel
tile axis) with ``measure=False``, the default hardware constants and no
cache, on the numpy backend, and checks two goldens:

1. ``tests/golden/tuning_baseline.json``, the reference's, on the fields
   that do not depend on the hardware table: the valid-candidate count,
   the enumerated kernel tile variants, the rank-1 candidate's peak device
   bytes (the residency walk) and that the winner passes the verifier.
   Predicted seconds, joules and the winners are priced with the
   reference's TPU constants there, so they are not compared.
2. ``tests/golden/port_tuning_baseline.json``, the port's own: the same
   fields plus the predicted winner, its predicted seconds and joules, the
   per-objective winners and the Pareto point count under the port's H100
   table (``repro_torch.roofline.analysis.HW``).  These are deterministic
   and computable on any host.

Exit status 1 on any regression.  ``--update`` regenerates the port's
golden only (bump ``repro_torch.core.tunecache.COST_MODEL_VERSION`` with an
intentional cost-model change).
"""
from __future__ import annotations

import json
import pathlib
import sys
from typing import Dict, List

HERE = pathlib.Path(__file__).resolve().parent
if str(HERE) not in sys.path:
    sys.path.insert(0, str(HERE))
GOLDEN_DIR = HERE.parent / "tests" / "golden"
REFERENCE_BASELINE_PATH = GOLDEN_DIR / "tuning_baseline.json"
PORT_BASELINE_PATH = GOLDEN_DIR / "port_tuning_baseline.json"

QUICK_N, QUICK_ITERS = 256, 4
REL_TOL = 0.05
# the fields of the reference's golden that no hardware constant moves
HW_FREE = ("n_valid", "n_kernel_variants", "peak_bytes", "verified")
PORT_FIELDS = HW_FREE + ("predicted_winner", "predicted_s", "energy_j",
                         "winners", "n_pareto")


def gate_programs() -> Dict[str, object]:
    import port_directive_micro as dm
    saved = dm.N, dm.ITERS
    dm.N, dm.ITERS = QUICK_N, QUICK_ITERS
    try:
        return dm.tuning_programs()
    finally:
        dm.N, dm.ITERS = saved


def baseline_row(pl) -> Dict:
    """The gated fields of one tuned plan (``measure=False``)."""
    from port_directive_micro import n_kernel_variants

    from repro_torch.core.verify import verify_plan
    tuning = pl.meta["tuning"]
    valid = [c for c in tuning["candidates"] if c["valid"]]
    top = next(c for c in valid if c["rank"] == 1)
    return {
        "predicted_winner": top["label"],
        "predicted_s": top["predicted_s"],
        "n_valid": len(valid),
        "n_kernel_variants": n_kernel_variants(valid),
        "energy_j": top["energy_j"],
        "peak_bytes": top["peak_bytes"],
        "winners": dict(tuning["winners"]),
        "n_pareto": len(tuning["pareto"]),
        "verified": bool(verify_plan(pl).ok),
    }


def compute_baseline() -> Dict[str, Dict]:
    from repro_torch.core import tune
    return {name: baseline_row(tune(prog, backend="numpy", measure=False,
                                    cache=False, use_calibration=False))
            for name, prog in sorted(gate_programs().items())}


def update() -> None:
    from repro_torch.core import COST_MODEL_VERSION
    baseline = {
        "cost_model_version": COST_MODEL_VERSION,
        "hw": "repro_torch.roofline.analysis.HW (NVIDIA H100 SXM5, "
              "uncalibrated)",
        "params": {"N": QUICK_N, "ITERS": QUICK_ITERS},
        "rel_tol": REL_TOL,
        "programs": compute_baseline(),
    }
    PORT_BASELINE_PATH.write_text(json.dumps(baseline, indent=2,
                                             sort_keys=True) + "\n")
    print(f"wrote {PORT_BASELINE_PATH}")


def _compare(name: str, got: Dict, want: Dict, fields, tol: float,
             source: str) -> List[str]:
    problems = []
    for key in fields:
        if key not in want:
            continue
        g, w = got[key], want[key]
        if isinstance(w, float) and not isinstance(w, bool):
            drift = abs(g - w) / max(abs(w), 1e-30)
            if drift > tol:
                problems.append(f"{name}: {key} drifted {drift:.1%} from "
                                f"{source} ({w:.6e} -> {g:.6e}, tol "
                                f"{tol:.0%})")
        elif g != w:
            problems.append(f"{name}: {key} {g!r} != {source} {w!r}")
    return problems


def check(current: Dict[str, Dict] = None) -> List[str]:
    """Regression messages against both goldens (empty = pass)."""
    from repro_torch.core import COST_MODEL_VERSION
    current = compute_baseline() if current is None else current
    ref = json.loads(REFERENCE_BASELINE_PATH.read_text())
    port = json.loads(PORT_BASELINE_PATH.read_text())
    problems = []
    if port["cost_model_version"] != COST_MODEL_VERSION:
        problems.append(
            f"cost-model version drift: port golden "
            f"v{port['cost_model_version']} vs current v{COST_MODEL_VERSION}"
            " — regenerate it (--update) with the version bump")
    for source, golden, fields in (
            ("reference golden", ref, HW_FREE),
            ("port golden", port, PORT_FIELDS)):
        for name, want in sorted(golden["programs"].items()):
            got = current.get(name)
            if got is None:
                problems.append(f"{name}: gate program disappeared")
                continue
            problems += _compare(name, got, want, fields,
                                 golden.get("rel_tol", REL_TOL), source)
    return problems


def main(argv=None) -> int:
    args = list(sys.argv[1:] if argv is None else argv)
    if "--update" in args:
        update()
        return 0
    problems = check()
    if problems:
        print("TUNING REGRESSION (port):")
        for p in problems:
            print(f"  - {p}")
        print("(intentional change? regenerate with: PYTHONPATH=src python "
              "benchmarks/port_check_tuning_baseline.py --update)")
        return 1
    print(f"port tuning baseline OK ({REFERENCE_BASELINE_PATH.name} on "
          f"{', '.join(HW_FREE)}; {PORT_BASELINE_PATH.name} in full)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
