"""Run one cell of the benchmark once and print its result line.

    python bench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

With ``--trace 0`` the line holds the cell's end-to-end metrics, with
``--trace 1`` its per-layer ones (``BENCHMARK.json``).  The run needs a
CUDA card; it exits non-zero and prints no result without one, or if the
process holds a JAX module or the JAX package once the window has closed.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
CACHE = ROOT / "bench" / ".cache"


def _environment() -> None:
    """Every cache a run reuses at a fixed path inside the checkout; the
    program's kernels build into ``build/`` at its root by themselves."""
    os.environ["REPRO_TORCH_TUNE_CACHE"] = str(CACHE / "tune")
    os.environ["TRITON_CACHE_DIR"] = str(CACHE / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(CACHE / "torch_extensions")
    os.environ["USE_FLAX"] = "0"
    for p in (str(ROOT / "src"), str(ROOT)):
        if p not in sys.path:
            sys.path.insert(0, p)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    _environment()

    import torch
    from bench import harness

    man = harness.manifest()
    c = harness.cell(args.workload, man)
    need = c["entry"]["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < need:
        print(f"bench: this cell needs {need} CUDA card(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    print(f"bench: {args.workload} seed {args.seed} on {harness.card()}",
          file=sys.stderr)
    return finish(c, man, args, "cuda")


def finish(c, man, args, dev) -> int:
    """Drive the cell on ``dev`` and print its line (the tests call this
    on the CPU at a tiny size)."""
    import importlib
    from bench import harness
    kind = c["work"]["kind"]
    driver = importlib.import_module(f"bench.drivers.{kind}")
    result, checks, ctx = driver.run(c, args.seed, args.seconds,
                                     bool(args.trace), dev, T_START)
    found = harness.loaded_forbidden()
    if found:
        print(f"bench: the process holds forbidden modules: {found}",
              file=sys.stderr)
        return 3
    metrics = harness.read_metrics(
        harness.metrics_of(args.workload, man, bool(args.trace)), ctx)
    line = {"correct": result["correct"], "attempted": result["attempted"],
            "failed": result["failed"], "metrics": metrics,
            "device": harness.device_info(result["peak_bytes"],
                                          result["summary"]
                                          if args.trace else None),
            "readings": result["readings"]}
    if args.trace and "breakdown" in result:
        line["breakdown"] = result["breakdown"]
    harness.emit(line, checks)
    return 0


if __name__ == "__main__":
    sys.exit(main())
