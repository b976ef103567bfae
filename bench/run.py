"""Run one cell of the benchmark once and print its result line.

    python bench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

With ``--trace 0`` the line holds the cell's end-to-end metrics, with
``--trace 1`` its per-layer ones (``BENCHMARK.json``).  The run needs a
CUDA card; it exits non-zero and prints no result without one (2), if the
process holds a JAX module or the JAX package once the window has closed
(3), or if the host's memory ran low (4: ``hostguard.py`` runs the cell
as its child and stops it).
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import resource  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
CACHE = ROOT / "bench" / ".cache"
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from bench import hostguard  # noqa: E402


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


def parse(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument(hostguard.MARK, dest="supervised", type=float,
                    default=None, help=argparse.SUPPRESS)
    return ap.parse_args(argv)


def supervise(argv, child=None, headroom=None) -> int:
    """Run the cell as a child of ``hostguard.supervise``: ``child`` is
    the command it runs (this file by default), ``headroom`` the host's
    reader (``hostguard.HostMemory`` by default)."""
    ap = argparse.ArgumentParser(add_help=False)
    ap.add_argument("--workload", default="?")
    ap.add_argument("--seed", default="?")
    known, _ = ap.parse_known_args(argv)
    cmd = child or [sys.executable, str(Path(__file__).resolve())]
    return hostguard.supervise([*cmd, *argv],
                               f"{known.workload} seed {known.seed}",
                               T_START, headroom)


def main(argv=None) -> int:
    args = parse(argv)
    t_start = T_START if args.supervised is None else args.supervised
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
    return finish(c, man, args, "cuda", t_start)


def finish(c, man, args, dev, t_start=T_START) -> int:
    """Drive the cell on ``dev`` and print its line (the tests call this
    on the CPU at a tiny size).  ``setup_s`` counts from ``t_start``."""
    import importlib
    from bench import harness
    kind = c["work"]["kind"]
    driver = importlib.import_module(f"bench.drivers.{kind}")
    result, checks, ctx = driver.run(c, args.seed, args.seconds,
                                     bool(args.trace), dev, t_start)
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
    peak = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024
    print(f"bench: host memory: this process's peak resident set "
          f"{peak / hostguard.GIB:.2f} GiB", file=sys.stderr)
    harness.emit(line, checks)
    return 0


if __name__ == "__main__":
    if hostguard.MARK in sys.argv:
        sys.exit(main())
    sys.exit(hostguard.end(supervise(sys.argv[1:])))
