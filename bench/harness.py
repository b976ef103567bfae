"""What every run shares: the manifest and the cell's files, the chip
check, the isolation check, the metric readers and the result line."""
from __future__ import annotations

import importlib.util
import json
import subprocess
import sys
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional

ROOT = Path(__file__).resolve().parent.parent
# top-level module names the process that prints a result may not hold
FORBIDDEN = ("jax", "jaxlib", "flax", "repro", "benchmarks")


def manifest(root: Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def cell(name: str, man: Optional[dict] = None,
         root: Path = ROOT) -> Dict[str, Any]:
    """The cell ``name``: its manifest entry, its workload file
    (``bench/workloads/<name>.json``) and its configuration file."""
    man = man or manifest(root)
    entry = next((w for w in man["workloads"] if w["name"] == name), None)
    if entry is None:
        raise SystemExit(f"unknown workload {name!r}; have "
                         f"{[w['name'] for w in man['workloads']]}")
    conf = next(c for c in man["configs"] if c["name"] == entry["config"])
    work = json.loads((root / "bench" / "workloads" / f"{name}.json")
                      .read_text())
    cfg = json.loads((root / conf["file"]).read_text())
    return {"entry": entry, "work": work, "cfg": cfg}


def metrics_of(name: str, man: dict, trace: bool) -> List[dict]:
    """The metrics a run of cell ``name`` reports: its end-to-end metrics,
    or with ``trace`` its per-layer ones."""
    e2e = [m for m in man["end_to_end"]
           if name in m.get("workloads", [name])]
    if not trace:
        return e2e
    moved = {m["name"] for m in e2e}
    return [m for m in man["per_layer"]
            if name in m.get("workloads", [name] if m["moves"] in moved
                             else [])]


def reader(metric: str, root: Path = ROOT
           ) -> Callable[[dict], Optional[float]]:
    """``read(ctx)`` of ``bench/metrics/<metric>.py``."""
    path = root / "bench" / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(
        "bench_metric_" + metric.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def read_metrics(specs: List[dict], ctx: dict) -> Dict[str, dict]:
    """Each metric's reading, or nothing where its reader found nothing
    to read; end-to-end readings are in ``ctx["e2e"]``."""
    out = {}
    for m in specs:
        if "layer" in m:
            value = reader(m["name"])(ctx)
        else:
            value = ctx["e2e"].get(m["name"])
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out


def loaded_forbidden() -> List[str]:
    return sorted({n.split(".")[0] for n in sys.modules}
                  & set(FORBIDDEN))


def card() -> str:
    """The card's name and power limit, as nvidia-smi reads them."""
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "nvidia-smi unavailable"


def device_info(peak_bytes: int, trace: Optional[dict]) -> dict:
    import torch
    if torch.cuda.is_available():
        info = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                "count": 1}
    else:
        info = {"platform": "cpu", "kind": "cpu", "count": 1}
    info["memory_peak_bytes"] = int(peak_bytes)
    if trace is not None:
        info.update(trace)
    return info


def emit(result: dict, checks: Dict[str, dict]) -> None:
    """The comparisons on standard error as its last lines, then the
    result as the last line of standard output, its ``checks`` last."""
    for k, v in checks.items():
        print(f"check {k}: {v['value']!r} limit {v['limit']!r}",
              file=sys.stderr)
    result = dict(result)
    result["checks"] = checks
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
