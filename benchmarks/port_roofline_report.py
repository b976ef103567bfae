"""Render the roofline table from the PyTorch port's dry-run records.

    PYTHONPATH=src python benchmarks/port_roofline_report.py
        [--variant baseline] [--mesh single] [--outdir artifacts/dryrun_torch]

The port's counterpart of ``benchmarks/roofline_report.py``: one row per
record ``<arch>__<shape>__<mesh>__<variant>.json`` that
``python -m repro_torch.launch.dryrun`` wrote (SKIP records included),
for the records of one mesh (``single``/``multi`` for the production
meshes, a shape such as ``2x4`` for a small one), with the reference's
columns.  The reference's note column reads XLA's ``memory.temp_bytes``,
which the port's trace has no counterpart for; the port's note is the
per-device bytes its ``CellArtifacts.lower`` reports instead: params,
optimizer state (marked ``host`` when offloaded) and cache.
"""
from __future__ import annotations

import argparse
import glob
import json
from typing import List

HEADER = ("| arch | shape | compute s | memory s | collective s | "
          "bottleneck | MODEL_FLOPS | useful | roofline | note |")
NOTE = ("note: per-device param / optimizer-state / cache bytes from the "
        "port's trace (no XLA temp_bytes)")


def load(variant: str = "baseline", outdir: str = "artifacts/dryrun_torch"
         ) -> List[dict]:
    rows = []
    for f in sorted(glob.glob(f"{outdir}/*__{variant}.json")):
        with open(f) as fh:
            rows.append(json.load(fh))
    return rows


def _note(mem: dict) -> str:
    opt = f"{mem['opt_bytes'] / 1e9:.3g}GB"
    if mem.get("opt_on_host"):
        opt += " host"
    return (f"params {mem['param_bytes'] / 1e9:.3g}GB, opt {opt}, "
            f"cache {mem['cache_bytes'] / 1e9:.3g}GB")


def table(rows: List[dict], mesh: str = "single") -> str:
    out = [NOTE, "", HEADER, "|---|---|---|---|---|---|---|---|---|---|"]
    for r in rows:
        if r.get("mesh") != mesh:
            continue
        if r["status"] == "SKIP":
            out.append(f"| {r['arch']} | {r['shape']} | — | — | — | — | — "
                       f"| — | — | SKIP: {r['reason'][:60]} |")
            continue
        ro = r["roofline"]
        out.append(
            f"| {r['arch']} | {r['shape']} | {ro['compute_s']:.4f} | "
            f"{ro['memory_s']:.4f} | {ro['collective_s']:.4f} | "
            f"{ro['bottleneck'].replace('_s', '')} | "
            f"{ro['model_flops']:.3g} | {ro['useful_ratio']:.2f} | "
            f"{ro['roofline_fraction']:.3f} | {_note(r['memory'])} |")
    return "\n".join(out)


def main(argv=None) -> str:
    ap = argparse.ArgumentParser()
    ap.add_argument("--variant", default="baseline")
    ap.add_argument("--mesh", default="single")
    ap.add_argument("--outdir", default="artifacts/dryrun_torch")
    args = ap.parse_args(argv)
    text = table(load(args.variant, args.outdir), args.mesh)
    print(text)
    return text


if __name__ == "__main__":
    main()
