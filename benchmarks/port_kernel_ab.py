#!/usr/bin/env python3
"""Time the kernel phases of ``chip_smoke.py`` on several checkouts of
this repo, in turns, on one CUDA card: an A/B comparison of two versions
of the port's kernels inside one run (so both meet the same card, power
limit and neighbours).

    python3 benchmarks/port_kernel_ab.py [--phases flash,wkv6] DIR [DIR ...]

Each DIR is the root of a checkout (e.g. a ``git archive`` of another
commit unpacked under ``build/``).  For each DIR in the order given (list
one twice to alternate: old new new old) a fresh Python process imports
that checkout's ``chip_smoke`` and runs its environment and build phases,
then the named kernel phases: ``flash`` (``phase_kernel``: flash attention
on both routes at qwen2.5-14b and recurrentgemma-2b widths),
``flash_bwd`` (``phase_flash_bwd_kernel``: the sm90 backward at
internlm2-20b's train-4k call), ``wkv6``,
``rglru``, ``rmsnorm`` and ``adamw`` (AdamW's update and square sum at
internlm2-20b's train-4k leaves).  Their JSON lines are printed prefixed with
``{"tree": DIR, ...}``.  Every phase checks its kernel against the plain
version as the smoke run does, so a failed check fails this run too.
Exits non-zero without a card.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

PHASES = {"flash": "phase_kernel", "flash_bwd": "phase_flash_bwd_kernel",
          "wkv6": "phase_wkv6_kernel",
          "rglru": "phase_rglru_kernel", "rmsnorm": "phase_rmsnorm_kernel",
          "adamw": "phase_adamw_kernel"}

CHILD = """
import sys
sys.path.insert(0, {root!r})
sys.path.insert(0, {src!r})
import torch
import chip_smoke as cs
if not torch.cuda.is_available():
    sys.exit("no CUDA device")
cs.phase_environment()
peaks = cs.card_peaks(torch.cuda.get_device_name(0))
cs.phase_build()
for name in {phases!r}:
    getattr(cs, name)(peaks)
"""


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--phases", default="flash,wkv6",
                    help=f"comma-separated, of {sorted(PHASES)}")
    ap.add_argument("trees", nargs="+", type=Path)
    args = ap.parse_args()
    phases = [PHASES[p] for p in args.phases.split(",")]
    for tree in args.trees:
        root = tree.resolve()
        code = CHILD.format(root=str(root), src=str(root / "src"),
                            phases=phases)
        proc = subprocess.run([sys.executable, "-c", code], cwd=root,
                              capture_output=True, text=True)
        for line in proc.stdout.splitlines():
            try:
                row = json.loads(line)
            except json.JSONDecodeError:
                print(line, flush=True)
                continue
            print(json.dumps({"tree": str(tree), **row}), flush=True)
        if proc.returncode:
            print(proc.stderr, file=sys.stderr, flush=True)
            return proc.returncode
    return 0


if __name__ == "__main__":
    sys.exit(main())
