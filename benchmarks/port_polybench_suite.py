"""Fig. 6 analogue on the PyTorch port: Polybench speedups.

    PYTHONPATH=src python benchmarks/port_polybench_suite.py
        [--backend cuda|cpu|numpy]

The port's counterpart of ``benchmarks/polybench_suite.py``.  Per problem
it times
    seq       — pure-host numpy execution (the paper's 'sequential'),
    naive     — device offload, transfers at every callsite (Figs. 4a/5a),
    omp2hmpp  — the planner's optimized schedule (this paper's system),
    hand      — the hand-tuned bound: inputs already on the device, every
                offload block run straight under torch there, zero
                transfers but one final fetch of the outputs,
and prints one CSV row per problem with the speedups against seq and
naive and the transfer bytes saved.  The backend is the torch one on
``cuda:0`` unless ``--backend cpu`` or ``--backend numpy`` is given;
``hand`` runs on the backend's device (the host for ``numpy``).
"""
from __future__ import annotations

import sys
import time
from typing import Dict, List

import numpy as np
import torch
from port_directive_micro import make_backend

from repro_torch.core import (execute, get_backend, naive_plan, plan,
                              run_host_oracle)
from repro_torch.polybench import PROBLEMS, build

SIZES = {
    "2mm": dict(n=512), "3mm": dict(n=512), "gemm": dict(n=512, iters=4),
    "atax": dict(n=2048), "bicg": dict(n=2048), "mvt": dict(n=2048),
    "gesummv": dict(n=1536), "syrk": dict(n=512, iters=2),
    "covariance": dict(n=768), "jacobi2d": dict(n=768, iters=10),
}
REPS = 3


def _time(fn, reps=REPS):
    fn()                     # warm
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        ts.append(time.perf_counter() - t0)
    return min(ts)


def _time_hand(p, inputs, device) -> float:
    """Every offload block under torch on ``device``, all arrays resident
    from the start, one fetch of the outputs at the end."""
    def run():
        env = {k: torch.from_numpy(np.asarray(v)).to(device)
               for k, v in inputs.items()}
        if device.type == "cuda":
            torch.cuda.synchronize(device)

        def exec_blocks(blocks, path):
            i = 0
            while i < len(blocks):
                blk = blocks[i]
                rel = blk.loop_path[len(path):]
                if not rel:
                    out = blk.fn(torch, **{v: env[v] for v in blk.reads})
                    for w in blk.writes:
                        env[w] = out[w]
                    i += 1
                else:
                    lid = rel[0]
                    j = i
                    while j < len(blocks) and \
                            len(blocks[j].loop_path) > len(path) and \
                            blocks[j].loop_path[len(path)] == lid:
                        j += 1
                    for _ in range(p.loops[lid].n_iters):
                        exec_blocks(blocks[i:j], path + (lid,))
                    i = j
        exec_blocks(p.blocks, ())
        for name in p.outputs:
            env[name].cpu()
    return _time(run)


def run_suite(backend=None, scale: float = 1.0) -> List[Dict]:
    """``scale`` multiplies the problem sizes; ``backend`` goes through
    ``get_backend``, so ``hand`` runs where the plans run."""
    backend = get_backend(backend)
    device = getattr(backend, "device", torch.device("cpu"))
    rows = []
    for name in sorted(PROBLEMS):
        size = {k: (max(8, int(v * scale)) if k == "n" else v)
                for k, v in SIZES[name].items()}
        p, inputs = build(name, **size)
        opt_plan, nv_plan = plan(p), naive_plan(p)

        t_seq = _time(lambda: run_host_oracle(p))
        t_nv = _time(lambda: execute(nv_plan, backend=backend))
        t_opt = _time(lambda: execute(opt_plan, backend=backend))
        t_hand = _time_hand(p, inputs, device)
        _, s_opt = execute(opt_plan, backend=backend)
        _, s_nv = execute(nv_plan, backend=backend)

        rows.append({
            "problem": name,
            "t_seq_ms": t_seq * 1e3,
            "t_naive_ms": t_nv * 1e3,
            "t_omp2hmpp_ms": t_opt * 1e3,
            "t_hand_ms": t_hand * 1e3,
            "speedup_vs_seq": t_seq / t_opt,
            "speedup_vs_naive": t_nv / t_opt,
            "hand_vs_omp2hmpp": t_opt / t_hand,
            "bytes_saved_vs_naive": (s_nv.h2d_bytes + s_nv.d2h_bytes
                                     - s_opt.h2d_bytes - s_opt.d2h_bytes),
            "transfers_opt": s_opt.h2d_transfers + s_opt.d2h_transfers,
            "transfers_naive": s_nv.h2d_transfers + s_nv.d2h_transfers,
        })
    return rows


def main(argv=None):
    args = list(sys.argv[1:] if argv is None else argv)
    be = make_backend(args[args.index("--backend") + 1]
                      if "--backend" in args else "cuda")
    rows = run_suite(be)
    for r in rows:
        print(f"fig6_{r['problem']},{r['t_omp2hmpp_ms'] * 1e3:.0f},"
              f"speedup_seq={r['speedup_vs_seq']:.2f}x;"
              f"speedup_naive={r['speedup_vs_naive']:.2f}x;"
              f"hand_gap={r['hand_vs_omp2hmpp']:.2f}x;"
              f"bytes_saved={r['bytes_saved_vs_naive']}")
    return rows


if __name__ == "__main__":
    main()
