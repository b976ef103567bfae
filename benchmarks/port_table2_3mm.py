"""Table 2 analogue on the PyTorch port: the generated 'source' for 3MM
and its schedule stats.

    PYTHONPATH=src python benchmarks/port_table2_3mm.py
        [--backend cuda|cpu|numpy]

The port's counterpart of ``benchmarks/table2_3mm.py``: prints the
HMPP-style emission (group/mapbyname/advancedload/async callsites/
noupdate/synchronize/delegatedstore/release) and one CSV row with the
measured transfer schedule of the optimized plan against the naive
policy's, and both plans' wall times.  The backend is the torch one on
``cuda:0`` unless ``--backend cpu`` or ``--backend numpy`` is given.
"""
from __future__ import annotations

import sys

from port_directive_micro import make_backend

from repro_torch.core import emit, execute, naive_plan, plan, transfer_summary
from repro_torch.polybench import build


def run(n: int = 512, show_source: bool = True, backend=None):
    p, _ = build("3mm", n=n)
    opt, naive = plan(p), naive_plan(p)
    if show_source:
        print(emit(opt))
        print()
    execute(opt, backend=backend)              # warm: builds, allocator
    execute(naive, backend=backend)
    _, s_opt = execute(opt, backend=backend)
    _, s_nv = execute(naive, backend=backend)
    summary = transfer_summary(opt)
    return {
        "loads_opt": s_opt.h2d_transfers, "loads_naive": s_nv.h2d_transfers,
        "stores_opt": s_opt.d2h_transfers,
        "stores_naive": s_nv.d2h_transfers,
        "noupdate_args": summary["noupdate_args"],
        "bytes_opt": s_opt.h2d_bytes + s_opt.d2h_bytes,
        "bytes_naive": s_nv.h2d_bytes + s_nv.d2h_bytes,
        "wall_opt_ms": s_opt.wall_time * 1e3,
        "wall_naive_ms": s_nv.wall_time * 1e3,
        "kernel_opt_ms": s_opt.kernel_time * 1e3,
    }


def main(argv=None):
    args = list(sys.argv[1:] if argv is None else argv)
    be = make_backend(args[args.index("--backend") + 1]
                      if "--backend" in args else "cuda")
    row = run(backend=be)
    extra = ";".join(f"{k}={v if not isinstance(v, float) else round(v, 2)}"
                     for k, v in row.items() if k != "wall_opt_ms")
    print(f"table2_3mm,{row['wall_opt_ms'] * 1e3:.0f},{extra}")
    return row


if __name__ == "__main__":
    main()
