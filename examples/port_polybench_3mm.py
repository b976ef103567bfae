"""The paper's worked example (Tables 1-2): 3MM through the OMP2HMPP
planner, on the PyTorch port.  Prints the generated HMPP-style source,
then executes the optimized and naive plans on the torch backend and
compares the transfer schedules.  Runs on ``cuda:0`` (and raises without
a card) unless ``--device cpu``:

    PYTHONPATH=src python examples/port_polybench_3mm.py [--device cpu]
"""
import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

import numpy as np  # noqa: E402

from repro_torch.core import (TorchDeviceBackend, emit, execute,  # noqa: E402
                              naive_plan, plan, run_host_oracle)
from repro_torch.polybench import build  # noqa: E402


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default; raises without a card) or cpu")
    args = ap.parse_args(argv)
    backend = TorchDeviceBackend(args.device)
    p, _ = build("3mm", n=256)

    optimized = plan(p)
    print("=" * 70)
    print("GENERATED CODE (paper Table 2 analogue)")
    print("=" * 70)
    print(emit(optimized))

    out_opt, s_opt = execute(optimized, backend=backend)
    out_nv, s_nv = execute(naive_plan(p), backend=backend)
    oracle = run_host_oracle(p)
    assert np.allclose(out_opt["out"], oracle["out"], rtol=1e-3)
    assert np.allclose(out_nv["out"], oracle["out"], rtol=1e-3)

    print(f"\ntransfer schedule comparison ({backend.device}):")
    print(f"  {'':>12s} {'optimized':>10s} {'naive':>10s}")
    print(f"  {'h2d count':>12s} {s_opt.h2d_transfers:>10d} "
          f"{s_nv.h2d_transfers:>10d}")
    print(f"  {'d2h count':>12s} {s_opt.d2h_transfers:>10d} "
          f"{s_nv.d2h_transfers:>10d}")
    print(f"  {'bytes moved':>12s} "
          f"{(s_opt.h2d_bytes + s_opt.d2h_bytes) // 2**20:>9d}M "
          f"{(s_nv.h2d_bytes + s_nv.d2h_bytes) // 2**20:>9d}M")
    print("\nresults match the pure-host oracle ✓")
    return s_opt, s_nv


if __name__ == "__main__":
    main()
