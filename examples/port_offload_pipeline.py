"""The paper's technique applied to a training loop, on the PyTorch port:
the miniature train-loop block-program is planned (batch upload hoisted,
weights and optimizer state device-resident with noupdate, loss fetched
once at the end), the generated schedule is printed, and both plans are
executed on the torch backend with instrumented transfers.  Runs on
``cuda:0`` (and raises without a card) unless ``--device cpu``:

    PYTHONPATH=src python examples/port_offload_pipeline.py [--device cpu]
"""
import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch.core import (TorchDeviceBackend, emit, execute,  # noqa: E402
                              naive_plan, plan)
from repro_torch.optim import plan_step_program  # noqa: E402


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default; raises without a card) or cpu")
    args = ap.parse_args(argv)
    backend = TorchDeviceBackend(args.device)
    prog = plan_step_program(n_steps=6)
    optimized = plan(prog)
    print(emit(optimized))

    _, s_opt = execute(optimized, backend=backend)
    _, s_nv = execute(naive_plan(prog), backend=backend)
    print(f"\noptimized: {s_opt.h2d_transfers} uploads / "
          f"{s_opt.d2h_transfers} downloads")
    print(f"naive:     {s_nv.h2d_transfers} uploads / "
          f"{s_nv.d2h_transfers} downloads")
    print("\nthe residency win: weights + optimizer state stay on device "
          f"across all 6 steps ({s_nv.h2d_transfers - s_opt.h2d_transfers} "
          "uploads elided)")
    return s_opt, s_nv


if __name__ == "__main__":
    main()
