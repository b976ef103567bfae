"""The knee sweep of a serve cell (not run by the benchmark's runs).

    python bench/sweep.py --workload <cell> --seeds 1 2 --seconds 51 \
        --rates 1 2 3 4

One set-up, then one window a rate and seed, each offered at that rate
with the cell's mix.  A line a window: the backlog (requests arrived and
not finished) at the window's middle and at its end, and the latency
readings.  The knee is the highest rate at which every seed's median
time to first token stays within 1.25 times the lowest rate's (the
backlog, a count at one instant, swings by the requests in flight).
"""
import argparse
import json
import os
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=30.0)
    ap.add_argument("--rates", type=float, nargs="+", required=True)
    args = ap.parse_args(argv)
    os.environ["REPRO_TORCH_TUNE_CACHE"] = str(ROOT / "bench/.cache/tune")
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    import torch
    from bench import harness, traffic
    from bench.drivers import serve as D
    c = harness.cell(args.workload)
    if not torch.cuda.is_available():
        print("sweep: needs a CUDA card", file=sys.stderr)
        return 2
    st = D.Setup(c, args.seeds[0], "cuda")
    for rate in args.rates:
        for seed in args.seeds:
            # each seed a schedule of its own: the knee holds for more
            # than the cell's one order
            tr = dict(c["work"]["traffic"], rate_rps=rate, order_seed=seed)
            reqs = traffic.serve_requests(tr, c["cfg"]["vocab"],
                                          args.seconds, seed)
            w = st.window(reqs, args.seconds, False)
            print(json.dumps({"rate_rps": rate, "seed": seed,
                              "requests": len(reqs),
                              "finished": len(w["done"]),
                              "backlog_mid": w["backlog_mid"],
                              "backlog_end": w["backlog_end"],
                              "wall_s": w["wall_s"], **D.e2e(w)}),
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
