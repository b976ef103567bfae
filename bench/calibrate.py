"""Readings that set a cell's limits (not run by the benchmark's runs).

    python bench/calibrate.py --workload <cell> --seeds 11 12 ... \
        [--control] [--faults] [--seconds 8]

For each seed it prints one JSON line: the program's numbers against the
fp32 reference (the lower readings), and with ``--control`` the control's
(the reference with every matrix product in float8 e4m3, put in the
program's place), and with ``--faults`` each planted fault's (train: a
step that returns its state unchanged, half the batch; serve: tokens
altered where produced).  Serve cells run a short window of ``--seconds``
at the cell's own rate and check as many requests as a run does.
"""
import argparse
import json
import os
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control", action="store_true")
    ap.add_argument("--faults", action="store_true")
    ap.add_argument("--seconds", type=float, default=8.0)
    args = ap.parse_args(argv)
    os.environ["REPRO_TORCH_TUNE_CACHE"] = str(ROOT / "bench/.cache/tune")
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    import torch
    from bench import faults, harness
    c = harness.cell(args.workload)
    if not torch.cuda.is_available():
        print("calibrate: needs a CUDA card", file=sys.stderr)
        return 2
    dev = "cuda"
    kind = c["work"]["kind"]
    for seed in args.seeds:
        t = time.perf_counter()
        row = {"seed": seed}
        if kind == "train":
            from bench.drivers import train as D
            st = D.Setup(c, seed, dev)
            prog = st.readings
            st.close()
            ref = D.reference_readings(c, seed, dev)
            row["program"] = D.compare(prog, ref)
            if args.control:
                row["control"] = D.compare(
                    D.reference_readings(c, seed, dev, "fp8"), ref)
            if args.faults:
                for name, wrap in faults.TRAIN.items():
                    st = D.Setup(c, seed, dev, wrap=wrap)
                    row[name] = D.compare(st.readings, ref)
                    st.close()
        else:
            from bench import traffic
            from bench.drivers import serve as D
            chk = c["work"]["check"]
            reqs = traffic.serve_requests(c["work"]["traffic"],
                                          c["cfg"]["vocab"], args.seconds,
                                          seed)
            st = D.Setup(c, seed, dev)
            w = st.window(reqs, args.seconds, False)
            done_fault = None
            if args.faults:
                with faults.altered_tokens():
                    done_fault = st.window(reqs, args.seconds, False)["done"]
            st.close()
            chosen = D.sample(w["done"], seed, chk["sample_tokens"],
                              chk["sample_requests"])
            ref = D.reference_logits(c, seed, dev, chosen)
            row["program"] = D.gap_stats(D.gaps(
                ref, [r.tokens for r in chosen]))
            row["tokens"] = sum(r.max_new_tokens for r in chosen)
            if args.control:
                ctl = D.reference_logits(c, seed, dev, chosen, "fp8")
                row["control"] = D.gap_stats(D.gaps(
                    ref, [lg.argmax(-1).cpu().numpy() for lg in ctl]))
                del ctl
            if done_fault is not None:
                fc = [done_fault[r.rid] for r in chosen]
                row["altered_tokens"] = D.gap_stats(D.gaps(
                    ref, [r.tokens for r in fc]))
            del ref
            D.free(dev)
        row["seconds"] = time.perf_counter() - t
        print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
