"""Tiny versions of the benchmark's cells for the CPU tests: the cells'
own files with every size shrunk, the limits kept."""
import copy
import json
from types import SimpleNamespace

from bench import harness

DENSE = dict(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_head=16,
             d_ff=96, vocab=257, dtype="float32")
RWKV = dict(n_layers=2, d_model=64, d_ff=96, vocab=257, rwkv_head_size=16,
            dtype="float32")


def cell(name: str, dtype: str = "float32", config: str = None):
    """The cell ``name`` shrunk; ``config`` runs its traffic on another
    configuration's file (the dense model behind the serving engine)."""
    c = copy.deepcopy(harness.cell(name))
    if config is not None:
        conf = next(x for x in harness.manifest()["configs"]
                    if x["name"] == config)
        c["cfg"] = json.loads((harness.ROOT / conf["file"]).read_text())
    c["cfg"].update(DENSE if c["cfg"]["family"] == "dense" else RWKV,
                    dtype=dtype)
    w = c["work"]
    if w["kind"] == "train":
        w["traffic"]["seq"] = 64
    else:
        w["traffic"].update(rate_rps=15.0, prompt_lens=[[4, .5], [9, .5]],
                            output_lens=[[3, .5], [7, .5]])
        w["engine"].update(max_seq=32, capacity=4)
        w["check"].update(sample_tokens=20)
    return c


def run(name: str, capsys, seconds=1.5, trace=0, seed=2 ** 33 + 5,
        dtype="float32", forbidden=(), config=None):
    """Drive the tiny cell through the run's own path on the CPU; returns
    (exit code, the last stdout line as JSON or None, stderr).  The test
    process holds JAX and the JAX package (other test files load them),
    so the isolation check sees ``forbidden`` in their place; the
    isolation itself is held in a clean process
    (``test_bench_isolation.py``)."""
    from unittest import mock

    from bench import run as entry
    c = cell(name, dtype, config)
    args = SimpleNamespace(workload=name, seed=seed, seconds=seconds,
                           trace=trace)
    with mock.patch.object(harness, "loaded_forbidden",
                           lambda: sorted(forbidden)):
        rc = entry.finish(c, harness.manifest(), args, "cpu")
    out, err = capsys.readouterr()
    lines = out.strip().splitlines()
    return rc, json.loads(lines[-1]) if lines else None, err
