"""The port's examples (``examples/port_*.py``, the JAX-free twins of
``examples/polybench_3mm.py``, ``offload_pipeline.py``, ``serve_demo.py``
and ``quickstart.py``) run on the CPU when asked to, print what their
reference twins print, and import neither JAX nor the reference; without
``--device cpu`` they run on the card and raise where there is none."""
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
EXAMPLES = {
    "port_polybench_3mm": ("GENERATED CODE", "results match the pure-host "
                           "oracle"),
    "port_offload_pipeline": ("optimized: 3 uploads / 2 downloads",
                              "27 uploads elided"),
    "port_serve_demo": ("=== internlm2-20b [dense] ===",
                        "=== rwkv6-3b [ssm] ==="),
    "port_quickstart": ("trained 60 steps", "held-out batch: loss",
                        "served: 8 tokens/request"),
}

_PROBE = r"""
import runpy, sys
sys.argv = [sys.argv[1]] + sys.argv[2:]
runpy.run_path(sys.argv[0], run_name="__main__")
leaked = sorted(m for m in sys.modules if m == "jax" or m.startswith("jax.")
                or m == "repro" or m.startswith("repro."))
assert not leaked, leaked
"""


def _run(name, *args):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    # the examples run small ops: one intra-op thread each, so they do
    # not fight the other test workers for the cores
    env["OMP_NUM_THREADS"] = "1"
    return subprocess.run(
        [sys.executable, "-c", _PROBE, str(ROOT / "examples" / f"{name}.py"),
         *args], cwd=ROOT, env=env, capture_output=True, text=True,
        timeout=300)


@pytest.mark.parametrize("name", sorted(EXAMPLES))
def test_example_runs_on_cpu(name):
    res = _run(name, "--device", "cpu")
    assert res.returncode == 0, res.stderr
    for text in EXAMPLES[name]:
        assert text in res.stdout, (text, res.stdout[-2000:])


def test_polybench_3mm_counts_equal_reference_example():
    """The 3mm example's transfer table: 4 uploads / 1 download optimized,
    6 / 3 naive, the paper's Table 2 and the reference example's."""
    sys.path.insert(0, str(ROOT / "examples"))
    try:
        import port_polybench_3mm
    finally:
        sys.path.pop(0)
    s_opt, s_nv = port_polybench_3mm.main(["--device", "cpu"])
    assert (s_opt.h2d_transfers, s_opt.d2h_transfers) == (4, 1)
    assert (s_nv.h2d_transfers, s_nv.d2h_transfers) == (6, 3)


@pytest.mark.parametrize("name", sorted(EXAMPLES))
def test_example_default_needs_a_card(name):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the example runs on it")
    res = _run(name)
    assert res.returncode != 0
    assert "no CUDA device" in res.stderr
