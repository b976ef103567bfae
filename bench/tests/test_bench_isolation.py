"""What the benchmark loads: no JAX, no JAX package, nothing of
``benchmarks/``; and the reference loads nothing of the program."""
import json
import subprocess
import sys

from bench import harness

PROBE = """
import json, sys
sys.path[:0] = [{src!r}, {root!r}]
{imports}
print(json.dumps(sorted({{n.split(".")[0] for n in sys.modules}})))
"""


def _top_level(imports: str):
    code = PROBE.format(src=str(harness.ROOT / "src"),
                        root=str(harness.ROOT), imports=imports)
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=harness.ROOT)
    assert res.returncode == 0, res.stderr
    return set(json.loads(res.stdout.strip().splitlines()[-1]))


def test_the_harness_loads_no_jax_nor_the_jax_package():
    mods = _top_level(
        "import bench.run, bench.harness, bench.calibrate, bench.sweep\n"
        "import bench.drivers.train, bench.drivers.serve\n"
        "from bench import harness\n"
        "for m in harness.manifest()['per_layer']:\n"
        "    harness.reader(m['name'])\n")
    assert "repro_torch" in mods
    assert not mods & {"jax", "jaxlib", "flax", "repro", "benchmarks"}


def test_the_reference_loads_nothing_of_the_program():
    mods = _top_level("import bench.reference, bench.yardstick, "
                      "bench.traffic")
    assert not mods & {"jax", "jaxlib", "flax", "repro", "repro_torch",
                       "benchmarks"}


def test_forbidden_names_are_compared_whole(monkeypatch):
    import types
    assert "repro" in harness.FORBIDDEN
    assert "repro_torch" not in harness.loaded_forbidden()
    monkeypatch.setitem(sys.modules, "flax.linen", types.ModuleType("x"))
    assert "flax" in harness.loaded_forbidden()
