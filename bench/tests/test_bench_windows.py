"""Both window kinds end to end on the CPU at a tiny size, the result
line's shape, and the faults ``correct`` has to catch."""
import subprocess
import sys

import pytest

from bench import faults, harness
from bench.tests import tiny

TRAIN, SERVE = "internlm2-20b.train-4k", "rwkv6-3b.serve-chat"
# the serve cell's traffic on the dense configuration: the engine over
# the KV pool and decode attention
DENSE = "internlm2-20b"


def _shape(line, name, trace):
    assert list(line)[-1] == "checks"
    assert set(line) >= {"correct", "attempted", "failed", "metrics",
                         "device"}
    want = {m["name"] for m in harness.metrics_of(name, harness.manifest(),
                                                  trace)}
    assert set(line["metrics"]) <= want
    for m in line["metrics"].values():
        assert set(m) == {"value", "unit"}
    assert set(line["device"]) >= {"platform", "kind", "count",
                                   "memory_peak_bytes"}
    for c in line["checks"].values():
        assert set(c) == {"value", "limit"}


@pytest.mark.parametrize("name,config", [(TRAIN, None), (SERVE, None),
                                         (SERVE, DENSE)],
                         ids=[TRAIN, SERVE, "internlm2-20b.serve-chat"])
def test_window_end_to_end(name, config, capsys):
    rc, line, err = tiny.run(name, capsys, config=config)
    assert rc == 0 and line["correct"] is True, line
    _shape(line, name, False)
    want = {m["name"] for m in harness.metrics_of(name, harness.manifest(),
                                                  False)}
    assert set(line["metrics"]) == want
    assert line["failed"] == 0 and line["attempted"] > 0
    assert err.strip().splitlines()[-1].startswith("check ")


@pytest.mark.parametrize("name", [TRAIN, SERVE])
def test_traced_window(name, capsys):
    rc, line, _ = tiny.run(name, capsys, trace=1)
    assert rc == 0 and line["correct"] is True
    _shape(line, name, True)
    assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
    # the CPU has no device trace: its readers stay silent
    assert not any("roofline" in k or "idle" in k for k in line["metrics"])
    assert line["metrics"]
    if name == TRAIN:
        # the traced interval's pace beside the window's; no device trace
        # here, so no interval and no busy time
        r = line["readings"]
        assert r["step_s"] > 0 and "traced_step_s" in r
        assert r["traced_step_s"] is None
        assert "traced_wall_s" not in r
        assert not {"busy_s", "window_s"} & set(line["device"])


@pytest.mark.parametrize("fault", sorted(faults.TRAIN))
def test_train_faults_fail(fault, capsys, monkeypatch):
    import repro_torch.launch.train as launch
    make = launch.make_train_step
    monkeypatch.setattr(launch, "make_train_step",
                        lambda m, o: faults.TRAIN[fault](make(m, o)))
    rc, line, err = tiny.run(TRAIN, capsys)
    assert rc == 0 and line["correct"] is False, line["checks"]


@pytest.mark.parametrize("config", [None, DENSE],
                         ids=[SERVE, "internlm2-20b.serve-chat"])
def test_altered_tokens_fail(config, capsys):
    with faults.altered_tokens(every=1):
        rc, line, _ = tiny.run(SERVE, capsys, config=config)
    assert rc == 0 and line["correct"] is False, line["checks"]


def test_bf16_window_runs(capsys):
    """The cells' own type at a tiny size: a whole line, finite readings
    (the limits are set at the cells' sizes, not at this one)."""
    import math
    rc, line, _ = tiny.run(TRAIN, capsys, dtype="bfloat16")
    assert rc == 0
    _shape(line, TRAIN, False)
    assert all(math.isfinite(c["value"]) for c in line["checks"].values())


def test_a_forbidden_module_withholds_the_result(capsys):
    rc, line, err = tiny.run(SERVE, capsys, seconds=0.5, forbidden=["jax"])
    assert rc != 0 and line is None and "jax" in err


def test_the_command_refuses_without_a_card():
    res = subprocess.run([sys.executable, "bench/run.py", "--workload",
                          TRAIN, "--seed", "1", "--seconds", "1",
                          "--trace", "0"], cwd=harness.ROOT,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode != 0 and res.stdout.strip() == ""
