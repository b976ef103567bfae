"""The port's paper-table harness, tuning trajectory and roofline report
against the reference's tools, on the CPU at small sizes.

  * ``benchmarks/port_run.py --device cpu`` prints the rows of
    ``benchmarks/run.py`` (both run here on the same small sizes, with the
    reference's train step stubbed: it takes minutes on the CPU): the
    same names in the same order, the same ``derived`` keys, and equal
    ``transfers=`` and ``bytes_saved=`` in every Fig. 6 row;
  * ``benchmarks/port_trajectory.py`` gives ``benchmarks/trajectory.py``'s
    regressions and notes for the same pair of snapshot dicts, and exits
    as it does under ``--gate``; each finds only its own snapshots;
  * ``port_directive_micro.write_bench_snapshot`` writes the reference
    snapshot's keys under ``BENCH_port_<YYYYMMDD>.json``;
  * ``benchmarks/port_roofline_report.py`` renders one row per dry-run
    record of ``run_cell(small=True)``, SKIP rows included, under the
    reference's columns.
"""
import functools
import json
import sys
import time
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "benchmarks"))

import port_directive_micro  # noqa: E402
import port_polybench_suite  # noqa: E402
import port_roofline_report  # noqa: E402
import port_run  # noqa: E402
import port_table2_3mm  # noqa: E402
import port_train_overlap  # noqa: E402
import port_trajectory  # noqa: E402


@pytest.fixture
def port_tune_cache(tmp_path, monkeypatch):
    monkeypatch.setenv("REPRO_TORCH_TUNE_CACHE", str(tmp_path / "tc"))


def _shrink(monkeypatch, table2, dm, poly, train):
    """One harness's pieces at small sizes: 3mm at n = 64, Figs. 4/5 at
    N = 256 with 4 iterations and one timed rep, the Polybench sizes
    × 1/16, 4 train steps."""
    monkeypatch.setattr(table2, "run", functools.partial(table2.run, n=64))
    for k, v in (("N", 256), ("ITERS", 4), ("REPS", 1)):
        monkeypatch.setattr(dm, k, v)
    monkeypatch.setattr(poly, "SIZES", {
        name: {k: (max(8, v // 16) if k == "n" else v)
               for k, v in size.items()}
        for name, size in poly.SIZES.items()})
    monkeypatch.setattr(poly, "REPS", 1)
    monkeypatch.setattr(train, "STEPS", 4)


def _ref_rows(monkeypatch, capsys, train_row):
    """``benchmarks/run.py``'s rows at the small sizes."""
    from benchmarks import (directive_micro, polybench_suite, run,
                            table2_3mm, train_overlap)
    _shrink(monkeypatch, table2_3mm, directive_micro, polybench_suite,
            train_overlap)
    monkeypatch.setattr(train_overlap, "run", lambda: train_row)
    capsys.readouterr()
    run.main()
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[0] == "name,us_per_call,derived"
    return [tuple(line.split(",", 2)) for line in lines[1:]]


def test_port_run_rows_are_the_reference_rows(monkeypatch, capsys,
                                              port_tune_cache):
    _shrink(monkeypatch, port_table2_3mm, port_directive_micro,
            port_polybench_suite, port_train_overlap)
    got = port_run.main(["--device", "cpu"])
    printed = capsys.readouterr().out.strip().splitlines()
    assert printed == ["name,us_per_call,derived"] + [",".join(r)
                                                       for r in got]
    by_name = {r[0]: port_run.parse_derived(r[2]) for r in got}
    t = by_name["train_overlap"]
    train_row = {"name": "train_overlap", "t_planned_ms": 1.0,
                 "t_sync_ms": 1.0, "speedup": 1.0,
                 "final_loss": float(t["final_loss"])}
    want = _ref_rows(monkeypatch, capsys, train_row)
    assert [r[0] for r in got] == [r[0] for r in want]
    for (name, _, d_got), (_, _, d_want) in zip(got, want):
        g, w = port_run.parse_derived(d_got), port_run.parse_derived(d_want)
        assert list(g) == list(w), name
        if name.startswith("fig6_"):
            assert (g["transfers"], g["bytes_saved"]) == \
                (w["transfers"], w["bytes_saved"]), name
            opt, naive = (int(x) for x in g["transfers"].split("/"))
            assert opt <= naive
    assert [r[0] for r in got][:3] == ["table2_3mm", "fig4_advancedload",
                                       "fig5_delegatestore"]
    assert len([r for r in got if r[0].startswith("fig6_")]) == 10
    assert torch.isfinite(torch.tensor(float(t["final_loss"])))


def test_port_run_needs_a_card_unless_cpu():
    if torch.cuda.is_available():
        pytest.skip("a card is present: port_run runs on it")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_run.rows()
    with pytest.raises(ValueError):
        port_run.rows("tpu")


def _snap(version, programs):
    return {"date": "2026-01-01", "cost_model_version": version,
            "params": {"N": 256, "ITERS": 4, "REPS": 1},
            "programs": programs}


def _row(measured=10.0, predicted=5.0, energy=1.0, peak=2.0):
    return {"measured_ms": measured, "predicted_ms": predicted,
            "energy_mj": energy, "peak_mb": peak}


# (previous, current) snapshot pairs: each verdict of the rules
PAIRS = {
    "steady": (_snap(1, {"a": _row()}), _snap(1, {"a": _row(10.5)})),
    "measured_regression": (_snap(1, {"a": _row()}),
                            _snap(1, {"a": _row(measured=12.0)})),
    "measured_faster": (_snap(1, {"a": _row()}),
                        _snap(1, {"a": _row(measured=5.0)})),
    "predicted_drift": (_snap(1, {"a": _row()}),
                        _snap(1, {"a": _row(predicted=7.0)})),
    "predicted_drift_new_model": (_snap(1, {"a": _row()}),
                                  _snap(2, {"a": _row(predicted=7.0)})),
    "energy_and_peak_drift": (_snap(1, {"a": _row()}),
                              _snap(1, {"a": _row(energy=2.0, peak=3.0)})),
    "missing_program": (_snap(1, {"a": _row(), "b": _row()}),
                        _snap(1, {"a": _row()})),
    "new_program": (_snap(1, {"a": _row()}),
                    _snap(1, {"a": _row(), "c": _row()})),
    "old_snapshot_without_objectives": (
        _snap(1, {"a": {"measured_ms": 10.0, "predicted_ms": 5.0}}),
        _snap(1, {"a": _row()})),
}


@pytest.mark.parametrize("case", sorted(PAIRS))
def test_trajectory_verdicts_are_the_reference_verdicts(case, tmp_path):
    from benchmarks import trajectory
    prev, curr = PAIRS[case]
    assert port_trajectory.diff(prev, curr) == trajectory.diff(prev, curr)
    codes = {}
    for tool, name in ((trajectory, "BENCH_{}.json"),
                       (port_trajectory, "BENCH_port_{}.json")):
        root = tmp_path / tool.__name__.replace(".", "_")
        root.mkdir()
        for date, snap in (("20260101", prev), ("20260102", curr)):
            (root / name.format(date)).write_text(json.dumps(snap))
        codes[tool] = [tool.main(["--root", str(root)] + gate)
                       for gate in ([], ["--gate"])]
    assert codes[port_trajectory] == codes[trajectory]
    assert codes[trajectory][0] == 0
    assert codes[trajectory][1] == (1 if trajectory.diff(prev, curr)[0]
                                    else 0)


def test_trajectory_finds_only_its_own_snapshots(tmp_path):
    from benchmarks import trajectory
    for name in ("BENCH_20260101.json", "BENCH_20260102.json",
                 "BENCH_port_20260101.json", "BENCH_port_serve_20260101.json",
                 "BENCH_port_2026010.json"):
        (tmp_path / name).write_text(json.dumps(_snap(1, {})))
    assert [Path(p).name for p in port_trajectory.find_snapshots(
        str(tmp_path))] == ["BENCH_port_20260101.json"]
    assert [Path(p).name for p in trajectory.find_snapshots(
        str(tmp_path))] == ["BENCH_20260101.json", "BENCH_20260102.json"]
    # one port snapshot: nothing to diff, never a failure
    assert port_trajectory.main(["--root", str(tmp_path), "--gate"]) == 0


def test_snapshot_has_the_reference_keys(tmp_path, monkeypatch):
    from benchmarks import directive_micro
    from repro_torch.core import COST_MODEL_VERSION
    rows = {"table2_3mm": _row()}
    monkeypatch.chdir(tmp_path)
    path = port_directive_micro.write_bench_snapshot(rows)
    assert path == f"BENCH_port_{time.strftime('%Y%m%d')}.json"
    assert port_trajectory._SNAP_RE.search(path)
    assert not __import__("benchmarks.trajectory").trajectory._SNAP_RE \
        .search(path)
    ref = json.loads(Path(directive_micro.write_bench_snapshot(
        rows, str(tmp_path / "ref.json"))).read_text())
    got = json.loads(Path(path).read_text())
    assert sorted(got) == sorted(ref)
    assert sorted(got["params"]) == sorted(ref["params"])
    assert got["programs"] == ref["programs"] == rows
    assert got["cost_model_version"] == COST_MODEL_VERSION
    assert got["date"] == ref["date"]


def test_roofline_report_renders_every_record(tmp_path):
    from benchmarks import roofline_report
    from repro_torch.configs import SHAPES, ShapeSpec
    from repro_torch.launch.dryrun import run_cell
    out = tmp_path / "dry"
    recs = [run_cell(arch, shape, "2x4", out, small=True)
            for arch, shape in (
                ("internlm2-20b", ShapeSpec("t", "train", 64, 8)),
                ("internlm2-20b", ShapeSpec("d", "decode", 64, 8)),
                ("rwkv6-3b", ShapeSpec("t", "train", 64, 8)),
                ("internlm2-20b", SHAPES["long_500k"]))]
    assert [r["status"] for r in recs] == ["OK", "OK", "OK", "SKIP"]
    text = port_roofline_report.main(["--mesh", "2x4", "--outdir",
                                      str(out)])
    lines = text.splitlines()
    ref_header = roofline_report.table([], "2x4").splitlines()
    assert lines[2:4] == ref_header
    body = lines[4:]
    assert len(body) == len(recs)
    assert sum("SKIP:" in line for line in body) == 1
    assert all(line.count("|") == ref_header[0].count("|") for line in body)
    assert all("params " in line and "opt " in line for line in body
               if "SKIP:" not in line)
    # records of other meshes and variants are not rows
    assert port_roofline_report.table(
        port_roofline_report.load("baseline", str(out)), "single") \
        .splitlines()[4:] == []
    assert port_roofline_report.load("other", str(out)) == []
