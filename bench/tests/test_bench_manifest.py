"""BENCHMARK.json against the contract's shape, and the data-driven
harness: a new cell and a new metric are files found by name."""
import json
import re
import shutil

from bench import harness

MAN = harness.manifest()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
E2E = {m["name"]: m for m in MAN["end_to_end"]}
CELLS = {w["name"]: w for w in MAN["workloads"]}


def test_top_level_keys():
    assert set(MAN) == {"command", "paths", "run_seconds", "configs",
                        "workloads", "end_to_end", "per_layer"}
    assert MAN["paths"] == ["bench"]
    assert 1 <= MAN["run_seconds"] <= 51
    assert len(json.dumps(MAN)) < 64 * 1024


def test_names_and_units():
    names = [x["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for x in MAN[k]]
    assert all(NAME.match(n) for n in names)
    for k in ("configs", "workloads"):
        assert len({x["name"] for x in MAN[k]}) == len(MAN[k])
    metrics = MAN["end_to_end"] + MAN["per_layer"]
    assert len({m["name"] for m in metrics}) == len(metrics)
    for m in metrics:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for w in MAN["workloads"]:
        assert NAME.match(w["traffic"]) and NAME.match(w["config"])
        assert w["chips"] == 1 and 0 < len(w["why"]) <= 200


def test_bounds():
    assert "setup_s" in E2E and E2E["setup_s"]["bound"] <= 0.25
    for m in MAN["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")


def test_every_moves_is_reported_where_the_metric_is():
    for m in MAN["per_layer"]:
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        moved = E2E[m["moves"]]
        for cell in m["workloads"]:
            assert cell in CELLS
            assert cell in moved.get("workloads", [cell])
    layers = {m["layer"] for m in MAN["per_layer"]}
    assert all(0 < len(x) <= 200 and "\n" not in x for x in layers)


def test_every_cell_reports_enough_and_has_its_files():
    for name in CELLS:
        e2e = harness.metrics_of(name, MAN, False)
        assert "setup_s" in {m["name"] for m in e2e} and len(e2e) >= 2
        assert harness.metrics_of(name, MAN, True)
        c = harness.cell(name, MAN)
        assert c["work"]["kind"] in ("train", "serve")
    for m in MAN["per_layer"]:
        assert callable(harness.reader(m["name"]))


def test_each_config_has_a_cell_and_its_own_file():
    files = [c["file"] for c in MAN["configs"]]
    assert len(set(files)) == len(files)
    used = {w["config"] for w in MAN["workloads"]}
    for c in MAN["configs"]:
        assert c["name"] in used
        assert c["file"].startswith("bench/")
        cfg = json.loads((harness.ROOT / c["file"]).read_text())
        assert cfg["reduced"] == c["reduced"]
        assert not any(k.endswith(("_dim", "_rank", "_size"))
                       for k in c["reduced"])


def test_a_new_cell_and_metric_are_found_by_name(tmp_path):
    root = tmp_path / "repo"
    shutil.copytree(harness.ROOT / "bench", root / "bench",
                    ignore=shutil.ignore_patterns(".cache", "__pycache__"))
    man = json.loads(json.dumps(MAN))
    man["workloads"].append(dict(CELLS["rwkv6-3b.serve-chat"],
                                 name="rwkv6-3b.serve-bursty",
                                 traffic="bursty"))
    man["per_layer"].append({"name": "serve.new_metric", "unit": "ms",
                             "better": "lower", "source": "host_clock",
                             "layer": "serving engine",
                             "moves": "ttft_p50_ms",
                             "workloads": ["rwkv6-3b.serve-bursty"]})
    (root / "BENCHMARK.json").write_text(json.dumps(man))
    work = json.loads((root / "bench/workloads/rwkv6-3b.serve-chat.json")
                      .read_text())
    work["traffic"].update(on_s=2.0, off_s=6.0)
    (root / "bench/workloads/rwkv6-3b.serve-bursty.json").write_text(
        json.dumps(work))
    (root / "bench/metrics/serve.new_metric.py").write_text(
        "def read(ctx):\n    return 42.0\n")
    c = harness.cell("rwkv6-3b.serve-bursty", harness.manifest(root), root)
    assert c["work"]["traffic"]["off_s"] == 6.0
    specs = harness.metrics_of("rwkv6-3b.serve-bursty", man, True)
    assert "serve.new_metric" in {m["name"] for m in specs}
    assert harness.reader("serve.new_metric", root)({}) == 42.0
