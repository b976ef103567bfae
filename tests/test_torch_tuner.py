"""The port's plan-space tuner against the reference's.

``plan(p, policy="auto")`` in the port walks the same grid, prunes into
the same execution classes and ranks by the same cost model as the
reference; only the hardware table (an H100's, not a TPU's) and the way
block FLOPs are counted (``FlopCounterMode`` instead of parsed HLO)
differ.  So with the reference's ``HW`` substituted inside a test, the
two ``measure=False`` tables must agree label for label: ranks, aliases,
predicted seconds and joules (rel 1e-9), peak bytes, winners and Pareto
points.  The per-block FLOP counts must equal the reference's exactly.

Every test here isolates the port's tuning cache in its own directory
(``REPRO_TORCH_TUNE_CACHE``), as ``tests/conftest.py`` does for the
reference's.
"""
import json
import pathlib
import sys

import numpy as np
import pytest
import torch

import repro.core as ref_core
import repro.optim.offload as ref_offload
import repro.polybench as ref_polybench
import repro.roofline.analysis as ref_roofline
import repro_torch.core as port_core
import repro_torch.core.tuner as port_tuner
import repro_torch.optim.offload as port_offload
import repro_torch.polybench as port_polybench
import repro_torch.roofline.analysis as port_roofline
from repro.core.tuner import _block_flops as ref_block_flops
from repro_torch.core import (PlanConfig, ShapeDtype, TorchDeviceBackend,
                              TuneCache, execute, plan, predict_cost,
                              run_host_oracle, tune, winner_exec_kwargs)

ROOT = pathlib.Path(__file__).resolve().parents[1]
GOLDEN = ROOT / "tests" / "golden"
sys.path.insert(0, str(ROOT / "benchmarks"))
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402
import directive_micro as ref_dm  # noqa: E402
import port_directive_micro as port_dm  # noqa: E402

QUICK_N, QUICK_ITERS = 256, 4      # the tuning gate's sizes
TABLE_RTOL = 1e-9
# qwen2.5-14b's attention width, the chip run's attn_step shape
QWEN_ATTN = (1, 4096, 4096, 8, 5, 128)


@pytest.fixture(autouse=True)
def _isolated_port_cache(tmp_path, monkeypatch):
    monkeypatch.setenv("REPRO_TORCH_TUNE_CACHE", str(tmp_path / "port_tc"))


def _gate(pkg_dm, build_3mm, attention_step_program):
    saved = pkg_dm.N, pkg_dm.ITERS
    pkg_dm.N, pkg_dm.ITERS = QUICK_N, QUICK_ITERS
    try:
        return {"fig4_advancedload": pkg_dm._advancedload_prog(),
                "fig5_delegatestore": pkg_dm._delegatestore_prog(),
                "table2_3mm": build_3mm(n=QUICK_N)[0],
                "attn_step": attention_step_program(n_steps=1)}
    finally:
        pkg_dm.N, pkg_dm.ITERS = saved


def ref_gate(name):
    return _gate(ref_dm, ref_polybench.build_3mm,
                 ref_offload.attention_step_program)[name]


def port_gate(name):
    return _gate(port_dm, port_polybench.build_3mm,
                 port_offload.attention_step_program)[name]


GATE = ("attn_step", "fig4_advancedload", "fig5_delegatestore", "table2_3mm")


@pytest.fixture()
def reference_hw(monkeypatch):
    """The reference's HW table in the port, wherever the port reads it."""
    hw = dict(ref_roofline.HW)
    monkeypatch.setattr(port_roofline, "HW", hw)
    monkeypatch.setattr(port_tuner, "HW", hw)
    return hw


# -- per-block FLOPs ---------------------------------------------------------

BLOCK_FLOP_PROGRAMS = (
    *[(name, lambda name=name: ref_polybench.build(name)[0],
       lambda name=name: port_polybench.build(name)[0])
      for name in sorted(ref_polybench.PROBLEMS)],
    *[(name, lambda name=name: ref_gate(name),
       lambda name=name: port_gate(name)) for name in GATE])


@pytest.mark.parametrize("name,build_ref,build_port", BLOCK_FLOP_PROGRAMS,
                         ids=[p[0] for p in BLOCK_FLOP_PROGRAMS])
def test_block_flops_equal_reference(name, build_ref, build_port):
    """FlopCounterMode with the mv/dot formulas counts what the
    reference's HLO parse counts, block for block (the matrix-vector
    problems would count 0 without them)."""
    pr, pp = build_ref(), build_port()
    want = ref_block_flops(pr, ref_core.analyze(pr).shapes)
    got = port_roofline.block_flops(pp, port_core.analyze(pp).shapes)
    assert got == want
    assert len(got) == len(pp.offload_blocks())


def test_block_flops_kernel_and_untraceable_blocks_count_zero():
    p = port_gate("attn_step")
    flops = port_roofline.block_flops(p, port_core.analyze(p).shapes)
    kernel = [b.idx for b in p.offload_blocks() if b.kernel]
    assert kernel and all(flops[i] == 0.0 for i in kernel)

    q = port_core.Program("broken")
    q.bind("A", np.ones((4, 4), np.float32))
    q.offload(lambda xp, A: {"B": A @ A}, reads=("A",), writes=("B",),
              name="ok")
    q.set_outputs("B")
    shapes = port_core.analyze(q).shapes
    q.blocks[0].fn = lambda xp, A: {"B": xp.no_such_op(A)}
    assert port_roofline.block_flops(q, shapes) == {0: 0.0}


# -- the measure=False tables ------------------------------------------------

def _survivors(tuning):
    return [c for c in tuning["candidates"]
            if c["valid"] and c["alias_of"] is None]


@pytest.mark.parametrize("name", GATE)
def test_tuning_table_equals_reference(name, reference_hw):
    want = ref_core.tune(ref_gate(name), backend="numpy", measure=False,
                         cache=False).meta["tuning"]
    got = tune(port_gate(name), backend="numpy", measure=False,
               cache=False).meta["tuning"]
    assert [c["label"] for c in got["candidates"]] \
        == [c["label"] for c in want["candidates"]]
    for g, w in zip(got["candidates"], want["candidates"]):
        for k in ("valid", "alias_of", "rank", "peak_bytes", "aliases"):
            assert g[k] == w[k], (g["label"], k)
        for k in ("predicted_s", "energy_j", "analytic_s"):
            if w.get(k) is None:
                assert g.get(k) is None
            else:
                assert g[k] == pytest.approx(w[k], rel=TABLE_RTOL), \
                    (g["label"], k)
    assert got["winners"] == want["winners"]
    assert [p["label"] for p in got["pareto"]] \
        == [p["label"] for p in want["pareto"]]
    assert got["pruned_invalid"] == want["pruned_invalid"]
    assert got["chosen"] == want["chosen"]

    golden = json.loads((GOLDEN / "tuning_baseline.json").read_text())
    tol = golden["rel_tol"]
    g = golden["programs"][name]
    for tuning in (got, want):
        valid = [c for c in tuning["candidates"] if c["valid"]]
        top = next(c for c in valid if c["rank"] == 1)
        assert top["label"] == g["predicted_winner"]
        assert top["predicted_s"] == pytest.approx(g["predicted_s"], rel=tol)
        assert top["energy_j"] == pytest.approx(g["energy_j"], rel=tol)
        assert top["peak_bytes"] == pytest.approx(g["peak_bytes"], rel=tol)
        assert len(valid) == g["n_valid"]
        assert port_dm.n_kernel_variants(valid) == g["n_kernel_variants"]
        assert tuning["winners"] == g["winners"]
        assert len(tuning["pareto"]) == g["n_pareto"]


def _ref_attn_qwen():
    import jax
    p = ref_offload.attention_step_program(2)
    B, S, T, K, G, D = QWEN_ATTN
    for n, shape in (("q", (B, S, K, G, D)), ("k", (B, T, K, D)),
                     ("v", (B, T, K, D))):
        p.inputs[n] = jax.ShapeDtypeStruct(shape, np.float32)
    return p


def _port_attn_qwen():
    p = port_offload.attention_step_program(2)
    B, S, T, K, G, D = QWEN_ATTN
    for n, shape in (("q", (B, S, K, G, D)), ("k", (B, T, K, D)),
                     ("v", (B, T, K, D))):
        p.inputs[n] = ShapeDtype(shape, np.dtype(np.float32))
    return p


# the chip run's tuner programs: (a) 3mm at n = 2048, (b) attn_step at
# qwen2.5-14b's attention width (abstract inputs: only shapes matter),
# (c) the four gate programs at the gate's sizes
CHIP_PROGRAMS = {
    "table2_3mm_n2048": (lambda: ref_polybench.build_3mm(n=2048)[0],
                         lambda: port_polybench.build_3mm(n=2048)[0]),
    "attn_step_qwen": (_ref_attn_qwen, _port_attn_qwen),
    **{f"gate_{n}": (lambda n=n: ref_gate(n), lambda n=n: port_gate(n))
       for n in GATE},
}


@pytest.mark.parametrize("name", sorted(CHIP_PROGRAMS))
def test_chip_tuner_constants_equal_reference(name):
    """Derives ``chip_smoke.TUNER_EXPECT``: the candidate count, the kernel
    tile variants and the execution classes left after pruning, as the
    reference's tuner gives them on its numpy backend.  The port's
    tuner gives the same on its own numpy backend and on the torch
    backend (neither donates).  The torch backend's kernels do not read
    the tile, so the measured programs run one class per tile-free
    class: the reference's classes over its tile variants (every class
    crosses every tile)."""
    build_ref, build_port = CHIP_PROGRAMS[name]
    want = ref_core.tune(build_ref(), backend="numpy", measure=False,
                         cache=False).meta["tuning"]
    got = tune(build_port(), backend="numpy", measure=False,
               cache=False).meta["tuning"]

    def counts(t):
        valid = [c for c in t["candidates"] if c["valid"]]
        return {"n_valid": len(valid),
                "n_kernel_variants": port_dm.n_kernel_variants(valid),
                "n_classes": len(_survivors(t))}
    torch_be = tune(build_port(), backend=TorchDeviceBackend(device="cpu"),
                    measure=False, cache=False).meta["tuning"]
    assert counts(got) == counts(want) == counts(torch_be)
    want = counts(want)
    n_measured = (0 if name.startswith("gate_") else
                  want["n_classes"] // want["n_kernel_variants"])
    assert want["n_classes"] % want["n_kernel_variants"] == 0
    assert {**want, "n_measured": n_measured} \
        == chip_smoke.TUNER_EXPECT[name]


def test_placements_wait_for_the_distributed_slice():
    """On a backend without a mesh, placements are labels only, as in the
    reference: the grid takes them, nothing is sharded and the plan
    records no mesh (mesh backends: tests/test_torch_mesh.py)."""
    p, _ = port_polybench.build_3mm(n=16)
    pl = tune(p, backend="numpy", measure=False, cache=False,
              placements=("replicate", "fsdp"))
    labels = {c["label"].rsplit("/", 1)[-1]
              for c in pl.meta["tuning"]["candidates"]}
    assert labels == {"replicate", "fsdp"}
    assert pl.meta["tuning"]["mesh"] is None and "mesh" not in pl.meta
    pl = tune(p, backend="numpy", measure=False, cache=False,
              configs=[PlanConfig(mesh_placement="fsdp")])
    assert pl.meta["tuning"]["chosen"].endswith("/fsdp")
    pl = tune(p, backend="numpy", measure=False, cache=False,
              placements=("",))
    assert pl.meta["tuning"]["mesh"] is None


# -- transfer bytes ----------------------------------------------------------

COST_GOLDEN = json.loads((GOLDEN / "cost_model.json").read_text())


@pytest.mark.parametrize("prog_key,builder", [
    ("3mm_n32", lambda: port_polybench.build_3mm(n=32)[0]),
    ("train_step_n4", lambda: port_offload.plan_step_program(n_steps=4)),
])
@pytest.mark.parametrize("policy", ["optimized", "naive"])
def test_predict_cost_matches_golden_and_execution(prog_key, builder,
                                                   policy):
    pl = plan(builder(), policy=policy)
    pred = predict_cost(pl, PlanConfig(policy=policy))
    for k, v in COST_GOLDEN[prog_key][policy].items():
        assert pred[k] == v, f"{prog_key}/{policy}/{k}"
    _, stats = execute(pl, backend=TorchDeviceBackend(device="cpu"))
    assert pred["h2d_bytes"] == stats.h2d_bytes
    assert pred["d2h_bytes"] == stats.d2h_bytes
    assert pred["loads"] == stats.h2d_transfers
    assert pred["stores"] == stats.d2h_transfers
    assert pred["syncs"] == stats.syncs


# -- measuring tune on the CPU -----------------------------------------------

def _close(got, want, rtol):
    scale = max(float(np.abs(want).max()), 1e-30)
    return float(np.abs(np.asarray(got, np.float64) - want).max()) \
        <= rtol * scale


MEASURED = {
    "3mm": lambda: port_polybench.build_3mm(n=32)[0],
    "attn_step": lambda: port_offload.attention_step_program(2),
}


@pytest.mark.parametrize("name", sorted(MEASURED))
def test_measuring_tune_on_cpu(name, tmp_path):
    be = TorchDeviceBackend(device="cpu")
    tc = TuneCache(tmp_path / "measured")
    p = MEASURED[name]()
    pl = tune(p, backend=be, reps=1, cache=tc)
    tuning, info = pl.meta["tuning"], pl.meta["tuning_cache"]
    survivors = _survivors(tuning)
    ran = {c["label"]: c for c in survivors if "measured_as" not in c}
    assert info["hit"] is False and info["measurements"] == len(ran)
    assert pl.meta["verify"]["ok"]
    for c in survivors:
        assert c["measured_s"] > 0
        assert 0 <= c["measured_kernel_s"] <= c["measured_s"]
        if "measured_as" in c:     # a tile class: its launches ran once
            same = ran[c["measured_as"]]
            assert c["label"] != same["label"]
            assert c["rank"] > same["rank"]
            assert (c["measured_s"], c["measured_kernel_s"]) \
                == (same["measured_s"], same["measured_kernel_s"])
    # the torch backend's kernels do not read the tile: one measured
    # class per tile-free class
    tiles = len({json.dumps(c["config"]["kernel_variants"])
                 for c in survivors})
    assert len(ran) * tiles == len(survivors)
    out, _ = execute(pl, **winner_exec_kwargs(pl, be))
    oracle = run_host_oracle(p)
    for k in p.outputs:
        assert _close(out[k], oracle[k], 1e-5), k

    again = tune(p, backend=be, reps=1, cache=tc)
    assert again.meta["tuning_cache"]["hit"] is True
    assert again.meta["tuning_cache"]["measurements"] == 0
    assert json.dumps(again.meta["tuning"], sort_keys=True) \
        == json.dumps(tuning, sort_keys=True)
    assert tuple(again.ops) == tuple(pl.ops)

    fresh = tune(p, backend=be, reps=1, cache=tc, refresh=True)
    assert fresh.meta["tuning_cache"]["hit"] is False
    assert fresh.meta["tuning_cache"]["measurements"] == len(ran)


def test_plan_auto_is_tune_and_fixed_policies_refuse_tuner_kwargs():
    p, _ = port_polybench.build_3mm(n=16)
    via_plan = plan(p, policy="auto", backend="numpy", measure=False,
                    cache=False)
    direct = tune(p, backend="numpy", measure=False, cache=False)
    assert via_plan.meta["tuning"] == direct.meta["tuning"]
    assert tuple(via_plan.ops) == tuple(direct.ops)
    pinned = plan(p, policy="auto", backend="numpy", measure=False,
                  cache=False, n_streams=3)
    assert {c["config"]["n_streams"]
            for c in pinned.meta["tuning"]["candidates"]} == {3}
    with pytest.raises(TypeError, match="tuner-only"):
        plan(p, backend="numpy")
    with pytest.raises(TypeError, match="tuner-only"):
        plan(p, policy="optimized", reps=3)


def test_measured_rows_train_the_device_class_store(tmp_path):
    """Measured candidates land in the per-device-class store keyed by
    the CPU device, and an accepted calibration prices the next tune."""
    be = TorchDeviceBackend(device="cpu")
    tc = TuneCache(tmp_path / "devclass")
    gemm, _ = port_polybench.build("gemm", n=16, iters=4)
    pl = tune(gemm, backend=be, reps=1, cache=tc)
    key = port_core.device_class_key(be)
    assert key == "TorchDeviceBackend:torch:cpu"
    rows = tc.load_measured_rows(key, port_roofline.HW)
    assert len(rows) == pl.meta["tuning_cache"]["measurements"]
    cal = pl.meta["tuning"]["calibration"]
    assert cal["n_rows"] == len(rows)
    if cal["accepted"]:
        assert tc.load_calibration(key, port_roofline.HW) == cal["fitted"]
        nxt = tune(port_polybench.build_3mm(n=16)[0], backend=be, reps=1,
                   cache=tc)
        assert nxt.meta["tuning"]["hw"]["pcie_bw"] == cal["fitted"]["pcie_bw"]


def test_objective_reselects_from_the_cached_table(tmp_path):
    be = TorchDeviceBackend(device="cpu")
    tc = TuneCache(tmp_path / "objective")
    p = port_offload.attention_step_program(1)
    first = tune(p, backend=be, reps=1, cache=tc)
    mem = tune(p, backend=be, reps=1, cache=tc, objective="memory")
    assert mem.meta["tuning_cache"]["hit"] is True
    assert mem.meta["tuning"]["chosen"] \
        == first.meta["tuning"]["winners"]["memory"]
    assert mem.meta["tuning"]["objective"] == "memory"


def test_flash_gradient_flows_through_the_tuned_block():
    """The kernel block's output carries a gradient on the CPU too: the
    attention step's loss differentiates back to q, k and v."""
    p = port_offload.attention_step_program(1)
    q, k, v = (torch.from_numpy(p.inputs[n]).requires_grad_()
               for n in "qkv")
    attn = next(b for b in p.offload_blocks() if b.kernel)
    o = attn.fn(torch, q=q, k=k, v=v)["o"]
    (o * o).sum().backward()
    assert all(t.grad is not None and torch.isfinite(t.grad).all()
               for t in (q, k, v))


# -- the port's gate and benchmark CLIs --------------------------------------

@pytest.fixture()
def gate():
    import port_check_tuning_baseline
    return port_check_tuning_baseline


@pytest.mark.parametrize("doctor", [None, "winner", "n_valid", "version"])
def test_port_tuning_gate(gate, monkeypatch, tmp_path, doctor):
    """The gate passes on this tree, and fails on a port golden whose
    winner changed, on a reference golden whose candidate count changed,
    and on a cost-model version drift."""
    current = gate.compute_baseline()
    assert gate.check(current) == []
    if doctor is None:
        return
    port = json.loads(gate.PORT_BASELINE_PATH.read_text())
    ref = json.loads(gate.REFERENCE_BASELINE_PATH.read_text())
    if doctor == "winner":
        port["programs"]["table2_3mm"]["predicted_winner"] = "bogus/label"
        want = "predicted_winner"
    elif doctor == "n_valid":
        ref["programs"]["attn_step"]["n_valid"] = 255
        want = "n_valid"
    else:
        port["cost_model_version"] += 1
        want = "version drift"
    for attr, doc, fname in (("PORT_BASELINE_PATH", port, "p.json"),
                             ("REFERENCE_BASELINE_PATH", ref, "r.json")):
        (tmp_path / fname).write_text(json.dumps(doc))
        monkeypatch.setattr(gate, attr, tmp_path / fname)
    problems = gate.check(current)
    assert problems and any(want in p for p in problems), problems


def test_port_benchmarks_run_on_the_host(tmp_path, monkeypatch):
    import port_polybench_suite
    import port_table2_3mm

    cpu = TorchDeviceBackend(device="cpu")
    row = port_table2_3mm.run(n=32, show_source=False, backend=cpu)
    assert (row["loads_opt"], row["loads_naive"]) == (4, 6)
    assert (row["stores_opt"], row["stores_naive"]) == (1, 3)
    assert row["bytes_opt"] < row["bytes_naive"]

    monkeypatch.setattr(port_polybench_suite, "REPS", 1)
    rows = port_polybench_suite.run_suite(cpu, scale=1 / 64)
    assert sorted(r["problem"] for r in rows) \
        == sorted(port_polybench.PROBLEMS)
    assert all(r["bytes_saved_vs_naive"] >= 0 for r in rows)

    monkeypatch.setattr(port_dm, "BACKEND", port_core.NumpyHostBackend())
    monkeypatch.setattr(port_dm, "N", QUICK_N)
    monkeypatch.setattr(port_dm, "ITERS", QUICK_ITERS)
    monkeypatch.setattr(port_dm, "REPS", 1)
    out = port_dm.bench_tuner(str(tmp_path / "report.json"))
    report = json.loads((tmp_path / "report.json").read_text())
    assert sorted(report["programs"]) == sorted(GATE)
    assert out["rows"]["attn_step"]["n_kernel_variants"] == 4
    assert all(r["measurements"] > 0 for r in out["rows"].values())
