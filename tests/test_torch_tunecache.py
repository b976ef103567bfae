"""The port's tuning cache (``repro_torch.core.tunecache``).

Mirrors the JAX-free parts of ``tests/test_tunecache.py``: fingerprints
that follow the program's content and shapes, not its values or the
identity of its lambdas; stale entries evicted; atomic writes; the LRU
bound; the per-device-class store keyed on the device (on CUDA, the
card's name).  The port keeps its own cache: ``REPRO_TORCH_TUNE_CACHE``,
never the reference's ``REPRO_TUNE_CACHE``.
"""
import json
import os

import numpy as np
import pytest
import torch

import repro_torch.core.tunecache as tunecache_mod
from repro_torch.core import (COST_MODEL_VERSION, Backend, NumpyHostBackend,
                              Program, TorchDeviceBackend, TuneCache,
                              backend_fingerprint, default_cache,
                              device_class_key, program_fingerprint, tune)
from repro_torch.polybench import build, build_3mm
from repro_torch.roofline.analysis import HW


@pytest.fixture(autouse=True)
def _isolated_port_cache(tmp_path, monkeypatch):
    monkeypatch.setenv("REPRO_TORCH_TUNE_CACHE", str(tmp_path / "port_tc"))


def _auto(p, **kw):
    kw.setdefault("backend", "numpy")
    kw.setdefault("reps", 1)
    return tune(p, **kw)


def _tuning_slots(tc):
    return [f for f in tc.path.glob("*.json")
            if not f.name.startswith("devclass--")]


# -- fingerprints ------------------------------------------------------------

def _kernel_prog(kernel=None, scale=2.0, name="fp"):
    p = Program(name)
    p.bind("x", np.ones((4, 4), np.float32))
    p.offload(lambda xp, x: {"y": x * scale}, reads=("x",), writes=("y",),
              name="k", kernel=kernel)
    p.host(lambda xp, y: {"o": y}, reads=("y",), writes=("o",), name="c")
    p.set_outputs("o")
    return p


@pytest.mark.parametrize("same,a,b", [
    (True, lambda: build_3mm(n=16)[0], lambda: build_3mm(n=16)[0]),
    (True, lambda: build_3mm(n=16)[0], lambda: build_3mm(n=16, seed=1)[0]),
    (False, lambda: build_3mm(n=16)[0], lambda: build_3mm(n=8)[0]),
    (True, lambda: _kernel_prog(), lambda: _kernel_prog()),
    (False, lambda: _kernel_prog(), lambda: _kernel_prog(scale=3.0)),
    (False, lambda: _kernel_prog(), lambda: _kernel_prog("rmsnorm")),
    (False, lambda: _kernel_prog(), lambda: _kernel_prog(name="other")),
], ids=["rebuilt", "new-values", "new-shape", "relabelled-lambdas",
        "edited-body", "kernel-tag", "renamed"])
def test_program_fingerprint(same, a, b):
    """Rebuilding a program (fresh lambda objects, new input values)
    keeps its fingerprint; a shape, a body, a kernel tag or a name
    changes it."""
    assert (program_fingerprint(a()) == program_fingerprint(b())) is same


def test_closure_captured_array_resize_changes_fingerprint():
    def make(n):
        w = np.ones((n,), np.float32)
        p = Program("capture")
        p.bind("x", np.ones((4,), np.float32))
        p.offload(lambda xp, x: {"y": x * w[:1].sum()}, reads=("x",),
                  writes=("y",), name="k")
        p.set_outputs("y")
        return p
    assert program_fingerprint(make(2000)) != program_fingerprint(make(4000))
    assert program_fingerprint(make(2000)) == program_fingerprint(make(2000))


def test_backend_keys_name_the_device(monkeypatch):
    cpu = TorchDeviceBackend(device="cpu")
    assert device_class_key(cpu) == "TorchDeviceBackend:torch:cpu"
    assert backend_fingerprint(cpu) \
        == "TorchDeviceBackend:torch:streams2:donateFalse:cpu"
    assert device_class_key(NumpyHostBackend()) \
        == "NumpyHostBackend:numpy:None"
    # twins of one device share the device-class store ...
    twins = [cpu.variant(n_streams=s, donate=d) for s in (1, 3, 4)
             for d in (False, True)]
    assert {device_class_key(b) for b in twins} == {device_class_key(cpu)}
    assert len({backend_fingerprint(b) for b in twins}) == len(twins)

    # ... and a card's key carries its name (a stand-in for a CUDA
    # backend: the key reads only the class, name and device)
    class Card(TorchDeviceBackend):
        def __init__(self, device):
            Backend.__init__(self)
            self.device = torch.device(device)
            self.n_streams, self.donate = 2, False

    monkeypatch.setattr(torch.cuda, "get_device_name",
                        lambda dev=None: "NVIDIA H100 80GB HBM3")
    card = Card("cuda:0")
    assert device_class_key(card) \
        == "Card:torch:cuda:0:NVIDIA H100 80GB HBM3"
    assert "None" not in backend_fingerprint(card)


# -- hits, misses and stale entries ------------------------------------------

def test_second_call_zero_measurements_identical_table():
    p, _ = build_3mm(n=16)
    pl1 = _auto(p)
    assert pl1.meta["tuning_cache"]["hit"] is False
    assert pl1.meta["tuning_cache"]["measurements"] > 0
    pl2 = _auto(p)
    assert pl2.meta["tuning_cache"] == {
        **pl2.meta["tuning_cache"], "hit": True, "measurements": 0}
    assert json.dumps(pl2.meta["tuning"], sort_keys=True) \
        == json.dumps(pl1.meta["tuning"], sort_keys=True)
    assert tuple(pl2.ops) == tuple(pl1.ops)
    for k in ("fuse_loops", "donate", "optimize", "kernel_variants"):
        assert pl2.meta[k] == pl1.meta[k], k


@pytest.mark.parametrize("kw,hit", [
    ({"refresh": True}, False), ({"cache": False}, False),
    ({"top_k": 1}, False), ({}, True)])
def test_cache_protocol(kw, hit):
    p, _ = build_3mm(n=16)
    _auto(p)
    pl = _auto(p, **kw)
    assert pl.meta["tuning_cache"]["hit"] is hit
    assert (pl.meta["tuning_cache"]["measurements"] == 0) is hit


def test_measure_off_bypasses_and_keeps_the_measured_entry():
    p, _ = build_3mm(n=16)
    _auto(p)
    pl = tune(p, backend="numpy", measure=False)
    assert all(c["measured_s"] is None
               for c in pl.meta["tuning"]["candidates"])
    assert _auto(p).meta["tuning_cache"]["hit"] is True


def test_program_edit_evicts_the_stale_entry(tmp_path):
    tc = TuneCache(tmp_path / "edit")
    _auto(_kernel_prog(scale=2.0, name="editme"), cache=tc)
    assert len(_tuning_slots(tc)) == 1
    pl = _auto(_kernel_prog(scale=3.0, name="editme"), cache=tc)
    assert pl.meta["tuning_cache"]["hit"] is False
    assert len(_tuning_slots(tc)) == 1          # overwritten, not added


def test_stale_fingerprint_lookup_deletes(tmp_path):
    tc = TuneCache(tmp_path / "stale")
    tc.store("slot", "fp-old", {"v": 1})
    assert tc.lookup("slot", "fp-new") is None
    assert not tc._slot_path("slot").exists()


def test_cost_model_version_bump_invalidates(monkeypatch):
    p, _ = build_3mm(n=16)
    _auto(p)
    monkeypatch.setattr(tunecache_mod, "COST_MODEL_VERSION",
                        COST_MODEL_VERSION + 1000)
    pl = _auto(p)
    assert pl.meta["tuning_cache"]["hit"] is False


def test_backend_swap_is_a_distinct_slot(tmp_path):
    p, _ = build_3mm(n=16)
    tc = TuneCache(tmp_path / "be")
    cpu = TorchDeviceBackend(device="cpu")
    _auto(p, cache=tc)
    assert _auto(p, backend=cpu, cache=tc).meta["tuning_cache"]["hit"] \
        is False
    assert _auto(p, cache=tc).meta["tuning_cache"]["hit"] is True
    assert _auto(p, backend=cpu, cache=tc).meta["tuning_cache"]["hit"] \
        is True


def test_corrupt_payload_is_evicted_and_remeasured(tmp_path):
    p, _ = build_3mm(n=16)
    tc = TuneCache(tmp_path / "corrupt")
    _auto(p, cache=tc)
    (slot,) = _tuning_slots(tc)
    entry = json.loads(slot.read_text())
    entry["payload"]["tuning"]["chosen"] = "no/such/label"
    slot.write_text(json.dumps(entry))
    pl = _auto(p, cache=tc)
    assert pl.meta["tuning_cache"]["hit"] is False
    assert pl.meta["tuning_cache"]["measurements"] > 0


# -- location and isolation --------------------------------------------------

def test_port_env_var_and_default_directory(monkeypatch, tmp_path):
    monkeypatch.chdir(tmp_path)
    monkeypatch.setenv("REPRO_TORCH_TUNE_CACHE", str(tmp_path / "mine"))
    monkeypatch.setenv("REPRO_TUNE_CACHE", str(tmp_path / "reference"))
    assert default_cache().path == tmp_path / "mine"
    monkeypatch.setenv("REPRO_TORCH_TUNE_CACHE", "off")
    assert default_cache() is None
    monkeypatch.setenv("XDG_CACHE_HOME", str(tmp_path / "xdg"))
    assert TuneCache().path == tmp_path / "xdg" / "repro_torch" / "tunecache"
    assert not (tmp_path / "off").exists()
    monkeypatch.delenv("REPRO_TORCH_TUNE_CACHE")
    assert default_cache().path == tmp_path / "xdg" / "repro_torch" \
        / "tunecache"


def test_tune_writes_only_the_port_cache(monkeypatch, tmp_path):
    monkeypatch.setenv("REPRO_TORCH_TUNE_CACHE", str(tmp_path / "port"))
    monkeypatch.setenv("REPRO_TUNE_CACHE", str(tmp_path / "reference"))
    pl = _auto(build_3mm(n=16)[0])
    assert pl.meta["tuning_cache"]["path"] == str(tmp_path / "port")
    assert list((tmp_path / "port").glob("*.json"))
    assert not (tmp_path / "reference").exists()


# -- atomic writes and the LRU bound -----------------------------------------

def test_store_is_atomic(tmp_path, monkeypatch):
    tc = TuneCache(tmp_path / "atomic")
    tc.store("slot", "fp", {"v": 1})

    def boom(*a, **k):
        raise RuntimeError("disk full")
    monkeypatch.setattr(tunecache_mod.json, "dump", boom)
    with pytest.raises(RuntimeError):
        tc.store("slot", "fp", {"v": 2})
    monkeypatch.undo()
    assert tc.lookup("slot", "fp") == {"v": 1}
    assert not list(tc.path.glob("*.tmp"))


def test_lru_evicts_oldest_past_cap(tmp_path):
    tc = TuneCache(tmp_path / "lru", max_entries=4)
    for i in range(6):
        tc.store(f"slot-{i:03d}", "fp", {"i": i})
        os.utime(tc._slot_path(f"slot-{i:03d}"), (i, i))
    assert len(list(tc.path.glob("*.json"))) == 4
    assert tc.lookup("slot-000", "fp") is None
    assert tc.lookup("slot-001", "fp") is None
    assert tc.lookup("slot-005", "fp") == {"i": 5}


def test_lru_lookup_touches_entry(tmp_path):
    tc = TuneCache(tmp_path / "lru2", max_entries=2)
    tc.store("a", "fp", {"v": "a"})
    os.utime(tc._slot_path("a"), (1, 1))
    tc.store("b", "fp", {"v": "b"})
    os.utime(tc._slot_path("b"), (2, 2))
    assert tc.lookup("a", "fp") == {"v": "a"}
    tc.store("c", "fp", {"v": "c"})
    assert tc.lookup("a", "fp") == {"v": "a"}
    assert tc.lookup("b", "fp") is None


@pytest.mark.parametrize("cap,writes,left", [(1, 3, 1), (0, 5, 5)])
def test_lru_cap_edges(tmp_path, cap, writes, left):
    tc = TuneCache(tmp_path / "lru3", max_entries=cap)
    for i in range(writes):
        tc.store(f"slot-{i}", "fp", {"i": i})
    assert len(list(tc.path.glob("*.json"))) == left
    assert tc.lookup(f"slot-{writes - 1}", "fp") == {"i": writes - 1}


def test_env_var_sets_cap(tmp_path, monkeypatch):
    monkeypatch.setenv("REPRO_TORCH_TUNE_CACHE_MAX", "3")
    monkeypatch.setenv("REPRO_TUNE_CACHE_MAX", "7")
    assert TuneCache(tmp_path / "cap").max_entries == 3
    monkeypatch.setenv("REPRO_TORCH_TUNE_CACHE_MAX", "not-a-number")
    assert TuneCache(tmp_path / "cap2").max_entries \
        == tunecache_mod._DEFAULT_MAX_ENTRIES


# -- the per-device-class store ----------------------------------------------

def test_calibration_store_per_device_class(tmp_path, monkeypatch):
    tc = TuneCache(tmp_path / "cal")
    cpu = TorchDeviceBackend(device="cpu")
    key = device_class_key(cpu)
    tc.store_calibration(key, HW, {"pcie_bw": 9e9})
    assert tc.load_calibration(key, HW) == {"pcie_bw": 9e9}
    assert tc.load_calibration(device_class_key(cpu.variant(n_streams=4)),
                               HW) == {"pcie_bw": 9e9}
    assert tc.load_calibration(device_class_key(NumpyHostBackend()),
                               HW) is None
    monkeypatch.setattr(tunecache_mod, "COST_MODEL_VERSION",
                        COST_MODEL_VERSION + 1000)
    assert tc.load_calibration(key, HW) is None


def test_fitted_constants_price_the_next_program(tmp_path):
    tc = TuneCache(tmp_path / "next")
    be = NumpyHostBackend()
    fitted = {"pcie_bw": 123e9, "launch_overhead_s": 7e-5,
              "sync_overhead_s": 3e-6}
    tc.store_calibration(device_class_key(be), HW, fitted)
    p, _ = build_3mm(n=16)
    pl = tune(p, backend=be, reps=1, cache=tc)
    assert pl.meta["tuning"]["hw"]["pcie_bw"] == 123e9
    pl2 = tune(p, backend=be, reps=1, cache=tc, use_calibration=False)
    assert pl2.meta["tuning"]["hw"]["pcie_bw"] == HW["pcie_bw"]


def test_measured_rows_hold_one_out_and_cap(tmp_path, monkeypatch):
    tc = TuneCache(tmp_path / "rows")
    key = "NumpyHostBackend:numpy:None"
    monkeypatch.setattr(TuneCache, "_MAX_DEVCLASS_PROGRAMS", 2)
    for i in range(3):
        tc.add_measured_rows(key, HW, f"fp{i}", f"prog{i}",
                             [{"measured_s": float(i + 1)}])
    rows = tc.load_measured_rows(key, HW)
    assert [r["program"] for r in rows] == ["prog1", "prog2"]
    assert [r["program"] for r in
            tc.load_measured_rows(key, HW, exclude_fp="fp2")] == ["prog1"]
    tc.store_predictor(key, HW, {"coef": {"flops": 1.0}})
    assert tc.load_predictor(key, HW) == {"coef": {"flops": 1.0}}


def test_cold_start_predictor_from_two_other_programs(tmp_path):
    """Measured rows of two programs train a predictor that prices a
    third, unmeasured program (recorded, and used for ranking)."""
    tc = TuneCache(tmp_path / "cold")
    for prog in (build_3mm(n=16)[0], build("gemm", n=16, iters=4)[0]):
        _auto(prog, cache=tc)
    pl = tune(build("2mm", n=16)[0], backend="numpy", measure=False,
              cache=tc)
    pred = pl.meta["tuning"]["predictor"]
    assert pred["n_programs"] == 2 and pred["source"] in ("fit", "cache")
    assert pred["used_for_ranking"] is True
    assert all("predictor_s" in c for c in pl.meta["tuning"]["candidates"]
               if c["valid"])
