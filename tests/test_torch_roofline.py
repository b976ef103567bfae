"""The port's roofline pricing and residency walk against the reference's.

``repro_torch.roofline.analysis`` carries the reference's cost model with
an H100 hardware table; every function it shares with
``repro.roofline.analysis`` must give the reference's numbers on the same
inputs (with the same constants passed in), and the table itself must
hold none of the reference's TPU figures.
"""
import json
import pathlib

import numpy as np
import pytest

import repro.configs as ref_configs
import repro.core as ref_core
import repro.polybench as ref_polybench
import repro.roofline.analysis as ref
import repro_torch.configs as port_configs
import repro_torch.core as port_core
import repro_torch.polybench as port_polybench
import repro_torch.roofline.analysis as port
from repro_torch.core import (DeviceResidency, NumpyHostBackend,
                              ResidencyStats, TorchDeviceBackend,
                              plan_peak_device_bytes)

GOLDEN = pathlib.Path(__file__).resolve().parent / "golden"
CAL = json.loads((GOLDEN / "calibration_3mm.json").read_text())
RTOL = 1e-9
ARCHS = ("qwen2.5-14b", "rwkv6-3b", "recurrentgemma-2b")


def test_hw_is_an_h100_table_without_tpu_figures():
    assert set(port.HW) == set(ref.HW)
    assert port.HW["peak_flops_bf16"] == 989e12
    assert port.HW["hbm_bw"] == 3.35e12
    assert port.HW["pcie_bw"] == 64e9
    assert port.HW["ici_bw"] == 450e9
    for k, v in ref.HW.items():
        assert port.HW[k] != v, k
    assert port.CALIBRATABLE == ref.CALIBRATABLE
    assert port.ENERGY_TERMS == ref.ENERGY_TERMS
    assert port.PREDICTOR_FEATURES == ref.PREDICTOR_FEATURES


def test_fit_on_the_calibration_golden_equals_reference():
    rows = [dict(r) for r in CAL["rows"]]
    want = ref.fit_offload_constants(rows, hw=dict(ref.HW))
    got = port.fit_offload_constants(rows, hw=dict(ref.HW))
    assert got.keys() == want.keys()
    for k in want:
        assert got[k] == pytest.approx(want[k], rel=RTOL), k
    # the generating constants come back whichever defaults seed the fit
    fitted = port.fit_offload_constants(rows)
    for k, v in CAL["true_hw"].items():
        assert fitted[k] == pytest.approx(v, rel=1e-6), k
    assert fitted["ici_bw"] == port.HW["ici_bw"]      # no collective column
    assert port.fit_offload_constants(rows[:2]) is None


@pytest.mark.parametrize("seed", range(3))
def test_rank_correlation_equals_reference(seed):
    rng = np.random.default_rng(seed)
    xs = rng.integers(0, 6, 25).astype(float)          # with ties
    ys = xs + rng.standard_normal(25)
    assert port.rank_correlation(xs, ys) \
        == pytest.approx(ref.rank_correlation(xs, ys), rel=RTOL)
    assert port.rank_correlation([1, 1, 1], [1, 2, 3]) == 0.0
    with pytest.raises(ValueError):
        port.rank_correlation([1, 2], [1])


def _candidate_rows(seed):
    rng = np.random.default_rng(seed)
    rows = []
    for prog in ("a", "b", "c"):
        for _ in range(6):
            r = {f: float(rng.uniform(0, 1e6)) for f in
                 port.PREDICTOR_FEATURES}
            r["config"] = {"n_streams": int(rng.integers(1, 5)),
                           "fuse_loops": bool(rng.integers(2)),
                           "donate": bool(rng.integers(2))}
            r["measured_s"] = float(rng.uniform(1e-4, 1e-2))
            r["program"] = prog
            rows.append(r)
    return rows


@pytest.mark.parametrize("seed", range(2))
def test_candidate_predictor_equals_reference(seed):
    rows = _candidate_rows(seed)
    want = ref.fit_candidate_predictor(rows)
    got = port.fit_candidate_predictor(rows)
    assert got.keys() == want.keys()
    assert got["coef"].keys() == want["coef"].keys()
    for k, v in want["coef"].items():
        assert got["coef"][k] == pytest.approx(v, rel=1e-7), k
    assert got["intercept"] == pytest.approx(want["intercept"], rel=1e-7,
                                             abs=1e-12)
    for r in rows:
        assert port.candidate_features(r) == ref.candidate_features(r)
        assert port.predict_candidate_s(got, r) == pytest.approx(
            ref.predict_candidate_s(want, r), rel=1e-6, abs=1e-12)
    assert port.fit_candidate_predictor(rows[:6]) is None   # one program


@pytest.mark.parametrize("shape", sorted(port_configs.SHAPES))
@pytest.mark.parametrize("arch", ARCHS)
def test_analytic_model_terms_equal_reference(arch, shape):
    pc, rc = port_configs.get_config(arch), ref_configs.get_config(arch)
    ps, rs = port_configs.SHAPES[shape], ref_configs.SHAPES[shape]
    assert port.analytic_model_flops(pc, ps) \
        == pytest.approx(ref.analytic_model_flops(rc, rs), rel=RTOL)
    for n_dev, kv in ((1, 2), (8, 1)):
        assert port.analytic_hbm_bytes(pc, ps, n_dev, kv_bytes=kv) \
            == pytest.approx(ref.analytic_hbm_bytes(rc, rs, n_dev,
                                                    kv_bytes=kv), rel=RTOL)


@pytest.mark.parametrize("terms", [
    (1e6, 2e5, 7, 3, 1e9, 4e7, 0.0), (0, 0, 1, 0, 0.0, 0.0, 0.0),
    (3e8, 1e8, 40, 12, 5e12, 1e9, 2e8)])
def test_offload_cost_terms_equal_reference(terms):
    want = ref.offload_cost_terms(*terms, hw=dict(ref.HW))
    got = port.offload_cost_terms(*terms, hw=dict(ref.HW))
    assert got.keys() == want.keys()
    for k in want:
        assert got[k] == pytest.approx(want[k], rel=RTOL), k
    own = port.offload_cost_terms(*terms)
    assert own["transfer_s"] == (terms[0] + terms[1]) / port.HW["pcie_bw"]


@pytest.mark.parametrize("kernel,shapes,itemsizes", [
    ("flash_attention", [(1, 128, 1, 1, 8), (1, 128, 1, 8),
                         (1, 128, 1, 8)], [4, 4, 4]),
    ("wkv6", [(1, 64, 2, 16)] * 4 + [(2, 16)], [4] * 5),
    ("rglru_scan", [(1, 256, 64), (1, 256, 64)], [4, 4]),
    ("rmsnorm", [(512, 64), (64,)], [4, 4]),
])
def test_kernel_roofline_terms_equal_reference(kernel, shapes, itemsizes):
    from repro.kernels import variants as ref_variants

    from repro_torch.kernels import variants as port_variants
    vs = port_variants.variants_for(kernel, shapes, itemsizes)
    assert [v.params for v in vs] == [
        v.params for v in ref_variants.variants_for(kernel, shapes,
                                                    itemsizes)]
    for v in vs:
        want = ref.kernel_roofline_terms(kernel, v.params, shapes, itemsizes,
                                         hw=dict(ref.HW))
        got = port.kernel_roofline_terms(kernel, v.params, shapes,
                                         itemsizes, hw=dict(ref.HW))
        assert got == want


@pytest.mark.parametrize("policy", ["optimized", "naive", "grouped",
                                    "pipeline"])
@pytest.mark.parametrize("name", ["3mm", "gemm", "covariance", "jacobi2d",
                                  "attn_step"])
def test_peak_device_bytes_equal_reference(name, policy):
    if name == "attn_step":
        from repro.optim.offload import attention_step_program as ref_b

        from repro_torch.optim.offload import attention_step_program as pb
        pr, pp = ref_b(2), pb(2)
    else:
        pr = ref_polybench.build(name, n=32)[0]
        pp = port_polybench.build(name, n=32)[0]
    ra, pa = ref_core.analyze(pr), port_core.analyze(pp)
    rpl = ref_core.plan(pr, policy=policy, analysis=ra)
    ppl = port_core.plan(pp, policy=policy, analysis=pa)
    for donate in (False, True):
        want = ref_core.plan_peak_device_bytes(rpl, donate=donate,
                                               shapes=ra.shapes)
        got = plan_peak_device_bytes(ppl, donate=donate, shapes=pa.shapes)
        assert got == want


@pytest.mark.parametrize("make", [
    NumpyHostBackend, lambda: TorchDeviceBackend(device="cpu"),
    lambda: "cpu"], ids=["numpy", "torch-cpu", "device-cpu"])
def test_device_residency_round_trip(make):
    spec = make()
    res = (DeviceResidency("cpu") if spec == "cpu"
           else DeviceResidency(backend=spec))
    a = np.arange(12, dtype=np.float32).reshape(3, 4)
    res.put_host("a", a)
    assert not res.resident("a")
    res.prefetch("a")
    res.prefetch("a")                       # already resident: elided
    res.wait("a")
    assert res.resident("a")
    dev = res.device_value("a")
    res.put_device("b", dev * 2)
    np.testing.assert_array_equal(res.fetch("b"), a * 2)
    np.testing.assert_array_equal(res.fetch("b"), a * 2)   # host valid
    res.release()
    assert not res.resident("a")
    assert res.stats == ResidencyStats(
        h2d_transfers=1, h2d_bytes=48, d2h_transfers=1, d2h_bytes=48,
        elided=2, h2d_time=res.stats.h2d_time, d2h_time=res.stats.d2h_time)
