"""Execution parity: the port's executor against the reference's.

The port runs each plan on its numpy backend and on
``TorchDeviceBackend(device="cpu")``, interpreted and compiled; the
reference runs the same program on its ``jax`` backend (never
``pinned``, which fails on jax CPU builds).  Outputs must be allclose and
the logical transfer counts identical; within the port, compiled output
must equal interpreted output bitwise.  Plans also cross packages as
records (``plan_records`` / ``plan_from_records``) and execute with the
reference's counts.
"""
import json

import numpy as np
import pytest
import torch

import repro.core as ref_core
import repro.optim.offload as ref_offload
import repro.polybench as ref_polybench
import repro_torch.core as port_core
import repro_torch.optim.offload as port_offload
import repro_torch.polybench as port_polybench
from repro_torch.core import (NumpyHostBackend, PlanExecutionError,
                              TorchDeviceBackend, plan_from_records,
                              plan_records)

# fp32 everywhere; XLA, numpy's BLAS and torch sum products in different
# orders, so outputs differ by a few ulps of the output's own scale (the
# largest seen is 2.2e-7 of it): compare normwise, 1e-5 of the scale
NORM_RTOL = 1e-5

PROGRAMS = {
    **{name: (lambda name=name: ref_polybench.build(name, n=32)[0],
              lambda name=name: port_polybench.build(name, n=32)[0])
       for name in ref_polybench.PROBLEMS},
    "attn_step": (lambda: ref_offload.attention_step_program(1),
                  lambda: port_offload.attention_step_program(1)),
    "train_loop": (lambda: ref_offload.plan_step_program(3),
                   lambda: port_offload.plan_step_program(3)),
}

BACKENDS = {"numpy": NumpyHostBackend,
            "torch-cpu": lambda: TorchDeviceBackend(device="cpu")}


def _close(got, want, what=""):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, what
    scale = max(float(np.abs(want).max()), 1.0)
    err = float(np.abs(got.astype(np.float64) - want).max())
    assert err <= NORM_RTOL * scale, f"{what}: err {err} of scale {scale}"


@pytest.mark.parametrize("backend", sorted(BACKENDS))
@pytest.mark.parametrize("policy", ("optimized", "naive"))
@pytest.mark.parametrize("program", sorted(PROGRAMS))
def test_execute_matches_reference(program, policy, backend):
    build_ref, build_port = PROGRAMS[program]
    pr = ref_core.plan(build_ref(), policy=policy)
    out_r, s_r = ref_core.execute(pr, backend="jax")

    pp = port_core.plan(build_port(), policy=policy)
    be = BACKENDS[backend]()
    out_i, s_i = port_core.execute(pp, mode="interpreted", backend=be)
    out_c, s_c = port_core.execute(pp, mode="compiled", backend=be)

    assert s_i.transfer_counts() == s_r.transfer_counts()
    assert s_c.transfer_counts() == s_r.transfer_counts()
    assert sorted(out_i) == sorted(out_r)
    for k in out_r:
        np.testing.assert_array_equal(out_c[k], out_i[k], err_msg=k)
        _close(out_i[k], out_r[k], k)
        assert out_i[k].dtype == np.asarray(out_r[k]).dtype


@pytest.mark.parametrize("program", ("3mm", "gemm", "jacobi2d",
                                     "attn_step", "train_loop"))
def test_host_oracle_matches_reference(program):
    """run_host_oracle runs every block on numpy, the attention block too
    (its wrapper takes numpy arrays to the plain version)."""
    build_ref, build_port = PROGRAMS[program]
    want = ref_core.run_host_oracle(build_ref())
    got = port_core.run_host_oracle(build_port())
    assert sorted(got) == sorted(want)
    for k in want:
        _close(got[k], want[k], k)


@pytest.mark.parametrize("policy", ("optimized", "naive", "grouped",
                                    "pipeline"))
@pytest.mark.parametrize("program", ("3mm", "gemm", "mvt", "attn_step",
                                     "train_loop"))
def test_reference_plan_runs_in_port(program, policy):
    """A reference plan, carried over as JSON records, rebuilds into a port
    plan that round-trips to the same records and executes with the
    reference's counts and outputs."""
    build_ref, build_port = PROGRAMS[program]
    pr = ref_core.plan(build_ref(), policy=policy)
    records = json.loads(json.dumps(plan_records(pr)))
    meta = {k: pr.meta[k] for k in ("policy", "n_transfer_streams",
                                     "verify")}
    pp = plan_from_records(records, build_port(), meta=meta)
    assert plan_records(pp) == plan_records(pr)
    assert pp.groups == pr.groups
    assert pp.meta["pure_device_loops"] == pr.meta["pure_device_loops"]
    assert port_core.emit(pp) == ref_core.emit(pr)
    assert port_core.verify_plan(pp).meta_record() == \
        ref_core.verify_plan(pr).meta_record()

    out_r, s_r = ref_core.execute(pr, backend="jax")
    for mode in ("interpreted", "compiled"):
        out_p, s_p = port_core.execute(
            pp, mode=mode, backend=TorchDeviceBackend(device="cpu"))
        assert s_p.transfer_counts() == s_r.transfer_counts()
        for k in out_r:
            _close(out_p[k], out_r[k], k)


def test_kernel_variants_pass_through_records():
    """The tuner's {"flash_attention": {...}} tile choice rides along in
    meta unchanged and binds onto the attention block in both modes."""
    kv = {"flash_attention": {"block_q": 64, "block_k": 128}}
    pr = ref_core.plan(ref_offload.attention_step_program(2))
    pp = plan_from_records(plan_records(pr),
                           port_offload.attention_step_program(2),
                           meta={"kernel_variants": kv})
    assert pp.meta["kernel_variants"] == kv
    out_r, s_r = ref_core.execute(pr, backend="jax", kernel_variants=kv)
    for mode in ("interpreted", "compiled"):
        out_p, s_p = port_core.execute(pp, mode=mode, backend="numpy")
        assert s_p.transfer_counts() == s_r.transfer_counts()
        _close(out_p["final_loss"], out_r["final_loss"])
    bad = {"flash_attention": {"block_q": 96, "block_k": 128}}
    with pytest.raises(port_core.PlanVerificationError):
        port_core.execute(pp, backend="numpy", kernel_variants=bad,
                          verify=True)


class TestTorchBackend:
    def test_fused_loop_is_one_dispatch(self):
        p = port_polybench.build("gemm", n=16, iters=5)[0]
        be = TorchDeviceBackend(device="cpu")
        _, s = port_core.execute(port_core.plan(p), mode="compiled",
                                 backend=be)
        assert s.kernel_calls == 5 and s.fused_launches == 1
        assert be.loop_dispatches == 1

    def test_compiled_mode_checks_residency(self):
        p = port_polybench.build("3mm", n=16)[0]
        pl = port_core.plan(p)
        drop = next(op for op in pl.ops if op.kind == "directive"
                    and isinstance(op.directive, port_core.AdvancedLoad))
        pl.ops.remove(drop)
        for mode in ("interpreted", "compiled"):
            with pytest.raises(PlanExecutionError):
                port_core.execute(pl, mode=mode,
                                  backend=TorchDeviceBackend(device="cpu"))

    def test_upload_download_and_streams(self):
        be = TorchDeviceBackend(device="cpu", n_streams=2)
        x = np.arange(12, dtype=np.float32).reshape(3, 4)
        h = be.upload(x, stream=3)
        assert isinstance(h, torch.Tensor) and h.dtype == torch.float32
        x[0, 0] = 99.0                    # the upload took a copy
        assert be._pending and be._stream_of(3) == 1
        be.sync(3)
        assert not any(be._pending.values())
        np.testing.assert_array_equal(be.download(h)[0], [0, 1, 2, 3])
        z = be.alloc((2, 5), np.dtype(np.float32))
        assert z.shape == (2, 5) and not z.any()

    def test_variant_twins_are_memoized(self):
        be = TorchDeviceBackend(device="cpu")
        twin = be.variant(n_streams=3, donate=True)
        assert twin is not be and twin.n_streams == 3 and twin.donate
        assert be.variant(n_streams=3, donate=True) is twin
        assert twin.variant(n_streams=2, donate=False) is be

    def test_registry(self):
        assert port_core.get_backend("numpy") is port_core.get_backend("numpy")
        with pytest.raises(ValueError):
            port_core.get_backend("jax")
        with pytest.raises(ValueError):
            TorchDeviceBackend(device="meta")

    def test_dtype_helper_round_trips(self):
        from repro_torch.core.dtypes import numpy_dtype, torch_dtype
        for n in (np.float32, np.float64, np.float16, np.int32, np.int64,
                  np.bool_, np.uint8):
            assert numpy_dtype(torch_dtype(n)) == np.dtype(n)
        assert numpy_dtype(np.float32) == np.dtype(np.float32)
        assert torch_dtype(torch.float32) is torch.float32
        with pytest.raises(TypeError):
            numpy_dtype(torch.bfloat16)


@pytest.mark.parametrize("program", sorted(ref_polybench.PROBLEMS))
def test_pinned_backend_name_is_torchs(program):
    """The reference's "pinned" name builds the port's TorchDeviceBackend,
    whose uploads already stage through pinned memory: on the ten
    polybench programs, asked for the CPU explicitly, its outputs are
    "torch"'s bit for bit, and both match the reference's ``jax``
    backend (never its ``pinned`` one, which fails on jax CPU builds)
    with the same transfer counts."""
    from repro_torch.core.backend import _REGISTRY
    assert _REGISTRY["pinned"] is _REGISTRY["torch"] is TorchDeviceBackend
    build_ref, build_port = PROGRAMS[program]
    out_r, s_r = ref_core.execute(ref_core.plan(build_ref()), backend="jax")
    pp = port_core.plan(build_port())
    out_t, s_t = port_core.execute(pp, backend=_REGISTRY["torch"]("cpu"))
    for mode in ("interpreted", "compiled"):
        out_p, s_p = port_core.execute(pp, mode=mode,
                                       backend=_REGISTRY["pinned"]("cpu"))
        assert s_p.transfer_counts() == s_t.transfer_counts() == \
            s_r.transfer_counts()
        assert sorted(out_p) == sorted(out_r)
        for k in out_r:
            np.testing.assert_array_equal(out_p[k], out_t[k], err_msg=k)
            _close(out_p[k], out_r[k], k)


def test_pinned_backend_needs_a_card():
    """By name, "pinned" is a card backend: without a card it raises,
    never falls back to the host."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the pinned backend runs on it")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_core.get_backend("pinned")
