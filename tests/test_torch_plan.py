"""Plan parity: the PyTorch port's planner against the JAX reference's.

For every polybench problem (n=32) under every placement policy, and for
the two training-step programs, both packages plan the same program and
must agree exactly: the plan as records, the ``emit()`` text, the
``verify_plan`` report, ``transfer_summary()``, and what the analysis
found (actual reads, io table, groups, byte sizes, pure-device loops).
"""
import dataclasses

import pytest
import torch

import repro.core as ref_core
import repro.optim.offload as ref_offload
import repro.polybench as ref_polybench
import repro_torch.core as port_core
import repro_torch.optim.offload as port_offload
import repro_torch.polybench as port_polybench
from repro_torch.core import plan_records

POLICIES = ("optimized", "naive", "grouped", "pipeline")

PROGRAMS = {
    **{name: (lambda name=name: ref_polybench.build(name, n=32)[0],
              lambda name=name: port_polybench.build(name, n=32)[0])
       for name in ref_polybench.PROBLEMS},
    "attn_step": (lambda: ref_offload.attention_step_program(1),
                  lambda: port_offload.attention_step_program(1)),
    "train_loop": (ref_offload.plan_step_program,
                   port_offload.plan_step_program),
}


def _violations(report):
    return [dataclasses.astuple(v) for v in report.violations]


@pytest.mark.parametrize("policy", POLICIES)
@pytest.mark.parametrize("program", sorted(PROGRAMS))
def test_plan_matches_reference(program, policy):
    build_ref, build_port = PROGRAMS[program]
    pr = ref_core.plan(build_ref(), policy=policy)
    pp = port_core.plan(build_port(), policy=policy)

    assert plan_records(pp) == plan_records(pr)
    assert port_core.emit(pp) == ref_core.emit(pr)
    assert port_core.transfer_summary(pp) == ref_core.transfer_summary(pr)

    rep_r = ref_core.verify_plan(pr)
    rep_p = port_core.verify_plan(pp)
    assert _violations(rep_p) == _violations(rep_r)
    assert rep_p.summary() == rep_r.summary()
    assert rep_p.meta_record() == rep_r.meta_record()

    assert pp.groups == pr.groups
    assert {b: {v: io.value for v, io in t.items()}
            for b, t in pp.io_table.items()} == \
        {b: {v: io.value for v, io in t.items()}
         for b, t in pr.io_table.items()}
    assert [b.actual_reads for b in pp.program.blocks] == \
        [b.actual_reads for b in pr.program.blocks]
    for key in ("policy", "optimize", "n_transfer_streams",
                "pure_device_loops", "var_nbytes", "verify"):
        assert pp.meta[key] == pr.meta[key], key


@pytest.mark.parametrize("program", sorted(PROGRAMS))
def test_analysis_shapes_match_reference(program):
    """The FX-traced shapes equal the jaxpr-traced ones, as numpy dtypes."""
    build_ref, build_port = PROGRAMS[program]
    an_r = ref_core.analyze(build_ref())
    an_p = port_core.analyze(build_port())
    assert sorted(an_p.shapes) == sorted(an_r.shapes)
    for v, sd in an_r.shapes.items():
        assert an_p.shapes[v].shape == tuple(sd.shape), v
        assert an_p.shapes[v].dtype == sd.dtype, v


def test_pruned_read_is_not_an_actual_read():
    """A declared read the body never touches is pruned (the paper's 3MM
    "E needs no upload" analysis), in both packages alike."""
    import numpy as np

    def build(core):
        p = core.Program("prune")
        p.bind("A", np.ones((4, 4), np.float32))
        p.bind("B", np.ones((4, 4), np.float32))
        p.offload(lambda xp, A, B: {"C": A * 2.0}, reads=("A", "B"),
                  writes=("C",), name="k")
        p.host(lambda xp, C: {"out": C}, reads=("C",), writes=("out",),
               name="use")
        p.set_outputs("out")
        return p

    pr = ref_core.plan(build(ref_core))
    pp = port_core.plan(build(port_core))
    assert pp.program.blocks[0].actual_reads == ("A",)
    assert port_core.emit(pp) == ref_core.emit(pr)


def test_auto_policy_waits_for_the_tuner():
    """policy="auto" is the tuner (tests/test_torch_tuner.py holds it to
    the reference's); its default backend is the card's, so without a
    card it raises instead of tuning on the CPU."""
    p = port_polybench.build("3mm", n=16)[0]
    pl = port_core.plan(p, policy="auto", backend="numpy", measure=False,
                        cache=False)
    assert pl.meta["tuning"]["chosen"] == port_core.tune(
        p, backend="numpy", measure=False, cache=False).meta["tuning"][
            "chosen"]
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            port_core.plan(p, policy="auto", cache=False)
    with pytest.raises(TypeError):
        port_core.plan(p, policy="optimized", backend="numpy")
