"""The fused-loop lowering of the port against the reference's
(``tests/test_fused_loop.py``): every program of that file is built in
both packages from the same inputs (``np.random.default_rng`` seeds), and
each check of its six classes is held in both.

Across the packages, for each program and each policy (``plan`` and
``naive_plan``): the plan records, the pure-device loops and the emitted
source are equal; for each mode, the port's ``TorchDeviceBackend("cpu")``
against the reference's ``jax`` backend and the port's ``numpy`` backend
against the reference's, the transfer counts and bytes, kernel calls,
syncs, fused launches and loop dispatches are equal.  The port's compiled
outputs equal its interpreted ones bit for bit, and are within 1e-6 of
the reference's (fp32): |port − ref| ≤ 1e-6 + 1e-6 · max |ref| over each
output, as ``tests/test_torch_exec.py`` scales its bound.  The rtol is
taken against the output's largest magnitude, not element by element:
torch's and XLA's CPU matmuls sum in different orders, so an element that
cancels (|x| ≪ max |x|) differs by up to 6e-6 of itself on 3mm and on the
nests, 1.4e-7 of the output's scale.  The reference's ``pinned`` backend
is never the comparator (it fails on jax CPU builds).
"""
import numpy as np
import pytest

from repro import core as ref_core
from repro.optim import plan_step_program as ref_step_program
from repro.polybench import build as ref_build
from repro_torch import core as port_core
from repro_torch.core import TorchDeviceBackend
from repro_torch.core.interop import plan_records
from repro_torch.optim import plan_step_program as port_step_program
from repro_torch.polybench import build as port_build

CORES = {"ref": ref_core, "port": port_core}
RTOL = ATOL = 1e-6


# ---------------------------------------------------------------------------
# The reference file's programs, built against either package's core
# ---------------------------------------------------------------------------

def _loop_prog(core, iters=6):
    """Kernel loop whose body is pure device: inputs hoisted before, the
    only download sunk after."""
    p = core.Program("fused")
    rng = np.random.default_rng(7)
    p.bind("A", rng.standard_normal((24, 24)).astype(np.float32))
    p.bind("C", rng.standard_normal((24, 24)).astype(np.float32))
    with p.loop(iters):
        p.offload(lambda xp, A, C: {"C": 0.25 * (A @ C) + C},
                  reads=("A", "C"), writes=("C",), name="k")
    p.host(lambda xp, C: {"out": C.sum(axis=0, keepdims=True)},
           reads=("C",), writes=("out",), name="consume")
    p.set_outputs("out")
    return p


def _nested_prog(core, n_outer=3, n_inner=4, multi_block=False):
    """A pure-device nest: both loops planner-pure, so the whole nest
    rolls into one dispatch."""
    p = core.Program("nest")
    rng = np.random.default_rng(11)
    p.bind("A", rng.standard_normal((16, 16)).astype(np.float32))
    p.bind("C", rng.standard_normal((16, 16)).astype(np.float32))
    with p.loop(n_outer):
        with p.loop(n_inner):
            p.offload(lambda xp, A, C: {"C": 0.25 * (A @ C) + C},
                      reads=("A", "C"), writes=("C",), name="k")
            if multi_block:
                p.offload(lambda xp, C: {"C": xp.tanh(C)},
                          reads=("C",), writes=("C",), name="squash")
    p.host(lambda xp, C: {"out": C.sum(axis=0, keepdims=True)},
           reads=("C",), writes=("out",), name="consume")
    p.set_outputs("out")
    return p


def _host_in_loop(core):
    p = core.Program()
    p.bind("A", np.ones((8,), np.float32))
    with p.loop(4):
        p.host(lambda xp, A: {"A": A + 1.0}, reads=("A",),
               writes=("A",), name="w")
        p.offload(lambda xp, A: {"B": A * 2.0}, reads=("A",),
                  writes=("B",), name="k")
    p.host(lambda xp, B: {"o": B}, reads=("B",), writes=("o",), name="c")
    p.set_outputs("o")
    return p


def _half_pure(core):
    """Outer body = host block + inner loop: only the inner loop fuses."""
    p = core.Program("half_pure")
    p.bind("A", np.ones((8, 8), np.float32))
    p.bind("C", np.ones((8, 8), np.float32))
    p.bind("h", np.ones((2,), np.float32))
    with p.loop(3):
        p.host(lambda xp, h: {"h": h * 1.5}, reads=("h",),
               writes=("h",), name="hostwork")
        with p.loop(4):
            p.offload(lambda xp, A, C: {"C": 0.5 * (A @ C)},
                      reads=("A", "C"), writes=("C",), name="k")
    p.host(lambda xp, C, h: {"out": C[:1] + h[:1]},
           reads=("C", "h"), writes=("out",), name="consume")
    p.set_outputs("out")
    return p


def _two_groups(core):
    p = core.Program("two_groups")
    p.bind("a", np.arange(8, dtype=np.float32))
    p.bind("b", np.arange(8, dtype=np.float32) + 100.0)
    p.offload(lambda xp, a: {"x": a * 2.0}, reads=("a",),
              writes=("x",), name="k0")
    p.offload(lambda xp, b: {"y": b + 1.0}, reads=("b",),
              writes=("y",), name="k1")
    p.host(lambda xp, x, y: {"o": x + y}, reads=("x", "y"),
           writes=("o",), name="c")
    p.set_outputs("o")
    return p


def _multi_output(core):
    p = core.Program()
    p.bind("A", np.ones((8, 8), np.float32))
    p.offload(lambda xp, A: {"S": A.sum(axis=0), "P": A * 2.0},
              reads=("A",), writes=("S", "P"), name="k")
    p.host(lambda xp, S, P: {"o": S + P.sum(axis=0)},
           reads=("S", "P"), writes=("o",), name="c")
    p.set_outputs("o")
    return p


def _no_outputs(core):
    p = core.Program()
    p.bind("a", np.ones((4,), np.float32))
    p.offload(lambda xp, a: {"b": a * 2.0}, reads=("a",),
              writes=("b",), name="k")
    return p


def _step_prog(core, n_steps=5):
    return (ref_step_program if core is ref_core
            else port_step_program)(n_steps=n_steps)


def _3mm(core):
    return (ref_build if core is ref_core else port_build)("3mm", n=16)[0]


PROGRAMS = {
    "loop6": lambda c: _loop_prog(c, 6),
    "loop3": lambda c: _loop_prog(c, 3),
    "nest3x4": lambda c: _nested_prog(c, 3, 4),
    "nest2x3": lambda c: _nested_prog(c, 2, 3),
    "nest_multi_block": lambda c: _nested_prog(c, 2, 3, multi_block=True),
    "host_in_loop": _host_in_loop,
    "half_pure": _half_pure,
    "step_body_state": _step_prog,
    "two_groups": _two_groups,
    "multi_output": _multi_output,
    "no_outputs": _no_outputs,
    "3mm": _3mm,
}

# (port backend, reference backend) pairs, fresh instances per test
PAIRS = {
    "device": (lambda: TorchDeviceBackend(device="cpu"),
               lambda: ref_core.JaxDeviceBackend()),
    "numpy": (lambda: port_core.NumpyHostBackend(),
              lambda: ref_core.NumpyHostBackend()),
}
MODES = ("interpreted", "compiled")


def _both(name):
    return {k: PROGRAMS[name](c) for k, c in CORES.items()}


def _run(core, be, pl, mode, **kw):
    before = be.loop_dispatches
    out, stats = core.execute(pl, mode=mode, backend=be, **kw)
    return out, stats, be.loop_dispatches - before


def _close(got, want, what=""):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype, what
    scale = float(np.abs(want).max()) if want.size else 0.0
    err = float(np.abs(got.astype(np.float64) - want).max()) \
        if want.size else 0.0
    assert err <= ATOL + RTOL * scale, f"{what}: err {err}, scale {scale}"


def _logical(stats, dispatches):
    return {**stats.transfer_counts(), "fused_launches":
            stats.fused_launches, "loop_dispatches": dispatches}


def _exec_parity(pp, pr, pair, **kw):
    """Both modes in both packages: logical counts equal, the port's
    modes bitwise equal, its outputs close to the reference's.  Returns
    the port's (outputs, stats, dispatches) by mode."""
    make_p, make_r = PAIRS[pair]
    got = {}
    for mode in MODES:
        out_r, s_r, d_r = _run(ref_core, make_r(), pr, mode, **kw)
        out_p, s_p, d_p = _run(port_core, make_p(), pp, mode, **kw)
        assert _logical(s_p, d_p) == _logical(s_r, d_r), mode
        assert sorted(out_p) == sorted(out_r)
        for k in out_r:
            _close(out_p[k], out_r[k], f"{mode} {k}")
        got[mode] = (out_p, s_p, d_p)
    for k in got["compiled"][0]:
        np.testing.assert_array_equal(got["compiled"][0][k],
                                      got["interpreted"][0][k], err_msg=k)
    return got


@pytest.mark.parametrize("pair", sorted(PAIRS))
@pytest.mark.parametrize("policy", ["plan", "naive_plan"])
@pytest.mark.parametrize("name", sorted(PROGRAMS))
def test_fused_lowering_parity(name, policy, pair):
    """Plans, emitted source, counts and outputs of every program of the
    reference's fused-loop file, in both packages."""
    progs = _both(name)
    pr = getattr(ref_core, policy)(progs["ref"])
    pp = getattr(port_core, policy)(progs["port"])
    assert plan_records(pp) == plan_records(pr)
    assert pp.pure_device_loops() == pr.pure_device_loops()
    assert port_core.emit(pp) == ref_core.emit(pr)
    _exec_parity(pp, pr, pair)


# ---------------------------------------------------------------------------
# The reference's classes, each check held in both packages
# ---------------------------------------------------------------------------

def _port_be(pair):
    return PAIRS[pair][0]()


class TestFusedLoop:
    @pytest.mark.parametrize("pair", sorted(PAIRS))
    def test_bitwise_equal_and_logical_parity(self, pair):
        progs = _both("loop6")
        got = _exec_parity(port_core.plan(progs["port"]),
                           ref_core.plan(progs["ref"]), pair)
        _, s_c, _ = got["compiled"]
        assert got["interpreted"][1].transfer_counts() == \
            s_c.transfer_counts()
        assert s_c.kernel_calls == 6 and s_c.fused_launches == 1

    @pytest.mark.parametrize("pair", sorted(PAIRS))
    def test_single_backend_dispatch(self, pair):
        be = _port_be(pair)
        _, s_c, d = _run(port_core, be, port_core.plan(
            _loop_prog(port_core, iters=5)), "compiled")
        assert d == 1 and s_c.fused_launches == 1

    def test_planner_marks_pure_device_loops(self):
        for core in CORES.values():
            assert len(core.plan(_loop_prog(core)).pure_device_loops()) == 1
            # a load inside the loop body (naive policy) disqualifies it
            assert core.naive_plan(_loop_prog(core)).pure_device_loops() \
                == ()

    def test_host_block_in_loop_not_fused(self):
        progs = _both("host_in_loop")
        pp = port_core.plan(progs["port"])
        assert pp.pure_device_loops() == ()
        got = _exec_parity(pp, ref_core.plan(progs["ref"]), "device")
        assert got["compiled"][1].fused_launches == 4

    def test_multi_block_body_with_body_defined_state(self):
        progs = _both("step_body_state")
        pp = port_core.plan(progs["port"])
        assert len(pp.pure_device_loops()) == 1
        got = _exec_parity(pp, ref_core.plan(progs["ref"]), "device")
        s_c = got["compiled"][1]
        assert s_c.kernel_calls == 10 and s_c.fused_launches == 1

    @pytest.mark.parametrize("pair", sorted(PAIRS))
    def test_mutated_plan_body_load_disables_fusion(self, pair):
        """A load spliced into a marked-pure body must not fuse, in
        either package, and keeps count parity with the interpreter."""
        plans = {}
        for k, core in CORES.items():
            pl = core.plan(_loop_prog(core, iters=3))
            begin = next(i for i, op in enumerate(pl.ops)
                         if op.kind == "loop_begin")
            pl.ops.insert(begin + 1, core.PlanOp(
                "directive", directive=core.AdvancedLoad(
                    var="A", group=0, stream=1)))
            plans[k] = pl
        assert plan_records(plans["port"]) == plan_records(plans["ref"])
        got = _exec_parity(plans["port"], plans["ref"], pair)
        assert got["compiled"][1].h2d_transfers == \
            got["interpreted"][1].h2d_transfers >= 3

    def test_emitter_prints_fused_region(self):
        text = port_core.emit(port_core.plan(_loop_prog(port_core)))
        assert "whole-loop lowering" in text and "region" in text
        assert text == ref_core.emit(ref_core.plan(_loop_prog(ref_core)))

    def test_compile_time_excluded_from_wall_time(self):
        be = TorchDeviceBackend(device="cpu")
        pl = port_core.plan(_loop_prog(port_core, iters=3))
        _, s_first = port_core.execute(pl, mode="compiled", backend=be)
        _, s_again = port_core.execute(pl, mode="compiled", backend=be)
        assert s_first.compile_time > 0.0     # lowering happened once...
        assert s_again.compile_time == 0.0    # ...and was cached
        assert s_first.transfer_counts() == s_again.transfer_counts()


class TestNestedFusedLoop:
    @pytest.mark.parametrize("pair", sorted(PAIRS))
    def test_nest_is_one_dispatch_bitwise_equal(self, pair):
        progs = _both("nest3x4")
        pp = port_core.plan(progs["port"])
        assert len(pp.pure_device_loops()) == 2
        got = _exec_parity(pp, ref_core.plan(progs["ref"]), pair)
        _, s_c, d = got["compiled"]
        assert s_c.kernel_calls == 12 and s_c.fused_launches == 1
        assert d == 1

    def test_multi_block_inner_body(self):
        progs = _both("nest_multi_block")
        got = _exec_parity(port_core.plan(progs["port"]),
                           ref_core.plan(progs["ref"]), "device")
        s_c = got["compiled"][1]
        assert s_c.kernel_calls == 2 * 3 * 2 and s_c.fused_launches == 1

    def test_host_block_between_loops_blocks_outer_fusion(self):
        progs = _both("half_pure")
        pp = port_core.plan(progs["port"])
        assert len(pp.pure_device_loops()) == 1   # inner only
        got = _exec_parity(pp, ref_core.plan(progs["ref"]), "device")
        assert got["compiled"][1].fused_launches == 3


class _Recording:
    """A backend mixin recording the ``donate_keys`` of each loop launch."""

    def _launch_loop(self, body_fn, n_iters, carry, *, stream=0,
                     donate_keys=()):
        self.donated.append(tuple(donate_keys))
        return super()._launch_loop(body_fn, n_iters, carry, stream=stream,
                                    donate_keys=donate_keys)


class _PortRec(_Recording, TorchDeviceBackend):
    def __init__(self, donate):
        super().__init__(device="cpu", donate=donate)
        self.donated = []


class _RefRec(_Recording, ref_core.JaxDeviceBackend):
    def __init__(self, donate):
        super().__init__(donate=donate)
        self.donated = []


class TestFusedLoopDonation:
    """The reference donates a fused loop's rewritten carry entries behind
    its ``donate`` flag.  The port's eager launches never reuse an input
    buffer (``supports_donation`` is False), so its flag changes nothing:
    it hands the loop the same keys as the reference and leaves every
    carry buffer as it was."""

    def test_launch_loop_keeps_every_carry_buffer(self):
        be = TorchDeviceBackend(device="cpu", donate=True)
        a = np.ones((8, 8), np.float32)
        c = np.full((8, 8), 2.0, np.float32)
        A, C = be.upload(a), be.upload(c)
        ref = c
        for _ in range(5):
            ref = 0.5 * (a @ ref)

        def body(env):
            return {"A": env["A"], "C": 0.5 * (env["A"] @ env["C"])}

        out = be.launch_loop(body, 5, {"A": A, "C": C},
                             donate_keys=("C",))
        np.testing.assert_allclose(be.download(out["C"]), ref, rtol=1e-5)
        np.testing.assert_array_equal(be.download(C), c)
        np.testing.assert_array_equal(be.download(A), a)
        assert not be.supports_donation

    def test_gated_behind_donate_flag(self):
        """The donate flag is carried by the backend and its twins, and a
        plan executes to the same result under either."""
        be = TorchDeviceBackend(device="cpu", donate=False)
        assert be.variant(donate=True).donate and not be.donate
        C = be.upload(np.ones((8, 8), np.float32))
        out = be.launch_loop(lambda env: {"C": env["C"] * 2.0}, 3,
                             {"C": C}, donate_keys=("C",))
        np.testing.assert_array_equal(be.download(out["C"]),
                                      np.full((8, 8), 8.0, np.float32))
        np.testing.assert_array_equal(be.download(C),
                                      np.ones((8, 8), np.float32))

    @pytest.mark.parametrize("nested", [False, True])
    def test_execute_parity_with_donation(self, nested):
        """Donating and non-donating backends: the same outputs and
        logical stats, one fused launch, and the same donated keys as the
        reference's lowering of the same plan."""
        name = "nest2x3" if nested else "loop6"
        progs = _both(name)
        pp, pr = port_core.plan(progs["port"]), ref_core.plan(progs["ref"])
        runs = {}
        for donate in (True, False):
            bp, br = _PortRec(donate), _RefRec(donate)
            out_p, s_p = port_core.execute(pp, mode="compiled", backend=bp)
            out_r, s_r = ref_core.execute(pr, mode="compiled", backend=br)
            assert bp.donated == br.donated and bp.donated
            assert s_p.transfer_counts() == s_r.transfer_counts()
            assert s_p.fused_launches == s_r.fused_launches == 1
            _close(out_p["out"], out_r["out"])
            runs[donate] = (out_p, s_p)
        np.testing.assert_array_equal(runs[True][0]["out"],
                                      runs[False][0]["out"])
        assert runs[True][1].transfer_counts() == \
            runs[False][1].transfer_counts()


class TestReleaseGroups:
    @pytest.mark.parametrize("pair", sorted(PAIRS))
    def test_release_frees_only_its_group(self, pair):
        """A Release(group=0) moved before group 1's callsite leaves
        group 1's device-resident input alone, in both packages."""
        plans = {}
        for k, core in CORES.items():
            p = _two_groups(core)
            pl = core.plan(p)
            assert len(pl.groups) == 2
            rel0 = next(op for op in pl.ops if op.kind == "directive"
                        and isinstance(op.directive, core.Release)
                        and op.directive.group == 0)
            k1_pos = next(i for i, op in enumerate(pl.ops)
                          if op.kind == "block"
                          and p.blocks[op.block_idx].name == "k1")
            pl.ops.remove(rel0)
            pl.ops.insert(k1_pos, rel0)
            plans[k] = pl
        assert plan_records(plans["port"]) == plan_records(plans["ref"])
        got = _exec_parity(plans["port"], plans["ref"], pair)
        oracle = port_core.run_host_oracle(plans["port"].program)
        for mode in MODES:
            _close(got[mode][0]["o"], oracle["o"], mode)

    def test_group_vars_resolution(self):
        from repro.core.executor import group_vars as ref_group_vars
        from repro_torch.core.executor import group_vars
        pl = port_core.plan(_two_groups(port_core))
        pr = ref_core.plan(_two_groups(ref_core))
        for g in (0, 1):
            assert group_vars(pl, g) == ref_group_vars(pr, g)
        assert group_vars(pl, 0) == {"a", "x"}
        assert group_vars(pl, 1) == {"b", "y"}


class TestNaiveSyncPerCallsite:
    def test_single_sync_for_multi_output_block(self):
        pl = port_core.naive_plan(_multi_output(port_core))
        s = port_core.transfer_summary(pl)
        assert s == ref_core.transfer_summary(
            ref_core.naive_plan(_multi_output(ref_core)))
        assert s["stores"] == 2 and s["syncs"] == 1
        _, stats = port_core.execute(pl, backend=TorchDeviceBackend("cpu"))
        assert stats.syncs == 1 and stats.d2h_transfers == 2

    def test_naive_syncs_equal_storing_callsites(self):
        pl = port_core.naive_plan(_3mm(port_core))
        stores = pl.directives(port_core.DelegateStore)
        syncs = pl.directives(port_core.Synchronize)
        assert len(syncs) == len({d.block_idx for d in syncs})
        assert len(syncs) == 3 and len(stores) == 3


class TestOracleOutputContract:
    def test_empty_outputs_returns_empty_like_execute(self):
        p = _no_outputs(port_core)
        assert port_core.run_host_oracle(p) == {}
        out, _ = port_core.execute(port_core.plan(p),
                                   backend=TorchDeviceBackend("cpu"))
        assert out == {}

    def test_oracle_keys_match_declared_outputs(self):
        p = _loop_prog(port_core, iters=2)
        oracle = port_core.run_host_oracle(p)
        assert set(oracle) == set(p.outputs)
        _close(oracle["out"], ref_core.run_host_oracle(
            _loop_prog(ref_core, iters=2))["out"])
