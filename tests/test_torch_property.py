"""Random block programs through both packages (the reference's
``tests/test_property.py`` strategy, run once for the two).

The strategy draws a program *spec* (the seed of its inputs, its blocks'
kinds, reads, write and host/offload choice, where loops open and close
and their trip counts) and a builder per package turns the spec into
that package's ``Program``, so both see the same draws.  Held for each
draw:

  1. the port's optimized = naive = host oracle (rtol 1e-5, atol 1e-5,
     the reference's bound), and every runner returns exactly the
     program's outputs;
  2. the port's optimized plan moves no more than its naive one, in
     transfers and in bytes, each direction;
  3. both plans are valid: the checking executor raises on any read of a
     space without a valid copy, in both modes;
  4. the port's plans equal the reference's (``plan_records``), and so do
     the transfer counts and bytes of both plans on the reference's
     ``numpy`` backend; outputs within the same bound of the reference's.
"""
import numpy as np
import pytest

hypothesis = pytest.importorskip(
    "hypothesis", reason="property tests need hypothesis "
    "(pip install -r requirements-dev.txt)")
from hypothesis import given, settings, strategies as st  # noqa: E402

from repro import core as ref_core  # noqa: E402
from repro_torch import core as port_core  # noqa: E402
from repro_torch.core import TorchDeviceBackend  # noqa: E402
from repro_torch.core.interop import plan_records  # noqa: E402

VARS = ["a", "b", "c", "d", "e"]
TOL = dict(rtol=1e-5, atol=1e-5)


def _mk_op(kind):
    if kind == 0:
        return lambda xp, x: {"_": x * 1.5 + 0.25}
    if kind == 1:
        return lambda xp, x: {"_": xp.tanh(x)}
    return lambda xp, x, y: {"_": x + 0.5 * y}


@st.composite
def specs(draw):
    """The reference's ``programs`` strategy, drawing in the same order,
    recorded as data: (seed, n_init, blocks), each block a dict of its
    loop action, trip count, kind, reads, write and host flag."""
    n_blocks = draw(st.integers(2, 7))
    seed = draw(st.integers(0, 2 ** 16))
    n_init = draw(st.integers(1, 3))
    live = VARS[:n_init]
    loop_open = False
    blocks = []
    for _ in range(n_blocks):
        action = draw(st.integers(0, 5))
        op = {"open": None, "close": False}
        if not loop_open and action == 0:
            op["open"] = draw(st.integers(2, 4))
            loop_open = True
        elif loop_open and action == 1:
            op["close"] = True
            loop_open = False
        kind = draw(st.integers(0, 2))
        n_in = 2 if kind == 2 else 1
        reads = tuple(draw(st.sampled_from(live)) for _ in range(n_in))
        if kind == 2 and reads[0] == reads[1]:
            reads, kind = (reads[0],), 0
        write = draw(st.sampled_from(VARS))
        op.update(kind=kind, reads=reads, write=write,
                  host=draw(st.booleans()))
        blocks.append(op)
        if write not in live:
            live.append(write)
    return {"seed": seed, "n_init": n_init, "blocks": blocks,
            "outputs": tuple(live)}


def build(core, spec):
    """``spec`` as a ``Program`` of ``core`` (either package): each block
    binds its own op, names and write through default arguments, as the
    reference's closures do."""
    p = core.Program("prop")
    rng = np.random.default_rng(spec["seed"])
    for v in VARS[:spec["n_init"]]:
        p.bind(v, rng.standard_normal(8).astype(np.float32))
    ctx = None
    for i, b in enumerate(spec["blocks"]):
        if b["open"] is not None:
            ctx = p.loop(b["open"])
            ctx.__enter__()
        elif b["close"]:
            ctx.__exit__(None, None, None)
            ctx = None
        fn, reads, write = _mk_op(b["kind"]), b["reads"], b["write"]

        def wrapped(xp, __fn=fn, __names=reads, **kw):
            vals = [kw[n] for n in __names]
            return {"_": __fn(xp, *vals)["_"]}

        def named(xp, __w=write, __wrapped=wrapped, **kw):
            return {__w: __wrapped(xp, **kw)["_"]}

        add = p.host if b["host"] else p.offload
        add(named, reads=reads, writes=(write,),
            name=f"{'h' if b['host'] else 'k'}{i}")
    if ctx is not None:
        ctx.__exit__(None, None, None)
    p.set_outputs(*spec["outputs"])
    return p


def _check(spec):
    pp, pr = build(port_core, spec), build(ref_core, spec)
    oracle = port_core.run_host_oracle(pp)
    ref_oracle = ref_core.run_host_oracle(pr)
    be = TorchDeviceBackend(device="cpu")
    counts = {}
    for policy in ("plan", "naive_plan"):
        plp, plr = getattr(port_core, policy)(pp), getattr(ref_core,
                                                           policy)(pr)
        assert plan_records(plp) == plan_records(plr), policy
        _, s_r = ref_core.execute(plr, backend="numpy")
        for mode in ("interpreted", "compiled"):
            out, s = port_core.execute(plp, mode=mode, backend=be)
            assert set(out) == set(oracle) == set(pp.outputs)
            for k in pp.outputs:
                np.testing.assert_allclose(out[k], oracle[k], **TOL)
                np.testing.assert_allclose(out[k], ref_oracle[k], **TOL)
            assert s.transfer_counts() == s_r.transfer_counts(), \
                (policy, mode)
        counts[policy] = s
    opt, nv = counts["plan"], counts["naive_plan"]
    assert opt.h2d_transfers <= nv.h2d_transfers
    assert opt.d2h_transfers <= nv.d2h_transfers
    assert opt.h2d_bytes <= nv.h2d_bytes
    assert opt.d2h_bytes <= nv.d2h_bytes


@settings(max_examples=60, deadline=None)
@given(specs())
def test_random_programs_match_reference(spec):
    _check(spec)


def test_builders_bind_each_blocks_own_write():
    """Two blocks in one spec: each block writes its own variable with
    its own op (a closure over the loop variable would make both write
    the last block's)."""
    spec = {"seed": 3, "n_init": 1, "outputs": ("a", "b", "c"),
            "blocks": [{"open": None, "close": False, "kind": 0,
                        "reads": ("a",), "write": "b", "host": False},
                       {"open": None, "close": False, "kind": 1,
                        "reads": ("b",), "write": "c", "host": True}]}
    out = port_core.run_host_oracle(build(port_core, spec))
    a = np.random.default_rng(3).standard_normal(8).astype(np.float32)
    np.testing.assert_allclose(out["b"], a * 1.5 + 0.25, rtol=1e-6)
    np.testing.assert_allclose(out["c"], np.tanh(a * 1.5 + 0.25),
                               rtol=1e-6)
    _check(spec)
