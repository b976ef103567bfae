"""A train cell's traced busy time and window (``devicetrace.summary``)
from one interval of a synthetic device trace: between the device starts
of two traced steps, found by the driver's step marks, with the device's
operations on every stream clipped to it."""
from types import SimpleNamespace

import pytest
from hypothesis import given, settings
from hypothesis import strategies as st
from torch.autograd import DeviceType

from bench import devicetrace, harness
from bench.drivers import train

# an offloaded train step whose compute got faster: steps overlap at
# 0.709 s a step, each leaving store copies in flight 0.352 s into the
# next step's compute
PACE, TAIL = 0.709e6, 0.352e6                        # µs
# a step on the compute stream, from its device start: its mark, two pieces
# with a 50 ms gap that no store covers, then the stores on a stream of
# their own
MARK = "void at::cuda::(anonymous namespace)::spin_kernel(long)"
COMPUTE = [(2.0, 0.400e6), (0.450e6, 0.600e6)]
STORE = PACE + TAIL - COMPUTE[-1][1]
IDLE = 0.050e6 / PACE                                # the steady idle share
FILL, N = train.FILL_STEPS, train.TRACED_STEPS
DRAINED_STEPS = 2         # steps traced from a drained device


def _event(name, a, b, stream=7):
    return SimpleNamespace(name=name, device_type=DeviceType.CUDA,
                           device_resource_id=stream,
                           time_range=SimpleNamespace(start=a, end=b))


def _prof(events):
    return SimpleNamespace(events=lambda: list(events),
                           key_averages=lambda: [])


def _steps(starts, store=STORE, mark=True):
    """Device events of steps starting at ``starts`` (µs): each step's
    mark, its compute, its stores after it on stream 8, and the program's
    range over them (an annotation, as a trace with the host's ops holds
    it)."""
    out = []
    for i, t in enumerate(starts):
        if mark:
            out.append(_event(MARK, t, t + COMPUTE[0][0]))
        out += [_event(f"gemm{i}", t + a, t + b) for a, b in COMPUTE]
        s0 = t + COMPUTE[-1][1]
        out += [_event(f"Memcpy DtoH {i}", s0, s0 + store, stream=8),
                _event("optimizer.update", s0, s0 + store, stream=8)]
    return out


def _traced(n_steps=FILL + N + 1, **kw):
    """A trace as the driver takes it: steps back to back at the window's
    pace, one in flight, the last one's stores drained at the end."""
    return _prof(_steps([i * PACE for i in range(n_steps)], **kw))


def _window():
    return {"trace_steps": N}


def test_drained_pairing_exceeds_the_window_one_interval_does_not():
    # two steps traced from a drained device, their busy time set against
    # the time the window's overlapped steps take
    drained = _prof(_steps([i * PACE for i in range(DRAINED_STEPS)]))
    wall = DRAINED_STEPS * PACE + TAIL
    assert devicetrace.busy_intervals(drained)[-1][1] == pytest.approx(wall)
    old = devicetrace.summary(
        drained, {"trace_window_s": DRAINED_STEPS * PACE / 1e6})
    assert old["busy_s"] > old["window_s"]
    assert wall / 1e6 - old["window_s"] == pytest.approx(0.352)
    # one interval of the trace, between two steps' device starts
    new = devicetrace.summary(_traced(), _window())
    assert 0 < new["busy_s"] <= new["window_s"]
    assert new["window_s"] == pytest.approx(N * 0.709)
    assert new["busy_s"] == pytest.approx(N * (0.709 - 0.050))
    ctx = {"prof": _traced(), "window": _window()}
    share = harness.reader("device.idle_share.train")(ctx)
    assert share == pytest.approx(100 * IDLE)


def test_stores_past_the_last_boundary_are_not_counted():
    short = devicetrace.summary(_traced(store=0.05e6), _window())
    long = devicetrace.summary(_traced(store=5 * PACE), _window())
    base = devicetrace.summary(_traced(), _window())
    # stores that end before the next step's device start leave gaps
    assert short["busy_s"] < base["busy_s"]
    # stores that run on for steps past the last boundary fill the
    # interval, and no further
    assert long["busy_s"] == pytest.approx(long["window_s"])
    assert long["window_s"] == base["window_s"]
    # more steps before the interval change nothing
    more = devicetrace.summary(_traced(n_steps=FILL + N + 3), _window())
    assert more == base


def test_a_mark_lost_as_the_tracer_starts_changes_nothing():
    events = _traced().events()
    first = next(e for e in events if e.name == MARK)
    lost = _prof([e for e in events if e is not first])
    assert devicetrace.summary(lost, _window()) == \
        devicetrace.summary(_traced(), _window())


def test_annotations_are_not_busy_and_marks_only_their_own_time():
    # one kernel after each step's mark, the program's range over the rest
    ev = []
    for i in range(4):
        t = i * 100.0
        ev += [_event(MARK, t, t + 1.0), _event(f"k{i}", t + 5.0, t + 10.0),
               _event("optimizer.update", t, t + 100.0),
               _event("ProfilerStep#1", t, t + 100.0)]
    prof = _prof(ev)
    s = devicetrace.summary(prof, {"trace_steps": 2})
    assert s == {"busy_s": pytest.approx(12e-6),
                 "window_s": pytest.approx(200e-6)}


def test_the_boundaries_are_the_marks_starts():
    prof = _traced()
    assert devicetrace.step_interval(prof, N) == (FILL * PACE,
                                                  (FILL + N) * PACE)
    assert devicetrace.step_interval(prof, 1) == ((FILL + N - 1) * PACE,
                                                  (FILL + N) * PACE)
    assert devicetrace.step_interval(prof, FILL + N + 1) is None


def test_no_reading_without_the_boundaries():
    # a trace without the driver's marks (a CPU run's profile, or too
    # few steps) gives no busy time and no window
    assert devicetrace.summary(_traced(mark=False), _window()) is None
    assert devicetrace.summary(_traced(n_steps=N), _window()) is None
    assert devicetrace.idle_share({"prof": _traced(n_steps=N),
                                   "window": _window()}) is None
    # nothing ran inside the interval
    assert devicetrace.in_interval(_traced(), ((FILL + N + 3) * PACE,
                                              (FILL + N + 4) * PACE)) is None


_span = st.tuples(st.floats(0, 1e7, allow_nan=False),
                  st.floats(0, 1e6, allow_nan=False),
                  st.integers(0, 6))


@settings(max_examples=300, deadline=None, database=None)
@given(ops=st.lists(_span, min_size=1, max_size=60),
       cut=st.tuples(st.floats(0, 1), st.floats(0, 1)))
def test_busy_never_exceeds_the_interval(ops, cut):
    """Any device operations on any streams, any interval inside the
    trace: busy time >= 0 and <= the interval's length, and equal to the
    union of the operations clipped to it."""
    prof = _prof([_event(f"op{i}", a, a + d, s)
                  for i, (a, d, s) in enumerate(ops)])
    t0 = min(a for a, _, _ in ops)
    t1 = max(a + d for a, d, _ in ops)
    lo, hi = sorted(t0 + c * (t1 - t0) for c in cut)
    got = devicetrace.in_interval(prof, (lo, hi))
    clipped = sorted((max(a, lo), min(a + d, hi)) for a, d, _ in ops
                     if min(a + d, hi) > max(a, lo))
    merged = []
    for a, b in clipped:
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    union = sum(b - a for a, b in merged)
    if got is None:
        assert union <= 1e-3 * len(ops)          # under a nanosecond an op
        return
    assert 0 < got["busy_s"] <= got["window_s"]
    assert got["window_s"] == pytest.approx((hi - lo) / 1e6, abs=1e-9)
    assert got["busy_s"] == pytest.approx(union / 1e6,
                                          abs=1e-9 * (1 + len(ops)))
