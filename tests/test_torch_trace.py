"""The port's spans and counters (``repro_torch.trace``): recorded only
under a profiler, bounded with what they defer, on the profiler's clock
and never a profiler range; the serving engine's spans per request and
step, and the offloaded update's byte counter on the CPU piece path."""
import gc
import importlib
import types
import weakref

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch import trace
from repro_torch.configs import get_config, reduced
from repro_torch.core import TorchDeviceBackend
from repro_torch.kernels import ops
from repro_torch.optim import adamw, offload
from repro_torch.serve import Engine, Request, ServeRuntime
from repro_torch.tree import leaves

adamw_module = importlib.import_module("repro_torch.optim.adamw")
CPU = TorchDeviceBackend("cpu")


@pytest.fixture(autouse=True)
def _fresh(tmp_path, monkeypatch):
    monkeypatch.setenv("REPRO_TORCH_TUNE_CACHE", str(tmp_path / "tc"))
    trace.clear()
    yield
    trace.clear()


def _profiled():
    return profile(activities=[ProfilerActivity.CPU])


def _by_name(recorded, name):
    return [s for s in recorded if s.name == name]


def test_off_records_nothing_and_reads_no_clock(monkeypatch):
    def boom():
        raise AssertionError("a clock was read")
    monkeypatch.setattr(trace, "time", types.SimpleNamespace(
        perf_counter_ns=boom, time_ns=boom))
    with trace.span(trace.OFFLOAD_UPDATE) as s:
        s.add("h2d_bytes", 4)
        s.later("wait_ns", boom)
        with trace.span(trace.SERVE_DECODE) as d:
            assert not s and not d
    assert trace.spans() == [] and trace.dropped() == 0


def test_nested_spans_keep_their_times_and_attributes():
    with _profiled():
        with trace.span(trace.OFFLOAD_UPDATE) as up:
            with trace.span(trace.SERVE_PREFILL, rid=3) as pre:
                pre.add("h2d_bytes", 5)
                pre.add("h2d_bytes", 7)
            with trace.span(trace.SERVE_DECODE):
                pass
            up.later("wait_ns", lambda: 9)
    got = trace.spans()
    assert [s.name for s in got] == [trace.OFFLOAD_UPDATE, trace.SERVE_PREFILL,
                                     trace.SERVE_DECODE]
    up_, pre_, dec_ = got
    assert up_ is up and pre_ is pre
    assert pre_.attrs == {"rid": 3, "h2d_bytes": 12}
    assert dec_.attrs == {} and up_.attrs == {"wait_ns": 9}
    for s in got:
        assert s.start_ns <= s.end_ns
        assert up_.start_ns <= s.start_ns and s.end_ns <= up_.end_ns
        assert s.name in trace.SPANS
    assert pre_.end_ns <= dec_.start_ns


def test_only_spans_opened_under_a_profiler_are_kept():
    with trace.span(trace.OFFLOAD_UPDATE):
        prof = _profiled()
        prof.start()
        with trace.span(trace.SERVE_DECODE):
            pass
        prof.stop()
    with trace.span(trace.SERVE_PREFILL):
        pass
    got = trace.spans()
    assert [s.name for s in got] == [trace.SERVE_DECODE]


def test_buffer_is_bounded_and_counts_what_it_dropped():
    rec = trace._Recorder(capacity=4)
    with _profiled():
        for i in range(10):
            with rec.span(trace.SERVE_PREFILL, rid=i):
                pass
    got = rec.spans()
    assert [s.attrs["rid"] for s in got] == [6, 7, 8, 9]
    assert rec.dropped == 6
    rec.clear()
    assert rec.spans() == [] and rec.dropped == 0


def test_deferred_values_go_with_dropped_spans():
    """A deferred attribute lives on its span: the buffer drops it with
    the span, and only the kept spans' values are ever computed."""
    rec = trace._Recorder(capacity=4)

    class Timing:
        calls = 0

        def __call__(self):
            Timing.calls += 1
            return 7

    alive = []
    with _profiled():
        for i in range(1000):
            t = Timing()
            alive.append(weakref.ref(t))
            with rec.span(trace.OFFLOAD_UPDATE) as s:
                s.later("wait_ns", t)
            del t, s
    gc.collect()
    assert sum(r() is not None for r in alive) == 4
    got = rec.spans()
    assert [s.attrs for s in got] == [{"wait_ns": 7}] * 4
    assert Timing.calls == 4 and rec.dropped == 996


def test_a_span_holds_the_profilers_event_on_its_timeline():
    a, b = torch.randn(256, 256), torch.randn(256, 256)
    with _profiled() as prof:
        with trace.span(trace.SERVE_DECODE):
            torch.mm(a, b)
    (s, start, end), = trace.placed(prof, trace.SERVE_DECODE)
    mm, = [e for e in prof.events() if e.name == "aten::mm"]
    assert start <= mm.time_range.start <= mm.time_range.end <= end
    assert end - start < 10e6     # µs: the same clock, not one off by ages


def test_placed_needs_a_trace_start():
    with _profiled():
        with trace.span(trace.SERVE_DECODE):
            pass
    assert list(trace.placed(object())) == []


def test_range_names_are_the_two_they_were():
    assert trace.RANGES == ("optimizer.update", "flash_attention.backward")
    assert adamw_module.UPDATE_RANGE == "optimizer.update"
    assert ops.BACKWARD_RANGE == "flash_attention.backward"
    assert not set(trace.RANGES) & set(trace.SPANS)


def _engine_run(n=5, capacity=2, gen=(3, 1, 4, 2, 5)):
    cfg = reduced(get_config("rwkv6-3b"))
    rt = ServeRuntime(cfg, max_seq=32, backend=CPU)
    rng = np.random.default_rng(0)
    reqs = [Request(rid=10 + i, max_new_tokens=gen[i % len(gen)],
                    prompt=rng.integers(0, cfg.vocab, 3 + i).astype(np.int32),
                    arrival_s=0.002 * i) for i in range(n)]
    eng = Engine(rt, capacity=capacity)
    with _profiled() as prof:
        rep = eng.run(reqs, respect_arrivals=True)
    return eng, reqs, rep, prof


def test_engine_spans_per_request_and_step():
    eng, reqs, rep, prof = _engine_run()
    got = trace.spans()
    prefills = _by_name(got, trace.SERVE_PREFILL)
    assert sorted(s.attrs["rid"] for s in prefills) == sorted(
        r.rid for r in reqs)
    decodes = _by_name(got, trace.SERVE_DECODE)
    assert len(decodes) == eng.batcher.steps == rep["steps"] > 0
    assert all(s.attrs == {} for s in decodes)
    assert len(got) == len(prefills) + len(decodes)
    assert not any(e.name.startswith(("serve.", "offload."))
                   for e in prof.events())


def test_engine_stamps_delivery():
    eng, reqs, rep, _ = _engine_run(n=3)
    for r in reqs:
        assert r.t_finish <= r.t_delivered
    assert len({r.t_delivered for r in reqs}) == 1     # one flush at the end
    lat = sorted(r.t_delivered - r.arrival_s for r in reqs)
    assert rep["delivery_p50_s"] == pytest.approx(lat[1])
    assert lat[1] <= rep["delivery_p99_s"] <= lat[2]
    # the host-clock times taken at enqueue are no longer reported
    assert not {"latency_p50_s", "latency_p99_s", "ttft_p50_s"} & set(rep)
    assert not hasattr(reqs[0], "record")


def test_engine_decode_spans_hold_their_steps_ops():
    """On the profiler's timeline each decode span holds the same ops:
    those its step ran, none of its neighbours'."""
    eng, reqs, rep, prof = _engine_run()
    ops = sorted(e.time_range.start for e in prof.events()
                 if e.name == "aten::embedding")
    counts = [sum(a <= t <= b for t in ops)
              for _, a, b in trace.placed(prof, trace.SERVE_DECODE)]
    assert len(counts) == rep["steps"]
    assert len(set(counts)) == 1 and counts[0] > 0


def test_untraced_engine_records_nothing():
    cfg = reduced(get_config("rwkv6-3b"))
    rt = ServeRuntime(cfg, max_seq=32, backend=CPU)
    Engine(rt, capacity=2).run(
        [Request(rid=0, prompt=np.arange(1, 5, dtype=np.int32),
                 max_new_tokens=3)], respect_arrivals=False)
    assert trace.spans() == []


def test_offload_cpu_pieces_count_the_state_bytes(monkeypatch):
    """The offloaded update's CPU piece path (plain copies for the
    streams) counts each update's state bytes, loaded in pieces of
    ``CHUNK`` elements, and has no stream to wait on."""
    monkeypatch.setattr(offload, "CHUNK", 50)
    gen = torch.Generator().manual_seed(0)
    params = {"a": torch.randn(7, 30, generator=gen),
              "b": torch.randn(40, generator=gen)}
    opt = adamw(lr=1e-3)
    state = opt.init(params)
    slots = opt.rule.slots(state)
    state_bytes = sum(t.nbytes for s in slots for t in s.values())
    with _profiled() as prof:
        for _ in range(2):
            grads = {k: torch.randn(v.shape, generator=gen)
                     for k, v in params.items()}
            offload._streamed(opt.rule, grads, state, params,
                              opt.rule.slots(state), None)
    ups = _by_name(trace.spans(), trace.OFFLOAD_UPDATE)
    assert len(ups) == 2
    for u in ups:
        assert u.attrs == {"h2d_bytes": state_bytes}
    assert not any(e.name.startswith("offload.") for e in prof.events())
    assert int(state["step"]) == 2
    assert all(torch.isfinite(t).all() for t in leaves(params))
