"""The readers of the program's spans and counters
(``device.idle_in_{decode,prefill}_share.serve``,
``optim.offload_{wait_ms,h2d_gbps}.train``) on a synthetic device trace
and synthetic spans with known answers; silent where the program or its
spans are missing, as at a commit before them."""
import sys
from types import SimpleNamespace

import numpy as np
import pytest
from torch.autograd import DeviceType

import repro_torch
from bench import harness
from repro_torch import trace

DECODE = "device.idle_in_decode_share.serve"
PREFILL = "device.idle_in_prefill_share.serve"
WAIT = "optim.offload_wait_ms.train"
H2D = "optim.offload_h2d_gbps.train"
T0 = 1_700_000_000_000_000_000     # the trace's start, Unix ns


def _prof(busy_us, rows=()):
    """A finished device-only trace: kernels at ``busy_us`` (µs from its
    start), and ``rows`` (name, device µs) for ``key_averages``."""
    events = [SimpleNamespace(name=f"k{i}", device_type=DeviceType.CUDA,
                              time_range=SimpleNamespace(start=a, end=b))
              for i, (a, b) in enumerate(busy_us)]
    avgs = [SimpleNamespace(key=n, device_type=DeviceType.CUDA,
                            self_device_time_total=us, count=1)
            for n, us in rows]
    kineto = SimpleNamespace(trace_start_ns=lambda: T0)
    return SimpleNamespace(events=lambda: events,
                           key_averages=lambda: avgs,
                           profiler=SimpleNamespace(kineto_results=kineto))


def _span(name, a_us, b_us, **attrs):
    """A closed span at ``a_us``..``b_us`` on that trace's timeline."""
    offset = 1_000
    return SimpleNamespace(name=name, attrs=dict(attrs), offset_ns=offset,
                           start_ns=T0 + int(a_us * 1e3) - offset,
                           end_ns=T0 + int(b_us * 1e3) - offset)


def _ctx(prof, window_s):
    return {"prof": prof, "window": {"trace_window_s": window_s}}


@pytest.fixture
def recorded(monkeypatch):
    """Hand the readers these spans as the program's."""
    def give(spans):
        monkeypatch.setattr(trace, "spans", lambda: list(spans))
    return give


# busy 40 µs; idle gaps 10-20, 30-50, 60-100 (70 µs); a window of 80 µs
# untraced: the device idles 50 % of it
BUSY = [(0, 10), (20, 30), (50, 60), (100, 110)]


def test_serve_shares_split_the_idle_time(recorded):
    recorded([_span("offload.update", 0, 110),
              _span("serve.decode", 15, 35),                # 5 + 5 idle
              _span("serve.decode", 70, 80),                # 10 idle
              _span("serve.prefill", 40, 65, rid=1),        # 10 + 5 idle
              _span("serve.decode", 200, 300)])             # after
    ctx = _ctx(_prof(BUSY), 80e-6)
    assert harness.reader("device.idle_share.serve")(ctx) == \
        pytest.approx(50.0)
    assert harness.reader(DECODE)(ctx) == pytest.approx(50.0 * 20 / 70)
    assert harness.reader(PREFILL)(ctx) == pytest.approx(50.0 * 15 / 70)


def test_a_span_over_busy_time_alone_reads_zero(recorded):
    recorded([_span("serve.decode", 1, 9), _span("serve.prefill", 21, 29)])
    ctx = _ctx(_prof(BUSY), 80e-6)
    assert harness.reader(DECODE)(ctx) == 0.0
    assert harness.reader(PREFILL)(ctx) == 0.0


def _overlap(gaps, spans):
    return sum(max(0.0, min(gb, sb) - max(ga, sa))
               for ga, gb in gaps for sa, sb in spans)


@pytest.mark.parametrize("seed", range(6))
def test_serve_shares_never_exceed_the_idle_share(seed, recorded):
    """Random busy intervals and alternating decode and prefill spans:
    each share is the brute-force overlap scaled, and together they stay
    within the idle share."""
    rng = np.random.default_rng(seed)
    edges = np.cumsum(rng.uniform(1, 50, 80))
    busy = [(edges[i], edges[i + 1]) for i in range(0, 80, 2)]
    cuts = np.sort(rng.uniform(-20, edges[-1] + 20, 30))
    spans = [_span("serve.decode" if i % 4 == 0 else "serve.prefill",
                   cuts[i], cuts[i + 1]) for i in range(0, 30, 2)]
    recorded(spans)
    window = sum(b - a for a, b in busy) / 1e6 / rng.uniform(0.1, 0.9)
    ctx = _ctx(_prof(busy), window)
    share = harness.reader("device.idle_share.serve")(ctx)
    gaps = [(a[1], b[0]) for a, b in zip(busy, busy[1:])]
    idle = sum(b - a for a, b in gaps)
    got = {}
    for metric, name in ((DECODE, "serve.decode"),
                         (PREFILL, "serve.prefill")):
        mine = [(s.start_ns + s.offset_ns - T0) / 1e3 for s in spans
                if s.name == name]
        ends = [(s.end_ns + s.offset_ns - T0) / 1e3 for s in spans
                if s.name == name]
        got[metric] = harness.reader(metric)(ctx)
        want = share * _overlap(gaps, list(zip(mine, ends))) / idle
        assert got[metric] == pytest.approx(want, rel=1e-9, abs=1e-9)
    assert got[DECODE] + got[PREFILL] <= share * (1 + 1e-12)


def test_offload_readers_count_the_traced_updates(recorded):
    # two updates in the trace, a third after its last device op (the
    # trace with the host's ops, which follows a synchronise)
    recorded([_span("offload.update", 50, 300, h2d_bytes=10 ** 9,
                    wait_ns=2_000_000),
              _span("offload.update", 320, 390, h2d_bytes=10 ** 9,
                    wait_ns=4_000_000),
              _span("offload.update", 500, 600, h2d_bytes=10 ** 9,
                    wait_ns=10 ** 9)])
    prof = _prof([(0, 100), (150, 400)],
                 rows=[("Memcpy HtoD (Pinned -> Device)", 40_000),
                       ("Memcpy DtoH (Device -> Pinned)", 30_000),
                       ("gemm", 1_000)])
    ctx = _ctx(prof, 1e-3)
    assert harness.reader(WAIT)(ctx) == pytest.approx(3.0)
    assert harness.reader(H2D)(ctx) == pytest.approx(2e9 / 0.04 / 1e9)


def test_cpu_updates_have_no_wait(recorded):
    recorded([_span("offload.update", 50, 300, h2d_bytes=8)])
    ctx = _ctx(_prof([(0, 400)], rows=[("Memcpy HtoD (x)", 10.0)]), 1e-3)
    assert harness.reader(WAIT)(ctx) is None
    assert harness.reader(H2D)(ctx) == pytest.approx(8 / 1e-5 / 1e9)


@pytest.mark.parametrize("metric", [DECODE, PREFILL, WAIT, H2D])
def test_silent_without_the_spans(metric, recorded, monkeypatch):
    prof = _prof(BUSY, rows=[("Memcpy HtoD (Pinned -> Device)", 40.0)])
    ctx = _ctx(prof, 80e-6)
    recorded([])
    assert harness.reader(metric)(ctx) is None
    recorded([_span("serve.decode", 15, 35), _span("serve.prefill", 40, 65),
              _span("offload.update", 5, 50, h2d_bytes=8, wait_ns=9)])
    assert harness.reader(metric)(ctx) is not None
    # a commit before the program's spans: no ``repro_torch.trace``
    monkeypatch.setitem(sys.modules, "repro_torch.trace", None)
    monkeypatch.delattr(repro_torch, "trace")
    assert harness.reader(metric)(ctx) is None
    assert harness.reader(metric)({"prof": None}) is None


@pytest.mark.parametrize("metric", [DECODE, PREFILL, WAIT, H2D])
def test_silent_on_a_trace_without_device_ops(metric, recorded):
    """A CPU run's trace holds no device operation."""
    recorded([_span("serve.decode", 15, 35), _span("serve.prefill", 40, 65),
              _span("offload.update", 5, 50, h2d_bytes=8, wait_ns=9)])
    assert harness.reader(metric)(_ctx(_prof([]), 1e-3)) is None
