"""The port's spans and counters, kept in memory on the profiler's clock.

A span is a named stretch of host time in the port (a prefill, a decode
step, an offloaded update) with a few integer attributes: a request id,
or counters such as bytes copied.  Spans are recorded only while a
``torch.profiler`` is active; otherwise ``span()`` tests one boolean and
hands back a shared handle that does nothing, with no clock read and no
record.  An operator who runs a profiler reads what the port did under it
with ``spans()``, and ``placed(prof)`` puts each span on that trace's
timeline:

    with torch.profiler.profile(activities=[...]) as prof:
        engine.run(requests)
    for s, a_us, b_us in trace.placed(prof, trace.SERVE_DECODE):
        ...   # a_us, b_us: µs from the trace's start, as prof's events

Why no span is a ``record_function`` range: Kineto projects every user
range onto the device timeline as an annotation, so a reader of the
device's busy time would have to know each range by name to leave it out.
A range around every decode step would cover every decode gap and turn the
device's idle time into busy time.  So only the two ranges the port had
before its spans stay ranges (``RANGES``, under their names), and every
name in ``SPANS`` is recorded here alone.

Clocks: a span is stamped with ``time.perf_counter_ns()``, and as it opens
it samples the offset from that clock to ``time.time_ns()``, the Unix
clock a profiler's trace counts from (``kineto_results.trace_start_ns()``).
"""
from __future__ import annotations

import collections
import time
from typing import Any, Callable, Dict, Iterator, List, Optional, Tuple

import torch.autograd.profiler as _profiler

__all__ = ["RANGES", "SPANS", "UPDATE_RANGE", "BACKWARD_RANGE",
           "SERVE_PREFILL", "SERVE_DECODE", "OFFLOAD_UPDATE", "Span",
           "span", "spans", "clear", "dropped", "placed"]

# the profiler ranges (``record_function``): the device trace shows them
# as annotations, and its readers leave them out by these names
UPDATE_RANGE = "optimizer.update"            # an optimizer's update
# flash's backward: the sm90 kernels' launches, or the blockwise recompute
BACKWARD_RANGE = "flash_attention.backward"
RANGES = (UPDATE_RANGE, BACKWARD_RANGE)

# the program spans (in memory only) and the attributes they carry
SERVE_PREFILL = "serve.prefill"    # ``ServeRuntime.prefill_request``: rid
SERVE_DECODE = "serve.decode"      # the engine's ``ServeRuntime.decode`` call
# one offloaded optimizer update: ``h2d_bytes`` loaded, and on a card
# ``wait_ns``, how long the compute stream stood stalled on the load stream
OFFLOAD_UPDATE = "offload.update"
SPANS = (SERVE_PREFILL, SERVE_DECODE, OFFLOAD_UPDATE)

CAPACITY = 1 << 16    # spans kept; the oldest go first


def _unix_offset_ns() -> int:
    """``time.time_ns()`` minus ``time.perf_counter_ns()``, now."""
    a = time.perf_counter_ns()
    u = time.time_ns()
    return u - (a + time.perf_counter_ns()) // 2


class _Off:
    """The handle ``span()`` gives while no profiler is active: it records
    nothing and is false, so callers can skip work only a span reads."""
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc) -> bool:
        return False

    def __bool__(self) -> bool:
        return False

    def add(self, key: str, n: int) -> None:
        pass

    def later(self, key: str, value: Callable[[], int]) -> None:
        pass


_OFF = _Off()


class Span:
    """One recorded span: ``name``, ``start_ns`` and ``end_ns``
    (``perf_counter_ns``; ``end_ns`` is None while open), ``attrs`` and
    ``offset_ns`` (to the Unix clock)."""
    __slots__ = ("name", "start_ns", "end_ns", "attrs", "offset_ns", "_rec")

    def __init__(self, rec: "_Recorder", name: str, attrs: Dict[str, Any]):
        self._rec, self.name, self.attrs = rec, name, attrs
        self.end_ns = None

    def __enter__(self):
        self.offset_ns = _unix_offset_ns()
        self._rec._keep(self)
        self.start_ns = time.perf_counter_ns()
        return self

    def __exit__(self, *exc) -> bool:
        self.end_ns = time.perf_counter_ns()
        return False

    def __bool__(self) -> bool:
        return True

    def add(self, key: str, n: int) -> None:
        """Add ``n`` to the counter attribute ``key``."""
        self.attrs[key] = self.attrs.get(key, 0) + n

    def later(self, key: str, value: Callable[[], int]) -> None:
        """Set attribute ``key`` to ``value()`` when the spans are read
        (device timings that must not synchronise where they are made).
        The call stays on the span, so it goes when the buffer drops the
        span."""
        self.attrs[key] = value


class _Recorder:
    """A bounded buffer of spans (``capacity``; the oldest are dropped and
    counted in ``dropped``)."""

    def __init__(self, capacity: int = CAPACITY):
        self._buf: collections.deque = collections.deque(maxlen=capacity)
        self.dropped = 0

    def span(self, name: str, **attrs: int):
        """A context manager over ``name``'s span; while no profiler is
        active, a handle that records nothing."""
        if not _profiler._is_profiler_enabled:
            return _OFF
        return Span(self, name, attrs)

    def _keep(self, s: Span) -> None:
        if len(self._buf) == self._buf.maxlen:
            self.dropped += 1
        self._buf.append(s)

    def spans(self) -> List[Span]:
        """The recorded spans in the order they opened, their deferred
        attributes resolved."""
        out = list(self._buf)
        for s in out:
            for key, value in list(s.attrs.items()):
                if callable(value):
                    s.attrs[key] = value()
        return out

    def clear(self) -> None:
        self._buf.clear()
        self.dropped = 0


_RECORDER = _Recorder()
span = _RECORDER.span
spans = _RECORDER.spans
clear = _RECORDER.clear


def dropped() -> int:
    """How many spans the buffer dropped since the last ``clear()``."""
    return _RECORDER.dropped


def _trace_start_ns(prof) -> Optional[int]:
    """The Unix time (ns) a finished ``torch.profiler.profile``'s events
    count from, or None where the profiler does not say."""
    try:
        return int(prof.profiler.kineto_results.trace_start_ns())
    except (AttributeError, TypeError, RuntimeError):
        return None


def placed(prof, name: Optional[str] = None
           ) -> Iterator[Tuple[Span, float, float]]:
    """(span, start, end) of each closed span (named ``name``) of
    ``spans()``, in µs on the timeline of the finished profiler ``prof``,
    where its events' ``time_range`` lies.  Nothing where ``prof`` does
    not say when its trace started."""
    t0 = _trace_start_ns(prof)
    if t0 is None:
        return
    for s in spans():
        if s.end_ns is None or (name is not None and s.name != name):
            continue
        yield (s, (s.start_ns + s.offset_ns - t0) / 1e3,
               (s.end_ns + s.offset_ns - t0) / 1e3)
