"""Readings from a ``torch.profiler`` trace of a short steady span: the
device's busy time (the union of the intervals in which any kernel or
copy ran), alone or within one interval of the trace, device time by
kernel and under a profiler range, and the breakdown the result line
carries."""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np

# the program's profiler ranges: in a trace with the host's ops they show
# on the device timeline as annotations, which are not operations
RANGES = ("flash_attention.backward", "optimizer.update")
# the train driver launches ``torch.cuda._sleep(0)`` on the compute
# stream before each traced step: that kernel's start on the device
# timeline is the step's device start (a trace of the device's operations
# alone holds no profiler range to mark it with)
STEP_MARK = "spin_kernel"


def _device_events(prof):
    from torch.autograd import DeviceType
    return [e for e in prof.events() if e.device_type == DeviceType.CUDA
            and e.name not in RANGES and not e.name.startswith("ProfilerStep")
            and e.time_range.end > e.time_range.start]


def busy_intervals(prof) -> List[Tuple[float, float]]:
    """The union of the device's operation intervals (µs), in order."""
    spans = sorted((e.time_range.start, e.time_range.end)
                   for e in _device_events(prof))
    out: List[List[float]] = []
    for a, b in spans:
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def busy_s(prof) -> float:
    return sum(b - a for a, b in busy_intervals(prof)) / 1e6


def kernel_rows(prof) -> List[Tuple[str, float, int]]:
    """(name, device seconds, count) of each device operation, largest
    first."""
    from torch.autograd import DeviceType
    rows = [(e.key, e.self_device_time_total / 1e6, e.count)
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA
            and e.self_device_time_total > 0 and e.key not in RANGES]
    return sorted(rows, key=lambda r: -r[1])


def kernels_named(prof, part: str) -> Tuple[float, int]:
    """Device seconds and launches of the operations whose name holds
    ``part``."""
    rows = [r for r in kernel_rows(prof) if part in r[0]]
    return sum(r[1] for r in rows), sum(r[2] for r in rows)


def under_range(prof, name: str) -> Tuple[float, int]:
    """Device seconds of the operations launched under the host range
    ``name``, and the number of times the range ran."""
    from torch.autograd import DeviceType
    evs = [e for e in prof.events()
           if e.device_type == DeviceType.CPU and e.name == name]
    return sum(e.device_time_total for e in evs) / 1e6, len(evs)


def idle_gaps(prof, top: int = 10) -> List[List]:
    """The device's idle gaps summed by the innermost host operation that
    was running at each gap's middle, longest first (seconds)."""
    from torch.autograd import DeviceType
    busy = busy_intervals(prof)
    if len(busy) < 2:
        return []
    gaps = [(b0[1], b1[0]) for b0, b1 in zip(busy, busy[1:])
            if b1[0] > b0[1]]
    gaps = sorted(gaps, key=lambda g: g[0] - g[1])[:500]
    cpu = [e for e in prof.events() if e.device_type == DeviceType.CPU]
    if not cpu:
        return []
    st = np.array([e.time_range.start for e in cpu], np.float64)
    en = np.array([e.time_range.end for e in cpu], np.float64)
    names = [e.name for e in cpu]
    sums: Dict[str, float] = {}
    for a, b in gaps:
        mid = (a + b) / 2
        hit = np.nonzero((st <= mid) & (en >= mid))[0]
        name = names[hit[np.argmin(en[hit] - st[hit])]] if len(hit) \
            else "host (no traced op)"
        sums[name] = sums.get(name, 0.0) + (b - a) / 1e6
    return [[k, v] for k, v in sorted(sums.items(), key=lambda kv: -kv[1])
            [:top]]


def breakdown(prof, prof_ops=None) -> Dict[str, List[List]]:
    """The longest device operations of ``prof`` (seconds, summed by
    name), and the device's longest idle gaps in ``prof_ops`` (a trace
    with the host's ops) by what the host was doing."""
    return {"device_ops": [[n, s] for n, s, _ in kernel_rows(prof)[:10]],
            "idle_gaps": idle_gaps(prof_ops) if prof_ops is not None
            else []}


def step_interval(prof, n: int) -> Optional[Tuple[float, float]]:
    """The ``n`` steps before the last of a trace whose steps each begin
    with the driver's mark (``STEP_MARK``): from the start of the mark
    ``n`` before the last to the start of the last (µs on the trace's
    timeline).  Counted from the end, since the tracer may lose records as
    it starts.  None where the trace holds fewer than ``n + 1`` marks."""
    marks = sorted(e.time_range.start for e in _device_events(prof)
                   if STEP_MARK in e.name)
    if len(marks) <= n:
        return None
    return marks[-1 - n], marks[-1]


def in_interval(prof, interval: Tuple[float, float]
                ) -> Optional[Dict[str, float]]:
    """busy_s, the union of the device's operation intervals on every
    stream intersected with ``interval`` (µs on the trace's timeline), and
    window_s, the interval's length; None where no operation ran in it.
    Both are counted in whole nanoseconds (the trace's own resolution) and
    no piece starts before the last one ended, so busy_s <= window_s."""
    lo, hi = (round(t * 1e3) for t in interval)
    busy, end = 0, lo
    for a, b in busy_intervals(prof):
        a, b = max(round(a * 1e3), end), min(round(b * 1e3), hi)
        if b > a:
            busy, end = busy + b - a, b
    if busy <= 0:
        return None
    return {"busy_s": busy / 1e9, "window_s": (hi - lo) / 1e9}


def summary(prof, window: dict) -> Optional[Dict[str, float]]:
    """busy_s and window_s of a traced span, or None if no device op ran.
    A train window names how many steps it measured (``trace_steps``):
    both numbers are then ``in_interval`` of ``step_interval``, one
    interval of the trace (the step marks in it count as busy time: about
    a µs a step).  A serve window gives ``trace_window_s``, the
    traced span's length scaled to the untraced pace, set against the
    whole trace's busy time."""
    if "trace_steps" in window:
        span = step_interval(prof, window["trace_steps"])
        return None if span is None else in_interval(prof, span)
    busy = busy_s(prof)
    if busy <= 0:
        return None
    return {"busy_s": busy, "window_s": window["trace_window_s"]}


def idle_share(ctx) -> Optional[float]:
    """The share (%) of the traced span in which no operation ran on the
    device: 1 - busy_s / window_s of ``summary``, from a trace of the
    device's operations alone (recording the host's ops would slow the
    host and widen the gaps)."""
    prof = ctx.get("prof")
    if prof is None:
        return None
    s = summary(prof, ctx["window"])
    if s is None:
        return None
    return 100.0 * (1.0 - s["busy_s"] / s["window_s"])
