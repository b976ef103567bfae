"""How long the compute stream stood stalled on the offload's load stream
in an offloaded update: the program's ``wait_ns`` counter of each
``offload.update`` span (timing events around each piece's wait), mean
over the updates of the device-only traced steps: those that started
after the trace's start and before its last device operation ended (the
next trace's update starts after a synchronise).  Nothing where the
program records no such spans."""
from bench import devicetrace

SPAN = "offload.update"


def read(ctx):
    prof = ctx.get("prof")
    if prof is None:
        return None
    try:
        from repro_torch import trace
    except ImportError:
        return None
    busy = devicetrace.busy_intervals(prof)
    if not busy:
        return None
    waits = [s.attrs["wait_ns"] for s, a, _ in trace.placed(prof, SPAN)
             if 0.0 <= a <= busy[-1][1] and "wait_ns" in s.attrs]
    if not waits:
        return None
    return sum(waits) / len(waits) / 1e6
